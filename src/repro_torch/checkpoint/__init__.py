from repro_torch.checkpoint.npz_store import (AsyncCheckpointer, latest_step,
                                              load_checkpoint, save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "load_checkpoint",
           "save_checkpoint"]
