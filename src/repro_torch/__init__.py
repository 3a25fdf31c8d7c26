"""PyTorch/CUDA port of the incremental kernel PCA system.

The JAX package ``repro`` is the reference; this package is its
counterpart for one NVIDIA H100, with hand-written CUDA kernels in
``kernels/csrc``.  It imports neither ``jax`` nor anything of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (or defaulted to) and absent —
    there is no silent fallback to the CPU.

    On CUDA it pins full-precision float32 products: a TF32 matmul keeps
    about three decimal digits and would miss the f32 tolerances silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
