"""minicpm-2b [dense] — llama-like with depth-scaled residuals and the WSD
(warmup–stable–decay) schedule (arXiv:2404.06395); ``SCHEDULE`` names it
for the training path (``launch/steps.schedule_for``).

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753.
"""
from repro_torch.models.config import ArchConfig

_SCALE_DEPTH = 1.4

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    tie_embeddings=True,
    residual_scale=_SCALE_DEPTH / (40 ** 0.5),   # scale_depth/sqrt(L)
    act="swiglu",
    dtype="bfloat16",
)

SCHEDULE = "wsd"
