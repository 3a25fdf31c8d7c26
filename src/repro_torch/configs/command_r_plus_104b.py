"""command-r-plus-104b [dense] — parallel attention∥FFN blocks, no biases,
tied embeddings (hf:CohereForAI/c4ai-command-r-plus lineage).

64L d_model=12288 96H (GQA kv=8, head_dim=128) d_ff=33792 vocab=256000.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab=256000,
    parallel_block=True,
    tie_embeddings=True,
    act="swiglu",
    rope_theta=75_000_000.0,
    dtype="bfloat16",
)
