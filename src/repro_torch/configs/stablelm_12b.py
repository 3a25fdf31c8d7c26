"""stablelm-12b [dense] — partial rotary embeddings (fraction 0.25), GQA
(hf:stabilityai/stablelm-2-12b lineage).

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    rope_fraction=0.25,
    act="swiglu",
    dtype="bfloat16",
)
