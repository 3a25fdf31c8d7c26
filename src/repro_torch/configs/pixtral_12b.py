"""pixtral-12b [vlm] — mistral-nemo decoder backbone; the pixtral-ViT
frontend is a STUB supplying precomputed patch embeddings
(hf:mistralai/Pixtral-12B-2409).

40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    act="swiglu",
    rope_theta=1_000_000.0,
    frontend="embeddings",
    frontend_len=1024,           # image patch tokens (stub)
    dtype="bfloat16",
)
