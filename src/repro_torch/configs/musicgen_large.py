"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens
(arXiv:2306.05284). The EnCodec frontend is a STUB: ``input_specs`` feeds
precomputed frame embeddings for the conditioning prefix.

48L d_model=2048 32H (MHA: kv=32) d_ff=8192 vocab=2048.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    act="gelu",
    qk_norm=False,
    rope_theta=10_000.0,
    frontend="embeddings",
    frontend_len=256,            # text/melody conditioning prefix (stub)
    dtype="bfloat16",
)
