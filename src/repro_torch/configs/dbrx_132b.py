"""dbrx-132b [moe] — 16 experts top-4, fine-grained MoE on every layer
(hf:databricks/dbrx-base).

40L d_model=6144 48H (GQA kv=8, head_dim=128) d_ff_expert=10752
vocab=100352.
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
    act="swiglu",
    rope_theta=500_000.0,
    dtype="bfloat16",
)
