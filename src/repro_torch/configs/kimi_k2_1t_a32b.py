"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 + 1 shared
expert, fine-grained experts (d_ff_expert=2048)  [arXiv:2501.kimi2,
paper-table].  Optimizer plan: Adafactor (factored 2nd moment), bf16
params; ``OPTIMIZER`` names it for the training path (not ported yet:
ROADMAP.md §1 item 11).

61L d_model=7168 64H (GQA kv=8) vocab=163840, MoE 384e top-8.
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, capacity_factor=1.25),
    qk_norm=True,
    act="swiglu",
    dtype="bfloat16",
)

OPTIMIZER = "adafactor"
