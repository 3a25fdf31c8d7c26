"""jamba-1.5-large-398b [hybrid] — Mamba + attention at 1:7 interleave with
MoE every other layer (arXiv:2403.19887).  Mamba decode state is O(1) and
the single attention layer per period uses a KV cache.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2 on
the odd layers, dense FFN on the even ones: the reference's config, field
for field.  One period (8 layers) with its experts holds 84 GiB of bf16
weights, more than one H100's 80 GB; ``dataclasses.replace(CONFIG,
moe=None)`` gives every layer the dense FFN (16.6 GiB a period).
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    # one attention layer per 8 (position 4 of the Jamba block), rest Mamba
    block_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    moe_every=2,
    moe_offset=1,                # MoE on odd layers, dense FFN on even
    ssm_d_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    dtype="bfloat16",
)
