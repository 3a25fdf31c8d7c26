"""jamba-1.5-large-398b [hybrid] — Mamba + attention at 1:7 interleave
(arXiv:2403.19887), at its full widths, without its experts.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.  The reference's
config adds MoE 16e top-2 (d_ff_expert=24576) on every odd layer; the
port runs it with ``moe=None``, so every layer takes the dense FFN, until
the experts are ported (ROADMAP.md §1 item 11).  One period (8 layers)
then holds 8.9 B parameters, 16.6 GiB in bf16.
"""
from repro_torch.models.config import ArchConfig

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
    moe=None,
    moe_every=2,                 # the reference's expert layers (unused)
    moe_offset=1,
    ssm_d_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    dtype="bfloat16",
)
