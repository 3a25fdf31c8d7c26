"""Architecture configuration — one frozen dataclass consumed everywhere.

A copy of the reference's ``models/config.py`` (pure Python, but it lives
in the reference package, which the port does not import).  Every
architecture the port runs is an ``ArchConfig`` in
``repro_torch.configs.<id>``; reduced smoke variants shrink the same
dataclass.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    # 'ep' is expert parallelism over a mesh; the port has no mesh yet
    # (ROADMAP.md §1 item 11.3), so it runs as 'einsum', as the reference's
    # does without one.
    impl: Literal["einsum", "scatter", "ep"] = "einsum"
    router_dtype: str = "float32"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0        # stablelm uses partial rotary (0.25)
    parallel_block: bool = False      # command-r style attn ∥ mlp
    act: Literal["swiglu", "gelu"] = "swiglu"
    tie_embeddings: bool = False
    residual_scale: float = 1.0       # minicpm depth-scaled residuals
    logit_soft_cap: float = 0.0

    moe: MoEConfig | None = None
    moe_every: int = 1                # apply MoE at layers i % moe_every == moe_offset
    moe_offset: int = 0

    # Block pattern over one period, e.g. jamba: 8-layer period with one attn.
    # Entries: 'attn' | 'mamba' | 'mlstm' | 'slstm'
    block_pattern: tuple[str, ...] = ("attn",)

    # SSM (mamba/SSD) geometry
    ssm_d_state: int = 16
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # xLSTM geometry
    xlstm_expand: int = 2

    attention: Literal["full", "nystrom"] = "full"
    nystrom_landmarks: int = 256
    # 'naive' materializes the (T, S) score matrix (the paper-era baseline);
    # 'flash' is the blockwise online-softmax form (no T² materialization) —
    # the §Perf memory-term optimization. Numerics identical (f32 softmax).
    attn_impl: Literal["naive", "flash"] = "naive"
    flash_block: int = 1024

    # Modality frontend stub: 'tokens' or 'embeddings' (vlm/audio backbones
    # receive precomputed frame/patch embeddings for part of the sequence).
    frontend: Literal["tokens", "embeddings"] = "tokens"
    frontend_len: int = 0             # positions fed as raw embeddings

    dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    def block_kind(self, i: int) -> str:
        return self.block_pattern[i % self.period]

    def ffn_kind(self, i: int) -> str:
        if self.moe is not None and i % self.moe_every == self.moe_offset:
            return "moe"
        return "dense" if self.d_ff > 0 else "none"

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        n_layers = max(self.period, 2 if self.period == 1 else self.period)
        kw = dict(
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=128,
            ssm_d_state=8,
            ssm_head_dim=16,
            ssm_chunk=8,
            nystrom_landmarks=8,
            frontend_len=4 if self.frontend == "embeddings" else 0,
            dtype="float32",
        )
        if self.moe is not None:
            kw["moe"] = replace(self.moe, n_experts=4,
                                top_k=min(self.moe.top_k, 2), d_ff_expert=32)
        return replace(self, **kw)


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (used for 6·N·D model-flops and memory plan)."""
    d, hd = cfg.d_model, cfg.hd
    n = 0
    n += cfg.vocab * d                                   # embedding
    if not cfg.tie_embeddings:
        n += cfg.vocab * d                               # lm head
    for i in range(cfg.n_layers):
        kind = cfg.block_kind(i)
        if kind == "attn":
            n += d * (cfg.n_heads * hd) + d * hd * cfg.n_kv_heads * 2
            n += cfg.n_heads * hd * d                    # o_proj
            n += 2 * d                                   # norms
            if cfg.qk_norm:
                n += 2 * hd
        elif kind == "mamba":
            d_in = cfg.ssm_expand * d
            n += d * 2 * d_in                            # in_proj (x, gate)
            n += d_in * cfg.ssm_conv                     # conv
            heads = d_in // cfg.ssm_head_dim
            n += d_in * 2 * cfg.ssm_d_state + d_in + heads * 2  # B,C,dt,A,D
            n += d_in * d + d                            # out_proj + norm
        elif kind in ("mlstm", "slstm"):
            d_in = cfg.xlstm_expand * d
            n += d * 3 * d_in + 3 * d_in                 # qkv(+gates approx)
            n += d_in * d + 2 * d
        ffn = cfg.ffn_kind(i)
        if ffn == "dense":
            mult = 3 if cfg.act == "swiglu" else 2
            n += mult * d * cfg.d_ff + d
        elif ffn == "moe":
            mo = cfg.moe
            n += d * mo.n_experts                        # router
            n += mo.n_experts * 3 * d * mo.d_ff_expert
            n += mo.n_shared_experts * 3 * d * mo.d_ff_expert
            n += d
    n += d                                               # final norm
    return n


def active_param_count(cfg: ArchConfig) -> int:
    """Active (per-token) parameters — MoE counts only top_k experts."""
    if cfg.moe is None:
        return param_count(cfg)
    dense_like = replace(
        cfg, moe=replace(cfg.moe,
                         n_experts=cfg.moe.top_k + cfg.moe.n_shared_experts,
                         n_shared_experts=0))
    return param_count(dense_like)
