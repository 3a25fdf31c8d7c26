"""Shared transformer layers: norms, RoPE, GQA attention (+KV cache), MLP,
embedding — the counterpart of the reference's ``models/layers.py``.

Each layer is an ``nn.Module`` holding its parameters under the
reference's leaf names, with weights laid out as the reference keeps them
(``x @ w``, w of shape (in, out)), and a function ``*_apply(p, ...)`` that
computes it from the module, so both packages are called alike.  The
reference's sharding constraints have no counterpart and are dropped.
Parameters are created empty and trainable; each module's
``reset_parameters(gen)`` draws its own (not its children's) from a
``torch.Generator`` as the reference's ``*_init`` does (the same
distributions, not the same bits).

The prefill's attention runs the ``flash_attention`` CUDA kernel
(``kernels/flash_attn``) for both ``attn_impl`` values; decode attends to
the KV cache in plain PyTorch, as the reference does, with its scores in
float32 as the kernel keeps them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models.config import ArchConfig

Tensor = torch.Tensor


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    """A trainable parameter, created empty (``reset_parameters`` or a
    converter fills it)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def dense_fill_(w: Tensor, gen: torch.Generator, scale: float = 1.0) -> None:
    """w ~ scale · N(0, 1) / sqrt(fan_in), fan_in = w.shape[0], drawn in
    float32 on w's device and cast to w's type."""
    z = torch.randn(w.shape, generator=gen, device=w.device)
    w.copy_(z * (scale / math.sqrt(w.shape[0])))


# ---------------------------------------------------------------- RMSNorm --
class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = _param((d,), dtype, device)

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        self.scale.fill_(1.0)


def rmsnorm_apply(p: RMSNorm, x: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


# ------------------------------------------------------------------- RoPE --
def rope_freqs(hd: int, theta: float, fraction: float,
               device=None) -> Tensor:
    rot = int(hd * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)                     # (rot/2,)


def apply_rope(x: Tensor, positions: Tensor, inv_freq: Tensor) -> Tensor:
    """x: (..., T, H, hd); positions: (..., T) integers."""
    rot2 = inv_freq.shape[0]
    ang = positions[..., :, None].float() * inv_freq     # (..., T, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x_rot = x[..., : 2 * rot2].float()
    x1, x2 = x_rot[..., :rot2], x_rot[..., rot2:]
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([y.to(x.dtype), x[..., 2 * rot2:]], dim=-1)


# -------------------------------------------------------------- Attention --
class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.hd, model_dtype(cfg)
        self.wq = _param((d, cfg.n_heads * hd), dt, device)
        self.wk = _param((d, cfg.n_kv_heads * hd), dt, device)
        self.wv = _param((d, cfg.n_kv_heads * hd), dt, device)
        self.wo = _param((cfg.n_heads * hd, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, dt, device)
            self.k_norm = RMSNorm(hd, dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_fill_(w, gen)


def _qkv(p: Attention, cfg: ArchConfig, x: Tensor, positions: Tensor):
    B, T, _ = x.shape
    hd = cfg.hd
    q = (x @ p.wq).reshape(B, T, cfg.n_heads, hd)
    k = (x @ p.wk).reshape(B, T, cfg.n_kv_heads, hd)
    v = (x @ p.wv).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm_apply(p.q_norm, q)
        k = rmsnorm_apply(p.k_norm, k)
    inv_freq = rope_freqs(hd, cfg.rope_theta, cfg.rope_fraction, x.device)
    return apply_rope(q, positions, inv_freq), apply_rope(k, positions,
                                                          inv_freq), v


def attention_apply(p: Attention, cfg: ArchConfig, x: Tensor,
                    positions: Tensor) -> Tensor:
    """Causal GQA self-attention (prefill path) through the
    ``flash_attention`` kernel, for either ``attn_impl`` (the reference's
    naive and flash forms compute the same function).  Positions are the
    prefill's 0..T-1, as the kernel's causal mask assumes."""
    B, T, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    return flash_ops.causal_attention(q, k, v).reshape(B, T, -1) @ p.wo


def attention_decode(p: Attention, cfg: ArchConfig, x: Tensor, cache: dict,
                     pos: Tensor) -> tuple[Tensor, dict]:
    """One-token decode against a (B, S, Hkv, hd) KV cache; the new k and v
    are written into the cache in place at position ``pos[0, 0]`` (the
    reference returns updated copies), and the cache is returned too."""
    B = x.shape[0]
    hd = cfg.hd
    positions = pos.reshape(1, 1).expand(B, 1) if pos.dim() == 0 else pos
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    slot = positions[0, :1].long()          # on the device: no host read
    k_cache = cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    v_cache = cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))

    S = k_cache.shape[1]
    groups = cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(B, 1, cfg.n_kv_heads, groups, hd)
    # Scores in float32, as the prefill's kernel keeps them.  The reference
    # rounds them to the activation type first; in bfloat16 that moves
    # decode's hidden states off the prefill's by enough to flip a near
    # tie in an MoE router downstream (ROADMAP.md §3).
    logits = torch.einsum("btkgh,bskh->bkgts", qh.float(),
                          k_cache.float()) / math.sqrt(hd)
    valid = (torch.arange(S, device=x.device)[None, :]
             <= positions[:, 0][:, None])                      # (B, S)
    logits = torch.where(valid[:, None, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v_cache).reshape(B, 1, -1)
    return out @ p.wo, cache


def attention_cache_init(cfg: ArchConfig, batch: int, max_seq: int,
                         device=None) -> dict:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dt = model_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ------------------------------------------------------------------- MLP --
class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, d_ff: int | None = None,
                 device=None):
        super().__init__()
        d, d_ff, dt = cfg.d_model, d_ff or cfg.d_ff, model_dtype(cfg)
        self.w_up = _param((d, d_ff), dt, device)
        self.w_down = _param((d_ff, d), dt, device)
        if cfg.act == "swiglu":
            self.w_gate = _param((d, d_ff), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.w_up, self.w_down, getattr(self, "w_gate", None)):
            if w is not None:
                dense_fill_(w, gen)


def mlp_apply(p: MLP, cfg: ArchConfig, x: Tensor) -> Tensor:
    h = x @ p.w_up
    if cfg.act == "swiglu":
        h = F.silu(x @ p.w_gate) * h
    else:
        h = F.gelu(h, approximate="tanh")       # jax.nn.gelu's default
    return h @ p.w_down


# ------------------------------------------------------------- Embedding --
class Embed(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dt = model_dtype(cfg)
        self.table = _param((cfg.vocab, cfg.d_model), dt, device)
        if not cfg.tie_embeddings:
            self.head = _param((cfg.d_model, cfg.vocab), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        z = torch.randn(self.table.shape, generator=gen,
                        device=self.table.device)
        self.table.copy_(z * 0.02)
        if hasattr(self, "head"):
            dense_fill_(self.head, gen)


def embed_apply(p: Embed, tokens: Tensor) -> Tensor:
    return p.table[tokens]


def logits_apply(p: Embed, cfg: ArchConfig, h: Tensor) -> Tensor:
    logits = h @ (p.table.T if cfg.tie_embeddings else p.head)
    if cfg.logit_soft_cap > 0:
        c = cfg.logit_soft_cap
        logits = c * torch.tanh(logits / c)
    return logits
