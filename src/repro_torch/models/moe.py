"""Mixture-of-Experts FFN — the counterpart of the reference's
``models/moe.py``.

Each batch row is a dispatch group with its own capacity C =
``_capacity(cfg, T)`` and causal slot positions (``_causal_positions``):
an assignment past its expert's C slots is dropped (GShard semantics), and
a decode loop with a per-expert count cache reproduces those drops
exactly (``moe_cache_init``, ``moe_decode``).

The reference's ``impl='einsum'`` dispatches and combines through one-hot
einsums, ``impl='scatter'`` through scatter/gather; both keep the same
assignments.  Here both move the kept rows by index (the one-hot products
select one row each, so an index gather is the same function) and differ
where the reference's roundings differ: ``einsum`` sums a token's K gated
expert rows in float32 and rounds once, ``scatter`` rounds each gated row
and each add to the activation type.  ``impl='ep'`` is the reference's
expert parallelism over a mesh; without one (the port has none yet:
ROADMAP.md §1 item 11) it runs as ``einsum``, as the reference's does.

The expert products are batched matmuls (``torch.bmm``), as the
reference's are plain einsums outside any kernel.  The router runs in
float32; the gates are cast to the activation type before the combine.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _param, dense_fill_, model_dtype

Tensor = torch.Tensor


class SharedExperts(nn.Module):
    """The always-on experts, one SwiGLU of width n_shared · d_ff_expert."""

    def __init__(self, d: int, f: int, dtype, device=None):
        super().__init__()
        self.w_up = _param((d, f), dtype, device)
        self.w_gate = _param((d, f), dtype, device)
        self.w_down = _param((f, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.w_up, self.w_gate, self.w_down):
            dense_fill_(w, gen)


class MoE(nn.Module):
    """``router`` (d, E) in float32, ``w_up``/``w_gate`` (E, d, f),
    ``w_down`` (E, f, d) in the model's type, and ``shared`` where the
    config has shared experts: the reference's leaves."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        mo, d, dt = cfg.moe, cfg.d_model, model_dtype(cfg)
        E, f = mo.n_experts, mo.d_ff_expert
        self.router = _param((d, E), torch.float32, device)
        self.w_up = _param((E, d, f), dt, device)
        self.w_gate = _param((E, d, f), dt, device)
        self.w_down = _param((E, f, d), dt, device)
        if mo.n_shared_experts:
            self.shared = SharedExperts(d, f * mo.n_shared_experts, dt,
                                        device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        # fan-in is the leading dimension, E for the expert banks, as in
        # the reference's dense_init.
        for w in (self.router, self.w_up, self.w_gate, self.w_down):
            dense_fill_(w, gen)


def _router(p: MoE, cfg: ArchConfig, x2d: Tensor):
    """(gates (T, K) float32 renormalised over the top k, expert ids
    (T, K), probabilities (T, E))."""
    logits = x2d.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, idx, probs


def _capacity(cfg: ArchConfig, T: int) -> int:
    mo = cfg.moe
    c = int(T * mo.top_k / mo.n_experts * mo.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _experts_ffn(p: MoE, xe: Tensor) -> Tensor:
    """xe: (E, C, d) -> (E, C, d), each expert's SwiGLU on its rows."""
    h = torch.bmm(xe, p.w_up)
    g = torch.bmm(xe, p.w_gate)
    return torch.bmm(F.silu(g) * h, p.w_down)


def _causal_positions(onehot: Tensor, counts0: Tensor | None = None
                      ) -> tuple[Tensor, Tensor]:
    """Per-(group, expert) capacity-slot positions, causal within each
    group: onehot (G, S, K, E) integer assignment one-hots; an assignment's
    slot counts the earlier assignments of its group to its expert, token
    major then k major, plus ``counts0`` (G, E), the counts carried in from
    earlier tokens.  Returns (pos (G, S, K), counts_end (G, E)); the counts
    include dropped assignments, as the parallel path's do."""
    G, S, K, E = onehot.shape
    flat = onehot.reshape(G, S * K, E)
    pos_in_e = torch.cumsum(flat, dim=1).reshape(G, S, K, E) - 1
    counts_end = flat.sum(1)
    if counts0 is not None:
        pos_in_e = pos_in_e + counts0[:, None, None, :]
        counts_end = counts_end + counts0
    return (pos_in_e * onehot).sum(-1), counts_end


def _route(p: MoE, cfg: ArchConfig, x3d: Tensor):
    """The router and the causal drops over (G, S, d): (gates (G, S, K)
    float32, expert ids (G, S, K), slots (G, S, K), kept (G, S, K),
    capacity C).  A dropped assignment's slot is C, a spare row no token
    reads."""
    G, S, d = x3d.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    C = _capacity(cfg, S)
    gate_vals, idx, _ = _router(p, cfg, x3d.reshape(G * S, d))
    idx = idx.reshape(G, S, K)
    pos, _ = _causal_positions(F.one_hot(idx, E), None)
    keep = pos < C
    return (gate_vals.reshape(G, S, K), idx, torch.where(keep, pos, C),
            keep, C)


def _dispatch_ffn(p: MoE, cfg: ArchConfig, x3d: Tensor):
    """Every kept assignment's expert output: (rows (G, S, K, d), gates
    (G, S, K) in the activation type, zero where dropped)."""
    G, S, d = x3d.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    gate_vals, idx, slot, keep, C = _route(p, cfg, x3d)
    g_idx = torch.arange(G, device=x3d.device)[:, None, None].expand(G, S, K)
    # Kept assignments own their (expert, group, slot) row; dropped ones
    # all land in the spare row C, which nothing reads.
    xe = x3d.new_zeros((E, G, C + 1, d))
    xe[idx, g_idx, slot] = x3d[:, :, None, :].expand(G, S, K, d)
    ye = _experts_ffn(p, xe.reshape(E, G * (C + 1), d)).reshape(
        E, G, C + 1, d)
    rows = ye[idx, g_idx, slot]
    gates = torch.where(keep, gate_vals, 0.0).to(x3d.dtype)
    return rows, gates


def _moe_einsum(p: MoE, cfg: ArchConfig, x3d: Tensor) -> Tensor:
    """The reference's einsum combine: the K gated rows summed in float32,
    rounded once."""
    rows, gates = _dispatch_ffn(p, cfg, x3d)
    return torch.einsum("gskd,gsk->gsd", rows.float(),
                        gates.float()).to(x3d.dtype)


def _moe_scatter(p: MoE, cfg: ArchConfig, x3d: Tensor) -> Tensor:
    """The reference's scatter combine: each gated row and each add
    rounded to the activation type."""
    rows, gates = _dispatch_ffn(p, cfg, x3d)
    out = rows * gates[..., None]
    y = out[:, :, 0]
    for k in range(1, out.shape[2]):
        y = y + out[:, :, k]
    return y


def _shared_experts(sp: SharedExperts, x2d: Tensor) -> Tensor:
    return (F.silu(x2d @ sp.w_gate) * (x2d @ sp.w_up)) @ sp.w_down


def moe_apply(p: MoE, cfg: ArchConfig, x: Tensor) -> Tensor:
    """x (B, T, d) -> (B, T, d); the batch rows are the dispatch groups."""
    B, T, d = x.shape
    if cfg.moe.impl == "scatter":
        y = _moe_scatter(p, cfg, x)
    else:
        y = _moe_einsum(p, cfg, x)
    if cfg.moe.n_shared_experts:
        y = y + _shared_experts(p.shared, x.reshape(B * T, d)).reshape(
            B, T, d)
    return y


# ------------------------------------------------------------- decode ------
def moe_cache_init(cfg: ArchConfig, batch: int, max_seq: int,
                   device=None) -> dict:
    """Per-sequence decode state: the running per-expert assignment counts
    (dropped ones included) and the capacity of a ``max_seq``-token
    parallel pass.  Decode replays a T-token ``moe_apply`` exactly iff
    ``_capacity(cfg, max_seq) == _capacity(cfg, T)``."""
    return {"counts": torch.zeros((batch, cfg.moe.n_experts),
                                  dtype=torch.int64, device=device),
            "capacity": _capacity(cfg, max_seq)}


def moe_decode(p: MoE, cfg: ArchConfig, x: Tensor, cache: dict
               ) -> tuple[Tensor, dict]:
    """One decode chunk x (B, S, d) through the MoE FFN: the router and the
    drops of ``moe_apply`` token for token, from the cached counts; the
    experts run dense over the few tokens (every expert on every token,
    weighted by its gate, zero where not chosen or dropped).  Returns the
    output and a new cache."""
    mo = cfg.moe
    B, S, d = x.shape
    E, K = mo.n_experts, mo.top_k
    x2d = x.reshape(B * S, d)
    gate_vals, idx, _ = _router(p, cfg, x2d)
    pos, counts = _causal_positions(F.one_hot(idx.reshape(B, S, K), E),
                                    cache["counts"])
    keep = (pos < cache["capacity"]).reshape(B * S, K)
    gates = x.new_zeros((B * S, E)).scatter_(
        1, idx, torch.where(keep, gate_vals, 0.0).to(x.dtype))
    xb = x2d.expand(E, B * S, d)
    h = torch.bmm(xb, p.w_up)
    g = torch.bmm(xb, p.w_gate)
    ye = torch.bmm(F.silu(g) * h, p.w_down)                # (E, BS, d)
    y = torch.einsum("etd,te->td", ye, gates)
    if mo.n_shared_experts:
        y = y + _shared_experts(p.shared, x2d)
    return y.reshape(B, S, d), {"counts": counts,
                                "capacity": cache["capacity"]}
