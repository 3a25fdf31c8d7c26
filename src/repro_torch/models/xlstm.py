"""xLSTM blocks (arXiv:2405.04517) — the counterpart of the reference's
``models/xlstm.py``: mLSTM (matrix memory, evaluated chunk by chunk as
linear attention with a data-dependent decay) and sLSTM (scalar memory, a
recurrence over time with exponential gating).

As in the reference: scalar (per-head) gates, no causal conv front end,
RMSNorm in place of GroupNorm.  Both run in plain PyTorch (the reference
reaches no kernel here): the mLSTM's chunks in a loop over T / chunk, the
sLSTM's steps in a loop over T with the input projection of all T tokens
hoisted out of it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (RMSNorm, _param, dense_fill_,
                                       model_dtype, rmsnorm_apply)

Tensor = torch.Tensor


# ------------------------------------------------------------------ mLSTM --
class MLSTM(nn.Module):
    """q, k, v and output-gate projections (d, d_in) and ``w_o`` (d_in, d)
    in the model's type; the input and forget gates ``w_i``, ``w_f``
    (d, H) and ``f_bias`` (H,) in float32."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, H, dt = cfg.d_model, cfg.n_heads, model_dtype(cfg)
        d_in = cfg.xlstm_expand * d
        f32 = torch.float32
        self.w_q = _param((d, d_in), dt, device)
        self.w_k = _param((d, d_in), dt, device)
        self.w_v = _param((d, d_in), dt, device)
        self.w_i = _param((d, H), f32, device)
        self.w_f = _param((d, H), f32, device)
        self.f_bias = _param((H,), f32, device)
        self.w_gate = _param((d, d_in), dt, device)
        self.out_norm = RMSNorm(d_in, dt, device)
        self.w_o = _param((d_in, d), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.w_q, self.w_k, self.w_v, self.w_i, self.w_f,
                  self.w_gate, self.w_o):
            dense_fill_(w, gen)
        self.f_bias.fill_(3.0)                 # open forget gates


def _mlstm_chunked(q: Tensor, k: Tensor, v: Tensor, log_f: Tensor,
                   log_i: Tensor, chunk: int) -> Tensor:
    """Stabilised chunked mLSTM.  q, k, v: (B, T, H, P); log_f, log_i:
    (B, T, H) float32; T a multiple of the chunk (or shorter than it).

    Within a chunk, with lc_t the cumulative log forget gate, g_s = log_i_s
    - lc_s and the carried stabiliser m_in (relative to the chunk's start),
    Mx_t = max(m_in, max_{s<=t} g_s) and

        y_t   = e^{m_in-Mx_t} q_t·S_in + sum_{s<=t} e^{g_s-Mx_t} (q_t·k_s/√P) v_s
        den_t = the same with z_in and k_s,   h_t = y_t / max(|den_t|, 1):

    every exponent is <= 0.  The carry (S, z, m) advances with the chunk's
    last stabiliser and is re-based to the next chunk's start."""
    B, T, H, P = q.shape
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"mLSTM: T = {T} is not a multiple of the chunk "
                         f"{Q}")
    dt = q.dtype
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    inv_sqrt_p = 1.0 / math.sqrt(P)
    S = torch.zeros((B, H, P, P), dtype=dt, device=q.device)
    z = torch.zeros((B, H, P), dtype=dt, device=q.device)
    m = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    hs = []
    for c0 in range(0, T, Q):
        qb, kb, vb = q[:, c0:c0 + Q], k[:, c0:c0 + Q], v[:, c0:c0 + Q]
        lc = torch.cumsum(log_f[:, c0:c0 + Q], dim=1)        # (B, Q, H)
        g = log_i[:, c0:c0 + Q] - lc
        Mx = torch.maximum(torch.cummax(g, dim=1).values, m[:, None, :])

        # Intra-chunk: D[t, s] = exp(g_s - Mx_t) on the causal triangle.
        dlog = g[:, None, :, :] - Mx[:, :, None, :]           # (B,Q,Q,H)
        D = torch.where(causal, torch.exp(dlog), 0.0)
        scores = torch.einsum("bqhp,bshp->bqsh", qb, kb).float()
        M = scores * inv_sqrt_p * D
        y = torch.einsum("bqsh,bshp->bqhp", M.to(dt), vb)
        den = M.sum(dim=2)                                    # (B, Q, H)

        # The carried state's contribution.
        cw = torch.exp(m[:, None, :] - Mx)                    # <= 1
        qw = qb * inv_sqrt_p * cw[..., None].to(dt)
        y = y + torch.einsum("bqhp,bhpn->bqhn", qw, S)
        den = den + torch.einsum("bqhp,bhp->bqh", qw, z).float()

        # Advance the carry with the chunk's last stabiliser.
        Mx_end = Mx[:, -1, :]                                 # (B, H)
        wk = torch.exp(g - Mx_end[:, None, :])[..., None].to(dt) * kb
        decay = torch.exp(m - Mx_end)
        S = (decay[..., None, None].to(dt) * S
             + torch.einsum("bshp,bshn->bhpn", wk, vb))
        z = decay[..., None].to(dt) * z + wk.sum(dim=1)
        hs.append(y / torch.clamp(den.abs(), min=1.0)[..., None].to(dt))
        # Re-base: m_in' = Mx_end + the chunk's summed log forget gate.
        m = Mx_end + lc[:, -1, :]
    return torch.cat(hs, dim=1).reshape(B, T, H * P)


def _gates(p: MLSTM, x: Tensor) -> tuple[Tensor, Tensor]:
    """(log_i, log_f) in float32."""
    x32 = x.float()
    return x32 @ p.w_i, F.logsigmoid(x32 @ p.w_f + p.f_bias)


def mlstm_apply(p: MLSTM, cfg: ArchConfig, x: Tensor) -> Tensor:
    B, T, d = x.shape
    H = cfg.n_heads
    P = cfg.xlstm_expand * d // H
    q = (x @ p.w_q).reshape(B, T, H, P)
    k = (x @ p.w_k).reshape(B, T, H, P)
    v = (x @ p.w_v).reshape(B, T, H, P)
    log_i, log_f = _gates(p, x)
    y = _mlstm_chunked(q, k, v, log_f, log_i, cfg.ssm_chunk)
    y = rmsnorm_apply(p.out_norm, y) * F.silu(x @ p.w_gate)
    return y @ p.w_o


def mlstm_cache_init(cfg: ArchConfig, batch: int, device=None) -> dict:
    H = cfg.n_heads
    P = cfg.xlstm_expand * cfg.d_model // H
    dt = model_dtype(cfg)
    return {"S": torch.zeros((batch, H, P, P), dtype=dt, device=device),
            "z": torch.zeros((batch, H, P), dtype=dt, device=device),
            "m": torch.zeros((batch, H), dtype=torch.float32,
                             device=device)}


def mlstm_decode(p: MLSTM, cfg: ArchConfig, x: Tensor, cache: dict
                 ) -> tuple[Tensor, dict]:
    """One-token recurrent step; x: (B, 1, d).  Returns the output and a
    new cache."""
    B, _, d = x.shape
    H = cfg.n_heads
    d_in = cfg.xlstm_expand * d
    P = d_in // H
    xt = x[:, 0]
    sqrt_p = torch.tensor(math.sqrt(P), dtype=x.dtype, device=x.device)
    q = (xt @ p.w_q).reshape(B, H, P) / sqrt_p
    k = (xt @ p.w_k).reshape(B, H, P)
    v = (xt @ p.w_v).reshape(B, H, P)
    log_i, log_f = _gates(p, xt)

    m_new = torch.maximum(log_f + cache["m"], log_i)
    wf = torch.exp(log_f + cache["m"] - m_new).to(x.dtype)
    wi = torch.exp(log_i - m_new).to(x.dtype)
    S = (wf[..., None, None] * cache["S"]
         + wi[..., None, None] * torch.einsum("bhp,bhn->bhpn", k, v))
    z = wf[..., None] * cache["z"] + wi[..., None] * k
    num = torch.einsum("bhp,bhpn->bhn", q, S)
    den = torch.clamp(torch.einsum("bhp,bhp->bh", q, z).abs(), min=1.0)
    y = (num / den[..., None]).reshape(B, d_in)
    y = rmsnorm_apply(p.out_norm, y) * F.silu(xt @ p.w_gate)
    return (y @ p.w_o)[:, None, :], {"S": S, "z": z, "m": m_new}


# ------------------------------------------------------------------ sLSTM --
class SLSTM(nn.Module):
    """The input and recurrent projections ``w_in``, ``r_in`` (d, 4d) of
    the gates i, f, z, o, their ``bias`` (4d,) in float32, and ``w_o``
    (d, d)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, model_dtype(cfg)
        self.w_in = _param((d, 4 * d), dt, device)
        self.r_in = _param((d, 4 * d), dt, device)
        self.bias = _param((4 * d,), torch.float32, device)
        self.out_norm = RMSNorm(d, dt, device)
        self.w_o = _param((d, d), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        dense_fill_(self.w_in, gen)
        dense_fill_(self.r_in, gen, scale=0.5)
        self.bias.zero_()
        dense_fill_(self.w_o, gen)


def _slstm_cell(p: SLSTM, gx_t: Tensor, h_dtype, state: tuple) -> tuple:
    """One sLSTM step with exponential gating and its stabiliser (the
    paper's eqs. 13-20); ``gx_t`` is the hoisted input projection x_t W."""
    c, n, m, h = state
    gates = (gx_t + h @ p.r_in).float() + p.bias
    i_, f_, z_, o_ = torch.chunk(gates, 4, dim=-1)
    m_new = torch.maximum(f_ + m, i_)
    i_s = torch.exp(i_ - m_new)
    f_s = torch.exp(f_ + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z_)
    n_new = f_s * n + i_s
    h_new = (torch.sigmoid(o_) * c_new / torch.clamp(n_new, min=1.0)
             ).to(h_dtype)
    return c_new, n_new, m_new, h_new


def slstm_apply(p: SLSTM, cfg: ArchConfig, x: Tensor) -> Tensor:
    B, T, d = x.shape
    gx = x @ p.w_in                      # all T tokens' input projection
    zeros = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    state = (zeros, zeros, zeros, zeros.to(x.dtype))
    hs = []
    for t in range(T):
        state = _slstm_cell(p, gx[:, t], x.dtype, state)
        hs.append(state[3])
    return rmsnorm_apply(p.out_norm, torch.stack(hs, dim=1)) @ p.w_o


def slstm_cache_init(cfg: ArchConfig, batch: int, device=None) -> dict:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "m": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), dtype=model_dtype(cfg),
                             device=device)}


def slstm_decode(p: SLSTM, cfg: ArchConfig, x: Tensor, cache: dict
                 ) -> tuple[Tensor, dict]:
    """One-token recurrent step; x: (B, 1, d).  Returns the output and a
    new cache."""
    state = (cache["c"], cache["n"], cache["m"], cache["h"])
    c, n, m, h = _slstm_cell(p, x[:, 0] @ p.w_in, x.dtype, state)
    y = rmsnorm_apply(p.out_norm, h[:, None, :]) @ p.w_o
    return y, {"c": c, "n": n, "m": m, "h": h}
