"""Selective SSM block (Mamba) in the SSD (Mamba-2) chunked form — the
counterpart of the reference's ``models/ssm.py``.

Prefill: the chunked parallel form.  The intra-chunk term of every chunk
comes from one launch of the ``ssd_intra_chunk`` CUDA kernel
(``kernels/ssd_chunk``); the inter-chunk recurrence over the T/Q chunk
states is a Python loop in PyTorch.  Decode: the O(1) recurrent update per
token.

Shapes: d_in = expand · d_model; heads H = d_in / head_dim (P); state N.
Scalar-per-head decay a_t = exp(dt_t · A) (A < 0), shared B_t, C_t (N,).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (RMSNorm, _param, dense_fill_,
                                       model_dtype, rmsnorm_apply)

Tensor = torch.Tensor


class Mamba(nn.Module):
    """Parameters of one Mamba block; ``dt_bias``, ``a_log`` and ``d_skip``
    are float32 whatever the model's type, as in the reference."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        H = d_in // cfg.ssm_head_dim
        N = cfg.ssm_d_state
        dt, f32 = model_dtype(cfg), torch.float32
        self.in_proj = _param((d, 2 * d_in), dt, device)
        self.conv_w = _param((cfg.ssm_conv, d_in), dt, device)
        self.bc_proj = _param((d_in, 2 * N), dt, device)
        self.dt_proj = _param((d_in, H), dt, device)
        self.dt_bias = _param((H,), f32, device)
        self.a_log = _param((H,), f32, device)
        self.d_skip = _param((H,), f32, device)
        self.out_norm = RMSNorm(d_in, dt, device)
        self.out_proj = _param((d_in, d), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.in_proj, self.bc_proj, self.dt_proj, self.out_proj):
            dense_fill_(w, gen)
        z = torch.randn(self.conv_w.shape, generator=gen,
                        device=self.conv_w.device)
        self.conv_w.copy_(z * 0.1)
        H = self.a_log.shape[0]
        self.dt_bias.zero_()
        self.a_log.copy_(torch.log(torch.arange(
            1, H + 1, dtype=torch.float32, device=self.a_log.device) / H
            + 0.5))
        self.d_skip.fill_(1.0)


def _causal_conv(x: Tensor, w: Tensor) -> Tensor:
    """Depthwise causal conv over time as the reference's shifted sum;
    x: (B, T, C), w: (K, C)."""
    K, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:T, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + pad[:, i:i + T, :] * w[i][None, None, :]
    return out


def _ssd_scan(xh: Tensor, a_log: Tensor, B: Tensor, C: Tensor, chunk: int
              ) -> Tensor:
    """Chunked SSD: xh (B, T, H, P) pre-scaled by dt; a_log (B, T, H)
    float32 log decay; B, C: (B, T, N).  Returns (B, T, H, P).

    The intra-chunk term of all B·T/Q chunks is one ``ssd_intra_chunk``
    call; the chunk state S (B, H, N, P) then runs through the chunks in
    order, adding each chunk's inter-chunk term C_t exp(cum_t) S_prev."""
    Bb, T, H, P = xh.shape
    N = B.shape[-1]
    Q = min(chunk, T)
    nc = T // Q
    dt = xh.dtype
    cum = torch.cumsum(a_log.reshape(Bb, nc, Q, H), dim=2)     # float32
    xc = xh.reshape(Bb, nc, Q, H, P)
    Bc = B.reshape(Bb, nc, Q, N)
    Cc = C.reshape(Bb, nc, Q, N)
    y = ssd_ops.intra_chunk(Cc.reshape(Bb * nc, Q, N).contiguous(),
                            Bc.reshape(Bb * nc, Q, N).contiguous(),
                            xc.reshape(Bb * nc, Q, H, P).contiguous(),
                            cum.reshape(Bb * nc, Q, H).contiguous()
                            ).reshape(Bb, nc, Q, H, P)

    S = torch.zeros((Bb, H, N, P), dtype=dt, device=xh.device)
    ys = []
    for i in range(nc):
        cum_i, total = cum[:, i], cum[:, i, -1, :]              # (B,Q,H), (B,H)
        # Inter-chunk: y_t += exp(cum_t) C_t^T S_prev.
        w_in = torch.exp(cum_i).to(dt)
        inter = torch.einsum("bqn,bhnp->bqhp", Cc[:, i], S)
        ys.append(y[:, i] + w_in[..., None] * inter)
        # Advance the chunk state.
        w_end = torch.exp(total[:, None, :] - cum_i).to(dt)
        S = (torch.exp(total)[..., None, None].to(dt) * S
             + torch.einsum("bqn,bqhp->bhnp", Bc[:, i],
                            w_end[..., None] * xc[:, i]))
    return torch.stack(ys, dim=1).reshape(Bb, T, H, P)


def mamba_apply(p: Mamba, cfg: ArchConfig, x: Tensor) -> Tensor:
    Bb, T, d = x.shape
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim

    xs, z = torch.chunk(x @ p.in_proj, 2, dim=-1)
    xs = F.silu(_causal_conv(xs, p.conv_w))

    Bm, Cm = torch.chunk(xs @ p.bc_proj, 2, dim=-1)             # (B,T,N)
    dt_raw = xs @ p.dt_proj + p.dt_bias.to(xs.dtype)
    dt = F.softplus(dt_raw.float())                             # (B,T,H)
    A = -torch.exp(p.a_log)                                     # (H,) < 0
    a_log_step = dt * A[None, None, :]                          # log decay

    xh = xs.reshape(Bb, T, H, P)
    xh_dt = xh * dt[..., None].to(xh.dtype)
    y = _ssd_scan(xh_dt, a_log_step, Bm, Cm, cfg.ssm_chunk)
    y = y + xh * p.d_skip.to(xh.dtype)[None, None, :, None]
    y = y.reshape(Bb, T, d_in)
    y = rmsnorm_apply(p.out_norm, y) * F.silu(z)
    return y @ p.out_proj


# -------------------------------------------------------------- decoding --
def mamba_cache_init(cfg: ArchConfig, batch: int, device=None) -> dict:
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    dt = model_dtype(cfg)
    return {
        "S": torch.zeros((batch, H, cfg.ssm_d_state, cfg.ssm_head_dim),
                         dtype=dt, device=device),
        "conv_buf": torch.zeros((batch, cfg.ssm_conv - 1, d_in), dtype=dt,
                                device=device),
    }


def mamba_decode(p: Mamba, cfg: ArchConfig, x: Tensor, cache: dict
                 ) -> tuple[Tensor, dict]:
    """One-token recurrent step; x: (B, 1, d).  Returns the output and a
    new cache (the old one is not modified)."""
    Bb, _, d = x.shape
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim

    xs, z = torch.chunk(x[:, 0] @ p.in_proj, 2, dim=-1)         # (B, d_in)
    window = torch.cat([cache["conv_buf"], xs[:, None, :]], dim=1)
    xs_c = F.silu(torch.einsum("bkc,kc->bc", window, p.conv_w))

    Bm, Cm = torch.chunk(xs_c @ p.bc_proj, 2, dim=-1)           # (B, N)
    dt = F.softplus((xs_c @ p.dt_proj
                     + p.dt_bias.to(xs_c.dtype)).float())
    A = -torch.exp(p.a_log)
    decay = torch.exp(dt * A[None, :])                          # (B, H)

    xh = xs_c.reshape(Bb, H, P) * dt[..., None].to(xs_c.dtype)
    S = (decay[..., None, None].to(cache["S"].dtype) * cache["S"]
         + torch.einsum("bn,bhp->bhnp", Bm, xh))
    y = torch.einsum("bn,bhnp->bhp", Cm, S)
    y = y + xs_c.reshape(Bb, H, P) * p.d_skip.to(xs_c.dtype)[None, :, None]
    y = y.reshape(Bb, d_in)
    y = rmsnorm_apply(p.out_norm, y) * F.silu(z)
    return (y @ p.out_proj)[:, None, :], {"S": S, "conv_buf": window[:, 1:]}
