"""Plain PyTorch versions of the SSD intra-chunk kernel and its backward."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _sum_type(x: Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _decay(cum: Tensor) -> Tensor:
    """D[g, t, s, h] = exp(cum_t[h] - cum_s[h]) for s <= t, else 0, in
    cum's type (G, Q, Q, H); the exponent is selected to 0 above the
    diagonal before the exponential (cum falls with t, so exp(cum_t -
    cum_s) overflows there, and a mask multiplied in afterwards would give
    inf·0 = NaN)."""
    Q = cum.shape[1]
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=cum.device).tril()[None, :, :, None]
    ldiff = cum[:, :, None, :] - cum[:, None, :, :]          # (G, Q, Q, H)
    return torch.where(causal, torch.exp(torch.where(causal, ldiff, 0.0)),
                       0.0)


def ssd_intra_chunk_ref(c: Tensor, b: Tensor, x: Tensor, cum: Tensor
                        ) -> Tensor:
    """y[g, t, h] = Σ_{s<=t} (c_t·b_s) exp(cum_t[h] - cum_s[h]) x[g, s, h]
    for c, b (G, Q, N), x (G, Q, H, P) and cum (G, Q, H) float32; returns
    (G, Q, H, P) in x's type.

    Numerics of the kernel it stands beside: scores summed in float32, the
    decay's exponent selected to 0 above the diagonal before the
    exponential (cum falls with t, so exp(cum_t - cum_s) overflows for
    s > t) and the product zeroed there, m = scores·decay cast to x's
    type, y summed in float32.  float64 operands (the CPU's tests only;
    the kernel takes float32 and bfloat16) are summed in float64."""
    f = _sum_type(x)
    scores = torch.einsum("gqn,gsn->gqs", c.to(f), b.to(f))
    m = (scores[..., None] * _decay(cum)).to(x.dtype).to(f)
    return torch.einsum("gqsh,gshp->gqhp", m, x.to(f)).to(x.dtype)


def ssd_intra_chunk_bwd_ref(c: Tensor, b: Tensor, x: Tensor, cum: Tensor,
                            dy: Tensor
                            ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(dc, db, dx, dcum), the gradients of ``ssd_intra_chunk_ref`` for the
    output's gradient dy (G, Q, H, P) in x's type, in explicit formulas.
    Per chunk and head h, with S = C Bᵀ, D_h the decay (0 above the
    diagonal) and M_h = S ∘ D_h:
      - dx_h = m_hᵀ dy_h, m_h = M_h rounded to x's type (as the forward
        applies it);
      - dM_h = (dy_h x_hᵀ) masked to s <= t and rounded to x's type (the
        gradient through the forward's cast of m);
      - dS = Σ_h dM_h ∘ D_h over all heads; dc = dS B, db = dSᵀ C;
      - Z_h = dM_h ∘ M_h, dcum[t, h] = Σ_s Z_h[t, s] - Σ_t' Z_h[t', t].
    Every sum in float32 (float64 for float64 operands); dc, db and dx
    rounded once to their operand's type, dcum in cum's type.  These are
    the points where autograd of the plain forward rounds, so the two
    differ only by the order of their sums."""
    Q = c.shape[1]
    f = _sum_type(x)
    cf, bf, xf, dyf = c.to(f), b.to(f), x.to(f), dy.to(f)
    D = _decay(cum).to(f)
    M = torch.einsum("gtn,gsn->gts", cf, bf)[..., None] * D
    m = M.to(x.dtype).to(f)
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=c.device).tril()[None, :, :, None]
    dM = torch.where(causal, torch.einsum("gthp,gshp->gtsh", dyf, xf), 0.0
                     ).to(x.dtype).to(f)
    dx = torch.einsum("gtsh,gthp->gshp", m, dyf).to(x.dtype)
    dS = (dM * D).sum(-1)
    dc = torch.einsum("gts,gsn->gtn", dS, bf).to(c.dtype)
    db = torch.einsum("gts,gtn->gsn", dS, cf).to(b.dtype)
    Z = dM * M
    dcum = (Z.sum(2) - Z.sum(1)).to(cum.dtype)
    return dc, db, dx, dcum
