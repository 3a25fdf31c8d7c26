"""Plain PyTorch version of the SSD intra-chunk kernel."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def ssd_intra_chunk_ref(c: Tensor, b: Tensor, x: Tensor, cum: Tensor
                        ) -> Tensor:
    """y[g, t, h] = Σ_{s<=t} (c_t·b_s) exp(cum_t[h] - cum_s[h]) x[g, s, h]
    for c, b (G, Q, N), x (G, Q, H, P) and cum (G, Q, H) float32; returns
    (G, Q, H, P) in x's type.

    Numerics of the kernel it stands beside: scores summed in float32, the
    decay's exponent selected to 0 above the diagonal before the
    exponential (cum falls with t, so exp(cum_t - cum_s) overflows for
    s > t) and the product zeroed there, m = scores·decay cast to x's
    type, y summed in float32."""
    G, Q, N = c.shape
    scores = torch.einsum("gqn,gsn->gqs", c.float(), b.float())
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=c.device).tril()[None, :, :, None]
    ldiff = cum[:, :, None, :] - cum[:, None, :, :]          # (G, Q, Q, H)
    decay = torch.where(causal, torch.exp(torch.where(causal, ldiff, 0.0)),
                        0.0)
    m = (scores[..., None] * decay).to(x.dtype).float()
    return torch.einsum("gqsh,gshp->gqhp", m, x.float()).to(x.dtype)
