"""Plain PyTorch versions of the RBF gram and the fused kernel-row +
projection kernels."""
from __future__ import annotations

import torch

from repro_torch.core import kernels_fn as kf

Tensor = torch.Tensor


def rbf_gram_ref(x: Tensor, y: Tensor, sigma) -> Tensor:
    """G = exp(-max(|x_i|² + |y_j|² - 2 x_i·y_j, 0) / sigma) for x (n, d)
    and y (m, d), summed in the operands' type; no output scale, like the
    kernel it stands beside."""
    xn = torch.sum(x * x, dim=-1)[:, None]
    yn = torch.sum(y * y, dim=-1)[None, :]
    d2 = torch.clamp_min(xn + yn - 2.0 * (x @ y.T), 0.0)
    return torch.exp(-d2 / sigma)


def krow_project_ref(u: Tensor, x: Tensor, x_new: Tensor, aux: Tensor,
                     num_active, row_offset=None, *,
                     spec: kf.KernelSpec) -> tuple[Tensor, Tensor]:
    """(a, P): a = k(x, x_new) zeroed on global rows >= num_active, and
    P = uᵀ [a | aux masked the same way] — through ``gram_block``, so the
    masked row is the unfused ``engine.masked_row`` value."""
    dtype = u.dtype
    r0 = 0 if row_offset is None else row_offset
    rows = r0 + torch.arange(u.shape[0], device=u.device)
    live = rows < torch.as_tensor(num_active, device=u.device)
    kr = kf.gram_block(x.to(dtype), x_new.to(dtype)[None, :],
                       spec=spec)[:, 0]
    a = torch.where(live, kr, 0.0)
    auxm = torch.where(live[:, None], aux.to(dtype), 0.0)
    v = torch.cat([a[:, None], auxm], dim=1)
    return a, u.T @ v
