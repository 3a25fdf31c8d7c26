"""Plain PyTorch version of the fused kernel-row + projection kernel."""
from __future__ import annotations

import torch

from repro_torch.core import kernels_fn as kf

Tensor = torch.Tensor


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
