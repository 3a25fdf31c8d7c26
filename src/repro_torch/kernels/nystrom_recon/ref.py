"""Plain PyTorch versions of the Nyström reconstruction and the fused
query-gram + projection kernels."""
from __future__ import annotations

import torch

from repro_torch.core import kernels_fn as kf
from repro_torch.kernels import tenantwise

Tensor = torch.Tensor


def scaled_gram_ref(b: Tensor, s: Tensor) -> Tensor:
    """K̃ = B diag(s) Bᵀ with the scaled copy of B materialized."""
    return (b * s[None, :]) @ b.T


def transform_project_ref(xq: Tensor, x: Tensor, s: Tensor, num_active, *,
                          spec: kf.KernelSpec) -> tuple[Tensor, Tensor]:
    """(Y, rowsum) = (Kq_masked @ s, Kq_masked @ 1), with the masked query
    gram Kq[i, j] = k(xq[i], x[j])·[j < m] materialized.  Takes the
    kernel's optional leading tenant axis (counts (B,)), tenant by tenant
    (``tenantwise``)."""
    if s.dim() == 3:
        return tenantwise(transform_project_ref, xq, x, s, num_active,
                          spec=spec)
    dtype = s.dtype
    kq = kf.gram_block(xq.to(dtype), x.to(dtype), spec=spec)
    live = torch.arange(x.shape[-2], device=x.device) < torch.as_tensor(
        num_active, device=x.device)[..., None]
    kq = torch.where(live[..., None, :], kq, 0.0)
    return kq @ s, torch.sum(kq, dim=-1)
