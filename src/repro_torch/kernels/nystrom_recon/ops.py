"""Wrapper for the fused batched-transform kernel: a CPU tensor runs
``ref.transform_project_ref``, a CUDA tensor launches
``csrc/transform_project.cu`` or raises."""
from __future__ import annotations

import torch

from repro_torch.core import kernels_fn as kf
from repro_torch.kernels import cuda
from repro_torch.kernels.nystrom_recon.ref import transform_project_ref
from repro_torch.kernels.rbf_gram.ops import fused_kind

Tensor = torch.Tensor

NCOMP = 8           # most projection columns transform_project takes


def transform_project(xq: Tensor, x: Tensor, s: Tensor, num_active, *,
                      spec: kf.KernelSpec) -> tuple[Tensor, Tensor]:
    """(Y, rowsum): Y = Kq_masked @ s and rowsum = Kq_masked @ 1 for a
    query batch xq (Q, d) against stored points x (n, d) and a projection
    s (n, C <= 8); the query gram is never stored."""
    if s.device.type == "cpu":
        return transform_project_ref(xq, x, s, num_active, spec=spec)
    kind = fused_kind(spec, "transform_project")
    xq = xq.to(s.dtype).contiguous()
    x = x.to(s.dtype)
    dtype = cuda.check_operands("transform_project", s, xq, x)
    n, ncomp = s.shape
    nq, dim = xq.shape
    if x.shape != (n, dim):
        raise ValueError(f"transform_project: shapes xq {xq.shape}, "
                         f"x {x.shape}, s {s.shape}")
    if not 1 <= ncomp <= NCOMP:
        raise ValueError(f"transform_project takes 1..{NCOMP} components, "
                         f"got {ncomp}")
    m = cuda.active_count(num_active, s.device)
    y = torch.empty((nq, ncomp), dtype=dtype, device=s.device)
    rs = torch.empty((nq,), dtype=dtype, device=s.device)
    cuda.launch("transform_project", dtype, xq, x, s, m, y, rs, nq, n, dim,
                ncomp, kind, float(spec.sigma), float(spec.scale))
    return y, rs
