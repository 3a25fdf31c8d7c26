"""Wrappers for the Nyström reconstruction and the fused batched-transform
kernels: a CPU tensor runs ``ref.scaled_gram_ref`` /
``ref.transform_project_ref``, a CUDA tensor launches
``csrc/scaled_gram.cu`` / ``csrc/transform_project.cu`` or raises."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import kernels_fn as kf
from repro_torch.kernels import cuda
from repro_torch.kernels.nystrom_recon.ref import (scaled_gram_ref,
                                                   transform_project_ref)
from repro_torch.kernels.rbf_gram.ops import fused_kind

Tensor = torch.Tensor

NCOMP = 8           # most projection columns transform_project takes
GRAM_SLAB = 32      # float32 scaled_gram: width of a TF32 plane's k slab


def scaled_gram(b: Tensor, s: Tensor) -> Tensor:
    """K̃ = B diag(s) Bᵀ for B (n, k) and s (k,): one triangle computed, the
    other mirrored (K̃ equals its transpose exactly), the scale applied to
    the left operand as it is read, so the scaled copy of B is never
    stored.  float32 runs three TF32 products on the tensor cores (B's
    TF32 head and tail planes in scratch); float64 runs DMMA."""
    if b.device.type == "cpu":
        return scaled_gram_ref(b, s)
    s = s.to(b.dtype)
    dtype = cuda.check_operands("scaled_gram", b, s)
    if b.dim() != 2 or s.shape != (b.shape[1],):
        raise ValueError(f"scaled_gram: need b (n, k) and s (k,), got "
                         f"{b.shape} and {s.shape}")
    n, k = b.shape
    out = torch.empty((n, n), dtype=dtype, device=b.device)
    if dtype == torch.float32:
        # TMA reads B's rows: 16-byte row strides and base.  Zero columns
        # (and zero scales) add nothing to K̃.
        kp = -(-k // 4) * 4
        if kp != k:
            b, s = F.pad(b, (0, kp - k)), F.pad(s, (0, kp - k))
        b, s = (x.clone() if x.data_ptr() % 16 else x for x in (b, s))
        k = kp
        scratch = torch.empty(2 * n * -(-k // GRAM_SLAB) * GRAM_SLAB,
                              dtype=dtype, device=b.device)
    else:
        scratch = b.new_empty(0)
    cuda.launch("scaled_gram", dtype, b, s, scratch, out, n, k)
    return out


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
