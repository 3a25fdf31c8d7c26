"""Wrappers for the RBF gram kernel and the fused kernel-row + projection
kernel (the ingest prologue): a CPU tensor runs ``ref.rbf_gram_ref`` /
``ref.krow_project_ref``, a CUDA tensor launches ``csrc/rbf_gram.cu`` /
``csrc/krow_project.cu`` or raises."""
from __future__ import annotations

import torch

from repro_torch.core import kernels_fn as kf
from repro_torch.kernels import cuda
from repro_torch.kernels.rbf_gram.ref import krow_project_ref, rbf_gram_ref

Tensor = torch.Tensor

# Kernels the fused CUDA epilogues implement, with their code in csrc.
FUSED_KERNELS = {"rbf": 0, "matern32": 1}
NAUX = 8            # projected columns: the kernel row + up to 7 aux


def fused_kind(spec: kf.KernelSpec, name: str) -> int:
    """The epilogue code of ``spec`` for a fused CUDA kernel; raises for a
    kernel the epilogues do not implement."""
    if spec.name not in FUSED_KERNELS:
        raise ValueError(f"{name}: the fused CUDA kernel implements "
                         f"{sorted(FUSED_KERNELS)}, not {spec.name!r}")
    return FUSED_KERNELS[spec.name]


def gram(x: Tensor, y: Tensor, sigma) -> Tensor:
    """G = exp(-|x_i - y_j|²/sigma) for x (n, d) and y (m, d) by the norm
    expansion, the norms and the exp epilogue in the same kernel; sums in
    the operands' type (float64 for f64)."""
    if x.device.type == "cpu":
        return rbf_gram_ref(x, y, sigma)
    dtype = cuda.check_operands("rbf_gram", x, y)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"rbf_gram: need x (n, d) and y (m, d), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    n, dim = x.shape
    m = y.shape[0]
    out = torch.empty((n, m), dtype=dtype, device=x.device)
    cuda.launch("rbf_gram", dtype, x, y, out, n, m, dim, float(sigma))
    return out


def krow_project(u: Tensor, x: Tensor, x_new: Tensor, aux: Tensor,
                 num_active, *, spec: kf.KernelSpec
                 ) -> tuple[Tensor, Tensor]:
    """(a, P): the masked kernel row a = k(X, x_new)·[row < m] and
    P = Uᵀ[a | aux·[row < m]] in one pass over U.  u (n, n), x (n, d),
    x_new (d,), aux (n, naux) with naux <= 7; P is (n, 1 + naux)."""
    if u.device.type == "cpu":
        return krow_project_ref(u, x, x_new, aux, num_active, spec=spec)
    kind = fused_kind(spec, "krow_project")
    dtype = cuda.check_operands("krow_project", u, x, x_new, aux)
    n = u.shape[0]
    dim = x.shape[1]
    naux = aux.shape[1]
    if (u.shape != (n, n) or x.shape != (n, dim) or x_new.shape != (dim,)
            or aux.shape != (n, naux)):
        raise ValueError(f"krow_project: shapes u {u.shape}, x {x.shape}, "
                         f"x_new {x_new.shape}, aux {aux.shape}")
    if naux + 1 > NAUX:
        raise ValueError(f"krow_project: at most {NAUX - 1} aux columns, "
                         f"got {naux}")
    m = cuda.active_count(num_active, u.device)
    a = torch.empty((n,), dtype=dtype, device=u.device)
    P = torch.empty((n, 1 + naux), dtype=dtype, device=u.device)
    cuda.launch("krow_project", dtype, u, x, x_new, aux, m, a, P, n, dim,
                naux, kind, float(spec.sigma), float(spec.scale))
    return a, P
