"""Wrappers for the eigenvector rotation and projection kernels.

The tensor's device picks the route: a CPU tensor runs the plain version
in ``ref.py``; a CUDA tensor launches the kernel of
``csrc/eigvec_rotate.cu`` / ``csrc/eigvec_project.cu`` or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.eigvec_update.ref import (eigvec_project_ref,
                                                   eigvec_rotate_ref)

Tensor = torch.Tensor

ROTATE_TILE = 64    # output tile of eigvec_rotate: its pruning granule
PROJECT_SLAB = 32   # columns of U per eigvec_project block
NPROJ = 8           # most columns eigvec_project takes


def rotate_vectors(u: Tensor, zhat: Tensor, d: Tensor, lam: Tensor,
                   inv: Tensor, num_active=None) -> Tensor:
    """C = U @ (zhat[:,None] / (d[:,None] - lam[None,:])) * inv, with the
    denominators formed in float64 and eps-guarded (``ref.eigvec_rotate_ref``
    says why).

    On the card the factor is generated tile by tile and never stored;
    with ``num_active`` = m the reduction stops at row m of the factor and
    output tiles beyond ceil(m/64) are written as exact zeros (the caller
    overwrites inactive columns; pruned rows of active columns are zero by
    the padding contract).
    """
    if u.device.type == "cpu":
        return eigvec_rotate_ref(u, zhat, d, lam, inv)
    dtype = cuda.check_operands("eigvec_rotate", u, zhat, inv)
    eps = torch.finfo(d.dtype).eps   # the guard of ref.eigvec_rotate_ref
    d = d.to(torch.float64)          # denominators in float64: see ref.py
    lam = lam.to(torch.float64)
    cuda.check_operands("eigvec_rotate", d, lam)
    n = u.shape[0]
    if u.shape != (n, n) or any(v.shape != (n,) for v in (zhat, d, lam, inv)):
        raise ValueError(f"eigvec_rotate: need u (n, n) and four (n,) "
                         f"vectors, got {u.shape}")
    m = cuda.active_count(n if num_active is None else num_active, u.device)
    out = torch.empty_like(u)
    cuda.launch("eigvec_rotate", dtype, u, zhat, d, lam, inv, m, out, n,
                eps)
    return out


def project_vectors(u: Tensor, v: Tensor, num_active=None) -> Tensor:
    """P = Uᵀ V with rows of V at or beyond ``num_active`` masked: the
    projection of Algorithm 2's second ±sigma pair, one read of U.  Output
    rows beyond the active slabs are exact zeros (their true value)."""
    if u.device.type == "cpu":
        return eigvec_project_ref(u, v, num_active)
    dtype = cuda.check_operands("eigvec_project", u, v)
    n = u.shape[0]
    if u.shape != (n, n) or v.dim() != 2 or v.shape[0] != n:
        raise ValueError(f"eigvec_project: need u (n, n), v (n, C), got "
                         f"{u.shape} and {v.shape}")
    ncol = v.shape[1]
    if not 1 <= ncol <= NPROJ:
        raise ValueError(f"eigvec_project takes 1..{NPROJ} columns, "
                         f"got {ncol}")
    m = cuda.active_count(n if num_active is None else num_active, u.device)
    out = torch.empty((n, ncol), dtype=dtype, device=u.device)
    cuda.launch("eigvec_project", dtype, u, v, m, out, n, ncol)
    return out
