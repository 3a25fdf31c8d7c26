"""Wrappers for the eigenvector rotation and projection kernels.

The tensor's device picks the route: a CPU tensor runs the plain version
in ``ref.py``; a CUDA tensor launches the kernel of
``csrc/eigvec_rotate.cu`` / ``csrc/eigvec_rotate2.cu`` /
``csrc/eigvec_project.cu`` or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.eigvec_update.ref import (eigvec_project_ref,
                                                   eigvec_rotate2_ref,
                                                   eigvec_rotate_ref,
                                                   offset_guard)

Tensor = torch.Tensor

ROTATE_TILE = 64    # output tile of eigvec_rotate: its pruning granule
PROJECT_SLAB = 32   # columns of U per eigvec_project block
NPROJ = 8           # most columns eigvec_project takes
ROTATE2_TILE = 64   # output tile of eigvec_rotate2: its pruning granule


def rotate_vectors(u: Tensor, zhat: Tensor, d: Tensor, lam: Tensor,
                   inv: Tensor, num_active=None, *, tau: Tensor) -> Tensor:
    """C = U @ (zhat[:,None] / ((d[:,None] - lam[None,:]) - tau)) * inv,
    with the denominators formed in float64 and guarded
    (``ref.eigvec_rotate_ref`` says why).

    On the card the factor is generated tile by tile and never stored;
    with ``num_active`` = m the reduction stops at row m of the factor and
    output tiles beyond ceil(m/64) are written as exact zeros (the caller
    overwrites inactive columns; pruned rows of active columns are zero by
    the padding contract).
    """
    if u.device.type == "cpu":
        return eigvec_rotate_ref(u, zhat, d, lam, inv, tau)
    dtype = cuda.check_operands("eigvec_rotate", u, zhat, inv)
    d = d.to(torch.float64)          # denominators in float64: see ref.py
    lam = lam.to(torch.float64)
    tau = tau.to(torch.float64)
    cuda.check_operands("eigvec_rotate", d, lam, tau)
    n = u.shape[0]
    if u.shape != (n, n) or any(v.shape != (n,)
                                for v in (zhat, d, lam, inv, tau)):
        raise ValueError(f"eigvec_rotate: need u (n, n) and five (n,) "
                         f"vectors, got {u.shape}")
    m = cuda.active_count(n if num_active is None else num_active, u.device)
    out = torch.empty_like(u)
    cuda.launch("eigvec_rotate", dtype, u, zhat, d, lam, tau, inv, m, out,
                n, offset_guard(dtype))
    return out


def rotate_vectors2(u: Tensor,
                    z1: Tensor, d1: Tensor, lam1: Tensor, inv1: Tensor,
                    defl1: Tensor, cid1: Tensor,
                    z2: Tensor, d2: Tensor, lam2: Tensor, inv2: Tensor,
                    defl2: Tensor, cid2: Tensor, num_active=None, *,
                    tau1: Tensor, tau2: Tensor) -> Tensor:
    """Fused double rotation C = U @ W1n @ W2n (``ref.eigvec_rotate2_ref``):
    each factor W[k, j] = z[k]·inv[j]/((d[k] - lam[j]) - tau[j]), deflated
    columns (defl[j] != 0) the identity column e_{cid[j]}.

    On the card each factor entry is formed once into scratch this
    wrapper allocates (W1n, W2n and W12, three (n, n) matrices), the
    factors are multiplied first, W12 = W1n @ W2n, then C = U @ W12
    (``csrc/eigvec_rotate2.cu`` says why): three launches; U @ W1n never
    exists.  With ``num_active`` = m the reductions stop at m and output
    tiles beyond ceil(m/64) in either axis are written as exact zeros
    (inactive columns inside the active tiles come out 0: the caller
    keeps U's own).
    """
    if u.device.type == "cpu":
        return eigvec_rotate2_ref(u, z1, d1, lam1, inv1, defl1, cid1,
                                  z2, d2, lam2, inv2, defl2, cid2,
                                  tau1=tau1, tau2=tau2)
    dtype = cuda.check_operands("eigvec_rotate2", u, z1, inv1, z2, inv2)
    n = u.shape[0]

    def factor(d, lam, tau, defl, cid):
        d, lam = d.to(torch.float64), lam.to(torch.float64)
        tau = tau.to(torch.float64)
        cuda.check_operands("eigvec_rotate2", d, lam, tau)
        defl = defl.to(dtype).contiguous()
        cuda.check_operands("eigvec_rotate2", u, defl)
        if cid.device != u.device:
            raise ValueError(f"eigvec_rotate2: cid on {cid.device}, u on "
                             f"{u.device}")
        return d, lam, tau, defl, cid.to(torch.int32).contiguous()

    d1, lam1, tau1, defl1, cid1 = factor(d1, lam1, tau1, defl1, cid1)
    d2, lam2, tau2, defl2, cid2 = factor(d2, lam2, tau2, defl2, cid2)
    if u.shape != (n, n) or any(v.shape != (n,) for v in (
            z1, d1, lam1, tau1, inv1, defl1, cid1,
            z2, d2, lam2, tau2, inv2, defl2, cid2)):
        raise ValueError(f"eigvec_rotate2: need u (n, n) and (n,) factor "
                         f"vectors, got {u.shape}")
    m = cuda.active_count(n if num_active is None else num_active, u.device)
    scratch = torch.empty((3, n, n), dtype=dtype, device=u.device)
    out = torch.empty_like(u)
    cuda.launch("eigvec_rotate2", dtype, u, z1, d1, lam1, tau1, inv1, defl1,
                cid1, z2, d2, lam2, tau2, inv2, defl2, cid2, m, scratch, out,
                n, offset_guard(dtype))
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
