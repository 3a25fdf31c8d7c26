"""Wrappers for the eigenvector rotation and projection kernels.

The tensor's device picks the route: a CPU tensor runs the plain version
in ``ref.py``; a CUDA tensor launches the kernels of
``csrc/eigvec_rotate.cu`` / ``csrc/eigvec_rotate2.cu`` /
``csrc/eigvec_project.cu`` or raises.

Each takes an optional leading tenant axis: ``u`` (B, R, n) with the
vectors (B, n) and the active counts (B,) is one launch for the B tenants,
tenant b reading its own count by pointer (the reference's kernels under
``jax.vmap``).  Tenant b's result equals the call on its operands alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda
# PROJECT_SLAB, ROTATE_TILE and ROTATE2_TILE, the kernels' pruning
# granules, are the plain versions' too.
from repro_torch.kernels.eigvec_update.ref import (  # noqa: F401
    PROJECT_SLAB, ROTATE2_TILE, ROTATE_TILE, eigvec_project_ref,
    eigvec_rotate2_ref, eigvec_rotate_ref, offset_guard)

Tensor = torch.Tensor

NPROJ = 8           # most columns eigvec_project takes


def tenants(u: Tensor, name: str) -> int | None:
    """B for a (B, R, n) operand, None for an (R, n) one; raises for any
    other rank."""
    if u.dim() not in (2, 3):
        raise ValueError(f"{name}: need u (R, n) or (B, R, n), got "
                         f"{tuple(u.shape)}")
    return u.shape[0] if u.dim() == 3 else None


def counts(num_active, u: Tensor, n: int, nb: int | None) -> Tensor:
    """The active counts the kernel reads: ``num_active``, or n for every
    tenant."""
    if num_active is None:
        num_active = torch.full(u.shape[:-2], n, dtype=torch.int32,
                                device=u.device)
    return cuda.active_count(num_active, u.device, nb)


def rotate_vectors(u: Tensor, zhat: Tensor, d: Tensor, lam: Tensor,
                   inv: Tensor, num_active=None, *, tau: Tensor,
                   row_offset: int | None = None) -> Tensor:
    """C = U @ (zhat[:,None] / ((d[:,None] - lam[None,:]) - tau)) * inv,
    with the denominators formed in float64 and guarded
    (``ref.eigvec_rotate_ref`` says why).

    ``u`` is the (M, M) state or an (R, M) row block whose first row is
    the state's row ``row_offset`` (a host int), optionally with a leading
    tenant axis (module docstring).  With ``num_active`` = m
    the reduction stops at row m of the factor, and output columns at or
    beyond ceil(m/64)·64 and rows at or beyond ceil(clamp(m - row_offset,
    0, R)/64)·64 are written as exact zeros (the caller overwrites
    inactive columns; pruned rows of active columns are zero by the
    padding contract).  On the card each factor entry is formed once into
    scratch this wrapper allocates, then multiplied: float32 as three TF32
    products on the tensor cores, float64 on the CUDA cores
    (``csrc/eigvec_rotate.cu``); two launches.
    """
    if u.device.type == "cpu":
        return eigvec_rotate_ref(u, zhat, d, lam, inv, tau, num_active,
                                 row_offset)
    nb = tenants(u, "eigvec_rotate")
    zhat, inv = zhat.contiguous(), inv.contiguous()
    dtype = cuda.check_operands("eigvec_rotate", u, zhat, inv)
    # Denominators in float64: see ref.py.
    d, lam, tau = (v.to(torch.float64).contiguous() for v in (d, lam, tau))
    cuda.check_operands("eigvec_rotate", d, lam, tau)
    n = u.shape[-1]
    lead = u.shape[:-2]
    if any(v.shape != lead + (n,) for v in (zhat, d, lam, inv, tau)):
        raise ValueError(f"eigvec_rotate: need u (R, n) and five (n,) "
                         f"vectors, each with u's tenant axis, got "
                         f"{tuple(u.shape)}")
    R = u.shape[-2]
    r0 = 0 if row_offset is None else int(row_offset)
    m = counts(num_active, u, n, nb)
    if dtype == torch.float32:
        # TMA reads rows whose stride is a multiple of 16 bytes, from a
        # 16-byte aligned start: otherwise U goes through a padded copy.
        ldu = -(-n // 4) * 4
        if ldu != n or u.data_ptr() % 16:
            u = F.pad(u, (0, ldu - n))
        scratch = torch.empty(lead + (2, n, -(-n // 32) * 32), dtype=dtype,
                              device=u.device)
    else:
        ldu = n
        scratch = torch.empty(lead + (n, n), dtype=dtype, device=u.device)
    out = torch.empty(lead + (R, n), dtype=dtype, device=u.device)
    cuda.launch("eigvec_rotate", dtype, u, zhat, d, lam, tau, inv, m,
                scratch, out, R, n, ldu, r0, nb or 1, offset_guard(dtype))
    return out


def rotate_vectors2(u: Tensor,
                    z1: Tensor, d1: Tensor, lam1: Tensor, inv1: Tensor,
                    defl1: Tensor, cid1: Tensor,
                    z2: Tensor, d2: Tensor, lam2: Tensor, inv2: Tensor,
                    defl2: Tensor, cid2: Tensor, num_active=None, *,
                    tau1: Tensor, tau2: Tensor,
                    row_offset: int | None = None) -> Tensor:
    """Fused double rotation C = U @ W1n @ W2n (``ref.eigvec_rotate2_ref``):
    each factor W[k, j] = z[k]·inv[j]/((d[k] - lam[j]) - tau[j]), deflated
    columns (defl[j] != 0) the identity column e_{cid[j]}.

    ``u`` is the (n, n) state or an (R, n) row block whose first row is
    the state's row ``row_offset`` (a host int), optionally with a leading
    tenant axis (module docstring); C has u's shape.  On the
    card each factor entry is formed once into scratch this wrapper
    allocates (W1n, W2n and W12, three (n, n) matrices), the factors are
    multiplied first, W12 = W1n @ W2n, then C = U @ W12
    (``csrc/eigvec_rotate2.cu`` says why): three launches, the first two
    the same for any rows; U @ W1n never exists.  With ``num_active`` = m
    the reductions stop at m, and output columns at or beyond
    ceil(m/64)·64 and rows at or beyond ceil(clamp(m - row_offset, 0,
    R)/64)·64 are written as exact zeros (inactive columns inside the
    active tiles come out 0: the caller keeps U's own).
    """
    if u.device.type == "cpu":
        return eigvec_rotate2_ref(u, z1, d1, lam1, inv1, defl1, cid1,
                                  z2, d2, lam2, inv2, defl2, cid2,
                                  num_active, row_offset,
                                  tau1=tau1, tau2=tau2)
    nb = tenants(u, "eigvec_rotate2")
    z1, inv1, z2, inv2 = (v.contiguous() for v in (z1, inv1, z2, inv2))
    dtype = cuda.check_operands("eigvec_rotate2", u, z1, inv1, z2, inv2)
    n = u.shape[-1]
    lead = u.shape[:-2]

    def factor(d, lam, tau, defl, cid):
        d, lam, tau = (v.to(torch.float64).contiguous()
                       for v in (d, lam, tau))
        cuda.check_operands("eigvec_rotate2", d, lam, tau)
        defl = defl.to(dtype).contiguous()
        cuda.check_operands("eigvec_rotate2", u, defl)
        if cid.device != u.device:
            raise ValueError(f"eigvec_rotate2: cid on {cid.device}, u on "
                             f"{u.device}")
        return d, lam, tau, defl, cid.to(torch.int32).contiguous()

    d1, lam1, tau1, defl1, cid1 = factor(d1, lam1, tau1, defl1, cid1)
    d2, lam2, tau2, defl2, cid2 = factor(d2, lam2, tau2, defl2, cid2)
    if any(v.shape != lead + (n,) for v in (
            z1, d1, lam1, tau1, inv1, defl1, cid1,
            z2, d2, lam2, tau2, inv2, defl2, cid2)):
        raise ValueError(f"eigvec_rotate2: need u (R, n) and (n,) factor "
                         f"vectors, each with u's tenant axis, got "
                         f"{tuple(u.shape)}")
    R = u.shape[-2]
    r0 = 0 if row_offset is None else int(row_offset)
    m = counts(num_active, u, n, nb)
    scratch = torch.empty(lead + (3, n, n), dtype=dtype, device=u.device)
    out = torch.empty_like(u)
    cuda.launch("eigvec_rotate2", dtype, u, z1, d1, lam1, tau1, inv1, defl1,
                cid1, z2, d2, lam2, tau2, inv2, defl2, cid2, m, scratch, out,
                n, R, r0, nb or 1, offset_guard(dtype))
    return out


def project_vectors(u: Tensor, v: Tensor, num_active=None, *,
                    row_offset: int | None = None) -> Tensor:
    """P = Uᵀ V with rows of V at or beyond ``num_active`` (global index)
    masked: the projection of Algorithm 2's second ±sigma pair, one read
    of U.  ``u`` (R, M) and ``v`` (R, C) may be a row block whose first
    row is the state's row ``row_offset`` (a host int); P is then the
    block's (M, C) partial.  Either may carry a leading tenant axis
    (module docstring).  Output rows at or beyond ceil(m/32)·32 are exact
    zeros (their true value)."""
    if u.device.type == "cpu":
        return eigvec_project_ref(u, v, num_active, row_offset)
    nb = tenants(u, "eigvec_project")
    v = v.contiguous()
    dtype = cuda.check_operands("eigvec_project", u, v)
    if v.dim() != u.dim() or v.shape[:-1] != u.shape[:-1]:
        raise ValueError(f"eigvec_project: need u (R, n), v (R, C), got "
                         f"{tuple(u.shape)} and {tuple(v.shape)}")
    R, n = u.shape[-2:]
    ncol = v.shape[-1]
    if not 1 <= ncol <= NPROJ:
        raise ValueError(f"eigvec_project takes 1..{NPROJ} columns, "
                         f"got {ncol}")
    r0 = 0 if row_offset is None else int(row_offset)
    m = counts(num_active, u, n, nb)
    out = torch.empty(u.shape[:-2] + (n, ncol), dtype=dtype, device=u.device)
    cuda.launch("eigvec_project", dtype, u, v, m, out, R, n, r0, ncol,
                nb or 1)
    return out
