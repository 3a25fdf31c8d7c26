"""Plain PyTorch versions of the Cauchy eigenvector rotation kernels.

The wrappers in ``ops.py`` run these for tensors on the CPU; the tests and
``chip_smoke.py`` hold the CUDA kernels against them on the card.  Each
takes the kernels' optional leading tenant axis: operands (B, ...) with
active counts (B,), every tenant computed as the unbatched call computes
it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import tenantwise

Tensor = torch.Tensor

ROTATE_TILE = 64    # eigvec_rotate's pruning granule (rows and columns)
ROTATE2_TILE = 64   # eigvec_rotate2's (its output tiles' granule)
PROJECT_SLAB = 32   # eigvec_project's pruning granule (output rows)


def eigvec_rotate_ref(u: Tensor, zhat: Tensor, d: Tensor, lam: Tensor,
                      inv: Tensor, tau: Tensor, num_active=None,
                      row_offset=None) -> Tensor:
    """C = (U @ W) * inv with W[k, j] = zhat[k] / ((d[k] - lam[j]) - tau[j]),
    W materialized (the kernel forms each entry once into scratch).
    ``tau`` is the roots' offset from their origin poles ``lam``;
    ``rankone._Roots`` says why.  (Absolute roots, the reference's form,
    are ``lam`` with a zero ``tau``.)  ``u`` may be an (R, M) row block
    whose first global row is ``row_offset``; with ``num_active`` = m the
    entries outside ``pruned_region_mask(R, M, m, row_offset,
    block=ROTATE_TILE)`` are exact zeros, as the kernel writes them (on
    the padding contract they are zeros anyway).

    Two guards the reference's ``eigvec_rotate`` lacks:

    * The denominators are formed in the type of ``d`` and ``lam`` — the
      secular solve's float64 for an f32 state under ``precise`` — and
      only then rounded to zhat's type.  Cast first, a root within half
      an f32 ulp of its pole rounds onto it and the division gives inf.
    * The denominators are guarded as ``rankone._cauchy_inv`` (which
      computes ``inv``) and ``cauchy_factor_ref`` guard them
      (``_denominators``).  Unguarded, an exact zero (a deflated
      column's own pole) divides.

    Otherwise, with operands of one type, this is the reference's formula.
    """
    if u.dim() == 3:
        return tenantwise(eigvec_rotate_ref, u, zhat, d, lam, inv, tau,
                          num_active, row_offset)
    den = _denominators(d, lam, tau, zhat.dtype)
    W = zhat[..., :, None] / den.to(zhat.dtype)
    C = (u @ W) * inv[..., None, :]
    if num_active is None:
        return C
    rows, cols = pruned_region_mask(*u.shape[-2:], num_active, row_offset,
                                    block=ROTATE_TILE, device=u.device)
    return torch.where(rows[..., :, None] & cols[..., None, :], C, 0.0)


def offset_guard(dtype) -> float:
    """The offset form's denominator guard for a result of type ``dtype``:
    tiny/eps, far below any distance a non-deflated root keeps from its
    pole, and large enough that z/guard cannot overflow."""
    fi = torch.finfo(dtype)
    return fi.tiny / fi.eps


def _denominators(d: Tensor, lam: Tensor, tau: Tensor,
                  out_dtype) -> Tensor:
    """(d[k] - lam[j]) - tau[j], guarded in its own type.

    In offset form the distance is exact to the last bit however small it
    is, so the guard only keeps an exact zero (a deflated column's own
    pole, coincident poles no merge joined) from dividing: ±``offset_guard``
    of ``out_dtype``, the type the denominator is rounded to, so the
    rounding cannot make it zero.  (The reference guards its absolute
    roots at ±eps.)"""
    return guard_zero((d[..., :, None] - lam[..., None, :])
                      - tau[..., None, :], out_dtype)


def guard_zero(den: Tensor, out_dtype) -> Tensor:
    """``den`` with entries below ``offset_guard(out_dtype)`` in magnitude
    replaced by ±guard.  The guard is a tensor of den's type: as a Python
    float, ``torch.where`` would round it to the default float32, where
    the float64 guard underflows to 0.  It is a fill on den's device, not
    a copy from the host (which would synchronize on every update)."""
    g = den.new_full((), offset_guard(out_dtype))
    return torch.where(den.abs() < g, torch.where(den < 0, -g, g), den)


def eigvec_project_ref(u: Tensor, v: Tensor, num_active=None,
                       row_offset=None) -> Tensor:
    """P = Uᵀ V with rows >= num_active (global index) masked to zero.
    ``u``/``v`` may be a (R, ·) row block whose first global row is
    ``row_offset``; P is then the block's (M, C) partial.  With
    ``num_active`` = m the output rows at or beyond ceil(m / PROJECT_SLAB)
    · PROJECT_SLAB are exact zeros, as the kernel writes them (on the
    padding contract they are zeros anyway)."""
    if u.dim() == 3:
        return tenantwise(eigvec_project_ref, u, v, num_active, row_offset)
    if num_active is None:
        return u.mT @ v
    r0 = 0 if row_offset is None else row_offset
    m = torch.as_tensor(num_active, device=u.device)
    live = (r0 + torch.arange(u.shape[-2], device=u.device)) < m[..., None]
    P = u.mT @ torch.where(live[..., :, None], v, 0.0)
    cols = pruned_region_mask(*u.shape[-2:], num_active, row_offset,
                              block=PROJECT_SLAB, device=u.device)[1]
    return torch.where(cols[..., :, None], P, 0.0)


def pruned_region_mask(R: int, M: int, m, row_offset=None, *, block: int,
                       device=None) -> tuple[Tensor, Tensor]:
    """(row_mask (R,), col_mask (M,)) of the tiles a pruned kernel WRITES:
    True inside the active tile range (real values), False where the
    kernel writes exact zeros.  ``block`` is the kernel's output tile;
    the masks lie on ``device`` (default the CPU).  Counts m of shape (B,)
    give masks (B, R) and (B, M)."""
    r0 = 0 if row_offset is None else row_offset
    m = torch.as_tensor(m, dtype=torch.int32, device=device)
    rows_active = torch.clamp(m - r0, 0, R)
    g_rows = -(-rows_active // block)
    g_cols = -(-m // block)
    row_mask = torch.arange(R, device=device) < (g_rows * block)[..., None]
    col_mask = torch.arange(M, device=device) < (g_cols * block)[..., None]
    return row_mask, col_mask


def cauchy_factor_ref(z: Tensor, d: Tensor, lam: Tensor, inv: Tensor,
                      defl: Tensor | None = None,
                      cid: Tensor | None = None, *,
                      tau: Tensor) -> Tensor:
    """Dense normalized Cauchy factor with deflated identity columns.

    W[k, j] = z[k]·inv[j]/((d[k]-lam[j]) - tau[j]) with the guard of
    ``_denominators`` on the denominator; columns with defl[j] != 0
    are replaced by e_{cid[j]} (cid defaults to j).
    """
    M = z.shape[-1]
    den = _denominators(d, lam, tau, z.dtype)
    W = z[..., :, None] * inv[..., None, :] / den.to(z.dtype)
    if defl is None:
        return W
    idx = torch.arange(M, device=z.device)
    if cid is None:
        cid = idx
    E = (idx[:, None] == cid[..., None, :]).to(W.dtype)
    return torch.where(defl[..., None, :] > 0, E, W)


def eigvec_rotate2_ref(u: Tensor,
                       z1: Tensor, d1: Tensor, lam1: Tensor, inv1: Tensor,
                       defl1: Tensor, cid1: Tensor,
                       z2: Tensor, d2: Tensor, lam2: Tensor, inv2: Tensor,
                       defl2: Tensor, cid2: Tensor, num_active=None,
                       row_offset=None, *,
                       tau1: Tensor, tau2: Tensor) -> Tensor:
    """C = (U @ W1) @ W2 with both normalized Cauchy factors materialized
    (``cauchy_factor_ref``; the kernel generates their tiles): the fused
    ±sigma pair's double rotation.  ``tau1``/``tau2`` are the roots'
    offsets from ``lam1``/``lam2``.  ``u`` may be an (R, M) row block
    whose first global row is ``row_offset``; with ``num_active`` = m the
    entries outside ``pruned_region_mask(R, M, m, row_offset,
    block=ROTATE2_TILE)`` are exact zeros, as the kernel writes them (on
    the padding contract they are zeros anyway)."""
    if u.dim() == 3:
        return tenantwise(eigvec_rotate2_ref, u, z1, d1, lam1, inv1, defl1,
                          cid1, z2, d2, lam2, inv2, defl2, cid2, num_active,
                          row_offset, tau1=tau1, tau2=tau2)
    W1 = cauchy_factor_ref(z1, d1, lam1, inv1, defl1, cid1, tau=tau1)
    W2 = cauchy_factor_ref(z2, d2, lam2, inv2, defl2, cid2, tau=tau2)
    C = (u @ W1.to(u.dtype)) @ W2.to(u.dtype)
    if num_active is None:
        return C
    rows, cols = pruned_region_mask(*u.shape[-2:], num_active, row_offset,
                                    block=ROTATE2_TILE, device=u.device)
    return torch.where(rows[..., :, None] & cols[..., None, :], C, 0.0)
