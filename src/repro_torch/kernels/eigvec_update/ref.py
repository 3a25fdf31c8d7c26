"""Plain PyTorch versions of the Cauchy eigenvector rotation kernels.

The wrappers in ``ops.py`` run these for tensors on the CPU; the tests and
``chip_smoke.py`` hold the CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def eigvec_rotate_ref(u: Tensor, zhat: Tensor, d: Tensor, lam: Tensor,
                      inv: Tensor) -> Tensor:
    """C = (U @ W) * inv with W[k, j] = zhat[k] / (d[k] - lam[j]),
    W materialized (the kernel generates it tile by tile).

    Two guards the reference's ``eigvec_rotate`` lacks:

    * The denominators are formed in the type of ``d`` and ``lam`` — the
      secular solve's float64 for an f32 state under ``precise`` — and
      only then rounded to zhat's type.  Cast first, a root within half
      an f32 ulp of its pole rounds onto it and the division gives inf.
    * A denominator smaller than that type's eps is replaced by ±eps, as
      ``rankone._cauchy_inv`` (which computes ``inv``), ``cauchy_factor_ref``
      and the reference's ``eigvec_rotate2`` do.  Unguarded, a root closer
      than eps to its pole gives a column that ``inv`` does not normalize.

    Otherwise, with operands of one type, this is the reference's formula.
    """
    den = d[:, None] - lam[None, :]
    eps = torch.finfo(den.dtype).eps
    den = torch.where(den.abs() < eps, torch.where(den < 0, -eps, eps), den)
    W = zhat[:, None] / den.to(zhat.dtype)
    return (u @ W) * inv[None, :]


def eigvec_project_ref(u: Tensor, v: Tensor, num_active=None,
                       row_offset=None) -> Tensor:
    """P = Uᵀ V with rows >= num_active (global index) masked to zero.
    ``u``/``v`` may be a (R, ·) row block whose first global row is
    ``row_offset``."""
    if num_active is not None:
        r0 = 0 if row_offset is None else row_offset
        rows = r0 + torch.arange(u.shape[0], device=u.device)
        v = torch.where((rows < num_active)[:, None], v, 0.0)
    return u.T @ v


def pruned_region_mask(R: int, M: int, m, row_offset=None, *,
                       block: int) -> tuple[Tensor, Tensor]:
    """(row_mask (R,), col_mask (M,)) of the tiles a pruned kernel WRITES:
    True inside the active tile range (real values), False where the
    kernel writes exact zeros.  ``block`` is the kernel's output tile."""
    r0 = 0 if row_offset is None else row_offset
    m = torch.as_tensor(m, dtype=torch.int32)
    rows_active = torch.clamp(m - r0, 0, R)
    g_rows = -(-rows_active // block)
    g_cols = -(-m // block)
    row_mask = torch.arange(R) < g_rows * block
    col_mask = torch.arange(M) < g_cols * block
    return row_mask, col_mask


def cauchy_factor_ref(z: Tensor, d: Tensor, lam: Tensor, inv: Tensor,
                      defl: Tensor | None = None,
                      cid: Tensor | None = None) -> Tensor:
    """Dense normalized Cauchy factor with deflated identity columns.

    W[k, j] = z[k]·inv[j]/(d[k]-lam[j]) with an eps guard on the
    denominator; columns with defl[j] != 0 are replaced by e_{cid[j]}
    (cid defaults to j).
    """
    M = z.shape[0]
    eps = torch.finfo(z.dtype).eps
    den = d[:, None] - lam[None, :]
    den = torch.where(den.abs() < eps,
                      torch.where(den < 0, -eps, eps), den)
    W = z[:, None] * inv[None, :] / den
    if defl is None:
        return W
    idx = torch.arange(M, device=z.device)
    if cid is None:
        cid = idx
    E = (idx[:, None] == cid[None, :]).to(W.dtype)
    return torch.where(defl[None, :] > 0, E, W)
