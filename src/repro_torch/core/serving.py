"""Snapshot serving: publish once, query many.

A ``ServingSnapshot`` freezes what a query needs — the stored points X,
the active count m and the projection S = U_active / sqrt(lam) — so the
eigpair sort and the top-C gather happen once per publication.  ``query``
computes

    Y, rowsum = K(x_q, X_masked) @ S          (fused kernel or masked gram)
    Y        += affine correction             (mean-adjusted KPCA only)

Only the fresh publication is ported here; the double buffer and the
retiring (buffer-donating) spelling come with ROADMAP.md, Open items §1
item 6.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import kernels_fn as kf, rankone

Tensor = torch.Tensor


class AffineCorrection(NamedTuple):
    """Mean-adjustment post-correction of a projected query batch: with
    rowsum rs per query,

        Y_adj = Y − (rs/mf)·colsumᵀ − 1·colprojᵀ + grand·colsumᵀ
    """

    mf: Tensor        # ()  active count as float
    colsum: Tensor    # (C,) 1ᵀS
    colproj: Tensor   # (C,) (K1/m)·S
    grand: Tensor     # ()  S_sum/m²


class ServingSnapshot(NamedTuple):
    """Published query state.

    S:          (M, C) projection matrix (X dtype)
    X:          (M, d) stored points at publication
    m:          ()     active count
    affine:     mean-adjustment correction, or None for linear heads
    generation: ()     int32 publication counter
    """

    S: Tensor
    X: Tensor
    m: Tensor
    affine: AffineCorrection | None
    generation: Tensor


def _transform_fields(state, *, n_components: int, adjusted: bool):
    """(S, affine) of the KPCA transform head: masked stable argsort,
    top-C gather, eps floor on the eigenvalues."""
    M = state.L.shape[0]
    mask = rankone.active_mask(M, state.m)
    order = torch.argsort(torch.where(mask, -state.L, torch.inf),
                          stable=True)[:n_components]
    lam = state.L[order]
    vec = state.U[:, order]                        # (M, C) gather — not M²
    denom = torch.sqrt(torch.clamp_min(lam, torch.finfo(state.L.dtype).eps))
    s_mat = (vec / denom[None, :]).to(state.X.dtype)
    if not adjusted:
        return s_mat, None
    mf = state.m.to(state.L.dtype)
    return s_mat, AffineCorrection(mf=mf,
                                   colsum=torch.sum(s_mat, dim=0),
                                   colproj=(state.K1 / mf) @ s_mat,
                                   grand=state.S / mf**2)


def publish_transform(state, *, n_components: int, adjusted: bool,
                      generation: int = 0) -> ServingSnapshot:
    """Publish a KPCA transform snapshot of ``state``.  The engine never
    writes a state in place, so the snapshot's X stays as published."""
    s_mat, affine = _transform_fields(state, n_components=n_components,
                                      adjusted=adjusted)
    return ServingSnapshot(S=s_mat, X=state.X, m=state.m, affine=affine,
                           generation=torch.tensor(generation,
                                                   dtype=torch.int32))


def query(snap: ServingSnapshot, xq: Tensor, *, spec: kf.KernelSpec,
          plan=None) -> Tensor:
    """Batch queries against a snapshot: (nq, d) -> (nq, C).

    Under ``plan.fuse_krow`` the query gram is never stored: the fused
    ``transform_project`` kernel contracts each kernel tile against S;
    otherwise the masked gram is built and multiplied.
    """
    if plan is not None and plan.fuse_krow:
        from repro_torch.kernels.nystrom_recon import ops as nops
        y, rs = nops.transform_project(xq, snap.X, snap.S, snap.m,
                                       spec=spec)
    else:
        kq = kf.gram_block(xq.to(snap.X.dtype), snap.X, spec=spec)
        mask = rankone.active_mask(snap.X.shape[0], snap.m)
        kq = torch.where(mask[None, :], kq, 0.0)
        y = kq @ snap.S
        rs = torch.sum(kq, dim=1)
    if snap.affine is not None:
        aff = snap.affine
        y = (y - (rs / aff.mf)[:, None] * aff.colsum[None, :]
             - aff.colproj[None, :] + aff.grand * aff.colsum[None, :])
    return y
