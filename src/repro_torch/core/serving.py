"""Snapshot serving: publish once, query many.

A ``ServingSnapshot`` freezes what a query needs — the stored points X,
the active count m and the projection S — so the eigpair sort and the
top-C gather happen once per publication.  ``query`` computes

    Y, rowsum = K(x_q, X_masked) @ S          (fused kernel or masked gram)
    Y        += affine correction             (mean-adjusted KPCA only)

and one head serves every workload through the published S and affine:
the KPCA transform (S = U_active/sqrt(lam), affine for Algorithm 2), KRR
predict (S = α[:, None], ``core/krr.py``) and Nyström features
(S = sqrt(m/n)·U·λ⁺, ``nystrom.publish_features``).

``publish_transform(..., retire=)`` writes the new snapshot into the
storage of a retired one, and ``DoubleBuffer`` retires the snapshot of two
publishes back, so a steady-state publish allocates nothing.  Torch has no
buffer donation: a write into retired storage is seen by every reference
to it, so the buffer writes only into snapshots it owns (see its
docstring).  The generation counter is a host (CPU) tensor.

Snapshots may be tenant-stacked (a leading axis B on every field, as
``engine.StreamBatch.publish`` makes them): ``publish_transform`` and
``query`` take a stacked state and stacked queries (B, nq, d), and under
``plan.fuse_krow`` one ``transform_project`` launch serves every tenant.
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
    M = state.L.shape[-1]
    mask = rankone.active_mask(M, state.m)
    order = torch.argsort(torch.where(mask, -state.L, torch.inf), dim=-1,
                          stable=True)[..., :n_components]
    lam = rankone.take(state.L, order)
    vec = rankone.take_cols(state.U, order)       # (M, C) gather — not M²
    denom = torch.sqrt(torch.clamp_min(lam, torch.finfo(state.L.dtype).eps))
    s_mat = (vec / denom[..., None, :]).to(state.X.dtype)
    if not adjusted:
        return s_mat, None
    mf = state.m.to(state.L.dtype)
    k1 = state.K1 / mf[..., None]
    colproj = (k1 @ s_mat if k1.dim() == 1
               else (k1[..., None, :] @ s_mat)[..., 0, :])
    return s_mat, AffineCorrection(mf=mf,
                                   colsum=torch.sum(s_mat, dim=-2),
                                   colproj=colproj,
                                   grand=state.S / mf**2)


def _into(dst: Tensor | None, src: Tensor) -> Tensor:
    """``src`` written into ``dst``'s storage where the two agree in
    shape, type and device, else a copy of ``src`` that owns its
    storage."""
    if (dst is not None and dst.shape == src.shape and dst.dtype == src.dtype
            and dst.device == src.device):
        return dst.copy_(src)
    return src.clone()


def _retiring(fresh: ServingSnapshot, retire: ServingSnapshot
              ) -> ServingSnapshot:
    """``fresh`` written into ``retire``'s storage, generation
    retire.generation + 2 (the retired snapshot is two publishes old)."""
    aff = fresh.affine
    if aff is not None:
        old = retire.affine
        aff = AffineCorrection(*(_into(getattr(old, f, None), getattr(aff, f))
                                 for f in AffineCorrection._fields))
    return ServingSnapshot(S=_into(retire.S, fresh.S),
                           X=_into(retire.X, fresh.X),
                           m=_into(retire.m, fresh.m), affine=aff,
                           generation=retire.generation.add_(2))


def publish_transform(state, *, n_components: int, adjusted: bool,
                      generation: int = 0,
                      retire: ServingSnapshot | None = None
                      ) -> ServingSnapshot:
    """Publish a KPCA transform snapshot of ``state``.  A fresh snapshot
    shares X and m with the state (the engine never writes a state in
    place).  With ``retire`` the snapshot is written into ``retire``'s
    storage instead, generation retire.generation + 2: ``retire`` is
    consumed, and must own its storage and be read by nobody again.  A
    tenant-stacked state gives stacked snapshots, each tenant's generation
    ``generation``."""
    s_mat, affine = _transform_fields(state, n_components=n_components,
                                      adjusted=adjusted)
    gen = torch.full(state.m.shape, generation, dtype=torch.int32)
    snap = ServingSnapshot(S=s_mat, X=state.X, m=state.m, affine=affine,
                           generation=gen)
    return snap if retire is None else _retiring(snap, retire)


def query(snap: ServingSnapshot, xq: Tensor, *, spec: kf.KernelSpec,
          plan=None) -> Tensor:
    """Batch queries against a snapshot: (nq, d) -> (nq, C); against
    tenant-stacked snapshots (B, nq, d) -> (B, nq, C).

    Under ``plan.fuse_krow`` the query gram is never stored: the fused
    ``transform_project`` kernel contracts each kernel tile against S (one
    launch for every tenant); otherwise the masked gram is built and
    multiplied.
    """
    xq = torch.as_tensor(xq, device=snap.X.device).to(snap.X.dtype)
    if plan is not None and plan.fuse_krow:
        from repro_torch.kernels.nystrom_recon import ops as nops
        y, rs = nops.transform_project(xq, snap.X, snap.S, snap.m,
                                       spec=spec)
    else:
        kq = kf.gram_block(xq.to(snap.X.dtype), snap.X, spec=spec)
        mask = rankone.active_mask(snap.X.shape[-2], snap.m)
        kq = torch.where(mask[..., None, :], kq, 0.0)
        y = kq @ snap.S
        rs = torch.sum(kq, dim=-1)
    if snap.affine is not None:
        aff = snap.affine
        colsum = aff.colsum[..., None, :]
        y = (y - (rs / aff.mf[..., None])[..., None] * colsum
             - aff.colproj[..., None, :]
             + aff.grand[..., None, None] * colsum)
    return y


def _snapshot_at(snaps: ServingSnapshot, b: int) -> ServingSnapshot:
    """Tenant ``b`` of tenant-stacked snapshots."""
    aff = snaps.affine
    return ServingSnapshot(
        S=snaps.S[b], X=snaps.X[b], m=snaps.m[b],
        affine=None if aff is None else AffineCorrection(*(f[b] for f in aff)),
        generation=snaps.generation[b])


def stack_snapshots(snaps: list[ServingSnapshot]) -> ServingSnapshot:
    """Tenant-stacked snapshots (a leading axis B on every field) from a
    list of snapshots of one shape."""
    aff = [s.affine for s in snaps]
    return ServingSnapshot(
        S=torch.stack([s.S for s in snaps]),
        X=torch.stack([s.X for s in snaps]),
        m=torch.stack([s.m for s in snaps]),
        affine=(None if aff[0] is None else AffineCorrection(
            *(torch.stack(f) for f in zip(*aff)))),
        generation=torch.stack([s.generation for s in snaps]))


def query_batch(snaps: ServingSnapshot, xq: Tensor, *, spec: kf.KernelSpec,
                plan=None) -> Tensor:
    """Per-tenant queries against tenant-stacked snapshots: (B, nq, d) ->
    (B, nq, C).  Under ``plan.fuse_krow`` one ``transform_project`` launch
    serves every tenant, each tenant's rows equal to its own ``query`` bit
    for bit; otherwise one ``query`` per tenant (a stacked matmul would
    round each tenant otherwise than its own query)."""
    if plan is not None and plan.fuse_krow:
        return query(snaps, xq, spec=spec, plan=plan)
    return torch.stack([query(_snapshot_at(snaps, b), xq[b], spec=spec,
                              plan=plan) for b in range(xq.shape[0])])


def _top_spectrum(state, C: int) -> Tensor:
    """Descending top-C active eigenvalues, zero past m."""
    mask = rankone.active_mask(state.L.shape[0], state.m)
    lam = state.L[torch.argsort(torch.where(mask, -state.L, torch.inf),
                                stable=True)[:C]]
    return torch.where(torch.arange(C, device=lam.device) < state.m, lam,
                       0.0)


class DoubleBuffer:
    """Host-side double buffer over published snapshots.

    ``front`` is the snapshot queries read; ``publish`` freezes the
    working state into a new front and retires the old one.  From the
    third publish on, the new snapshot is written into the storage of the
    snapshot retired two publishes back, so publication allocates nothing
    and the swap is a reference flip; its first two publishes copy X and m
    so that every snapshot the buffer writes into is its own.

    Torch has no donation that invalidates the old handle: a reference
    kept to a snapshot two publishes old silently reads the new values.
    The buffer never writes into ``front`` or into the snapshot just
    retired, so a handle stays valid for one publish after it left the
    front; hold one longer only as a copy.

    ``publish`` takes a ``healthy`` verdict from the caller's probe: an
    unhealthy state is never published, the buffer keeps serving the last
    healthy front and counts the refusal in ``skipped``.  ``ref_lam``
    holds the published top-C spectrum beside each front.
    """

    def __init__(self, state=None, *, n_components: int | None = None,
                 adjusted: bool = True):
        self.n_components = n_components
        self.adjusted = adjusted
        self.front: ServingSnapshot | None = None
        self._retired: ServingSnapshot | None = None
        self._generation = 0
        self.skipped = 0
        self.ref_lam: Tensor | None = None
        if state is not None:
            self.publish(state)

    def publish(self, state, *, n_components: int | None = None,
                adjusted: bool | None = None,
                healthy: bool = True) -> ServingSnapshot:
        nc = self.n_components if n_components is None else n_components
        adj = self.adjusted if adjusted is None else adjusted
        if nc is None:
            raise ValueError("n_components must be set on the buffer or "
                             "passed to publish()")
        if not healthy:
            if self.front is None:
                raise ValueError("refusing to publish an unhealthy state "
                                 "with no prior healthy snapshot to serve")
            self.skipped += 1
            return self.front
        retire, self._retired = self._retired, self.front
        snap = publish_transform(state, n_components=nc, adjusted=adj,
                                 generation=self._generation, retire=retire)
        if retire is None:
            snap = snap._replace(X=snap.X.clone(), m=snap.m.clone())
        self.front = snap
        self.ref_lam = _top_spectrum(state, nc)
        self._generation += 1
        return self.front

    def query(self, xq: Tensor, *, spec: kf.KernelSpec, plan=None) -> Tensor:
        if self.front is None:
            raise ValueError("no snapshot published yet")
        return query(self.front, xq, spec=spec, plan=plan)
