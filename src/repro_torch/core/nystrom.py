"""Incremental Nyström approximation (paper §4), append-only.

The landmark set grows one point at a time; the eigendecomposition of the
(unadjusted) landmark gram K_{m,m} is maintained by Algorithm 1
(``engine._ingest`` with ``adjusted=False``), and the Nyström eigenpairs of
the full n×n kernel matrix follow from the Williams–Seeger rescaling
(paper eq. 7):

    Λ_nys = (n/m) Λ,        U_nys = sqrt(m/n) K_{n,m} U Λ⁺

so that  K̃ = U_nys Λ_nys U_nysᵀ = K_{n,m} K_{m,m}⁺ K_{m,n}.  The O(n²m)
reconstruction B diag(1/Λ) Bᵀ (B = K_{n,m} U) runs in the hand-written
``scaled_gram`` kernel (``reconstruct_tilde(use_pallas=True)``).

Two row regimes, as in the reference:

* **Fixed rows** (default): the full dataset ``x_all`` is known upfront
  and ``Knm`` is allocated dense (n, M).
* **Growing rows** (``init_nystrom(..., grow_rows=True)``): ``Knm`` starts
  at the seed landmarks' rows and ``observe_rows`` appends a row block per
  observed point; the observed points ride in ``NystromState.Xrows``.

``engine.Engine.add_landmark`` runs ``add_landmark`` at the active bucket.
Landmark removal and replacement, leverage scores and the swap deltas are
not ported yet (ROADMAP.md, Open items §1 item 5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.core import engine as eng
from repro_torch.core import inkpca, kernels_fn as kf, rankone

Tensor = torch.Tensor


class NystromState(NamedTuple):
    kpca: inkpca.KPCAState   # eigendecomposition of K_{m,m} (unadjusted)
    Knm: Tensor              # (n, M) columns k(X_rows, x_j) for landmarks j<m
    Xrows: Tensor | None = None   # (n, d) observed row points (grow_rows)


def init_nystrom(x_all: Tensor | None, x0: Tensor, capacity: int,
                 spec: kf.KernelSpec, *, dtype=torch.float32,
                 grow_rows: bool = False) -> NystromState:
    """Seed landmarks ``x0`` (on their device) and the Knm columns."""
    kpca = inkpca.init_state(x0, capacity, spec, adjusted=False, dtype=dtype)
    x0 = x0.to(dtype)
    if grow_rows:
        if x_all is not None:
            raise ValueError("grow_rows=True derives rows from the stream; "
                             "pass x_all=None and call observe_rows")
        x_rows = x0              # landmarks are observed points too
    else:
        if x_all is None:
            raise ValueError("x_all is required unless grow_rows=True")
        x_rows = x_all.to(device=x0.device, dtype=dtype)
    n = x_rows.shape[0]
    Knm = torch.zeros((n, capacity), dtype=dtype, device=x0.device)
    Knm[:, :x0.shape[0]] = kf.gram_block(x_rows, x0, spec=spec)
    return NystromState(kpca=kpca, Knm=Knm,
                        Xrows=x_rows if grow_rows else None)


def observe_rows(state: NystromState, xb: Tensor, spec: kf.KernelSpec, *,
                 plan: eng.UpdatePlan | None = None) -> NystromState:
    """Append a block of observed points as new Knm rows (grow_rows only).

    Under a bucketed ``plan.fuse_krow`` the gram is evaluated only against
    the active landmark bucket (columns beyond it are zero anyway), so a
    call costs O(b·M_b·d), not O(b·M·d)."""
    if state.Xrows is None:
        raise ValueError("observe_rows needs a grow_rows=True state")
    dtype = state.Knm.dtype
    xb = torch.atleast_2d(xb).to(device=state.Knm.device, dtype=dtype)
    M = state.Knm.shape[1]
    if (plan is not None and plan.fuse_krow
            and plan.dispatch == "bucketed"):
        Mb = eng.bucket_for(max(int(state.kpca.m), 1), M, plan.min_bucket)
    else:
        Mb = M
    mask = rankone.active_mask(Mb, state.kpca.m)
    rows_b = kf.gram_block(xb, state.kpca.X[:Mb], spec=spec).to(dtype)
    rows = xb.new_zeros((xb.shape[0], M))
    rows[:, :Mb] = torch.where(mask[None, :], rows_b, 0.0)
    return state._replace(Knm=torch.cat([state.Knm, rows], dim=0),
                          Xrows=torch.cat([state.Xrows, xb], dim=0))


def add_landmark(state: NystromState, x_all: Tensor | None, x_new: Tensor,
                 spec: kf.KernelSpec, *,
                 plan: eng.UpdatePlan = eng.DEFAULT_PLAN) -> NystromState:
    """Grow the landmark set by one point: Algorithm 1 on K_{m,m} (the fused
    prologue and pair under ``plan``) and the new landmark's Knm column.

    In ``grow_rows`` mode the column is evaluated against the observed
    rows in the state (``x_all`` must be None); observe the point first if
    it should also be a row.  Out of place: the input state is unchanged.
    """
    m = state.kpca.m
    kpca = eng._ingest(state.kpca, x_new, spec, False, plan)
    x_rows = state.Xrows if state.Xrows is not None else x_all
    col = kf.kernel_row(x_new.to(state.Knm.dtype),
                        x_rows.to(device=state.Knm.device,
                                  dtype=state.Knm.dtype), spec=spec)
    Knm = state.Knm.index_copy(1, m.reshape(1).long(), col[:, None])
    return state._replace(kpca=kpca, Knm=Knm)


def _pinv_lam(L: Tensor, mask: Tensor) -> Tensor:
    """Pseudo-inverse of the active spectrum: near-zero eigenvalues deflate
    to 0 instead of amplifying to 1/0."""
    tol = (L.shape[0] * torch.finfo(L.dtype).eps
           * torch.max(torch.where(mask, L.abs(), 0.0)))
    ok = mask & (L.abs() > tol)
    return torch.where(ok, 1.0 / torch.where(ok, L, 1.0), 0.0)


def admission_residual(state: NystromState, x: Tensor,
                       spec: kf.KernelSpec) -> Tensor:
    """Projection residual of a candidate landmark onto the landmark span:
    δ(x) = k(x,x) − b(x)ᵀ K_{m,m}⁺ b(x) ≥ 0, in O(m²) from the eigenpairs."""
    st = state.kpca
    mask = rankone.active_mask(st.L.shape[0], st.m)
    b, k_xx = eng.masked_row(st, x.to(st.X.dtype), spec)
    y = st.U.T @ b
    return k_xx - torch.sum(_pinv_lam(st.L, mask) * y * y)


def _rows_are_landmarks(state: NystromState, spec: kf.KernelSpec) -> bool:
    """Do the stored landmark points coincide with the observed rows, in
    order?  Checked by rebuilding the Knm columns from the stored points
    (a count match alone is not enough: landmarks may come from outside
    the rows)."""
    st = state.kpca
    n = state.Knm.shape[0]
    m = int(st.m)
    G = kf.gram_block(st.X[:n].to(st.L.dtype), st.X[:m],
                      spec=spec).to(state.Knm.dtype)
    scale = float(G.abs().max()) + 1e-30
    err = float((state.Knm[:, :m] - G).abs().max())
    return err <= 1e-5 * scale


def trace_error(state: NystromState, spec: kf.KernelSpec,
                x_all: Tensor | None = None) -> Tensor:
    """Trace norm of K − K̃ over the observed rows, in O(n·m²) from the
    maintained eigenpairs: K − K̃ is PSD, so it is Σ_i k(x_i,x_i) − K̃_ii."""
    st = state.kpca
    x_rows = state.Xrows if state.Xrows is not None else x_all
    n = state.Knm.shape[0]
    if x_rows is not None:
        diag_k = kf.kernel_diag(x_rows.to(device=st.L.device,
                                          dtype=st.L.dtype), spec=spec)
    elif kf.constant_diag(spec) is not None:
        # Stationary kernels have an input-independent diagonal.
        diag_k = torch.full((n,), kf.constant_diag(spec), dtype=st.L.dtype,
                            device=st.L.device)
    elif n == int(st.m) and _rows_are_landmarks(state, spec):
        diag_k = kf.kernel_diag(st.X[:n].to(st.L.dtype), spec=spec)
    else:
        raise ValueError(
            "trace_error is underdetermined: fixed-row state without "
            "x_all, a non-constant-diagonal kernel, and observed rows "
            "not covered by the stored landmarks — pass x_all")
    mask = rankone.active_mask(st.L.shape[0], st.m)
    B = state.Knm @ torch.where(mask[None, :], st.U, 0.0)
    diag_tilde = torch.sum(B ** 2 * _pinv_lam(st.L, mask)[None, :], dim=1)
    return torch.sum(diag_k - diag_tilde)


def admission_trace_delta(state: NystromState, x: Tensor,
                          spec: kf.KernelSpec,
                          x_all: Tensor | None = None
                          ) -> tuple[Tensor, Tensor]:
    """Exact decrease of ``trace_error`` from admitting ``x``, O(n·m):
    the reconstruction gains r rᵀ/δ with r = K_nm K_mm⁺ b − c and δ the
    admission residual, so the trace gap drops by Σ r²/δ.  Returns
    ``(delta, residual)``; delta is 0 where δ is numerically zero."""
    st = state.kpca
    x_rows = state.Xrows if state.Xrows is not None else x_all
    if x_rows is None:
        raise ValueError("admission_trace_delta needs the observed rows "
                         "(grow_rows state or x_all)")
    x = x.to(device=st.X.device, dtype=st.X.dtype)
    mask = rankone.active_mask(st.L.shape[0], st.m)
    b, k_xx = eng.masked_row(st, x, spec)
    y = st.U.T @ b
    alpha = _pinv_lam(st.L, mask) * y          # K_mm⁺ b in the eigenbasis
    delta_res = k_xx - torch.sum(y * alpha)
    c = kf.kernel_row(x, x_rows.to(device=st.L.device, dtype=st.L.dtype),
                      spec=spec)
    r = state.Knm @ (st.U @ alpha) - c
    tol = torch.finfo(st.L.dtype).eps * torch.clamp_min(k_xx, 1.0)
    delta = torch.where(delta_res > tol,
                        torch.sum(r * r) / torch.maximum(delta_res, tol),
                        torch.zeros_like(delta_res))
    return delta, delta_res


class TraceErrorTracker:
    """``trace_error`` kept current from O(n·m) increments across admissions
    (the swap paths of the reference's tracker wait for landmark
    replacement, ROADMAP.md Open items §1 item 5):

    * ``observe(state, x)`` — a newly observed row adds its own residual;
    * ``admitted(state_before, x)`` — subtract ``admission_trace_delta``;
    * every ``resync_every`` admissions the value re-anchors to the exact
      recompute (``maybe_resync`` with the post-event state).
    """

    def __init__(self, state: NystromState, spec: kf.KernelSpec, *,
                 x_all: Tensor | None = None, resync_every: int = 64):
        self.spec = spec
        self.x_all = x_all
        self.resync_every = int(resync_every)
        self.value = float(trace_error(state, spec, x_all))
        self._admits = 0
        self._pending_resync = False

    def resync(self, state: NystromState) -> float:
        self.value = float(trace_error(state, self.spec, self.x_all))
        self._admits = 0
        self._pending_resync = False
        return self.value

    def observe(self, state: NystromState, x: Tensor,
                residual: float | None = None) -> float:
        if residual is None:
            residual = float(admission_residual(state, x, self.spec))
        self.value += max(float(residual), 0.0)
        return self.value

    def admitted(self, state_before: NystromState, x: Tensor) -> float:
        delta, _ = admission_trace_delta(state_before, x, self.spec,
                                         self.x_all)
        self.value = max(self.value - float(delta), 0.0)
        self._admits += 1
        if self.resync_every and self._admits >= self.resync_every:
            self._admits = 0
            self._pending_resync = True
        return self.value

    def maybe_resync(self, state: NystromState) -> float:
        """Honor a pending periodic re-anchor (call with the CURRENT state
        after the admission that tripped it)."""
        if self._pending_resync:
            return self.resync(state)
        return self.value


class SufficientSubsetRule:
    """Online stopping rule for landmark admission: sufficient once the
    relative improvement of the error has stayed below ``rel_tol`` for
    ``patience`` consecutive admissions (the plateau of the paper's
    Fig. 2 curves)."""

    def __init__(self, rel_tol: float = 1e-2, patience: int = 3):
        self.rel_tol = float(rel_tol)
        self.patience = int(patience)
        self.history: list[float] = []
        self._flat = 0

    @property
    def sufficient(self) -> bool:
        return self._flat >= self.patience

    def observe(self, err) -> bool:
        """Record one error value; returns True once sufficient."""
        err = float(err)
        if self.history:
            prev = self.history[-1]
            rel = (prev - err) / max(abs(prev), 1e-30)
            self._flat = self._flat + 1 if rel < self.rel_tol else 0
        self.history.append(err)
        return self.sufficient


def nystrom_eigpairs(state: NystromState, n: int) -> tuple[Tensor, Tensor]:
    """Approximate eigenpairs of the full K by the rescaling (paper eq. 7)."""
    st = state.kpca
    mask = rankone.active_mask(st.L.shape[0], st.m)
    mf = st.m.to(st.L.dtype)
    lam_nys = torch.where(mask, (n / mf) * st.L, 0.0)
    U_nys = torch.sqrt(mf / n) * (state.Knm @ (
        st.U * _pinv_lam(st.L, mask)[None, :]))
    return lam_nys, torch.where(mask[None, :], U_nys, 0.0)


def query_features(state: NystromState, xq: Tensor, n: int,
                   spec: kf.KernelSpec, *,
                   plan: eng.UpdatePlan | None = None) -> Tensor:
    """Nyström eigenvector rows at out-of-sample points:
    sqrt(m/n) · k(x_q, X_lm) U Λ⁺ ((nq, d) -> (nq, M), zero beyond m).

    Under ``plan.fuse_krow`` the query gram is never stored: one
    ``transform_project`` call contracts each kernel tile against
    S = U diag(λ⁺), all M columns."""
    from repro_torch.kernels.nystrom_recon import ops as nops

    st = state.kpca
    M = st.L.shape[0]
    mask = rankone.active_mask(M, st.m)
    mf = st.m.to(st.L.dtype)
    s_mat = (st.U * _pinv_lam(st.L, mask)[None, :]).to(st.X.dtype)
    xq = torch.as_tensor(xq, device=st.X.device).to(st.X.dtype)
    if plan is not None and plan.fuse_krow:
        y = nops.transform_project(xq, st.X, s_mat.contiguous(), st.m,
                                   spec=spec)[0]
    else:
        kq = kf.gram_block(xq, st.X, spec=spec)
        y = torch.where(mask[None, :], kq, 0.0) @ s_mat
    return torch.sqrt(mf / n) * torch.where(mask[None, :], y, 0.0)


def recon_factors(state: NystromState) -> tuple[Tensor, Tensor]:
    """(B, s) with K̃ = B diag(s) Bᵀ: B = K_{n,m} U on the active columns
    (n, M) and s the active spectrum's pseudo-inverse (M,)."""
    st = state.kpca
    mask = rankone.active_mask(st.L.shape[0], st.m)
    B = state.Knm @ torch.where(mask[None, :], st.U, 0.0)
    return B, _pinv_lam(st.L, mask)


def reconstruct_tilde(state: NystromState, *,
                      use_pallas: bool = False) -> Tensor:
    """K̃ = K_{n,m} K_{m,m}⁺ K_{m,n} from the maintained eigenpairs; with
    ``use_pallas`` through the ``scaled_gram`` kernel (on the card; its
    plain version on the CPU), else the plain (B·s) @ Bᵀ."""
    B, inv_lam = recon_factors(state)
    if use_pallas:
        from repro_torch.kernels.nystrom_recon import ops as nops
        return nops.scaled_gram(B, inv_lam)
    return (B * inv_lam[None, :]) @ B.T


@dataclass
class ErrorNorms:
    fro: float
    spectral: float
    trace: float


def approximation_error(K: Tensor, K_tilde: Tensor) -> ErrorNorms:
    """Frobenius / spectral / trace norms of K − K̃ (paper Fig. 2)."""
    D = K - K_tilde
    ev = torch.linalg.eigvalsh(D)            # D symmetric
    return ErrorNorms(fro=float(torch.linalg.norm(D)),
                      spectral=float(ev.abs().max()),
                      trace=float(ev.abs().sum()))
