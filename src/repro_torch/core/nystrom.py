"""Incremental Nyström approximation (paper §4) and its landmark lifecycle.

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
A landmark can also be removed (the exact inverse of Algorithm 1,
``core/downdate.py``) or replaced, and ``consider_landmark`` admits a
candidate by its projection residual, swapping out the lowest-leverage
landmark once the budget is full; ``TraceErrorTracker`` keeps the trace
error current across the lifecycle in O(n·m) per event, and
``SufficientSubsetRule`` stops the admissions on its plateau.
``publish_features`` freezes the out-of-sample feature head into a
``serving.ServingSnapshot``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
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
                 plan: eng.UpdatePlan | None = None,
                 m: int | None = None) -> NystromState:
    """Append a block of observed points as new Knm rows (grow_rows only).

    Under a bucketed ``plan.fuse_krow`` the gram is evaluated only against
    the active landmark bucket (columns beyond it are zero anyway), so a
    call costs O(b·M_b·d), not O(b·M·d); ``m`` is the host's landmark
    count that picks the bucket (None reads it).

    Under ``plan.health`` with quarantine, non-finite points are dropped
    before any Knm row is built (a NaN row would poison every later
    trace-error contraction); the caller sees the rejection in the row
    count.  The filter reads one flag back per call, as row growth is a
    host-level decision anyway."""
    if state.Xrows is None:
        raise ValueError("observe_rows needs a grow_rows=True state")
    dtype = state.Knm.dtype
    xb = torch.atleast_2d(xb).to(device=state.Knm.device, dtype=dtype)
    policy = plan.health if plan is not None else None
    if policy is not None and policy.quarantine:
        keep = torch.isfinite(xb).all(dim=1)
        if not bool(keep.all()):
            xb = xb[keep]
            if xb.shape[0] == 0:
                return state
    M = state.Knm.shape[1]
    if (plan is not None and plan.fuse_krow
            and plan.dispatch == "bucketed"):
        if m is None:
            m = int(state.kpca.m)
        Mb = eng.bucket_for(max(m, 1), M, plan.min_bucket)
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


def remove_landmark(state: NystromState, j: Tensor, spec: kf.KernelSpec, *,
                    plan: eng.UpdatePlan = eng.DEFAULT_PLAN) -> NystromState:
    """Shrink the landmark set by one point: the eigensystem of K_{m,m} is
    downdated by the exact inverse of Algorithm 1, the Knm columns follow
    the survivor-order permutation the downdate applies to the landmark
    rows, and the evicted landmark's column is zeroed.  Observed rows are
    untouched: an ex-landmark stays an observed point.  ``j`` is an int
    or a 0-d device tensor; out of place."""
    from repro_torch.core import downdate as dd

    st = state.kpca
    j = torch.as_tensor(j, dtype=torch.int32, device=st.L.device)
    order = dd.boundary_perm(j, st.m, st.L.shape[0])
    Knm = state.Knm[:, order].index_fill(1, (st.m - 1).reshape(1).long(),
                                         0.0)
    kpca = dd.downdate_unadjusted(dd.permute_to_boundary(st, j), spec,
                                  plan=plan)
    return state._replace(kpca=kpca, Knm=Knm)


def replace_landmark(state: NystromState, x_all: Tensor | None, j,
                     x_new: Tensor, spec: kf.KernelSpec, *,
                     plan: eng.UpdatePlan = eng.DEFAULT_PLAN
                     ) -> NystromState:
    """Swap landmark ``j`` for ``x_new``: remove, then add.  O(m³) of
    eigensystem work and one new Knm column, against the O(n·m·d) gram
    and eigh of a rebuild.  ``engine.Engine.replace_landmark`` is the
    bucketed spelling."""
    state = remove_landmark(state, j, spec, plan=plan)
    return add_landmark(state, x_all, x_new, spec, plan=plan)


# ------------------------------------------------- landmark admission ----
def leverage_scores(state: NystromState, reg: float = 1e-6) -> Tensor:
    """Ridge leverage of each landmark under the maintained eigensystem:
    l_j = Σ_k U[j,k]² λ_k/(λ_k + reg·tr/m), the regulariser scaled by the
    mean active eigenvalue (floored at the state type's smallest normal)
    so that ``reg`` is dimensionless.  Low-leverage landmarks are the
    redundant ones, the victims of the "leverage" policy."""
    st = state.kpca
    mask = rankone.active_mask(st.L.shape[0], st.m)
    lam = torch.where(mask, st.L, 0.0)
    lam_bar = torch.sum(lam) / torch.clamp_min(st.m.to(st.L.dtype), 1.0)
    lam_reg = torch.clamp_min(reg * lam_bar, torch.finfo(st.L.dtype).tiny)
    w = torch.where(mask, lam / (lam + lam_reg), 0.0)
    scores = torch.sum(st.U ** 2 * w[None, :], dim=1)
    return torch.where(mask, scores, 0.0)


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


def _removal_terms(st, j: Tensor):
    """(pinv, w, W_jj) of removing landmark ``j``: the active spectrum's
    pseudo-inverse, w = W e_j with W = K_mm⁺ = U diag(λ⁺) Uᵀ, and
    W_jj."""
    mask = rankone.active_mask(st.L.shape[0], st.m)
    pinv = _pinv_lam(st.L, mask)
    uj = rankone.index_get(st.U, j)
    return pinv, st.U @ (pinv * uj), torch.sum(uj * uj * pinv)


def removal_trace_delta(state: NystromState, j) -> tuple[Tensor, Tensor]:
    """Exact increase of ``trace_error`` from removing landmark ``j``,
    O(n·m): deleting row and column j of the landmark gram turns W into
    W − w wᵀ/W_jj, so the trace gap grows by Σ_i (K_nm w)_i² / W_jj.
    Returns ``(inc, W_jj)``; W_jj ≤ 0 means the leave-one-out inverse does
    not exist (resync instead)."""
    st = state.kpca
    j = torch.as_tensor(j, dtype=torch.int32, device=st.L.device)
    _, w, Wjj = _removal_terms(st, j)
    t = state.Knm @ w
    return (torch.sum(t * t)
            / torch.clamp_min(Wjj, torch.finfo(st.L.dtype).tiny), Wjj)


def swap_trace_delta(state: NystromState, j, x: Tensor, spec: kf.KernelSpec,
                     x_all: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Exact net change of ``trace_error`` from replacing landmark ``j``
    with ``x``, O(n·m) from the pre-swap state: the removal adds
    Σ(K_nm w)²/W_jj, then the admission against the deflated inverse
    A = W − w wᵀ/W_jj subtracts Σ r²/δ', with b̃ the candidate's kernel
    row zeroed at the victim, δ' = k_xx − b̃ᵀAb̃ and r = K_nm A b̃ − c.
    Returns ``(net, W_jj)``, net to be added to the tracked value; W_jj
    ≤ 0 or a non-finite net means resync."""
    st = state.kpca
    x_rows = state.Xrows if state.Xrows is not None else x_all
    if x_rows is None:
        raise ValueError("swap_trace_delta needs the observed rows "
                         "(grow_rows state or x_all)")
    dtype = st.L.dtype
    j = torch.as_tensor(j, dtype=torch.int32, device=st.L.device)
    x = x.to(device=st.X.device, dtype=st.X.dtype)
    pinv, w, Wjj_raw = _removal_terms(st, j)
    Wjj = torch.clamp_min(Wjj_raw, torch.finfo(dtype).tiny)
    t = state.Knm @ w
    inc = torch.sum(t * t) / Wjj

    b, k_xx = eng.masked_row(st, x, spec)
    bt = rankone.index_set(b, j, 0.0)            # row vs the survivors
    Wb = st.U @ (pinv * (st.U.T @ bt))
    Ab = Wb - w * (torch.dot(w, bt) / Wjj)
    delta_res = k_xx - torch.dot(bt, Ab)
    c = kf.kernel_row(x, x_rows.to(device=st.L.device, dtype=dtype),
                      spec=spec)
    r = state.Knm @ Ab - c
    tol = torch.finfo(dtype).eps * torch.clamp_min(k_xx, 1.0)
    dec = torch.where(delta_res > tol,
                      torch.sum(r * r) / torch.maximum(delta_res, tol),
                      torch.zeros_like(delta_res))
    return inc - dec, Wjj_raw


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
    """``trace_error`` kept current from O(n·m) increments across the
    landmark lifecycle:

    * ``observe(state, x)`` — a newly observed row adds its own residual;
    * ``admitted(state_before, x)`` — subtract ``admission_trace_delta``;
    * ``replaced(state_after, state_before=, x=, j=)`` — add
      ``swap_trace_delta`` of the pre-swap state; ``j`` defaults to the
      lowest-leverage landmark (pass the victim the caller chose: in f32 a
      near-tie can pick another one).  A degenerate victim (W_jj ≤ 0), a
      non-finite delta, or only ``state_after`` resyncs exactly;
    * every ``resync_every`` admissions or swaps the value re-anchors to
      the exact recompute at the next event (``maybe_resync`` with the
      post-event state).  ``resyncs`` counts the exact recomputes.
    """

    def __init__(self, state: NystromState, spec: kf.KernelSpec, *,
                 x_all: Tensor | None = None, resync_every: int = 64):
        self.spec = spec
        self.x_all = x_all
        self.resync_every = int(resync_every)
        self.value = float(trace_error(state, spec, x_all))
        self._admits = 0
        self._pending_resync = False
        self.resyncs = 0

    def resync(self, state: NystromState) -> float:
        self.value = float(trace_error(state, self.spec, self.x_all))
        self.resyncs += 1
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
        self._count_increment()
        return self.value

    def replaced(self, state_after: NystromState, *,
                 state_before: NystromState | None = None,
                 x: Tensor | None = None, j: int | None = None) -> float:
        import math

        if state_before is None or x is None:
            return self.resync(state_after)
        if j is None:
            m = int(state_before.kpca.m)
            j = int(np.argmin(leverage_scores(state_before)[:m].cpu()
                              .numpy()))
        net, Wjj = swap_trace_delta(state_before, j, x, self.spec,
                                    self.x_all)
        net, Wjj = torch.stack((net, Wjj)).tolist()   # one host read
        if not math.isfinite(net) or Wjj <= 0.0:
            return self.resync(state_after)
        self.value = max(self.value + net, 0.0)
        self._count_increment()
        return self.value

    def _count_increment(self) -> None:
        self._admits += 1
        if self.resync_every and self._admits >= self.resync_every:
            # The re-anchor needs the post-event state, and callers hand
            # in the pre-event one: defer it to ``maybe_resync``.
            self._admits = 0
            self._pending_resync = True

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


def consider_landmark(engine, state: NystromState, x: Tensor, *,
                      x_all: Tensor | None = None,
                      budget: int | None = None, admit_tol: float = 1e-3,
                      reg: float = 1e-6, min_rows: int = 0,
                      residual: float | None = None, m: int | None = None,
                      info: dict | None = None
                      ) -> tuple[NystromState, str]:
    """Leverage-policy admission of one candidate landmark:

    * residual δ(x) ≤ admit_tol · k(x,x): already spanned — "rejected";
    * below ``budget`` landmarks: "admitted" (bucketed add);
    * at the budget: the lowest-leverage landmark is swapped out if its
      leverage is below the candidate's normalised residual — "replaced"
      (``info["victim"]`` receives its index) — else "rejected".

    ``engine`` is an ``engine.Engine`` (adjusted=False).  The host reads
    δ(x) (unless ``residual`` forwards it), k(x, x) and, at the budget,
    the leverage scores: three reads at most, as the reference; ``m`` is
    the host's landmark count (None reads it)."""
    M = state.kpca.L.shape[0]
    if m is None:
        m = int(state.kpca.m)
    budget = budget if budget is not None else M - 1
    dtype = state.kpca.L.dtype
    x = x.to(device=state.kpca.X.device, dtype=state.kpca.X.dtype)
    delta = (float(residual) if residual is not None
             else float(admission_residual(state, x, engine.spec)))
    k_xx = float(kf.kernel_diag(x[None].to(dtype), spec=engine.spec)[0])
    gain = delta / max(k_xx, 1e-30)
    if gain <= admit_tol:
        return state, "rejected"
    if m < budget:
        return engine.add_landmark(state, x_all, x, m=m,
                                   min_rows=min_rows), "admitted"
    lev = leverage_scores(state, reg=reg)[:m].cpu().numpy()
    victim = int(np.argmin(lev))
    if float(lev[victim]) < gain:
        if info is not None:
            info["victim"] = victim
        return engine.replace_landmark(state, x_all, victim, x, m=m,
                                       min_rows=min_rows), "replaced"
    return state, "rejected"


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


def publish_features(state: NystromState, n: int, *, generation: int = 0):
    """Freeze the out-of-sample feature head (``query_features``) into a
    ``serving.ServingSnapshot``: S = sqrt(m/n)·U·λ⁺ over all M columns,
    computed once at publication, so serving-time Nyström features are
    snapshot queries against the frozen landmark set."""
    from repro_torch.core import serving

    st = state.kpca
    mask = rankone.active_mask(st.L.shape[0], st.m)
    mf = st.m.to(st.L.dtype)
    s_mat = (torch.sqrt(mf / n)
             * (st.U * _pinv_lam(st.L, mask)[None, :])).to(st.X.dtype)
    return serving.ServingSnapshot(
        S=s_mat, X=st.X, m=st.m, affine=None,
        generation=torch.tensor(generation, dtype=torch.int32))


def snapshot_features(snap, xq: Tensor, spec: kf.KernelSpec, *,
                      plan: eng.UpdatePlan | None = None) -> Tensor:
    """Nyström eigenvector rows at query points from a published snapshot
    ((nq, d) -> (nq, M); columns >= m are zero)."""
    from repro_torch.core import serving

    return serving.query(snap, xq, spec=spec, plan=plan)


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
