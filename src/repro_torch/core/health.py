"""Self-healing layer: health probes, input quarantine, heal ladder.

The rank-one updates (paper Algorithms 1–2) are exact in theory but add
rounding error over an unbounded stream, and one non-finite input poisons
U for good.  This module gives every stream three things.

**Probes** (``probe``): a sampled orthogonality residual over B rotating
active columns (O(M·B)), and the spectrum's negativity and finiteness, as
device tensors.  A ``HealthState`` of 0-d tensors rides the stream; a
guarded step refreshes it after its update with no read to the host.  The
columns rotate with the probe count, so a drifting column is caught within
⌈m/B⌉ probes.

**Quarantine** (``_gate`` in the guarded steps): a non-finite point (or,
optionally, a point whose kernel row carries almost no mass) is rejected
before the rank-one pairs fire.  The update runs all the same, on a
finite stand-in (the stored row X[0]), and a ``torch.where`` select at
full capacity discards it: a rejected point returns the prior state bit
for bit, and the kernels launch the same way whatever the verdict.

**The heal ladder** (``heal_kpca`` / ``Engine.heal``):

    polish   QR re-orthonormalisation of U; eigenvalues untouched.  Keeps
             the padding invariants (active columns vanish on rows ≥ m).
    resync   re-diagonalise from the stored points, as ``inkpca.init_state``
             does (gram, optional centering, eigh), and rebuild S and K1.
    restore  the stored points are corrupt: raise ``HealthError`` so the
             caller reloads the last checkpoint (``checkpoint.npz_store``).

``level="auto"`` takes the cheapest rung that the exact residual (a host
read, O(M³), at heal time only) says will restore health.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import engine as eng
from repro_torch.core import kernels_fn as kf
from repro_torch.core import rankone
from repro_torch.core.rankone import index_set

Tensor = torch.Tensor


class HealthError(RuntimeError):
    """In-place healing cannot proceed: the stored points are corrupt, so
    the only exact recovery is the last good checkpoint."""


class HealthPolicy(NamedTuple):
    """Health configuration, carried as ``UpdatePlan.health`` (fields and
    defaults as in the reference).

    probe_cols:  columns sampled per orthogonality probe (B)
    orth_tol:    healthy threshold on max_j ‖(UᵀU − I) e_j‖₂ over the probed
                 columns
    neg_tol:     relative negativity threshold: min(L) < −neg_tol·max|L|
                 flags corruption (a centered f32 gram carries small
                 negatives, up to ~2e-3·max|L|, when healthy)
    quarantine:  reject non-finite inputs
    outlier_tol: reject a point whose masked kernel row has
                 max_i |a_i| < outlier_tol·k(x, x); 0 disables
    polish_max:  largest exact residual ``heal(level='auto')`` still hands
                 to the polish rung
    drift_tol:   spectral drift that triggers a republish
    """

    probe_cols: int = 8
    orth_tol: float = 1e-3
    neg_tol: float = 1e-2
    quarantine: bool = True
    outlier_tol: float = 0.0
    polish_max: float = 1e-2
    drift_tol: float = 0.05


DEFAULT_POLICY = HealthPolicy()


class HealthState(NamedTuple):
    """Probe results and quarantine counters, 0-d tensors on the stream's
    device (reading them is the caller's sync).

    orth_err:      last sampled orthogonality residual
    neg_frac:      max(0, −min L)/max|L| over the active spectrum
    nonfinite:     sticky: 1 once a probe saw a non-finite entry
    quarantined:   points rejected by the gate so far
    rejected_last: 1 iff the most recent offered point was rejected
    probes:        probe counter (drives the column rotation)
    spec_drift:    relative top-C spectral drift against the last
                   published spectrum; −1 before one is folded in
    """

    orth_err: Tensor
    neg_frac: Tensor
    nonfinite: Tensor
    quarantined: Tensor
    rejected_last: Tensor
    probes: Tensor
    spec_drift: Tensor


def init_health(dtype=torch.float32, device=None) -> HealthState:
    z = torch.zeros((), dtype=dtype, device=device)
    zi = torch.zeros((), dtype=torch.int32, device=device)
    return HealthState(orth_err=z, neg_frac=z.clone(), nonfinite=zi,
                       quarantined=zi.clone(), rejected_last=zi.clone(),
                       probes=zi.clone(),
                       spec_drift=torch.full((), -1.0, dtype=dtype,
                                             device=device))


# ------------------------------------------------------------- probes --
def top_spectrum(state, C: int) -> Tensor:
    """Descending top-C active eigenvalues, zero past m."""
    M = state.L.shape[0]
    mask = rankone.active_mask(M, state.m)
    order = torch.argsort(torch.where(mask, -state.L, torch.inf),
                          stable=True)
    lam = state.L[order[:C]]
    return torch.where(torch.arange(C, device=lam.device) < state.m, lam,
                       0.0)


def spectral_drift(state, ref_lam: Tensor) -> Tensor:
    """Relative L2 distance of the top-C spectrum from a frozen one."""
    cur = top_spectrum(state, ref_lam.shape[0])
    tiny = torch.finfo(cur.dtype).tiny
    return (torch.linalg.vector_norm(cur - ref_lam)
            / torch.clamp_min(torch.linalg.vector_norm(ref_lam), tiny))


def probe(state, hstate: HealthState, policy: HealthPolicy,
          ref_lam: Tensor | None = None) -> HealthState:
    """One health probe of an (L, U, m) state: B rotating active columns
    checked for orthogonality against the whole basis (which also catches
    mass on an inactive row), and the active spectrum for negativity and
    non-finite entries.  Device tensors in and out, no host read."""
    L, U, m = state.L, state.U, state.m
    M = L.shape[0]
    dtype = L.dtype
    B = max(1, min(int(policy.probe_cols), M))
    mm = torch.clamp_min(m, 1)
    idx = (hstate.probes * B
           + torch.arange(B, dtype=torch.int32, device=L.device)) % mm
    cols = U.index_select(1, idx.long())                     # (M, B)
    # (UᵀU − I) e_j for the probed columns; the identity's columns by a
    # comparison (one_hot would read its indices' range back).
    eye = torch.arange(M, device=L.device)[:, None] == idx[None, :]
    E = U.T @ cols - eye.to(dtype)
    orth = torch.sqrt(torch.max(torch.sum(E * E, dim=0)))
    act = rankone.active_mask(M, m)
    Lact = torch.where(act, L, 0.0)
    lmax = torch.max(torch.abs(Lact))
    tiny = torch.finfo(dtype).tiny
    neg = torch.clamp_min(-torch.min(Lact), 0.0) / torch.clamp_min(lmax,
                                                                   tiny)
    finite = (torch.isfinite(Lact).all() & torch.isfinite(cols).all()
              & torch.isfinite(orth))
    drift = (spectral_drift(state, ref_lam) if ref_lam is not None
             else hstate.spec_drift)
    return hstate._replace(
        orth_err=orth.to(dtype), neg_frac=neg.to(dtype),
        nonfinite=torch.maximum(hstate.nonfinite,
                                (~finite).to(torch.int32)),
        probes=hstate.probes + 1, spec_drift=drift.to(dtype))


def verdict(hstate: HealthState, policy: HealthPolicy) -> Tensor:
    """Healthy/unhealthy as a 0-d bool tensor, from the last probe."""
    return ((hstate.nonfinite == 0) & (hstate.orth_err <= policy.orth_tol)
            & (hstate.neg_frac <= policy.neg_tol))


def is_healthy(hstate: HealthState, policy: HealthPolicy) -> bool:
    """``verdict`` read on the host (one sync)."""
    return bool(verdict(hstate, policy))


def _leading(state, Mb: int):
    """The leading Mb×Mb block as views (no copy), for reading."""
    if Mb >= state.L.shape[0]:
        return state
    return state._replace(L=state.L[:Mb], U=state.U[:Mb, :Mb])


# -------------------------------------------------------- input gate --
def _gate(sub, x_new: Tensor, spec: kf.KernelSpec, policy: HealthPolicy
          ) -> tuple[Tensor, Tensor]:
    """Quarantine decision and stand-in for one offered point: ``(ok,
    x_safe)``, ``ok`` a 0-d bool tensor, ``x_safe`` the point when
    accepted and the stored row X[0] when rejected (a finite point of the
    stream, so the update that runs regardless cannot overflow)."""
    x_new = x_new.to(sub.X.dtype)
    if not policy.quarantine:
        return torch.ones((), dtype=torch.bool, device=x_new.device), x_new
    ok = torch.isfinite(x_new).all()
    stand_in = sub.X[0]
    if policy.outlier_tol > 0.0:
        a, k_new = eng.masked_row(sub, torch.where(ok, x_new, stand_in),
                                  spec)
        amax = torch.max(torch.abs(a))
        ok = ok & ((amax >= policy.outlier_tol * k_new) | (sub.m == 0))
    return ok, torch.where(ok, x_new, stand_in)


def _note_gate(hstate: HealthState, ok: Tensor) -> HealthState:
    rej = (~ok).to(torch.int32)
    return hstate._replace(quarantined=hstate.quarantined + rej,
                           rejected_last=rej)


def _select(ok: Tensor, new, old):
    """Leaf-wise ``torch.where(ok, new, old)``: bit for bit ``old`` where
    ``ok`` is false."""
    return type(old)(*(torch.where(ok, n, o) for n, o in zip(new, old)))


def always_accepts(policy: HealthPolicy) -> bool:
    """The gate cannot reject: no quarantine, so no outlier test either."""
    return not policy.quarantine


# ------------------------------------------------- guarded steps --
def guarded_update(engine, full, hstate: HealthState, x_new: Tensor, *,
                   Mb: int):
    """slice → gate → ingest → scatter → full-capacity select → probe.
    The select runs on the whole state, so a rejected point returns the
    caller's state bit for bit under bucketed dispatch too."""
    policy = engine.plan.health
    M = full.L.shape[0]
    sub = eng.slice_state(full, Mb) if Mb < M else full
    ok, x_safe = _gate(sub, x_new, engine.spec, policy)
    new = eng._ingest(sub, x_safe, engine.spec, engine.adjusted, engine.plan)
    out = eng.scatter_state(full, new) if Mb < M else new
    out = _select(ok, out, full)
    h = probe(_leading(out, Mb), _note_gate(hstate, ok), policy)
    return out, h


def guarded_grow_step(engine, wstate, hstate: HealthState, x_new: Tensor, *,
                      Mb: int):
    """One guarded append-only window step: the arrival stamp and the
    clock advance only for an accepted point, so a rejection leaves the
    ring, the ages and the clock untouched."""
    from repro_torch.core import window as wnd

    kpca, h = guarded_update(engine, wstate.kpca, hstate, x_new, Mb=Mb)
    ok = h.rejected_last == 0
    ages = torch.where(ok, index_set(wstate.ages, wstate.kpca.m,
                                     wstate.clock), wstate.ages)
    clock = torch.where(ok, wstate.clock + 1, wstate.clock)
    return wnd.WindowState(kpca=kpca, ages=ages, clock=clock), h


def guarded_window_step(engine, wstate, hstate: HealthState, x_new: Tensor,
                        *, window: int, min_rows: int = 0):
    """One guarded steady-state window step (m = W): evict the oldest point
    and ingest, on the stand-in if the gate rejects, then select the
    eigensystem, the ages and the clock, so a rejected point leaves all
    three as they were."""
    from repro_torch.core import window as wnd

    policy = engine.plan.health
    ok, x_safe = _gate(wstate.kpca, x_new, engine.spec, policy)
    new = engine._window_point(wstate, x_safe, window=window, m=window,
                               min_rows=min_rows)
    out = wnd.WindowState(kpca=_select(ok, new.kpca, wstate.kpca),
                          ages=torch.where(ok, new.ages, wstate.ages),
                          clock=torch.where(ok, new.clock, wstate.clock))
    Mb = engine._bucket(out.kpca.L.shape[0], window, min_rows)
    h = probe(_leading(out.kpca, Mb), _note_gate(hstate, ok), policy)
    return out, h


# --------------------------------------------------------- heal ladder --
def exact_orth_residual(state) -> float:
    """Exact max_j ‖(UᵀU − I) e_j‖₂ over all M columns, read on the host
    (O(M³): heal time only); +inf when U holds a non-finite entry."""
    U = state.U
    if not bool(torch.isfinite(U).all()):
        return float("inf")
    M = U.shape[0]
    E = U.T @ U - torch.eye(M, dtype=U.dtype, device=U.device)
    return float(torch.sqrt(torch.max(torch.sum(E * E, dim=0))))


def polish(state):
    """Cheapest rung: QR re-orthonormalisation of U, eigenvalues untouched,
    signs fixed so Q stays aligned with U column for column."""
    Q, R = torch.linalg.qr(state.U)
    s = torch.sign(torch.diagonal(R))
    s = torch.where(s == 0, 1.0, s)
    return state._replace(U=Q * s[None, :])


def _check_stored(state, m: int) -> None:
    if not bool(torch.isfinite(state.X[:m]).all()):
        raise HealthError("stored points are non-finite — in-place resync "
                          "impossible; restore from the last checkpoint")


def resync(state, spec: kf.KernelSpec, adjusted: bool):
    """Exact rung: re-diagonalise from the stored active points as
    ``inkpca.init_state`` does (gram of X[:m], optional centering, eigh)
    and rebuild S and K1.  Raises ``HealthError`` on corrupt points."""
    m = int(state.m)
    M = state.L.shape[0]
    dtype, dev = state.L.dtype, state.L.device
    _check_stored(state, m)
    Xa = state.X[:m]
    K0 = kf.gram_block(Xa, Xa, spec=spec)
    S = torch.sum(K0)
    K1 = torch.sum(K0, dim=1)
    Keff = kf.center_gram(K0) if adjusted else K0
    lam, vec = torch.linalg.eigh(Keff)
    L = torch.zeros((M,), dtype=dtype, device=dev)
    L[:m] = lam.to(dtype)
    U = torch.eye(M, dtype=dtype, device=dev)
    U[:m, :m] = vec.to(dtype)
    L = rankone.sentinelize(L, state.m, L.new_zeros(()))
    K1p = torch.zeros((M,), dtype=dtype, device=dev)
    K1p[:m] = K1.to(dtype)
    return state._replace(L=L, U=U, S=S.to(dtype), K1=K1p)


def heal_kpca(state, spec: kf.KernelSpec, adjusted: bool,
              policy: HealthPolicy = DEFAULT_POLICY, *,
              level: str = "auto", rung_out: list | None = None):
    """Walk the ladder on one ``KPCAState``.

    ``level`` "polish" | "resync" forces a rung; "auto" measures the exact
    residual and takes the cheapest rung that restores health: no-op when
    healthy, polish for a small loss of orthogonality, resync when the
    eigenvalues are implicated or the residual is past
    ``policy.polish_max``.  Non-finite stored points raise ``HealthError``
    from every rung.  The rung taken ("noop" | "polish" | "resync") is
    appended to ``rung_out`` when given.
    """
    def took(rung: str):
        if rung_out is not None:
            rung_out.append(rung)

    m = int(state.m)
    _check_stored(state, m)
    if level == "polish":
        took("polish")
        return polish(state)
    if level == "resync":
        took("resync")
        return resync(state, spec, adjusted)
    if level != "auto":
        raise ValueError(f"unknown heal level {level!r}")
    M = state.L.shape[0]
    Lact = torch.where(rankone.active_mask(M, state.m), state.L, 0.0)
    lmax = float(torch.max(torch.abs(Lact)))
    eig_ok = (bool(torch.isfinite(Lact).all())
              and float(-torch.min(Lact)) <= policy.neg_tol * max(lmax,
                                                                  1e-30))
    r = exact_orth_residual(state)
    if eig_ok and r <= policy.orth_tol:
        took("noop")
        return state
    if eig_ok and r <= policy.polish_max:
        polished = polish(state)
        if exact_orth_residual(polished) <= policy.orth_tol:
            took("polish")
            return polished
    took("resync")
    return resync(state, spec, adjusted)
