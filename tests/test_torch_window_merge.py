"""Witness: what carries the f32 sliding window's extra eigenvalue error.

An f32 window's top eigenvalues drift from eigh of its points once the
window is full, far beyond the append-only level.  The rank-one update's
cluster merge (``rankone._cluster_merge``) joins poles closer than
64·eps·(‖A‖ + |σ|‖z‖²), with eps the state type's, and moves the joined
eigenvalues by up to that tolerance.  In the steady state it fires in the
downdate's inverse pairs and in the ingest's pairs far more often than
while the window grows.  With the tolerance at the solve type's eps (f64,
the only change) no merge fires, and the error stays at the growth
phase's level although every eviction still runs the same downdate,
Householder contraction included.  ROADMAP.md §3 records the fault.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import batch, downdate as dd, engine as eng
from repro_torch.core import inkpca, kernels_fn as kf, rankone
from repro_torch.testing.threads import one_torch_thread  # noqa: F401

CAP, W, POINTS, DIM = 128, 100, 300, 16
EPS_RATIO = torch.finfo(torch.float64).eps / torch.finfo(torch.float32).eps


def _top8_rel_err(stream, spec) -> float:
    st = stream.kpca_state
    m = int(st.m)
    X = st.X[:m].double()
    lam_ref, _ = batch.batch_kpca(kf.gram_block(X, X, spec=spec),
                                  adjusted=True)
    lam_ref = lam_ref.flip(0)[:8]
    lam = eng.eigpairs(st)[0][:8].double()
    return float(((lam - lam_ref).abs() / lam_ref.abs()).max())


def _stream(monkeypatch, tol_scale: float):
    """The f32 ``pallas`` window service at CAP/W on the CPU, the merge's
    tolerance scaled by ``tol_scale``: (error when the window first fills,
    final error, merges fired by phase, ‖UᵀU − I‖max at the end)."""
    fired = {"growth": 0, "steady_ingest": 0, "steady_downdate": 0}
    phase = ["growth"]
    merge, downdate = rankone._cluster_merge, dd.downdate

    def counted_merge(d, z, tol):
        out = merge(d, z, tol * tol_scale)
        fired[phase[0]] += int(out[2])
        return out

    def marked_downdate(*args, **kw):
        phase[0] = "steady_downdate"
        try:
            return downdate(*args, **kw)
        finally:
            phase[0] = "steady_ingest"

    monkeypatch.setattr(rankone, "_cluster_merge", counted_merge)
    monkeypatch.setattr(dd, "downdate", marked_downdate)
    rng = np.random.default_rng(0)
    spec = kf.KernelSpec(name="rbf", sigma=float(DIM))
    plan = eng.UpdatePlan(matmul="pallas", dispatch="bucketed", window=W,
                          fuse_krow=True)
    assert plan.precise       # the secular solves run in f64
    s = inkpca.KPCAStream(torch.tensor(rng.normal(size=(4, DIM)),
                                       dtype=torch.float32),
                          CAP, spec, adjusted=True, plan=plan,
                          dtype=torch.float32, device="cpu")
    at_full = None
    for _ in range(POINTS):
        phase[0] = "steady_ingest" if s.m >= W else "growth"
        s.update(torch.tensor(rng.normal(size=(DIM,)), dtype=torch.float32))
        if at_full is None and s.m == W:
            at_full = _top8_rel_err(s, spec)
    U = s.kpca_state.U[:W, :W].double()
    orth = float((U.T @ U - torch.eye(W, dtype=torch.float64)).abs().max())
    return at_full, _top8_rel_err(s, spec), fired, orth


@pytest.mark.parametrize("tol_eps", ["state_f32", "solve_f64"])
def test_f32_window_error_is_carried_by_cluster_merges(monkeypatch,
                                                       tol_eps):
    at_full, final, fired, orth = _stream(
        monkeypatch, 1.0 if tol_eps == "state_f32" else EPS_RATIO)
    steps = POINTS - (W - 4)
    assert at_full < 2e-6                        # growth: append-only level
    assert orth < 2e-5               # U orthogonal to f32 rounding either way
    if tol_eps == "state_f32":
        # The merge fires on more than a quarter of the steady steps in
        # each stage, against a few times in all while the window grew ...
        assert fired["growth"] <= 10
        assert fired["steady_downdate"] > steps / 4
        assert fired["steady_ingest"] > steps / 4
        # ... and the error climbs to several times the growth level.
        assert final > 4 * at_full
    else:
        assert sum(fired.values()) == 0
        assert final < 2 * at_full
