"""The port's self-healing layer (``core/health.py``, the engine's gate
stage) against the reference's, on the same numpy states and points.

Both packages take the same f64 states through ``convert`` (capacity
32–64, d = 8) and the same points.  The probe fields are held to 1e-12,
guarded streams to the streams' 1e-9 (eigenvalues and reconstruction),
the heal ladder to the rung the reference takes on the same corrupted
state.  Rejected points leave the port's state bit for bit.  The
reference streams point by point at one bucket shape (fixed dispatch).
"""
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng, health as jhl  # noqa: E402
from repro.core import inkpca as jink, kernels_fn as jkf  # noqa: E402
from repro.core import rankone as jrk  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch.core import batch as tbatch, convert  # noqa: E402
from repro_torch.core import engine as teng, health as thl  # noqa: E402
from repro_torch.core import inkpca as tink, kernels_fn as tkf  # noqa: E402
from repro_torch.core import nystrom as tny, rankone as trk  # noqa: E402
from repro_torch.core import window as twnd  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

SIGMA = 4.0
JSPEC, TSPEC = jkf.KernelSpec(sigma=SIGMA), tkf.KernelSpec(sigma=SIGMA)
D = 8
HPLAN = dict(health=thl.DEFAULT_POLICY)


def _data(n=40, seed=0):
    return np.random.default_rng(seed).normal(size=(n, D))


@lru_cache(maxsize=None)
def _port_state(n, seed, capacity=32):
    """A streamed state of ``n`` points (read only: the corruptors and
    the heal ladder work out of place)."""
    X = _data(n, seed)
    s = tink.KPCAStream(torch.tensor(X[:4]), capacity, TSPEC,
                        dtype=torch.float64, device="cpu")
    s.update_block(torch.tensor(X[4:]))
    return s.kpca_state


def _jax_state(tstate):
    return jink.KPCAState(**{k: jnp.asarray(v) for k, v in
                             convert.state_to_numpy(tstate).items()})


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _same_kpca(tk, jk, atol=1e-9):
    m = int(jk.m)
    assert int(tk.m) == m
    np.testing.assert_allclose(tk.L.numpy()[:m], np.asarray(jk.L)[:m],
                               atol=atol)
    np.testing.assert_allclose(trk.reconstruct(tk.L, tk.U, tk.m).numpy(),
                               np.asarray(jrk.reconstruct(jk.L, jk.U, jk.m)),
                               atol=atol)
    np.testing.assert_array_equal(tk.X.numpy(), np.asarray(jk.X))


def _corrupted(kind, tst):
    """The same corruption of one state in both packages."""
    jst = _jax_state(tst)
    if kind == "none":
        return tst, jst
    if kind == "eigvecs":
        return (faults.corrupt_eigvecs(tst, magnitude=0.3, seed=1),
                jfaults.corrupt_eigvecs(jst, magnitude=0.3, seed=1))
    if kind == "eigenvalue":
        return (faults.corrupt_eigenvalue(tst, j=0, value=-1.0),
                jfaults.corrupt_eigenvalue(jst, j=0, value=-1.0))
    if kind == "support":
        m = int(tst.m)
        U = tst.U.clone()
        U[m - 1, 0] += 0.5
        return tst._replace(U=U), jst._replace(U=jst.U.at[m - 1, 0].add(0.5))
    assert kind == "bitflip"
    return (faults.bitflip_eigvec(tst, 1, 2, bit=62),
            jfaults.bitflip_eigvec(jst, 1, 2, bit=62))


# ------------------------------------------------------------- probes --
@pytest.mark.parametrize("kind", ["none", "eigvecs", "eigenvalue", "support",
                                  "bitflip"])
def test_probe_fields_match_reference(kind):
    """Five rotating probes of the same (corrupted) state, with a frozen
    reference spectrum on the last: every field within 1e-12."""
    tst, jst = _corrupted(kind, _port_state(30, 0))
    th = thl.init_health(torch.float64)
    jh = jhl.init_health(jnp.float64)
    ref = np.array([9.0, 5.0, 3.0, 1.0])
    for i in range(5):
        last = i == 4
        th = thl.probe(tst, th, thl.DEFAULT_POLICY,
                       torch.tensor(ref) if last else None)
        jh = (jhl._probe_ref_jit(jst, jh, jhl.DEFAULT_POLICY,
                                 jnp.asarray(ref)) if last
              else jhl._probe_jit(jst, jh, jhl.DEFAULT_POLICY))
        for f in thl.HealthState._fields:
            np.testing.assert_allclose(float(getattr(th, f)),
                                       float(getattr(jh, f)), rtol=1e-12,
                                       atol=1e-12, err_msg=f)
    assert thl.is_healthy(th, thl.DEFAULT_POLICY) == (kind == "none")


def test_probe_rotation_catches_a_column_within_its_cycle():
    """A column outside the first probe window is caught within ⌈m/B⌉
    probes."""
    tst, _ = _corrupted("support", _port_state(30, 0))
    h = thl.init_health(torch.float64)
    seen = []
    for _ in range(-(-int(tst.m) // thl.DEFAULT_POLICY.probe_cols)):
        h = thl.probe(tst, h, thl.DEFAULT_POLICY)
        seen.append(float(h.orth_err) > 1e-2)
    assert any(seen)


# --------------------------------------------------------- quarantine --
def test_guarded_stream_with_poisoned_points_matches_reference():
    """40 points with three poisoned ones (NaN, inf, -inf) through the
    guarded stream of each package (the port on its main path: fused
    prologue, rotation kernel's plain version, bucketed; the reference
    point by point under fixed dispatch): states within 1e-9, the same
    quarantine count and probe count, probe gauges within 1e-9."""
    X = _data(44, seed=1)
    poison = {7: "nan", 19: "inf", 30: "-inf"}
    ts = tink.KPCAStream(torch.tensor(X[:4]), 64, TSPEC,
                         plan=teng.UpdatePlan(
                             matmul="pallas", fuse_krow=True,
                             dispatch="bucketed", min_bucket=16, **HPLAN),
                         dtype=torch.float64, device="cpu")
    js = jink.KPCAStream(jnp.asarray(X[:4]), 64, JSPEC,
                         plan=jeng.UpdatePlan(health=jhl.DEFAULT_POLICY),
                         dtype=jnp.float64)
    for i, x in enumerate(X[4:]):
        if i in poison:
            x = faults.nan_point(D, kind=poison[i], index=i % D, base=x)
        ts.update(x.astype(np.float64))
        js.update(jnp.asarray(x, jnp.float64))
    _same_kpca(ts.kpca_state, js.kpca_state)
    th, jh = ts.health_report(), js.health_report()
    assert th["quarantined"] == jh["quarantined"] == 3
    assert th["probes"] == jh["probes"] == 40
    for f in ("orth_err", "neg_frac"):
        assert th[f] == pytest.approx(jh[f], abs=1e-9)
    assert ts.m == 4 + 40 - 3 and ts.is_healthy()


@pytest.mark.parametrize("dispatch,window", [("fixed", None),
                                             ("bucketed", None),
                                             ("bucketed", 10)])
def test_rejected_points_leave_the_state_bit_for_bit(dispatch, window):
    """Each rejected point returns the prior state (eigensystem, ring and
    clock) bit for bit, and a guarded stream that saw poisoned points
    equals, bit for bit, the guarded stream that never saw them (the
    host's count bounds pick the same bucket for every point)."""
    X = _data(18, seed=2)
    plan = teng.UpdatePlan(matmul="pallas", fuse_krow=True,
                           dispatch=dispatch, min_bucket=8, window=window,
                           **HPLAN)

    def stream():
        return tink.KPCAStream(torch.tensor(X[:4]), 32, TSPEC, plan=plan,
                               dtype=torch.float64, device="cpu")

    a, b = stream(), stream()
    for i, x in enumerate(X[4:]):
        if i % 6 == 3:
            before = a.state
            a.update(faults.nan_point(D, kind="inf", base=x))
            assert _leaves_equal(torch.utils._pytree.tree_leaves(a.state),
                                 torch.utils._pytree.tree_leaves(before))
        a.update(x)
        b.update(x)
    assert _leaves_equal(torch.utils._pytree.tree_leaves(a.state),
                         torch.utils._pytree.tree_leaves(b.state))
    assert int(a.health.quarantined) == 2 and int(b.health.quarantined) == 0
    blk = np.array(X[:9])
    blk[4] = np.nan
    a.update_block(torch.tensor(blk))
    b.update_block(torch.tensor(np.delete(X[:9], 4, axis=0)))
    assert _leaves_equal(torch.utils._pytree.tree_leaves(a.state),
                         torch.utils._pytree.tree_leaves(b.state))
    assert a.m == b.m


def test_guarded_update_equals_unguarded_and_rejects_like_reference():
    """Engine spelling: a clean point through ``update_guarded`` equals
    ``update`` bit for bit; non-finite points of each kind tick the
    quarantine counter and leave the state untouched, as in the
    reference."""
    tst = _port_state(9, 3, capacity=16)
    engine = teng.Engine(TSPEC, teng.UpdatePlan(**HPLAN))
    plain = teng.Engine(TSPEC)
    x = torch.tensor(_data(1, seed=4)[0])
    st1, h1 = engine.update_guarded(tst, thl.init_health(torch.float64), x)
    assert _leaves_equal(st1, plain.update(tst, x))
    assert int(h1.quarantined) == 0 and int(h1.rejected_last) == 0
    st2, h2 = st1, h1
    for kind in ("nan", "inf", "-inf"):
        st2, h2 = engine.update_guarded(st2, h2, torch.tensor(
            faults.nan_point(D, kind=kind, base=x.numpy())))
        assert _leaves_equal(st2, st1)
    assert int(h2.quarantined) == 3 and int(h2.rejected_last) == 1


def test_outlier_gate_matches_reference():
    """With ``outlier_tol`` the gate of both packages rejects a far point
    (a kernel row of ~0 against the stored points) and passes a near one,
    with the same stand-in; the port's guarded update then leaves the
    state untouched for the far point and grows it for the near one."""
    pol_t = thl.HealthPolicy(outlier_tol=1e-6)
    pol_j = jhl.HealthPolicy(outlier_tol=1e-6)
    X = _data(6, seed=5)
    tspec, jspec = tkf.KernelSpec(sigma=0.5), jkf.KernelSpec(sigma=0.5)
    tst = tink.init_state(torch.tensor(X[:5]), 32, tspec, adjusted=False,
                          dtype=torch.float64)
    jst = jink.init_state(jnp.asarray(X[:5]), 32, jspec, adjusted=False,
                          dtype=jnp.float64)
    jgate = jax.jit(jhl._gate, static_argnums=(2, 3))
    for x, want in ((np.full(D, 1e3), False), (X[5], True),
                    (faults.nan_point(D), False)):
        tok, tx = thl._gate(tst, torch.tensor(x, dtype=torch.float64),
                            tspec, pol_t)
        jok, jx = jgate(jst, jnp.asarray(x, jnp.float64), jspec, pol_j)
        assert bool(tok) == bool(jok) == want
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    te = teng.Engine(tspec, teng.UpdatePlan(health=pol_t), adjusted=False)
    th = thl.init_health(torch.float64)
    st1, th = te.update_guarded(tst, th, torch.full((D,), 1e3,
                                                    dtype=torch.float64))
    assert _leaves_equal(st1, tst) and int(th.quarantined) == 1
    st2, th = te.update_guarded(st1, th, torch.tensor(X[5]))
    assert int(st2.m) == 6 and int(th.quarantined) == 1


# -------------------------------------------------------- heal ladder --
@pytest.mark.parametrize("kind,magnitude,rung", [
    ("healthy", 0.0, "noop"), ("tilt", 1e-3, "polish"),
    ("tilt", 0.5, "resync"), ("eigenvalue", 0.0, "resync")])
def test_heal_takes_the_references_rung(kind, magnitude, rung):
    """``heal_kpca(level="auto")`` on the same corrupted state takes the
    reference's rung in both packages and lands on the same state:
    polish's U within 1e-10, resync's eigenvalues and reconstruction
    within 1e-10 (both equal batch KPCA of the stored points)."""
    tst = _port_state(16, 6)
    jst = _jax_state(tst)
    if kind == "tilt":
        tst = faults.corrupt_eigvecs(tst, magnitude=magnitude, seed=7)
        jst = jfaults.corrupt_eigvecs(jst, magnitude=magnitude, seed=7)
    elif kind == "eigenvalue":
        tst = faults.corrupt_eigenvalue(tst, j=0, value=-1.0)
        jst = jfaults.corrupt_eigenvalue(jst, j=0, value=-1.0)
    t_rung, j_rung = [], []
    th = thl.heal_kpca(tst, TSPEC, True, rung_out=t_rung)
    jh = jhl.heal_kpca(jst, JSPEC, True, rung_out=j_rung)
    assert t_rung == j_rung == [rung]
    if rung == "polish":
        np.testing.assert_allclose(th.U.numpy(), np.asarray(jh.U),
                                   atol=1e-10)
    else:
        _same_kpca(th, jh, atol=1e-10)
    assert thl.exact_orth_residual(th) < 1e-9
    if rung == "resync":
        m = int(tst.m)
        K = tkf.gram_block(tst.X[:m], tst.X[:m], spec=TSPEC)
        lam, _ = tbatch.batch_kpca(K, adjusted=True)
        np.testing.assert_allclose(np.sort(th.L.numpy()[:m]), lam.numpy(),
                                   atol=1e-10)


def test_poisoned_stored_row_raises_health_error_in_both():
    tst = _port_state(10, 8)
    jst = _jax_state(tst)
    bad_t = faults.poison_stored_row(tst, row=1)
    bad_j = jfaults.poison_stored_row(jst, row=1)
    for level in ("auto", "polish", "resync"):
        with pytest.raises(thl.HealthError):
            thl.heal_kpca(bad_t, TSPEC, True, level=level)
        with pytest.raises(jhl.HealthError):
            jhl.heal_kpca(bad_j, JSPEC, True, level=level)
    with pytest.raises(thl.HealthError):
        thl.resync(bad_t, TSPEC, True)


def test_engine_heal_routes_state_kinds():
    """A KPCA state heals in place; a window keeps its ring and clock; a
    Nyström state heals its landmark eigensystem (unadjusted) and keeps
    Knm and its rows."""
    X = _data(20, seed=9)
    engine = teng.Engine(TSPEC, teng.UpdatePlan(**HPLAN))
    st = faults.corrupt_eigvecs(_port_state(20, 9), magnitude=0.5, seed=3)
    assert thl.exact_orth_residual(engine.heal(st)) < 1e-9

    ws = twnd.init_window(torch.tensor(X[:4]), 16, TSPEC,
                          dtype=torch.float64)
    ws = teng.Engine(TSPEC).window_block(ws, torch.tensor(X[4:]), window=8)
    bad = ws._replace(kpca=faults.corrupt_eigvecs(ws.kpca, magnitude=0.5,
                                                  seed=4))
    wh = engine.heal(bad)
    assert torch.equal(wh.ages, ws.ages) and torch.equal(wh.clock, ws.clock)
    assert thl.exact_orth_residual(wh.kpca) < 1e-9

    ny = tny.init_nystrom(None, torch.tensor(X[:4]), 16, TSPEC,
                          dtype=torch.float64, grow_rows=True)
    ny = ny._replace(kpca=faults.corrupt_eigvecs(ny.kpca, magnitude=0.5))
    rung = []
    nh = engine.heal(ny, rung_out=rung)
    assert rung == ["resync"] and torch.equal(nh.Knm, ny.Knm)
    lam, _ = tbatch.batch_kpca(tkf.gram_block(
        ny.kpca.X[:4], ny.kpca.X[:4], spec=TSPEC), adjusted=False)
    np.testing.assert_allclose(np.sort(nh.kpca.L.numpy()[:4]), lam.numpy(),
                               atol=1e-12)


def test_stream_heal_clears_flags_and_matches_batch():
    """A stream whose state drifted is flagged by its next probe, heals,
    and then equals batch KPCA of its points; the sticky flags clear."""
    X = _data(14, seed=10)
    s = tink.KPCAStream(torch.tensor(X[:4]), 32, TSPEC,
                        plan=teng.UpdatePlan(**HPLAN), dtype=torch.float64,
                        device="cpu")
    s.update_block(torch.tensor(X[4:12]))
    s.state = faults.corrupt_eigvecs(s.state, magnitude=0.3, seed=9)
    s.update(X[12])
    assert not s.is_healthy()
    s.heal()
    s.health = s.engine.probe(s.state, s.health)
    assert s.is_healthy() and s.health_report()["nonfinite"] == 0
    st = s.kpca_state
    K = tkf.gram_block(st.X[:s.m], st.X[:s.m], spec=TSPEC)
    lam, _ = tbatch.batch_kpca(K, adjusted=True)
    np.testing.assert_allclose(np.sort(st.L.numpy()[:s.m]), lam.numpy(),
                               atol=1e-10)


def test_window_quarantine_leaves_ring_untouched():
    """A rejected window point (growth and steady state) leaves the
    eigensystem, the ages and the clock bit for bit, in the port as in the
    reference (``window.ingest`` with ``hstate``)."""
    W = 6
    X = _data(10, seed=11)
    te = teng.Engine(TSPEC, teng.UpdatePlan(window=W, **HPLAN))
    ws = twnd.init_window(torch.tensor(X[:4]), 16, TSPEC,
                          dtype=torch.float64)
    for x in list(X[4:]) + [None]:
        out, h = twnd.ingest(te, ws, torch.tensor(faults.nan_point(D)),
                             window=W, hstate=thl.init_health(torch.float64))
        assert _leaves_equal(torch.utils._pytree.tree_leaves(out),
                             torch.utils._pytree.tree_leaves(ws))
        assert int(h.quarantined) == 1
        if x is not None:
            ws = twnd.ingest(te, ws, torch.tensor(x), window=W)
    assert int(ws.clock) == 10 and int(ws.kpca.m) == W


def test_observe_rows_quarantine_drops_nonfinite_rows():
    """Non-finite observed rows are dropped before any Knm row is built
    (as the reference's ``observe_rows`` does): the grown state equals,
    bit for bit, the state that observed only the finite rows, and a
    block of only non-finite rows returns the state itself."""
    X = _data(12, seed=12)
    xb = np.array(X[4:])
    xb[2, 0], xb[5, 3] = np.nan, np.inf
    plan = teng.UpdatePlan(**HPLAN)
    tn = tny.init_nystrom(None, torch.tensor(X[:4]), 32, TSPEC,
                          dtype=torch.float64, grow_rows=True)
    got = tny.observe_rows(tn, torch.tensor(xb), TSPEC, plan=plan)
    want = tny.observe_rows(tn, torch.tensor(np.delete(xb, [2, 5], axis=0)),
                            TSPEC)
    assert got.Knm.shape[0] == 4 + 6
    assert torch.equal(got.Knm, want.Knm) and torch.equal(got.Xrows,
                                                          want.Xrows)
    same = tny.observe_rows(got, torch.tensor(faults.nan_point(D)), TSPEC,
                            plan=plan)
    assert same is got


def test_plan_health_must_be_a_policy():
    with pytest.raises(TypeError, match="HealthPolicy"):
        teng.Engine(TSPEC, teng.UpdatePlan(health=True))
    with pytest.raises(ValueError, match="health policy"):
        teng.Engine(TSPEC).update_guarded(
            _port_state(6, 0), thl.init_health(torch.float64),
            torch.zeros(D, dtype=torch.float64))
