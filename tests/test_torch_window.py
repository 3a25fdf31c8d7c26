"""The port's sliding-window streams (``core/window.py``, the engine's
evict stage, ``KPCAStream(window=W)``) against the reference's, on the same
numpy inputs.

Both packages stream the same f64 points under the same plan; the port is
held to the reference (eigenvalues and reconstruction atol 1e-9, the
arrival ring exactly) and to batch KPCA of the trailing window
(``tests/test_window.py``'s 1e-9).  The reference runs its jnp oracles
(``REPRO_PALLAS_FORCE=ref``), the port its plain kernel versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng, inkpca as jink  # noqa: E402
from repro.core import kernels_fn as jkf, rankone as jrk  # noqa: E402
from repro.core import window as jwnd  # noqa: E402
from repro_torch.core import convert, engine as teng  # noqa: E402
from repro_torch.core import inkpca as tink  # noqa: E402
from repro_torch.core import kernels_fn as tkf, rankone as trk  # noqa: E402
from repro_torch.core import window as twnd  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

SIGMA = 5.0
JSPEC, TSPEC = jkf.KernelSpec(sigma=SIGMA), tkf.KernelSpec(sigma=SIGMA)


def _streams(X0, capacity, **kw):
    js = jink.KPCAStream(jnp.asarray(X0), capacity, JSPEC,
                         dtype=jnp.float64, **kw)
    ts = tink.KPCAStream(torch.tensor(X0), capacity, TSPEC,
                         dtype=torch.float64, device="cpu", **kw)
    return js, ts


def _same(tw, jw, atol=1e-9):
    """Port window state against the reference's: the eigensystem, the
    stored rows and the arrival ring (exactly)."""
    _same_kpca(tw.kpca, jw.kpca, atol)
    np.testing.assert_array_equal(tw.ages.numpy(), np.asarray(jw.ages))
    assert int(tw.clock) == int(jw.clock)


def _same_kpca(tk, jk, atol=1e-9):
    m = int(jk.m)
    assert int(tk.m) == m
    np.testing.assert_allclose(tk.L.numpy()[:m], np.asarray(jk.L)[:m],
                               atol=atol)
    np.testing.assert_allclose(trk.reconstruct(tk.L, tk.U, tk.m).numpy(),
                               np.asarray(jrk.reconstruct(jk.L, jk.U, jk.m)),
                               atol=atol)
    np.testing.assert_array_equal(tk.X.numpy(), np.asarray(jk.X))


def _batch_eff(X, adjusted):
    K = tkf.gram_block(torch.tensor(X), torch.tensor(X), spec=TSPEC)
    return (tkf.center_gram(K) if adjusted else K).numpy()


@pytest.mark.parametrize("adjusted", [False, True])
@pytest.mark.parametrize("dispatch", ["fixed", "bucketed"])
def test_windowed_stream_matches_trailing_batch(adjusted, dispatch):
    """After every point the port's windowed state is the reference's and
    batch KPCA of the trailing W points; its rows are those points in
    arrival order and its ages consecutive stamps."""
    X = np.random.default_rng(3).normal(size=(26, 4))
    W = 8
    js, ts = _streams(X[:4], 16, adjusted=adjusted, dispatch=dispatch,
                      min_bucket=8, window=W)
    for i in range(4, 26):
        js.update(jnp.asarray(X[i]))
        ts.update(torch.tensor(X[i]))
        _same(ts.state, js.state)
        st, m = ts.kpca_state, ts.m
        assert int(st.m) == m == min(i + 1, W)
        rec = trk.reconstruct(st.L, st.U, st.m).numpy()[:m, :m]
        np.testing.assert_allclose(rec, _batch_eff(X[i + 1 - m:i + 1],
                                                   adjusted), atol=1e-9)
    np.testing.assert_array_equal(ts.kpca_state.X.numpy()[:W], X[26 - W:])
    np.testing.assert_array_equal(ts.state.ages.numpy()[:W],
                                  np.arange(26 - W, 26))
    assert twnd.oldest_row(ts.state) == jwnd.oldest_row(js.state) == 0


@pytest.mark.parametrize("window", [None, 10])
def test_stream_downdate_matches_reference(window):
    """``KPCAStream.downdate(i)`` removes physical row i — through the
    window's ``evict`` when windowed — as the reference's does, and the
    stream goes on from there."""
    X = np.random.default_rng(13).normal(size=(16, 4))
    js, ts = _streams(X[:4], 16, dispatch="bucketed", min_bucket=8,
                      window=window)
    for x in X[4:12]:
        js.update(jnp.asarray(x))
        ts.update(torch.tensor(x))
    js.downdate(3)
    ts.downdate(3)
    for x in X[12:]:
        js.update(jnp.asarray(x))
        ts.update(torch.tensor(x))
    if window is None:
        _same_kpca(ts.state, js.state)
    else:
        _same(ts.state, js.state)
    assert ts.m == int(ts.kpca_state.m) == (10 if window else 15)


@pytest.mark.parametrize("adjusted", [False, True])
@pytest.mark.parametrize("dispatch", ["fixed", "bucketed"])
def test_window_block_matches_pointwise_every_step(adjusted, dispatch):
    """``update_block`` (a loop over ``Engine.step`` with the active count
    tracked on the host) equals the port's point-wise loop (1e-10, ring
    exactly) and the reference's block, over cuts that cover growth only,
    the growth→steady transition and steady state."""
    X = np.random.default_rng(61).normal(size=(40, 4))
    kw = dict(adjusted=adjusted, dispatch=dispatch, min_bucket=8, window=8)
    jblk, ref = _streams(X[:4], 16, **kw)
    _, blk = _streams(X[:4], 16, **kw)
    i = 4
    for cut in (7, 13, 25, 40):
        for t in range(i, cut):
            ref.update(torch.tensor(X[t]))
        blk.partial_fit_block(torch.tensor(X[i:cut]))
        jblk.partial_fit_block(jnp.asarray(X[i:cut]))
        i = cut
        a, b = ref.state, blk.state
        assert blk.m == ref.m == int(b.kpca.m)
        np.testing.assert_allclose(b.kpca.L.numpy(), a.kpca.L.numpy(),
                                   atol=1e-10)
        np.testing.assert_allclose(
            trk.reconstruct(b.kpca.L, b.kpca.U, b.kpca.m).numpy(),
            trk.reconstruct(a.kpca.L, a.kpca.U, a.kpca.m).numpy(),
            atol=1e-10)
        np.testing.assert_array_equal(b.ages.numpy(), a.ages.numpy())
        assert int(b.clock) == int(a.clock)
        _same(b, jblk.state)


def test_engine_window_step_matches_ingest():
    """``Engine.window_step`` equals ``window.ingest`` (and the
    reference's ``window.ingest``) below and at a full window."""
    X = np.random.default_rng(71).normal(size=(20, 3))
    plan = dict(dispatch="bucketed", min_bucket=8)
    je = jeng.Engine(JSPEC, jeng.UpdatePlan(**plan), adjusted=True)
    te = teng.Engine(TSPEC, teng.UpdatePlan(**plan), adjusted=True)
    jw = jwnd.init_window(jnp.asarray(X[:4]), 16, JSPEC, adjusted=True,
                          dtype=jnp.float64)
    ta = tb = twnd.init_window(torch.tensor(X[:4]), 16, TSPEC, adjusted=True,
                               dtype=torch.float64)
    for t in range(4, 20):
        jw = jwnd.ingest(je, jw, jnp.asarray(X[t]), window=6)
        ta = twnd.ingest(te, ta, torch.tensor(X[t]), window=6)
        tb = te.window_step(tb, torch.tensor(X[t]), window=6)
        np.testing.assert_allclose(tb.kpca.L.numpy(), ta.kpca.L.numpy(),
                                   atol=1e-10)
        np.testing.assert_array_equal(tb.ages.numpy(), ta.ages.numpy())
        _same(ta, jw)


def test_rebase_ages_preserves_eviction_order():
    """A clock at the sentinel's edge rebases; the port's ring after the
    rebase is the reference's, and the stream keeps matching the trailing
    batch window."""
    rng = np.random.default_rng(25)
    X = rng.normal(size=(16, 3))
    js, ts = _streams(X[:4], 8, adjusted=False, window=6)
    for x in X[4:12]:
        js.update(jnp.asarray(x))
        ts.update(torch.tensor(x))
    sent = twnd.age_sentinel()
    assert sent == jwnd.age_sentinel(js.state.ages.dtype)
    shift = (sent - 1) - int(ts.state.clock)
    st, jst = ts.state, js.state
    ts.state = st._replace(ages=torch.where(st.ages == sent, sent,
                                            st.ages + shift),
                           clock=st.clock + shift)
    js.state = jst._replace(ages=jnp.where(jst.ages == sent, sent,
                                           jst.ages + shift),
                            clock=jst.clock + shift)
    js.update(jnp.asarray(X[12]))
    ts.update(torch.tensor(X[12]))
    assert int(ts.state.clock) < sent // 2 and ts.m == 6
    _same(ts.state, js.state)
    order = np.argsort(ts.state.ages.numpy()[:6])
    np.testing.assert_array_equal(order, np.arange(6))
    for x in X[13:]:
        ts.update(torch.tensor(x))
    st = ts.kpca_state
    rec = trk.reconstruct(st.L, st.U, st.m).numpy()[:6, :6]
    np.testing.assert_allclose(rec, _batch_eff(st.X.numpy()[:6], False),
                               atol=1e-9)


def test_window_validation():
    x0 = np.random.default_rng(0).normal(size=(4, 3))
    for window in (1, 32, 3):          # too small, past capacity, < seed
        with pytest.raises(ValueError):
            tink.KPCAStream(x0, 16, TSPEC, window=window, device="cpu")
    stream = tink.KPCAStream(x0, 16, TSPEC, window=8, device="cpu")
    with pytest.raises(ValueError, match="windowed"):
        stream.truncate(4)
    plain = tink.KPCAStream(x0, 16, TSPEC, device="cpu")
    assert int(plain.truncate(2).m) == 2 == plain.m
    with pytest.raises(ValueError, match="window size"):
        teng.Engine(TSPEC).step(teng.make_stream(stream.state),
                                torch.zeros(3))


def test_plan_window_field_drives_stream():
    """``UpdatePlan.window`` is the plan's spelling of the same mode, in
    both packages."""
    x0 = np.random.default_rng(0).normal(size=(4, 3))
    for make, plan in (
            (lambda p: jink.KPCAStream(jnp.asarray(x0), 16, JSPEC, plan=p),
             jeng.UpdatePlan(window=8)),
            (lambda p: tink.KPCAStream(x0, 16, TSPEC, plan=p, device="cpu"),
             teng.UpdatePlan(window=8))):
        s = make(plan)
        assert s.window == 8 and hasattr(s.state, "ages")
        assert s.kpca_state is s.state.kpca
    plain = tink.KPCAStream(x0, 16, TSPEC, device="cpu")
    assert plain.window is None and plain.kpca_state is plain.state


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("matmul", ["jnp", "pallas2"])
def test_engine_step_drives_both_packages_with_one_plan(windowed, matmul):
    """One plan object (the reference's ``UpdatePlan``) drives both
    packages' ``Engine.step(make_stream(...))``, append-only and
    windowed, and the two bundles stay equal."""
    X = np.random.default_rng(7).normal(size=(20, 4))
    plan = jeng.UpdatePlan(matmul=matmul, dispatch="bucketed", min_bucket=8,
                           window=6 if windowed else None)
    je = jeng.Engine(JSPEC, plan, adjusted=True)
    te = teng.Engine(TSPEC, plan, adjusted=True)
    if windowed:
        js = jeng.make_stream(jwnd.init_window(
            jnp.asarray(X[:4]), 16, JSPEC, dtype=jnp.float64))
        ts = teng.make_stream(twnd.init_window(
            torch.tensor(X[:4]), 16, TSPEC, dtype=torch.float64))
    else:
        js = jeng.make_stream(jink.init_state(
            jnp.asarray(X[:4]), 32, JSPEC, adjusted=True, dtype=jnp.float64))
        ts = teng.make_stream(tink.init_state(
            torch.tensor(X[:4]), 32, TSPEC, adjusted=True,
            dtype=torch.float64))
    for x in X[4:]:
        js = je.step(js, jnp.asarray(x))
        ts = te.step(ts, torch.tensor(x))
    assert ts.windowed == js.windowed == windowed
    if windowed:
        _same(ts, js)
    else:
        m = int(js.kpca.m)
        np.testing.assert_allclose(ts.kpca.L.numpy()[:m],
                                   np.asarray(js.kpca.L)[:m], atol=1e-9)


def test_health_and_metrics_bundles_raise():
    """Health and metrics bundles are ported (ROADMAP.md item 7): one
    reference plan with a health policy and metrics drives a guarded,
    metered window bundle through both packages' ``Engine.step``, a NaN
    point among them, and the bundles stay equal (the ring and the
    counters exactly).  A health bundle without a policy raises."""
    from repro.core import health as jhl, telemetry as jtm
    from repro_torch.core import health as thl, telemetry as ttm

    X = np.random.default_rng(8).normal(size=(16, 4))
    plan = jeng.UpdatePlan(window=6, health=jhl.DEFAULT_POLICY, metrics=True)
    je = jeng.Engine(JSPEC, plan, adjusted=True)
    te = teng.Engine(TSPEC, plan, adjusted=True)
    js = jeng.make_stream(jwnd.init_window(jnp.asarray(X[:4]), 16, JSPEC,
                                           dtype=jnp.float64),
                          health=jhl.init_health(jnp.float64),
                          metrics=jtm.init_metrics(jnp.float64))
    ts = teng.make_stream(twnd.init_window(torch.tensor(X[:4]), 16, TSPEC,
                                           dtype=torch.float64),
                          health=thl.init_health(torch.float64),
                          metrics=ttm.init_metrics(torch.float64))
    for i, x in enumerate(X[4:]):
        if i == 5:
            x = np.full(4, np.nan)
        js = je.step(js, jnp.asarray(x))
        ts = te.step(ts, torch.tensor(x))
    _same(ts, js)
    assert int(ts.health.quarantined) == int(js.health.quarantined) == 1
    assert ttm.metrics_report(ts.metrics) == pytest.approx(
        jtm.metrics_report(js.metrics), abs=1e-9)
    st = tink.init_state(torch.zeros(2, 3, dtype=torch.float64), 8, TSPEC,
                         adjusted=True, dtype=torch.float64)
    with pytest.raises(ValueError, match="health policy"):
        teng.Engine(TSPEC).step(teng.make_stream(
            st, health=thl.init_health(torch.float64)), torch.zeros(3))


def test_jax_window_continues_in_the_port():
    """A windowed stream run in JAX past its first evictions crosses over
    with ``window_from_numpy`` and continues in the port equal to the
    reference's own continuation; ``window_to_numpy`` returns it."""
    X = np.random.default_rng(9).normal(size=(40, 4))
    plan = dict(matmul="pallas", fuse_krow=True, dispatch="bucketed",
                min_bucket=8)
    js = jink.KPCAStream(jnp.asarray(X[:4]), 16, JSPEC,
                         plan=jeng.UpdatePlan(**plan, window=10),
                         dtype=jnp.float64)
    for x in X[4:20]:
        js.update(jnp.asarray(x))
    fields = {k: np.asarray(getattr(js.state.kpca, k))
              for k in convert.FIELDS}
    fields.update(ages=np.asarray(js.state.ages),
                  clock=np.asarray(js.state.clock))
    tw = convert.window_from_numpy(fields, device="cpu")
    back = convert.window_to_numpy(tw)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v)
    engine = teng.Engine(TSPEC, teng.UpdatePlan(**plan, window=10))
    for x in X[20:]:
        js.update(jnp.asarray(x))
        tw = twnd.ingest(engine, tw, torch.tensor(x), window=10)
    _same(tw, js.state)
    with pytest.raises(ValueError, match="missing"):
        convert.window_from_numpy(convert.state_to_numpy(tw.kpca))
