"""The port's truncation and compaction (``Engine.truncate``/``compact``,
``KPCAStream.truncate``, the Nyström row-support clamp and the
``min_rows`` floor) against the reference's, on the same numpy inputs.

Both packages run f64 with the same plan; the port is held to the
reference at ``tests/test_engine.py``'s tolerances (reconstructions atol
1e-8 after streaming, 1e-9/1e-10 for a one-shot truncation), and to its
own properties exactly where the reference asserts them (shapes,
capacity, the active count, support as a prefix).  The subset-tracking
bars are ``tests/test_subset_tracking.py``'s (top-3 within 25 % of eigh,
the top one at least 0.95 of it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import batch as jbatch, engine as jeng  # noqa: E402
from repro.core import inkpca as jink, kernels_fn as jkf  # noqa: E402
from repro.core import nystrom as jn, rankone as jrk  # noqa: E402
from repro_torch.core import engine as teng, inkpca as tink  # noqa: E402
from repro_torch.core import kernels_fn as tkf  # noqa: E402
from repro_torch.core import nystrom as tn, rankone as trk  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

JSPEC, TSPEC = jkf.KernelSpec(sigma=5.0), tkf.KernelSpec(sigma=5.0)
BUK = dict(dispatch="bucketed", min_bucket=8)


def _streams(X0, capacity, **kw):
    js = jink.KPCAStream(jnp.asarray(X0), capacity, JSPEC,
                         dtype=jnp.float64, **kw)
    ts = tink.KPCAStream(torch.tensor(X0), capacity, TSPEC,
                         dtype=torch.float64, device="cpu", **kw)
    return js, ts


def _feed(stream, X):
    """Stream the rows of X one point at a time (the reference's per-point
    step compiles once per bucket, its block scan once per block
    length)."""
    for x in X:
        stream.update(jnp.asarray(x) if isinstance(stream, jink.KPCAStream)
                      else torch.tensor(x))


def _rec(st):
    if isinstance(st.L, torch.Tensor):
        return trk.reconstruct(st.L, st.U, st.m).numpy()
    return np.asarray(jrk.reconstruct(st.L, st.U, st.m))


def _same_states(ts, js, atol):
    m = int(js.m)
    assert int(ts.m) == m and ts.L.shape == js.L.shape
    np.testing.assert_allclose(np.sort(ts.L.numpy()[:m]),
                               np.sort(np.asarray(js.L)[:m]), atol=atol)
    np.testing.assert_allclose(_rec(ts), _rec(js), atol=atol)


def _grown(n=16, capacity=64, adjusted=False, seed=17):
    X = np.random.default_rng(seed).normal(size=(n + 12, 4))
    js, ts = _streams(X[:4], capacity, adjusted=adjusted, **BUK)
    _feed(js, X[4:n])
    ts.update_block(torch.tensor(X[4:n]))
    return js, ts, X


@pytest.mark.parametrize("adjusted", [False, True])
def test_compact_shrinks_to_the_bucket_as_the_reference(adjusted):
    js, ts, _ = _grown(adjusted=adjusted)
    js.truncate(6, compact=True)
    ts.truncate(6, compact=True)
    Mb = teng.bucket_for(7, 64, 8)
    assert ts.state.L.shape == (Mb,) and ts.state.U.shape == (Mb, Mb)
    assert ts.state.K1.shape == (Mb,) and ts.state.X.shape == (Mb, 4)
    assert int(ts.state.m) == 6 == ts.m and ts._min_rows == 0
    _same_states(ts.state, js.state, 1e-9)
    np.testing.assert_array_equal(ts.state.X.numpy(),
                                  np.asarray(js.state.X))


def test_compact_of_a_prefix_supported_state_is_a_reallocation():
    js, ts, _ = _grown(n=12)
    m = int(ts.state.m)
    tc, jc = ts.engine.compact(ts.state), js.engine.compact(js.state)
    np.testing.assert_allclose(_rec(tc)[:m, :m], _rec(ts.state)[:m, :m],
                               atol=1e-9)
    _same_states(tc, jc, 1e-9)
    with pytest.raises(ValueError):
        ts.engine.compact(ts.state, capacity=m)


@pytest.mark.parametrize("adjusted", [False, True])
def test_uncompacted_truncate_carries_the_floor(adjusted):
    """After a truncation without compaction the kept columns have support
    on the old rows: the bucketed stream keeps slicing at that floor and
    matches the fixed-dispatch stream, as in the reference."""
    X = np.random.default_rng(17).normal(size=(26, 4))
    jf, tf = _streams(X[:4], 64, adjusted=adjusted)
    jb, tb = _streams(X[:4], 64, adjusted=adjusted, **BUK)
    for s in (jf, jb, tf, tb):
        _feed(s, X[4:18])
        s.truncate(5)
    for s in (jf, jb):
        _feed(s, X[18:])
    for s in (tf, tb):
        s.update_block(torch.tensor(X[18:]))
    assert tb._min_rows == 18 and tb.m == 13
    np.testing.assert_allclose(tb.reconstruction().numpy(),
                               tf.reconstruction().numpy(), atol=1e-8)
    np.testing.assert_allclose(tb.reconstruction().numpy(),
                               np.asarray(jb.reconstruction()), atol=1e-8)
    _same_states(tb.state, jb.state, 1e-8)


def test_the_floor_matters():
    """Without the floor, a bucketed stream after an uncompacted
    truncation drops the old rows' mass and leaves the fixed stream."""
    X = np.random.default_rng(17).normal(size=(26, 4))
    _, tf = _streams(X[:4], 64)
    _, tb = _streams(X[:4], 64, **BUK)
    for s in (tf, tb):
        s.update_block(torch.tensor(X[4:18]))
        s.truncate(5)
    tb._min_rows = 0
    for s in (tf, tb):
        s.update_block(torch.tensor(X[18:]))
    err = np.abs(tb.reconstruction().numpy()
                 - tf.reconstruction().numpy()).max()
    assert err > 1e-3


def test_compacted_stream_streams_until_it_is_full():
    js, ts, X = _grown()
    js.truncate(6, compact=True)
    ts.truncate(6, compact=True)
    rng = np.random.default_rng(5)
    more = rng.normal(size=(3, 4))
    _feed(js, more[:2])
    ts.update_block(torch.tensor(more[:2]))
    assert int(ts.state.m) == 8 and torch.isfinite(ts.state.U).all()
    _same_states(ts.state, js.state, 1e-8)
    with pytest.raises(ValueError, match="need room"):
        ts.update(torch.tensor(more[2]))
    # an explicit capacity leaves room to grow (the engine's and the
    # stream's spelling agree)
    js2, ts2, _ = _grown()
    js2.truncate(6, compact=True)
    js2.state = js2.engine.compact(js2.state, capacity=32)
    ts2.truncate(6, compact=True, capacity=32)
    extra = rng.normal(size=(8, 4))
    _feed(js2, extra)
    ts2.update_block(torch.tensor(extra))
    assert int(ts2.state.m) == 14 and ts2.state.L.shape == (32,)
    _same_states(ts2.state, js2.state, 1e-8)


def test_engine_truncate_default_compacts_at_unchanged_capacity():
    X = np.random.default_rng(24).normal(size=(24, 4))
    je = jeng.Engine(JSPEC, jeng.UpdatePlan(**BUK), adjusted=False)
    te = teng.Engine(TSPEC, teng.UpdatePlan(**BUK), adjusted=False)
    js = jink.init_state(jnp.asarray(X[:4]), 64, JSPEC, adjusted=False,
                         dtype=jnp.float64)
    ts = tink.init_state(torch.tensor(X[:4]), 64, TSPEC, adjusted=False,
                         dtype=torch.float64)
    js = je.truncate(je.update_block(js, jnp.asarray(X[4:18])), 5)
    ts = te.truncate(te.update_block(ts, torch.tensor(X[4:18])), 5)
    assert ts.L.shape == (64,)
    assert float(ts.U[5:, :5].abs().max()) < 1e-12
    _same_states(ts, js, 1e-10)
    js = je.update_block(js, jnp.asarray(X[18:]))
    ts = te.update_block(ts, torch.tensor(X[18:]))
    _same_states(ts, js, 1e-8)


def test_truncate_keeps_exactly_k_active():
    X = np.random.default_rng(21).normal(size=(12, 3))
    specs = (jkf.KernelSpec(sigma=3.0), tkf.KernelSpec(sigma=3.0))
    js = jink.KPCAStream(jnp.asarray(X[:10]), 12, specs[0], adjusted=False,
                         dtype=jnp.float64)
    ts = tink.KPCAStream(torch.tensor(X[:10]), 12, specs[1], adjusted=False,
                         dtype=torch.float64, device="cpu")
    jst, tst = js.truncate(4), ts.truncate(4)
    assert int(tst.m) == 4 == ts.m
    lam_before = np.sort(np.asarray(js.state.L)[:4])
    np.testing.assert_allclose(np.sort(tst.L.numpy()[:4]), lam_before,
                               atol=1e-12)
    np.testing.assert_allclose(ts.reconstruction().numpy()[:4, :4],
                               np.asarray(js.reconstruction())[:4, :4],
                               atol=1e-10)
    assert int(jst.m) == 4


def test_truncated_stream_tracks_dominant_eigenvalues():
    """``tests/test_subset_tracking.py`` in both packages: the truncated
    stream's top-3 eigenvalues within 25 % of eigh, the top one at least
    0.95 of it, and the port equal to the reference."""
    X = np.random.default_rng(21).normal(size=(40, 4))
    sigma = float(np.median(((X[:, None] - X[None]) ** 2).sum(-1)))
    jspec, tspec = jkf.KernelSpec(sigma=sigma), tkf.KernelSpec(sigma=sigma)
    js = jink.KPCAStream(jnp.asarray(X[:20]), 40, jspec, adjusted=False,
                         dtype=jnp.float64)
    ts = tink.KPCAStream(torch.tensor(X[:20]), 40, tspec, adjusted=False,
                         dtype=torch.float64, device="cpu")
    js.truncate(8)
    ts.truncate(8)
    _feed(js, X[20:])
    ts.update_block(torch.tensor(X[20:]))
    K = np.asarray(jkf.gram_block(jnp.asarray(X), jnp.asarray(X),
                                  spec=jspec))
    lam_ref = np.sort(np.asarray(jbatch.batch_kpca(jnp.asarray(K),
                                                   adjusted=False)[0]))[::-1]
    lam = ts.eigpairs()[0].numpy()[:3]
    rel = np.abs(lam - lam_ref[:3]) / lam_ref[:3]
    assert (rel < 0.25).all() and lam[0] >= 0.95 * lam_ref[0]
    np.testing.assert_allclose(lam, np.asarray(js.eigpairs()[0])[:3],
                               atol=1e-8)


def test_windowed_stream_still_refuses_truncation():
    x0 = np.random.default_rng(0).normal(size=(4, 3))
    stream = tink.KPCAStream(x0, 16, TSPEC, window=8, device="cpu")
    with pytest.raises(ValueError, match="windowed"):
        stream.truncate(4)


# ------------------------------------------------ Nyström truncation ----
def _nystrom_pair(seed, engines):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(4, 4))
    js = jn.init_nystrom(None, jnp.asarray(x0), 64, JSPEC,
                         dtype=jnp.float64, grow_rows=True)
    ts = tn.init_nystrom(None, torch.tensor(x0), 64, TSPEC,
                         dtype=torch.float64, grow_rows=True)
    je, te = engines
    for _ in range(16):
        x = rng.normal(size=4)
        js = je.add_landmark(js, None, jnp.asarray(x))
        ts = te.add_landmark(ts, None, torch.tensor(x))
    return js, ts, rng


def test_nystrom_truncate_compact_keeps_every_observed_row():
    je = jeng.Engine(JSPEC, jeng.UpdatePlan(**BUK), adjusted=False)
    te = teng.Engine(TSPEC, teng.UpdatePlan(**BUK), adjusted=False)
    js, ts, rng = _nystrom_pair(37, (je, te))
    rows = rng.normal(size=(10, 4))
    js = jn.observe_rows(js, jnp.asarray(rows), JSPEC)
    ts = tn.observe_rows(ts, torch.tensor(rows), TSPEC)
    n_rows, m_before = ts.Knm.shape[0], int(ts.kpca.m)
    t_nc = te.truncate(ts, 8, compact=False)
    t_c = te.truncate(ts, 8, compact=True)
    j_c = je.truncate(js, 8, compact=True)
    assert t_c.Knm.shape == (n_rows, 32) == tuple(j_c.Knm.shape)
    assert t_c.Xrows.shape == ts.Xrows.shape
    assert int(t_c.kpca.m) == m_before and t_c.kpca.L.shape[0] < 64
    want = np.asarray(jn.reconstruct_tilde(j_c))
    np.testing.assert_allclose(tn.reconstruct_tilde(t_c).numpy(), want,
                               atol=1e-10)
    np.testing.assert_allclose(tn.reconstruct_tilde(t_nc).numpy(), want,
                               atol=1e-10)
    x = rng.normal(size=4)
    t2 = te.add_landmark(tn.observe_rows(t_c, torch.tensor(x[None]), TSPEC),
                         None, torch.tensor(x))
    j2 = je.add_landmark(jn.observe_rows(j_c, jnp.asarray(x[None]), JSPEC),
                         None, jnp.asarray(x))
    np.testing.assert_allclose(tn.reconstruct_tilde(t2).numpy(),
                               np.asarray(jn.reconstruct_tilde(j2)),
                               atol=1e-9)
    with pytest.raises(ValueError, match="row-support"):
        te.truncate(ts, 8, compact=True, capacity=16)


def test_nystrom_uncompacted_truncate_add_landmark_min_rows():
    buk = (jeng.Engine(JSPEC, jeng.UpdatePlan(**BUK), adjusted=False),
           teng.Engine(TSPEC, teng.UpdatePlan(**BUK), adjusted=False))
    tfix = teng.Engine(TSPEC, adjusted=False)
    js, ts, rng = _nystrom_pair(41, buk)
    r = int(ts.kpca.m)
    ja = buk[0].truncate(js, 8, compact=False)
    a = b = buk[1].truncate(ts, 8, compact=False)
    assert int(a.kpca.m) == 8
    for _ in range(3):
        x = rng.normal(size=4)
        ja = buk[0].add_landmark(ja, None, jnp.asarray(x), min_rows=r)
        a = buk[1].add_landmark(a, None, torch.tensor(x), min_rows=r)
        b = tfix.add_landmark(b, None, torch.tensor(x))
    np.testing.assert_allclose(tn.reconstruct_tilde(a).numpy(),
                               tn.reconstruct_tilde(b).numpy(), atol=1e-9)
    np.testing.assert_allclose(tn.reconstruct_tilde(a).numpy(),
                               np.asarray(jn.reconstruct_tilde(ja)),
                               atol=1e-9)


def test_truncated_adjusted_stream_overestimates_as_the_reference():
    """Witness (ROADMAP.md §3): a truncated Algorithm-2 stream keeps the
    pre-truncation sums S and K1 that centre every later update, so its
    top eigenvalue ends far above eigh's (1.7× here, k = 5 after 18
    points, 26 in all; 5.4× on the card's truncate phase shape); the
    unadjusted stream stays within the subset-tracking 25 %.  The port
    equals the reference in both (atol 1e-8)."""
    X = np.random.default_rng(17).normal(size=(26, 4))
    for adjusted in (True, False):
        js, ts = _streams(X[:4], 64, adjusted=adjusted, **BUK)
        _feed(js, X[4:18])
        ts.update_block(torch.tensor(X[4:18]))
        js.truncate(5)
        ts.truncate(5)
        _feed(js, X[18:])
        ts.update_block(torch.tensor(X[18:]))
        top = ts.eigpairs()[0].numpy()[:3]
        np.testing.assert_allclose(top, np.asarray(js.eigpairs()[0])[:3],
                                   atol=1e-8)
        K = tkf.gram_block(torch.tensor(X), torch.tensor(X), spec=TSPEC)
        ref = np.sort(jbatch.batch_kpca(jnp.asarray(K.numpy()),
                                        adjusted=adjusted)[0])[::-1][:3]
        ratio = top / np.asarray(ref)
        if adjusted:
            assert ratio[0] > 1.5
        else:
            assert (np.abs(ratio - 1) < 0.25).all()


def test_fused_prologue_after_uncompacted_truncation_is_the_references():
    """Witness (ROADMAP.md §3): an uncompacted truncation leaves mass on
    rows past m, which the fused prologue's identity Uᵀe_m = e_m and the
    kernels' row pruning assume away, so the fused kernel route (``pallas``
    with ``fuse_krow``) ends more than 0.1 away from the unfused one after
    8 more points.  The port's fused stream equals the reference's (atol
    1e-9)."""
    X = np.random.default_rng(17).normal(size=(26, 4))
    kw = dict(matmul="pallas", fuse_krow=True, **BUK)
    js = jink.KPCAStream(jnp.asarray(X[:4]), 64, JSPEC, adjusted=False,
                         dtype=jnp.float64, plan=jeng.UpdatePlan(**kw))
    out = {}
    for fuse in (True, False):
        ts = tink.KPCAStream(torch.tensor(X[:4]), 64, TSPEC, adjusted=False,
                             dtype=torch.float64, device="cpu",
                             plan=teng.UpdatePlan(**dict(kw, fuse_krow=fuse)))
        ts.update_block(torch.tensor(X[4:18]))
        ts.truncate(5)
        ts.update_block(torch.tensor(X[18:]))
        out[fuse] = ts.reconstruction().numpy()
    _feed(js, X[4:18])
    js.truncate(5)
    _feed(js, X[18:])
    np.testing.assert_allclose(out[True], np.asarray(js.reconstruction()),
                               atol=1e-9)
    assert np.abs(out[True] - out[False]).max() > 0.1
