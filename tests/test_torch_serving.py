"""The port's serving snapshots (``core/serving.py``: the retiring
publish, ``DoubleBuffer``, ``query_batch``) and its KRR and Nyström
snapshot heads against the reference's, on the same numpy inputs.

Mirrors ``tests/test_serving.py`` without its checkpoint, ``StreamBatch``
and mesh cases.  Both packages run f64; a snapshot query is held to the
reference's at atol 1e-9, and to the port's own per-call path bit for
bit where the reference asserts bit equality (the same contraction,
hoisted to publication).  States cross between packages as numpy arrays
(``convert.snapshot_from_numpy``, ``convert.krr_from_numpy``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng, inkpca as jink  # noqa: E402
from repro.core import kernels_fn as jkf, krr as jkrr  # noqa: E402
from repro.core import nystrom as jn, serving as jsrv  # noqa: E402
from repro_torch.core import convert, engine as teng  # noqa: E402
from repro_torch.core import inkpca as tink, kernels_fn as tkf  # noqa: E402
from repro_torch.core import krr as tkrr, nystrom as tn  # noqa: E402
from repro_torch.core import serving as tsrv  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

JSPEC, TSPEC = jkf.KernelSpec(sigma=2.0), tkf.KernelSpec(sigma=2.0)


def _streams(seed=0, n=6, d=5, capacity=64, fuse=False):
    """Both packages' Algorithm-2 streams over the same points, and the
    generator for what follows."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(4, d))
    jplan = jeng.DEFAULT_PLAN._replace(fuse_krow=fuse)
    tplan = teng.DEFAULT_PLAN._replace(fuse_krow=fuse)
    js = jink.KPCAStream(jnp.asarray(x0), capacity, JSPEC, adjusted=True,
                         dtype=jnp.float64, plan=jplan)
    ts = tink.KPCAStream(torch.tensor(x0), capacity, TSPEC, adjusted=True,
                         dtype=torch.float64, plan=tplan, device="cpu")
    for _ in range(n):
        x = rng.normal(size=(d,))
        js.update(jnp.asarray(x))
        ts.update(torch.tensor(x))
    return js, ts, rng, d


def _close(got, want, atol=1e-9):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("fuse", [False, True])
def test_transform_is_publish_query(fuse):
    js, ts, rng, d = _streams(fuse=fuse)
    q = rng.normal(size=(7, d))
    tplan = teng.DEFAULT_PLAN._replace(fuse_krow=fuse)
    y1 = teng.transform_state(ts.kpca_state, torch.tensor(q), spec=TSPEC,
                              adjusted=True, n_components=4, plan=tplan)
    snap = tsrv.publish_transform(ts.kpca_state, n_components=4,
                                  adjusted=True)
    assert torch.equal(y1, tsrv.query(snap, torch.tensor(q), spec=TSPEC,
                                      plan=tplan))
    jsnap = jsrv.publish_transform(js.kpca_state, n_components=4,
                                   adjusted=True)
    want = np.asarray(jsrv.query(jsnap, jnp.asarray(q), spec=JSPEC))
    _close(np.abs(y1.numpy()), np.abs(want))


def test_snapshot_immutable_under_ingest():
    """Queries against the front are bit for bit the same through any
    ingest into the working state; a republish serves the new
    eigensystem, equal to its frozen transform bit for bit."""
    js, ts, rng, d = _streams(n=5)
    buf = tsrv.DoubleBuffer(ts.kpca_state, n_components=4)
    q = torch.tensor(rng.normal(size=(6, d)))
    y0 = buf.query(q, spec=TSPEC)
    for _ in range(8):
        ts.update(torch.tensor(rng.normal(size=(d,))))
        assert torch.equal(buf.query(q, spec=TSPEC), y0)
    buf.publish(ts.kpca_state)
    y1 = buf.query(q, spec=TSPEC)
    assert not torch.equal(y1, y0)
    assert torch.equal(y1, teng.transform_state(
        ts.kpca_state, q, spec=TSPEC, adjusted=True, n_components=4))


def test_swap_then_query_commutes():
    """A handle kept to the front answers the same after the next publish
    (one publish ahead is the double buffer's guarantee), and the
    generation advances by one."""
    _, ts, rng, d = _streams(n=5)
    buf = tsrv.DoubleBuffer(ts.kpca_state, n_components=4)
    snap_g = buf.front
    q = torch.tensor(rng.normal(size=(6, d)))
    y_before = tsrv.query(snap_g, q, spec=TSPEC)
    ts.update(torch.tensor(rng.normal(size=(d,))))
    buf.publish(ts.kpca_state)
    assert torch.equal(tsrv.query(snap_g, q, spec=TSPEC), y_before)
    assert int(buf.front.generation) == int(snap_g.generation) + 1


def test_double_buffer_reuses_the_storage_of_two_publishes_back():
    """Generations 0, 1, 2, 3; the third publish writes into the first
    snapshot's storage and the fourth into the second's, while the
    snapshot each publish retires (the old front) stays untouched; each
    snapshot equals a fresh publish of the same state bit for bit; the
    buffer's first two publishes own their X (the working state's X is
    never written)."""
    _, ts, rng, d = _streams(n=5)
    q = torch.tensor(rng.normal(size=(6, d)))
    buf = tsrv.DoubleBuffer(n_components=4)
    snaps, states = [], []
    for g in range(4):
        ts.update(torch.tensor(rng.normal(size=(d,))))
        st = ts.kpca_state
        states.append((st, st.X.clone()))
        if g >= 1:
            front = buf.front
            y_front = tsrv.query(front, q, spec=TSPEC)
        snaps.append(buf.publish(st))
        assert int(snaps[-1].generation) == g
        fresh = tsrv.publish_transform(st, n_components=4, adjusted=True)
        for f in ("S", "X", "m"):
            assert torch.equal(getattr(snaps[-1], f), getattr(fresh, f))
        for f in tsrv.AffineCorrection._fields:
            assert torch.equal(getattr(snaps[-1].affine, f),
                               getattr(fresh.affine, f))
        if g >= 2:
            assert snaps[-1].X.data_ptr() == snaps[g - 2].X.data_ptr()
            assert snaps[-1].S.data_ptr() == snaps[g - 2].S.data_ptr()
        if g >= 1:      # the snapshot this publish retired is untouched
            assert buf._retired is front
            assert torch.equal(tsrv.query(front, q, spec=TSPEC), y_front)
    for st, X in states:
        assert torch.equal(st.X, X)
    assert snaps[0].X.data_ptr() != states[0][0].X.data_ptr()


def test_double_buffer_refuses_an_unhealthy_state():
    _, ts, rng, d = _streams(n=5)
    buf = tsrv.DoubleBuffer(n_components=4)
    with pytest.raises(ValueError, match="unhealthy"):
        buf.publish(ts.kpca_state, healthy=False)
    with pytest.raises(ValueError, match="no snapshot"):
        buf.query(torch.zeros(1, d), spec=TSPEC)
    front = buf.publish(ts.kpca_state)
    ts.update(torch.tensor(rng.normal(size=(d,))))
    assert buf.publish(ts.kpca_state, healthy=False) is front
    assert buf.skipped == 1 and int(buf.front.generation) == 0
    lam = teng.eigpairs(ts.kpca_state)[0]
    buf.publish(ts.kpca_state)
    assert torch.equal(buf.ref_lam, lam[:4])
    with pytest.raises(ValueError, match="n_components"):
        tsrv.DoubleBuffer().publish(ts.kpca_state)


@pytest.mark.parametrize("fuse", [False, True])
def test_query_batch_equals_per_tenant_queries(fuse):
    """``query_batch`` over stacked snapshots equals one ``query`` per
    tenant bit for bit, and the reference's ``query_batch`` over its own
    snapshots of the same streams within 1e-9."""
    plan = teng.DEFAULT_PLAN._replace(fuse_krow=fuse)
    snaps, jsnaps = [], []
    for b in range(3):
        js, ts, rng, d = _streams(seed=b, n=3 + b)
        snaps.append(tsrv.publish_transform(ts.kpca_state, n_components=4,
                                            adjusted=True, generation=b))
        jsnaps.append(jsrv.publish_transform(js.kpca_state, n_components=4,
                                             adjusted=True, generation=b))
    q = torch.tensor(np.random.default_rng(9).normal(size=(3, 5, d)))
    stacked = tsrv.stack_snapshots(snaps)
    got = tsrv.query_batch(stacked, q, spec=TSPEC, plan=plan)
    for b in range(3):
        assert torch.equal(got[b], tsrv.query(snaps[b], q[b], spec=TSPEC,
                                              plan=plan))
    jstack = jsrv.ServingSnapshot(
        S=jnp.stack([s.S for s in jsnaps]), X=jnp.stack([s.X for s in jsnaps]),
        m=jnp.stack([s.m for s in jsnaps]),
        affine=jsrv.AffineCorrection(*(jnp.stack(f) for f in zip(
            *[s.affine for s in jsnaps]))),
        generation=jnp.stack([s.generation for s in jsnaps]))
    want = np.asarray(jsrv.query_batch(jstack, jnp.asarray(q.numpy()),
                                       spec=JSPEC))
    _close(np.abs(got.numpy()), np.abs(want))


def test_snapshot_carried_across_answers_as_the_reference():
    """A reference snapshot crosses over as numpy arrays
    (``convert.snapshot_from_numpy``) and answers the reference's queries
    within 1e-9; the round trip is exact, for the affine and the linear
    heads."""
    js, _, rng, d = _streams(n=6)
    q = rng.normal(size=(5, d))
    jsnap = jsrv.publish_transform(js.kpca_state, n_components=4,
                                   adjusted=True, generation=7)
    fields = {k: np.asarray(getattr(jsnap, k))
              for k in ("S", "X", "m", "generation")}
    fields.update({k: np.asarray(getattr(jsnap.affine, k))
                   for k in jsrv.AffineCorrection._fields})
    snap = convert.snapshot_from_numpy(fields, device="cpu")
    _close(tsrv.query(snap, torch.tensor(q), spec=TSPEC).numpy(),
           np.asarray(jsrv.query(jsnap, jnp.asarray(q), spec=JSPEC)))
    back = convert.snapshot_to_numpy(snap)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v)
    lin = convert.snapshot_from_numpy({k: fields[k] for k in
                                       ("S", "X", "m", "generation")},
                                      device="cpu")
    assert lin.affine is None
    assert convert.snapshot_to_numpy(lin)["mf"] is None
    with pytest.raises(ValueError, match="missing"):
        convert.snapshot_from_numpy({"S": fields["S"]}, device="cpu")


@pytest.mark.parametrize("fuse", [False, True])
def test_krr_and_nystrom_snapshot_heads(fuse):
    """The KRR predict head reproduces ``predict`` and the Nyström feature
    head ``query_features`` (the port's bit for bit on the masked-gram
    path, within 1e-12 of the scale on the fused one, whose kernel sums
    in another order), and each matches the reference's head within
    1e-9."""
    plan = teng.DEFAULT_PLAN._replace(fuse_krow=fuse)
    rng = np.random.default_rng(3)
    d = 4
    x0, y0 = rng.normal(size=(4, d)), rng.normal(size=(4,))
    kj = jkrr.init_krr(jnp.asarray(x0), jnp.asarray(y0), 32, JSPEC)
    kt = tkrr.init_krr(torch.tensor(x0), torch.tensor(y0), 32, TSPEC)
    for _ in range(5):
        x, y = rng.normal(size=(d,)), float(rng.normal())
        kj = jkrr.add_point(kj, jnp.asarray(x), y, JSPEC)
        kt = tkrr.add_point(kt, torch.tensor(x), y, TSPEC)
    xq = rng.normal(size=(6, d))
    snap = tkrr.publish_predict(kt, 0.1)
    got = tkrr.snapshot_predict(snap, torch.tensor(xq), TSPEC, plan=plan)
    direct = tkrr.predict(kt, torch.tensor(xq), 0.1, TSPEC)
    if fuse:
        _close(got, direct, 1e-12 * float(direct.abs().max()))
    else:
        assert torch.equal(got, direct)
    _close(got, np.asarray(jkrr.snapshot_predict(
        jkrr.publish_predict(kj, 0.1), jnp.asarray(xq), JSPEC)))

    nj = jn.init_nystrom(None, jnp.asarray(x0), 32, JSPEC,
                         dtype=jnp.float64, grow_rows=True)
    nt = tn.init_nystrom(None, torch.tensor(x0), 32, TSPEC,
                         dtype=torch.float64, grow_rows=True)
    for _ in range(5):
        x = rng.normal(size=(d,))
        nj = jn.add_landmark(jn.observe_rows(nj, jnp.asarray(x), JSPEC),
                             None, jnp.asarray(x), JSPEC)
        nt = tn.add_landmark(tn.observe_rows(nt, torch.tensor(x), TSPEC),
                             None, torch.tensor(x), TSPEC)
    n = nt.Knm.shape[0]
    fsnap = tn.publish_features(nt, n, generation=3)
    assert fsnap.S.shape == (32, 32) and int(fsnap.generation) == 3
    feats = tn.snapshot_features(fsnap, torch.tensor(xq), TSPEC, plan=plan)
    direct = tn.query_features(nt, torch.tensor(xq), n, TSPEC, plan=plan)
    _close(feats, direct, 1e-12 * float(direct.abs().max()))
    want = np.asarray(jn.snapshot_features(jn.publish_features(nj, n),
                                           jnp.asarray(xq), JSPEC))
    # Eigenvector signs are each package's own: compare |features| and the
    # sign-free product F Λ Fᵀ.
    _close(np.abs(feats.numpy()), np.abs(want))
    lam = nt.kpca.L.numpy()
    _close((feats.numpy() * lam) @ feats.numpy().T,
           (want * np.asarray(nj.kpca.L)) @ want.T)
