"""The port's decremental updates (``core/downdate.py``, ``Engine.downdate``
and ``Engine.replace``) against the reference's, on the same numpy inputs.

Both packages grow the same f64 stream under the same plan values; the
port's state after a downdate is held to the reference's (eigenvalues and
reconstruction, atol 1e-9), to its own state before the update it undoes
(``tests/test_downdate.py``'s 1e-10) and to the batch oracle.  The
reference runs its jnp oracles (``REPRO_PALLAS_FORCE=ref``), the port its
plain kernel versions on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng, inkpca as jink  # noqa: E402
from repro.core import kernels_fn as jkf, rankone as jrk  # noqa: E402
from repro_torch.core import engine as teng, inkpca as tink  # noqa: E402
from repro_torch.core import downdate as tdd  # noqa: E402
from repro_torch.core import kernels_fn as tkf, rankone as trk  # noqa: E402

SIGMA = 5.0
JSPEC, TSPEC = jkf.KernelSpec(sigma=SIGMA), tkf.KernelSpec(sigma=SIGMA)


def _engines(adjusted, **plan):
    return (jeng.Engine(JSPEC, jeng.UpdatePlan(**plan), adjusted=adjusted),
            teng.Engine(TSPEC, teng.UpdatePlan(**plan), adjusted=adjusted))


def _grow(adjusted, plan, n=11, capacity=16, d=4, seed=11):
    """Both packages' states after n points (4 seed + n - 4 updates)."""
    X = np.random.default_rng(seed).normal(size=(n, d))
    je, te = _engines(adjusted, **plan)
    js = jink.init_state(jnp.asarray(X[:4]), capacity, JSPEC,
                         adjusted=adjusted, dtype=jnp.float64)
    ts = tink.init_state(torch.tensor(X[:4]), capacity, TSPEC,
                         adjusted=adjusted, dtype=torch.float64)
    for i in range(4, n):
        js = je.update(js, jnp.asarray(X[i]))
        ts = te.update(ts, torch.tensor(X[i]))
    return je, te, js, ts, X


def _recon(st, rk):
    return np.asarray(rk.reconstruct(st.L, st.U, st.m))


def _same(ts, js, atol=1e-9):
    m = int(js.m)
    assert int(ts.m) == m
    np.testing.assert_allclose(ts.L.numpy()[:m], np.asarray(js.L)[:m],
                               atol=atol)
    np.testing.assert_allclose(_recon(ts, trk), _recon(js, jrk), atol=atol)
    np.testing.assert_allclose(ts.K1.numpy(), np.asarray(js.K1), atol=atol)
    np.testing.assert_allclose(float(ts.S), float(js.S), atol=atol)
    np.testing.assert_array_equal(ts.X.numpy(), np.asarray(js.X))


def _batch(X, adjusted):
    K = tkf.gram_block(torch.tensor(X), torch.tensor(X), spec=TSPEC)
    return (tkf.center_gram(K) if adjusted else K).numpy()


@pytest.mark.parametrize("adjusted", [False, True])
@pytest.mark.parametrize("dispatch", ["fixed", "bucketed"])
@pytest.mark.parametrize("matmul", ["jnp", "jnp2", "pallas", "pallas2"])
def test_downdate_update_roundtrip(adjusted, dispatch, matmul):
    """downdate(update(state, x), last) is the state again (1e-10), and
    equal to the reference's (1e-9), on every rotation route."""
    plan = dict(matmul=matmul, dispatch=dispatch, min_bucket=8)
    je, te, js, ts, _ = _grow(adjusted, plan)
    x_new = np.random.default_rng(5).normal(size=4)
    js2 = je.downdate(je.update(js, jnp.asarray(x_new)), 11)
    ts1 = te.update(ts, torch.tensor(x_new))
    ts2 = te.downdate(ts1, int(ts1.m) - 1)
    m = int(ts.m)
    assert int(ts2.m) == m
    np.testing.assert_allclose(ts2.L.numpy()[:m], ts.L.numpy()[:m],
                               atol=1e-10)
    np.testing.assert_allclose(_recon(ts2, trk), _recon(ts, trk), atol=1e-10)
    np.testing.assert_allclose(ts2.K1.numpy(), ts.K1.numpy(), atol=1e-10)
    np.testing.assert_allclose(float(ts2.S), float(ts.S), atol=1e-9)
    np.testing.assert_array_equal(ts2.X.numpy(), ts.X.numpy())
    _same(ts2, js2)


@pytest.mark.parametrize("adjusted", [False, True])
def test_downdate_interior_matches_batch(adjusted):
    """Removing an interior point leaves the batch eigensystem of the
    survivors, in their arrival order, as the reference does."""
    je, te, js, ts, X = _grow(adjusted, {})
    ts2 = te.downdate(ts, 2)
    _same(ts2, je.downdate(js, 2))
    keep = [i for i in range(11) if i != 2]
    m = int(ts2.m)
    np.testing.assert_allclose(_recon(ts2, trk)[:m, :m],
                               _batch(X[keep], adjusted), atol=1e-10)
    np.testing.assert_array_equal(ts2.X.numpy()[:m], X[keep])


def test_downdate_preserves_padding_invariants():
    """Inactive columns exactly identity, active columns zero on rows >= m,
    sentinels above the spectrum, U orthogonal — and the reference's
    state."""
    plan = dict(dispatch="bucketed", min_bucket=8)
    je, te, js, ts, _ = _grow(True, plan)
    ts2 = te.downdate(ts, 4)
    _same(ts2, je.downdate(js, 4))
    M, m = ts2.L.shape[0], int(ts2.m)
    U, L = ts2.U.numpy(), ts2.L.numpy()
    np.testing.assert_array_equal(U[:, m:], np.eye(M)[:, m:])
    assert np.abs(U[m:, :m]).max() == 0.0
    assert L[m:].min() > L[:m].max() and (np.diff(L[m:]) > 0).all()
    np.testing.assert_allclose(U @ U.T, np.eye(M), atol=1e-12)


def test_downdate_rebuckets_downward_and_keeps_streaming():
    """Downdating below a rung re-buckets the next update downward; the
    bucketed port equals the fixed port and the bucketed reference."""
    X = np.random.default_rng(23).normal(size=(20, 4))
    plan = dict(dispatch="bucketed", min_bucket=8)
    jb, tb = _engines(True, **plan)
    _, tf = _engines(True)
    jsb = jink.init_state(jnp.asarray(X[:4]), 32, JSPEC, adjusted=True,
                          dtype=jnp.float64)
    tsb = tink.init_state(torch.tensor(X[:4]), 32, TSPEC, adjusted=True,
                          dtype=torch.float64)
    tsf = tsb
    for i in range(4, 10):
        jsb = jb.update(jsb, jnp.asarray(X[i]))
        tsb = tb.update(tsb, torch.tensor(X[i]))
        tsf = tf.update(tsf, torch.tensor(X[i]))
    for _ in range(3):
        jsb = jb.downdate(jsb, 0)
        tsb = tb.downdate(tsb, 0)
        tsf = tf.downdate(tsf, 0)
    assert teng.bucket_for(int(tsb.m) + 1, 32, 8) == 8
    for i in range(10, 20):
        jsb = jb.update(jsb, jnp.asarray(X[i]))
        tsb = tb.update(tsb, torch.tensor(X[i]))
        tsf = tf.update(tsf, torch.tensor(X[i]))
    assert int(tsb.m) == int(tsf.m) == 17
    np.testing.assert_allclose(_recon(tsb, trk), _recon(tsf, trk), atol=1e-9)
    _same(tsb, jsb)


def test_engine_replace_swaps_point():
    """replace(i, x) on a full state is the batch eigensystem of the set
    with X[i] swapped for x, and the reference's state."""
    rng = np.random.default_rng(29)
    X = rng.normal(size=(8, 3))
    je, te = _engines(True)
    js = jink.init_state(jnp.asarray(X[:4]), 8, JSPEC, adjusted=True,
                         dtype=jnp.float64)
    ts = tink.init_state(torch.tensor(X[:4]), 8, TSPEC, adjusted=True,
                         dtype=torch.float64)
    for i in range(4, 8):
        js = je.update(js, jnp.asarray(X[i]))
        ts = te.update(ts, torch.tensor(X[i]))
    x_new = rng.normal(size=3)
    ts2 = te.replace(ts, 3, torch.tensor(x_new))
    _same(ts2, je.replace(js, 3, jnp.asarray(x_new)))
    Xk = np.concatenate([X[[0, 1, 2, 4, 5, 6, 7]], x_new[None]])
    np.testing.assert_allclose(_recon(ts2, trk), _batch(Xk, True),
                               atol=1e-10)


def test_downdate_validation():
    _, te, _, ts, _ = _grow(False, {})
    for i in (int(ts.m), -1):
        with pytest.raises(ValueError, match="outside active range"):
            te.downdate(ts, i)
    small = tink.init_state(torch.zeros(1, 4, dtype=torch.float64), 8, TSPEC,
                            adjusted=False, dtype=torch.float64)
    with pytest.raises(ValueError, match="at least 2"):
        te.downdate(small, 0)


def test_boundary_perm_matches_reference():
    """The survivor-order permutation of both packages, at every i < m."""
    from repro.core import downdate as jdd

    M, m = 12, 9
    for i in range(m):
        want = np.asarray(jdd.boundary_perm(jnp.asarray(i), jnp.asarray(m),
                                            M))
        got = tdd.boundary_perm(torch.tensor(i), torch.tensor(m), M)
        np.testing.assert_array_equal(got.numpy(), want)
