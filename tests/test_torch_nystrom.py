"""The port's incremental Nyström (paper §4) against the reference's.

The same numpy inputs go through both packages in f64, in both row
regimes.  Tolerances are ``tests/test_nystrom.py``'s where it states one
(1e-9 / 1e-10 absolute, rtol 1e-8 for the trace identity); elsewhere
1e-10 of the quantity's scale.  ``scaled_gram``'s plain version is held to
the reference's ``scaled_gram_ref`` at 1e-12 (f64) and, with the
reference's own rtol 1e-3, to its Pallas kernel in interpret mode (f32,
``tests/test_kernels_pallas.py::test_scaled_gram_sweep``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng, kernels_fn as jkf  # noqa: E402
from repro.core import nystrom as jn  # noqa: E402
from repro.data import uci_like as juci  # noqa: E402
from repro.kernels.nystrom_recon.nystrom_recon import (  # noqa: E402
    scaled_gram as j_scaled_gram_kernel)
from repro.kernels.nystrom_recon.ref import scaled_gram_ref  # noqa: E402
from repro_torch.core import convert, engine as teng  # noqa: E402
from repro_torch.core import kernels_fn as tkf  # noqa: E402
from repro_torch.core import nystrom as tn  # noqa: E402
from repro_torch.data import uci_like as tuci  # noqa: E402
from repro_torch.kernels.nystrom_recon import ops as nops  # noqa: E402

PLAN = dict(matmul="pallas2", fuse_krow=True, dispatch="bucketed",
            min_bucket=8)


# ----------------------------------------------------------- scaled_gram --
@pytest.mark.parametrize("n,k", [(64, 32), (170, 60), (130, 129)])
def test_scaled_gram_plain_matches_reference(n, k):
    rng = np.random.default_rng(n + k)
    b = rng.normal(size=(n, k))
    s = rng.uniform(0.1, 1.0, size=k)
    got = nops.scaled_gram(torch.from_numpy(b), torch.from_numpy(s)).numpy()
    want = np.asarray(scaled_gram_ref(jnp.asarray(b), jnp.asarray(s)))
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    b32, s32 = b.astype(np.float32), s.astype(np.float32)
    got32 = nops.scaled_gram(torch.from_numpy(b32), torch.from_numpy(s32))
    kern = j_scaled_gram_kernel(jnp.asarray(b32), jnp.asarray(s32),
                                interpret=True)
    np.testing.assert_allclose(got32.numpy(), np.asarray(kern), rtol=1e-3,
                               atol=1e-3)


def test_reference_scaled_gram_accumulates_f64_in_f32():
    """Witness (ROADMAP.md, "Faults found"): the reference's kernel sums an
    f64 B in float32 (``preferred_element_type=jnp.float32``), so on f64
    inputs it is off its own f64 oracle by more than 1e-9 of the scale
    (7.8e-8 when written); the port's sums in f64 and holds 1e-12.  Once the
    reference is fixed, this test fails and goes with the fix."""
    rng = np.random.default_rng(0)
    b, s = rng.normal(size=(130, 129)), rng.uniform(0.1, 1.0, size=129)
    want = np.asarray(scaled_gram_ref(jnp.asarray(b), jnp.asarray(s)))
    scale = np.abs(want).max()
    kern = np.asarray(j_scaled_gram_kernel(jnp.asarray(b), jnp.asarray(s),
                                           interpret=True))
    assert np.abs(kern - want).max() > 1e-9 * scale
    got = nops.scaled_gram(torch.from_numpy(b), torch.from_numpy(s)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * scale


# ------------------------------------------------------------- the state --
def _data(n=40, d=4, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    sigma = float(np.median(((X[:, None] - X[None]) ** 2).sum(-1)))
    return X, sigma, rng


def _specs(sigma, name="rbf", **kw):
    return (jkf.KernelSpec(name=name, sigma=sigma, **kw),
            tkf.KernelSpec(name=name, sigma=sigma, **kw))


def _fixed_pair(X, sigma, m0=5, m1=14, capacity=24, plan=None):
    """Both packages' fixed-row states grown from m0 to m1 landmarks."""
    jspec, tspec = _specs(sigma)
    js = jn.init_nystrom(jnp.asarray(X), jnp.asarray(X[:m0]), capacity,
                         jspec, dtype=jnp.float64)
    ts = tn.init_nystrom(torch.tensor(X), torch.tensor(X[:m0]), capacity,
                         tspec, dtype=torch.float64)
    jp = jeng.UpdatePlan(**plan) if plan else jeng.DEFAULT_PLAN
    tp = teng.UpdatePlan(**plan) if plan else teng.DEFAULT_PLAN
    for i in range(m0, m1):
        js = jn.add_landmark(js, jnp.asarray(X), jnp.asarray(X[i]), jspec,
                             plan=jp)
        ts = tn.add_landmark(ts, torch.tensor(X), torch.tensor(X[i]), tspec,
                             plan=tp)
    return js, ts, jspec, tspec


def _grown_pair(seed=7, d=3, n_obs=30, every=3, capacity=16, plan=None):
    """Both packages' grow_rows states: every ``every``-th observed point
    also becomes a landmark, through the bucketed ``Engine``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, d))
    jspec, tspec = _specs(4.0)
    plan = plan or PLAN
    je = jeng.Engine(jspec, jeng.UpdatePlan(**plan), adjusted=False)
    te = teng.Engine(tspec, teng.UpdatePlan(**plan), adjusted=False)
    js = jn.init_nystrom(None, jnp.asarray(X[:4]), capacity, jspec,
                         dtype=jnp.float64, grow_rows=True)
    ts = tn.init_nystrom(None, torch.tensor(X[:4]), capacity, tspec,
                         dtype=torch.float64, grow_rows=True)
    for i in range(4, n_obs):
        js = jn.observe_rows(js, jnp.asarray(X[i]), jspec, plan=je.plan)
        ts = tn.observe_rows(ts, torch.tensor(X[i]), tspec, plan=te.plan)
        if i % every == 0:
            js = je.add_landmark(js, None, jnp.asarray(X[i]))
            ts = te.add_landmark(ts, None, torch.tensor(X[i]))
    return X, js, ts, jspec, tspec


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


def _assert_states_match(js, ts, atol=1e-9):
    m = int(js.kpca.m)
    assert int(ts.kpca.m) == m
    _close(np.sort(ts.kpca.L.numpy()[:m]), np.sort(np.asarray(js.kpca.L)[:m]),
           atol)
    _close(ts.Knm.numpy(), np.asarray(js.Knm), 1e-10)
    if js.Xrows is None:
        assert ts.Xrows is None
    else:
        _close(ts.Xrows.numpy(), np.asarray(js.Xrows), 0.0)


@pytest.mark.parametrize("plan", [None, PLAN], ids=["default", "pallas2"])
def test_fixed_rows_state_and_reconstruction_match_reference(plan):
    X, sigma, _ = _data()
    js, ts, jspec, tspec = _fixed_pair(X, sigma, plan=plan)
    _assert_states_match(js, ts)
    want = np.asarray(jn.reconstruct_tilde(js))
    for use_pallas in (False, True):
        _close(tn.reconstruct_tilde(ts, use_pallas=use_pallas).numpy(), want,
               1e-9)
    _close(tn.trace_error(ts, tspec, torch.tensor(X)),
           jn.trace_error(js, jspec, jnp.asarray(X)), 1e-9)


def test_grow_rows_state_and_functions_match_reference():
    X, js, ts, jspec, tspec = _grown_pair()
    assert ts.Knm.shape[0] == X.shape[0]
    _assert_states_match(js, ts)
    _close(tn.reconstruct_tilde(ts, use_pallas=True).numpy(),
           np.asarray(jn.reconstruct_tilde(js)), 1e-9)
    _close(tn.trace_error(ts, tspec), jn.trace_error(js, jspec), 1e-9)
    rng = np.random.default_rng(1)
    for x in (X[6], rng.normal(size=X.shape[1])):
        _close(tn.admission_residual(ts, torch.tensor(x), tspec),
               jn.admission_residual(js, jnp.asarray(x), jspec), 1e-10)
        td, tres = tn.admission_trace_delta(ts, torch.tensor(x), tspec)
        jd, jres = jn.admission_trace_delta(js, jnp.asarray(x), jspec)
        _close(td, jd, 1e-9)
        _close(tres, jres, 1e-10)


@pytest.mark.parametrize("fuse_krow", [False, True])
def test_eigpairs_and_query_features_match_reference(fuse_krow):
    X, sigma, rng = _data()
    js, ts, jspec, tspec = _fixed_pair(X, sigma)
    n = X.shape[0]
    jl, ju = jn.nystrom_eigpairs(js, n)
    tl, tu = tn.nystrom_eigpairs(ts, n)
    _close(tl.numpy(), np.asarray(jl), 1e-9)
    _close((tu * tl) @ tu.T, (np.asarray(ju) * np.asarray(jl)) @ np.asarray(
        ju).T, 1e-9)
    xq = rng.normal(size=(7, X.shape[1]))
    jplan = jeng.UpdatePlan(fuse_krow=fuse_krow)
    tplan = teng.UpdatePlan(fuse_krow=fuse_krow)
    jf = np.asarray(jn.query_features(js, jnp.asarray(xq), n, jspec,
                                      plan=jplan))
    tf = tn.query_features(ts, torch.tensor(xq), n, tspec, plan=tplan)
    _close(np.abs(tf.numpy()), np.abs(jf), 1e-9)
    _close((tf * tl) @ tf.T, (jf * np.asarray(jl)) @ jf.T, 1e-9)


def test_pinv_and_approximation_error_match_reference():
    L = np.array([5.0, 1e-20, 2.0, -3e-19, 7.0, 9.0])
    mask = np.arange(6) < 5
    _close(tn._pinv_lam(torch.tensor(L), torch.tensor(mask)).numpy(),
           np.asarray(jn._pinv_lam(jnp.asarray(L), jnp.asarray(mask))), 0.0)
    rng = np.random.default_rng(3)
    A = rng.normal(size=(9, 9))
    K, Kt = A @ A.T, A[:, :4] @ A[:, :4].T
    te = tn.approximation_error(torch.tensor(K), torch.tensor(Kt))
    je = jn.approximation_error(jnp.asarray(K), jnp.asarray(Kt))
    np.testing.assert_allclose([te.fro, te.spectral, te.trace],
                               [je.fro, je.spectral, je.trace], rtol=1e-12)
    e = tn.approximation_error(torch.eye(4), torch.zeros(4, 4))
    assert e.fro == 2.0 and e.spectral == 1.0 and e.trace == 4.0


def test_trace_identity_and_fallbacks_match_reference():
    """trace_error equals the trace norm of K - K̃ (rtol 1e-8, as in
    ``tests/test_nystrom.py``), and the no-x_all fallbacks behave as the
    reference's: stored landmarks covering the rows, a constant diagonal,
    and the underdetermined case raising."""
    X, sigma, _ = _data()
    js, ts, jspec, tspec = _fixed_pair(X, sigma, m1=12)
    K = tkf.gram_block(torch.tensor(X), torch.tensor(X), spec=tspec)
    te = float(tn.trace_error(ts, tspec, torch.tensor(X)))
    off = tn.approximation_error(K, tn.reconstruct_tilde(ts)).trace
    np.testing.assert_allclose(te, off, rtol=1e-8)
    np.testing.assert_allclose(float(tn.trace_error(ts, tspec)), te,
                               rtol=1e-12)
    rng = np.random.default_rng(59)
    x_all = rng.normal(size=(6, 3))
    jpoly, tpoly = _specs(1.0, name="poly", degree=2, coef0=1.0)
    st = tn.init_nystrom(torch.tensor(x_all), torch.tensor(x_all[:2]), 16,
                         tpoly, dtype=torch.float64)
    sj = jn.init_nystrom(jnp.asarray(x_all), jnp.asarray(x_all[:2]), 16,
                         jpoly, dtype=jnp.float64)
    te_, je_ = teng.Engine(tpoly, adjusted=False), jeng.Engine(
        jpoly, jeng.UpdatePlan(), adjusted=False)
    for i in range(2, 6):
        st = te_.add_landmark(st, torch.tensor(x_all), torch.tensor(x_all[i]))
        sj = je_.add_landmark(sj, jnp.asarray(x_all), jnp.asarray(x_all[i]))
    _close(tn.trace_error(st, tpoly), jn.trace_error(sj, jpoly), 1e-10)
    st3 = tn.init_nystrom(torch.tensor(X), torch.tensor(X[:3]), 16, tpoly,
                          dtype=torch.float64)
    with pytest.raises(ValueError, match="underdetermined"):
        tn.trace_error(st3, tpoly)


def test_tracker_and_stopping_rule_match_reference():
    """TraceErrorTracker over observe/admit with a periodic re-anchor, and
    SufficientSubsetRule on one error trend, in both packages."""
    rng = np.random.default_rng(53)
    d = 3
    jspec, tspec = _specs(4.0)
    je = jeng.Engine(jspec, jeng.UpdatePlan(), adjusted=False)
    te = teng.Engine(tspec, adjusted=False)
    x0 = rng.normal(size=(4, d))
    js = jn.init_nystrom(None, jnp.asarray(x0), 16, jspec, grow_rows=True,
                         dtype=jnp.float64)
    ts = tn.init_nystrom(None, torch.tensor(x0), 16, tspec, grow_rows=True,
                         dtype=torch.float64)
    jt = jn.TraceErrorTracker(js, jspec, resync_every=3)
    tt = tn.TraceErrorTracker(ts, tspec, resync_every=3)
    jr, tr = jn.SufficientSubsetRule(rel_tol=0.05, patience=2), \
        tn.SufficientSubsetRule(rel_tol=0.05, patience=2)
    for _ in range(7):
        x = rng.normal(size=(d,))
        jt.observe(js, jnp.asarray(x))
        tt.observe(ts, torch.tensor(x))
        js = jn.observe_rows(js, jnp.asarray(x), jspec)
        ts = tn.observe_rows(ts, torch.tensor(x), tspec)
        jprev, tprev = js, ts
        js = je.add_landmark(js, None, jnp.asarray(x))
        ts = te.add_landmark(ts, None, torch.tensor(x))
        jt.admitted(jprev, jnp.asarray(x))
        tt.admitted(tprev, torch.tensor(x))
        jt.maybe_resync(js)
        tt.maybe_resync(ts)
        np.testing.assert_allclose(tt.value, jt.value, atol=1e-9)
        assert tr.observe(tt.value) == jr.observe(jt.value)
    np.testing.assert_allclose(tt.value, float(tn.trace_error(ts, tspec)),
                               atol=1e-9)
    assert tr.history == pytest.approx(jr.history, abs=1e-9)


def test_offer_landmark_append_matches_reference_and_leverage_raises():
    rng = np.random.default_rng(11)
    jspec, tspec = _specs(4.0)
    je = jeng.Engine(jspec, jeng.UpdatePlan(**PLAN), adjusted=False)
    te = teng.Engine(tspec, teng.UpdatePlan(**PLAN), adjusted=False)
    x0 = rng.normal(size=(4, 3))
    js = jn.init_nystrom(None, jnp.asarray(x0), 12, jspec, grow_rows=True,
                         dtype=jnp.float64)
    ts = tn.init_nystrom(None, torch.tensor(x0), 12, tspec, grow_rows=True,
                         dtype=torch.float64)
    actions = []
    for _ in range(10):
        x = rng.normal(size=(3,))
        js = jn.observe_rows(js, jnp.asarray(x), jspec)
        ts = tn.observe_rows(ts, torch.tensor(x), tspec)
        js, ja = je.offer_landmark(js, jnp.asarray(x), budget=9)
        ts, ta = te.offer_landmark(ts, torch.tensor(x), budget=9)
        assert ja == ta
        actions.append(ta)
    assert actions.count("admitted") == 5 and actions[-1] == "rejected"
    _assert_states_match(js, ts)
    lev = teng.Engine(tspec, teng.UpdatePlan(landmark_policy="leverage"),
                      adjusted=False)
    with pytest.raises(NotImplementedError, match="item 5"):
        lev.offer_landmark(ts, torch.tensor(x))


def test_nystrom_state_carried_across_continues_as_the_reference():
    """A grow_rows state built in JAX crosses over as numpy arrays
    (``convert.nystrom_from_numpy``); both packages then observe and admit
    the same points and agree at ``tests/test_nystrom.py``'s tolerances."""
    X, js, _, jspec, tspec = _grown_pair(n_obs=18)
    fields = {k: np.asarray(getattr(js.kpca, k)) for k in convert.FIELDS}
    fields.update(Knm=np.asarray(js.Knm), Xrows=np.asarray(js.Xrows))
    ts = convert.nystrom_from_numpy(fields, device="cpu")
    back = convert.nystrom_to_numpy(ts)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v)
    je = jeng.Engine(jspec, jeng.UpdatePlan(**PLAN), adjusted=False)
    te = teng.Engine(tspec, teng.UpdatePlan(**PLAN), adjusted=False)
    rng = np.random.default_rng(5)
    for _ in range(6):
        x = rng.normal(size=(X.shape[1],))
        js = jn.observe_rows(js, jnp.asarray(x), jspec)
        ts = tn.observe_rows(ts, torch.tensor(x), tspec)
        js = je.add_landmark(js, None, jnp.asarray(x))
        ts = te.add_landmark(ts, None, torch.tensor(x))
    _assert_states_match(js, ts)
    _close(tn.trace_error(ts, tspec), jn.trace_error(js, jspec), 1e-9)
    with pytest.raises(ValueError, match="inconsistent"):
        convert.nystrom_from_numpy({**fields, "Knm": np.zeros((3, 5))},
                                   device="cpu")


def test_grow_rows_argument_validation():
    _, tspec = _specs(2.0)
    x = torch.zeros((3, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="x_all=None"):
        tn.init_nystrom(x, x, 8, tspec, grow_rows=True)
    with pytest.raises(ValueError, match="x_all is required"):
        tn.init_nystrom(None, x, 8, tspec)
    st = tn.init_nystrom(x, x, 8, tspec)
    with pytest.raises(ValueError, match="grow_rows"):
        tn.observe_rows(st, x[0], tspec)


def test_constant_diag_and_datasets_match_reference():
    for name in ("rbf", "matern32", "linear", "poly"):
        jspec, tspec = _specs(2.0, name=name)
        assert tkf.constant_diag(tspec) == jkf.constant_diag(jspec)
    np.testing.assert_array_equal(tuci.magic_like(n=300, seed=4),
                                  juci.magic_like(n=300, seed=4))
    np.testing.assert_array_equal(tuci.yeast_like(n=200),
                                  juci.yeast_like(n=200))
    np.testing.assert_array_equal(tuci.load_dataset("magic", n=500),
                                  juci.load_dataset("magic", n=500))


def test_f32_trace_error_gap_is_the_references_too():
    """Both packages' f32 Nyström on the same ``magic_like`` rows (256,
    d = 10, RBF at the median heuristic) and the same landmark order, 8
    seed landmarks grown to 48 on the fused-pair plan, each ``trace_error``
    against the f64 recomputation from the dense grams (pseudo-inverse cut
    at capacity·eps32·λmax, as the f32 run's ``_pinv_lam`` cuts it).

    When written: the port 1.6e-6 off, the reference 1.15 off.  The
    reference's gap is its streamed f32 eigenvalues, 7.9e-3·λmax off eigh
    of the landmarks' gram (the port's 2.4e-7·λmax): the f32 drift of
    ROADMAP.md §3.  So the f32 gap that ``chip_smoke.py`` reads on the
    card (~2e-3 at capacity 512) is not the port's own."""
    n, capacity, m0, m1 = 256, 64, 8, 48
    X = tuci.load_dataset("magic", n=n, seed=0)
    np.testing.assert_array_equal(X, juci.load_dataset("magic", n=n, seed=0))
    sigma = float(tkf.median_heuristic(torch.tensor(X)))
    jspec, tspec = _specs(sigma)
    order = np.random.default_rng(0).permutation(n)
    je = jeng.Engine(jspec, jeng.UpdatePlan(**PLAN), adjusted=False)
    te = teng.Engine(tspec, teng.UpdatePlan(**PLAN), adjusted=False)
    Xj, Xt = jnp.asarray(X, jnp.float32), torch.tensor(X, dtype=torch.float32)
    js = jn.init_nystrom(Xj, Xj[order[:m0]], capacity, jspec,
                         dtype=jnp.float32)
    ts = tn.init_nystrom(Xt, Xt[order[:m0]], capacity, tspec,
                         dtype=torch.float32)
    for i in range(m0, m1):
        js = je.add_landmark(js, Xj, Xj[order[i]])
        ts = te.add_landmark(ts, Xt, Xt[order[i]])
    X64 = torch.tensor(X)
    lm = X64[order[:m1]]
    lam, V = torch.linalg.eigh(tkf.gram_block(lm, lm, spec=tspec))
    ok = lam > capacity * torch.finfo(torch.float32).eps * lam.max()
    B = tkf.gram_block(X64, lm, spec=tspec) @ V[:, ok]
    exact = float((tkf.kernel_diag(X64, spec=tspec)
                   - (B ** 2 / lam[ok]).sum(1)).sum())
    port = abs(float(tn.trace_error(ts, tspec, Xt)) - exact) / exact
    ref = abs(float(jn.trace_error(js, jspec, Xj)) - exact) / exact
    assert port < 1e-4
    assert ref > 0.1 and ref > 100 * port
    # Where the reference's gap comes from: its streamed f32 eigenvalues,
    # against eigh of the same landmarks' gram (in units of λmax).
    eig_port = np.abs(np.sort(ts.kpca.L.numpy()[:m1]) - lam.numpy()).max()
    eig_ref = np.abs(np.sort(np.asarray(js.kpca.L)[:m1])
                     - lam.numpy()).max()
    lmax = float(lam.max())
    assert eig_port < 1e-5 * lmax
    assert eig_ref > 1e-3 * lmax
