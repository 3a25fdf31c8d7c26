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
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

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
    """The append policy admits until the budget, as the reference; the
    leverage policy (``consider_landmark``) takes the reference's actions
    on the same offers and ends in the same state."""
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
    lplan = dict(PLAN, landmark_policy="leverage")
    jl = jeng.Engine(jspec, jeng.UpdatePlan(**lplan), adjusted=False)
    tl = teng.Engine(tspec, teng.UpdatePlan(**lplan), adjusted=False)
    actions = []
    for _ in range(12):
        x = rng.normal(size=(3,))
        js = jn.observe_rows(js, jnp.asarray(x), jspec)
        ts = tn.observe_rows(ts, torch.tensor(x), tspec)
        js, ja = jl.offer_landmark(js, jnp.asarray(x), budget=11)
        ts, ta = tl.offer_landmark(ts, torch.tensor(x), budget=11)
        assert ja == ta
        actions.append(ta)
    assert {"admitted", "rejected"} <= set(actions)
    _assert_states_match(js, ts)


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


# ---------------------------------------------------- landmark lifecycle --
def _batch_tilde(K, keep):
    return K[:, keep] @ np.linalg.solve(K[np.ix_(keep, keep)], K[:, keep].T)


def _gram(X, spec):
    return tkf.gram_block(torch.tensor(X), torch.tensor(X), spec=spec).numpy()


def test_remove_landmark_matches_reference_and_batch():
    """``tests/test_nystrom.py``'s removal at j = 0, 3 and 11 (first,
    interior, boundary): K̃ equals batch Nyström on the survivors (atol
    1e-9) and the reference's; the evicted column is zero, the
    survivors' columns in order (atol 1e-12)."""
    X, sigma, _ = _data(n=30)
    js, ts, jspec, tspec = _fixed_pair(X, sigma, m1=12)
    K = _gram(X, tspec)
    for j in (0, 3, 11):
        t2 = tn.remove_landmark(ts, j, tspec)
        j2 = jn.remove_landmark(js, jnp.int32(j), jspec)
        keep = [i for i in range(12) if i != j]
        got = tn.reconstruct_tilde(t2).numpy()
        _close(got, _batch_tilde(K, keep), 1e-9)
        _close(got, np.asarray(jn.reconstruct_tilde(j2)), 1e-9)
        assert int(t2.kpca.m) == 11
        assert float(t2.Knm[:, 11:].abs().max()) == 0.0
        _close(t2.Knm[:, :11].numpy(), K[:, keep], 1e-12)
        _assert_states_match(j2, t2)


def test_replace_landmark_matches_reference_and_batch():
    """Replacement is removal then admission: batch Nyström on the swapped
    set (atol 1e-8, the reference's), the reference's state, and a
    landmark replaced by itself leaves K̃ unchanged (atol 1e-9)."""
    X, sigma, _ = _data(n=30)
    js, ts, jspec, tspec = _fixed_pair(X, sigma, m1=12)
    K = _gram(X, tspec)
    t2 = tn.replace_landmark(ts, torch.tensor(X), 2, torch.tensor(X[20]),
                             tspec)
    j2 = jn.replace_landmark(js, jnp.asarray(X), jnp.int32(2),
                             jnp.asarray(X[20]), jspec)
    keep = [i for i in range(12) if i != 2] + [20]
    _close(tn.reconstruct_tilde(t2).numpy(), _batch_tilde(K, keep), 1e-8)
    _assert_states_match(j2, t2)
    t3 = tn.replace_landmark(ts, torch.tensor(X), 11, torch.tensor(X[11]),
                             tspec)
    _close(tn.reconstruct_tilde(t3).numpy(),
           tn.reconstruct_tilde(ts).numpy(), 1e-9)


@pytest.mark.parametrize("matmul", ["jnp", "pallas", "pallas2"])
def test_engine_remove_and_replace_bucketed_match_fixed(matmul):
    """Bucketed ``Engine.remove_landmark``/``replace_landmark`` equal the
    module functions at capacity (atol 1e-10, the reference's) and the
    reference's bucketed engine (atol 1e-9), on each rotation route."""
    X, sigma, _ = _data(n=30)
    jspec, tspec = _specs(sigma)
    plan = dict(dispatch="bucketed", min_bucket=8, matmul=matmul)
    je = jeng.Engine(jspec, jeng.UpdatePlan(**plan), adjusted=False)
    te = teng.Engine(tspec, teng.UpdatePlan(**plan), adjusted=False)
    tp = teng.UpdatePlan(matmul=matmul)
    js = jn.init_nystrom(jnp.asarray(X), jnp.asarray(X[:5]), 24, jspec,
                         dtype=jnp.float64)
    ts = tn.init_nystrom(torch.tensor(X), torch.tensor(X[:5]), 24, tspec,
                         dtype=torch.float64)
    for i in range(5, 12):
        js = je.add_landmark(js, jnp.asarray(X), jnp.asarray(X[i]))
        ts = te.add_landmark(ts, torch.tensor(X), torch.tensor(X[i]))
    a = te.remove_landmark(ts, 3)
    _close(tn.reconstruct_tilde(a).numpy(),
           tn.reconstruct_tilde(tn.remove_landmark(ts, 3, tspec,
                                                   plan=tp)).numpy(), 1e-10)
    _assert_states_match(je.remove_landmark(js, 3), a)
    c = te.replace_landmark(ts, torch.tensor(X), 3, torch.tensor(X[25]))
    d = tn.replace_landmark(ts, torch.tensor(X), 3, torch.tensor(X[25]),
                            tspec, plan=tp)
    _close(tn.reconstruct_tilde(c).numpy(),
           tn.reconstruct_tilde(d).numpy(), 1e-10)
    _assert_states_match(je.replace_landmark(js, jnp.asarray(X), 3,
                                             jnp.asarray(X[25])), c)
    assert te.downdate(ts, 3).Knm.shape == ts.Knm.shape
    for j in (12, -1):
        with pytest.raises(ValueError, match="outside active range"):
            te.remove_landmark(ts, j)
    one = ts._replace(kpca=ts.kpca._replace(
        m=torch.tensor(1, dtype=torch.int32)))
    with pytest.raises(ValueError, match="at least 2"):
        te.replace_landmark(one, None, 0, torch.tensor(X[0]))


def test_remove_landmark_grow_rows_keeps_observed_stream():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(20, 3))
    jspec, tspec = _specs(4.0)
    js = jn.init_nystrom(None, jnp.asarray(X[:4]), 12, jspec,
                         dtype=jnp.float64, grow_rows=True)
    ts = tn.init_nystrom(None, torch.tensor(X[:4]), 12, tspec,
                         dtype=torch.float64, grow_rows=True)
    js = jn.observe_rows(js, jnp.asarray(X[4:]), jspec)
    ts = tn.observe_rows(ts, torch.tensor(X[4:]), tspec)
    for i in range(4, 9):
        js = jn.add_landmark(js, None, jnp.asarray(X[i]), jspec)
        ts = tn.add_landmark(ts, None, torch.tensor(X[i]), tspec)
    t2 = tn.remove_landmark(ts, 1, tspec)
    assert t2.Knm.shape == ts.Knm.shape and t2.Xrows.shape == ts.Xrows.shape
    K = _gram(X, tspec)
    _close(tn.reconstruct_tilde(t2).numpy(),
           _batch_tilde(K, [0, 2, 3, 4, 5, 6, 7, 8]), 1e-9)
    _assert_states_match(jn.remove_landmark(js, jnp.int32(1), jspec), t2)


@pytest.mark.parametrize("dispatch", ["fixed", "bucketed"])
def test_replace_landmark_donate_matches_copy(dispatch):
    """``donate=True`` writes the result into the input state's own
    storage (Knm and U keep their data pointers) and equals the copying
    spelling bit for bit; the copying spelling leaves its input as it
    was."""
    X, sigma, _ = _data(n=30)
    _, tspec = _specs(sigma)
    te = teng.Engine(tspec, teng.UpdatePlan(dispatch=dispatch, min_bucket=8),
                     adjusted=False)
    ts = tn.init_nystrom(torch.tensor(X), torch.tensor(X[:5]), 24, tspec,
                         dtype=torch.float64)
    for i in range(5, 10):
        ts = te.add_landmark(ts, torch.tensor(X), torch.tensor(X[i]))
    before = [t.clone() for t in (ts.Knm, ts.kpca.U, ts.kpca.L)]
    ref = te.replace_landmark(ts, torch.tensor(X), 2, torch.tensor(X[20]))
    for a, b in zip(before, (ts.Knm, ts.kpca.U, ts.kpca.L)):
        assert torch.equal(a, b)
    spare = ts._replace(kpca=ts.kpca._replace(
        **{k: v.clone() for k, v in ts.kpca._asdict().items()}),
        Knm=ts.Knm.clone())
    ptrs = (spare.Knm.data_ptr(), spare.kpca.U.data_ptr())
    out = te.replace_landmark(spare, torch.tensor(X), 2, torch.tensor(X[20]),
                              donate=True)
    assert (out.Knm.data_ptr(), out.kpca.U.data_ptr()) == ptrs
    for f in ("L", "U", "m", "S", "K1", "X"):
        assert torch.equal(getattr(out.kpca, f), getattr(ref.kpca, f)), f
    assert torch.equal(out.Knm, ref.Knm)


# ---------------------------------------------------- leverage admission --
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_leverage_and_residual_scores_match_reference(dtype):
    """Leverage in (0, 1] on the landmarks, zero past m, the reference's
    within 1e-12 (f64) / 1e-6 (f32: the state's own type, whose smallest
    normal floors the regulariser); a landmark is spanned (residual
    < 1e-10), a held-out point is not (> 1e-4)."""
    X, sigma, _ = _data(n=30)
    js, ts, jspec, tspec = _fixed_pair(X, sigma, m1=12)
    if dtype == "float32":
        ts = ts._replace(kpca=ts.kpca._replace(**{
            k: v.float() for k, v in ts.kpca._asdict().items()
            if v.is_floating_point()}), Knm=ts.Knm.float())
    for reg in (1e-2, 1e-6, 0.0):
        lev = tn.leverage_scores(ts, reg=reg).double().numpy()
        want = np.asarray(jn.leverage_scores(js, reg=reg))
        _close(lev, want, 1e-12 if dtype == "float64" else 1e-6)
        assert (lev[:12] > 0).all() and (lev[:12] <= 1.0 + 1e-6).all()
        assert np.abs(lev[12:]).max() == 0.0
    if dtype == "float64":
        assert float(tn.admission_residual(ts, torch.tensor(X[3]),
                                           tspec)) < 1e-10
        assert float(tn.admission_residual(ts, torch.tensor(X[25]),
                                           tspec)) > 1e-4


def test_removal_and_swap_trace_deltas_match_reference_and_recompute():
    """``removal_trace_delta`` and ``swap_trace_delta`` against the
    reference (atol 1e-9; W_jj rtol 1e-8) and against the exact
    before/after difference of ``trace_error`` (atol 1e-8)."""
    X, js, ts, jspec, tspec = _grown_pair()
    te = teng.Engine(tspec, adjusted=False)
    m = int(ts.kpca.m)
    before = float(tn.trace_error(ts, tspec))
    x = torch.tensor(np.random.default_rng(8).normal(size=X.shape[1]))
    for j in (0, m // 2, m - 1):
        inc, wjj = tn.removal_trace_delta(ts, j)
        jinc, jwjj = jn.removal_trace_delta(js, jnp.int32(j))
        _close(inc, jinc, 1e-9)
        # W_jj is a diagonal entry of K_mm⁺ (~1/λmin, 2e3 here): relative.
        np.testing.assert_allclose(float(wjj), float(jwjj), rtol=1e-8)
        after = float(tn.trace_error(te.remove_landmark(ts, j), tspec))
        _close(float(inc), after - before, 1e-8)
        net, wjj = tn.swap_trace_delta(ts, j, x, tspec)
        jnet, _ = jn.swap_trace_delta(js, jnp.int32(j), jnp.asarray(x.numpy()),
                                      jspec)
        _close(net, jnet, 1e-9)
        swapped = te.replace_landmark(ts, None, j, x)
        _close(float(net), float(tn.trace_error(swapped, tspec)) - before,
               1e-8)


def test_tracker_follows_the_lifecycle_as_the_reference():
    """A swap-heavy lifecycle (``tests/test_fused_ingest_transform.py``'s,
    over 24 points: the leverage arm never fires on an i.i.d. stream, so
    every third point from m = 6 on replaces the lowest-leverage landmark
    through ``Engine.replace_landmark``; the others are offered under the
    leverage policy), the tracker fed each event with the victim passed
    through: the tracked value equals the reference's and the exact
    recompute (atol 1e-8) after every event, and no swap resyncs."""
    rng = np.random.default_rng(15)
    d = 4
    jspec, tspec = _specs(4.0)
    plan = dict(dispatch="bucketed", min_bucket=8, landmark_policy="leverage")
    je = jeng.Engine(jspec, jeng.UpdatePlan(**plan), adjusted=False)
    te = teng.Engine(tspec, teng.UpdatePlan(**plan), adjusted=False)
    x0 = rng.normal(size=(4, d))
    js = jn.init_nystrom(None, jnp.asarray(x0), 16, jspec, grow_rows=True,
                         dtype=jnp.float64)
    ts = tn.init_nystrom(None, torch.tensor(x0), 16, tspec, grow_rows=True,
                         dtype=torch.float64)
    jt = jn.TraceErrorTracker(js, jspec, resync_every=10_000)
    tt = tn.TraceErrorTracker(ts, tspec, resync_every=10_000)
    actions = []
    for i in range(24):
        x = rng.normal(size=(d,))
        res = float(tn.admission_residual(ts, torch.tensor(x), tspec))
        jt.observe(js, jnp.asarray(x))
        tt.observe(ts, torch.tensor(x), residual=res)
        js = jn.observe_rows(js, jnp.asarray(x), jspec)
        ts = tn.observe_rows(ts, torch.tensor(x), tspec)
        jprev, tprev, info = js, ts, {}
        m = int(ts.kpca.m)
        if m >= 6 and i % 3 == 0:
            j = int(np.argmin(tn.leverage_scores(ts)[:m].numpy()))
            assert j == int(np.argmin(np.asarray(jn.leverage_scores(js)[:m])))
            js = je.replace_landmark(js, None, j, jnp.asarray(x))
            ts = te.replace_landmark(ts, None, j, torch.tensor(x))
            action, info["victim"] = "replaced", j
        else:
            js, action = je.offer_landmark(js, jnp.asarray(x), budget=6)
            ts, ta = te.offer_landmark(ts, torch.tensor(x), budget=6,
                                       residual=res, info=info)
            assert ta == action
        actions.append(action)
        if action == "admitted":
            jt.admitted(jprev, jnp.asarray(x))
            tt.admitted(tprev, torch.tensor(x))
        elif action == "replaced":
            jt.replaced(js, state_before=jprev, x=jnp.asarray(x),
                        j=info["victim"])
            tt.replaced(ts, state_before=tprev, x=torch.tensor(x),
                        j=info["victim"])
        np.testing.assert_allclose(tt.value, jt.value, atol=1e-8)
        np.testing.assert_allclose(tt.value, float(tn.trace_error(ts, tspec)),
                                   atol=1e-8)
    assert actions.count("replaced") >= 5 and "admitted" in actions
    assert tt.resyncs == 0
    _assert_states_match(js, ts)
    # The legacy spelling (the state after only) resyncs exactly.
    tt.replaced(ts)
    assert tt.resyncs == 1


def test_tracker_periodic_resync_is_deferred_to_the_next_event():
    rng = np.random.default_rng(53)
    jspec, tspec = _specs(4.0)
    te = teng.Engine(tspec, adjusted=False)
    x0 = rng.normal(size=(4, 3))
    ts = tn.init_nystrom(None, torch.tensor(x0), 16, tspec, grow_rows=True,
                         dtype=torch.float64)
    tt = tn.TraceErrorTracker(ts, tspec, resync_every=2)
    pending = []
    for _ in range(4):
        x = torch.tensor(rng.normal(size=(3,)))
        tt.observe(ts, x)
        ts = tn.observe_rows(ts, x, tspec)
        prev = ts
        ts = te.add_landmark(ts, None, x)
        tt.admitted(prev, x)
        pending.append(tt._pending_resync)
        tt.maybe_resync(ts)
    assert pending == [False, True, False, True] and tt.resyncs == 2
    np.testing.assert_allclose(tt.value, float(tn.trace_error(ts, tspec)),
                               atol=1e-10)


def test_consider_landmark_reads_and_victim():
    """The leverage policy takes all three actions on the reference's
    sequence, rejects a duplicate of a landmark without touching the
    state, stays within the budget, and reports the victim it swapped
    out (the argmin of the leverage it read)."""
    X, sigma, _ = _data(n=40)
    jspec, tspec = _specs(sigma)
    plan = dict(dispatch="bucketed", min_bucket=8)
    je = jeng.Engine(jspec, jeng.UpdatePlan(**plan), adjusted=False)
    te = teng.Engine(tspec, teng.UpdatePlan(**plan), adjusted=False)
    js = jn.init_nystrom(jnp.asarray(X), jnp.asarray(X[:5]), 24, jspec,
                         dtype=jnp.float64)
    ts = tn.init_nystrom(torch.tensor(X), torch.tensor(X[:5]), 24, tspec,
                         dtype=torch.float64)
    acts = []
    for i in range(5, 40):
        lev = tn.leverage_scores(ts)[:int(ts.kpca.m)].numpy()
        info = {}
        js, ja = jn.consider_landmark(je, js, jnp.asarray(X[i]),
                                      x_all=jnp.asarray(X), budget=10)
        ts, ta = tn.consider_landmark(te, ts, torch.tensor(X[i]),
                                      x_all=torch.tensor(X), budget=10,
                                      info=info)
        assert ja == ta
        acts.append(ta)
        if ta == "replaced":
            assert info["victim"] == int(np.argmin(lev))
    assert {"admitted", "rejected"} <= set(acts) and int(ts.kpca.m) <= 10
    _assert_states_match(js, ts)
    t2, act = tn.consider_landmark(te, ts, torch.tensor(X[0]),
                                   x_all=torch.tensor(X), budget=10)
    assert act == "rejected" and t2 is ts
    app = teng.Engine(tspec, teng.UpdatePlan(landmark_policy="append"),
                      adjusted=False)
    s0 = tn.init_nystrom(torch.tensor(X), torch.tensor(X[:5]), 24, tspec,
                         dtype=torch.float64)
    st, act = app.offer_landmark(s0, torch.tensor(X[0]),
                                 x_all=torch.tensor(X))
    assert act == "admitted" and int(st.kpca.m) == 6
    lev_engine = teng.Engine(tspec, teng.UpdatePlan(
        landmark_policy="leverage"), adjusted=False)
    st, act = lev_engine.offer_landmark(s0, torch.tensor(X[0]),
                                        x_all=torch.tensor(X))
    assert act == "rejected" and int(st.kpca.m) == 5
    with pytest.raises(ValueError):
        teng.Engine(tspec, teng.UpdatePlan(landmark_policy="bogus"))
