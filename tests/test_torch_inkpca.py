"""The port's streaming KPCA against the reference's, point for point.

A 40-point Algorithm 2 stream runs under the slice's plan
``UpdatePlan(matmul="pallas", fuse_krow=True, dispatch="bucketed",
min_bucket=16)`` in f64 through both packages' ``KPCAStream`` (the port on
the CPU, where every kernel wrapper runs its plain version).  Tolerances
are ``tests/test_inkpca.py``'s: eigenvalues atol 1e-9, S and K1 rtol
1e-10, and 5e-5 of the spectrum's scale against the batch eigh oracle.
The f32 tests hold the two packages' f32 streams together where the
reference has not drifted, and witness where it has.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng, inkpca as jink  # noqa: E402
from repro.core import kernels_fn as jkf  # noqa: E402
from repro_torch.core import batch as tbatch, engine as teng  # noqa: E402
from repro_torch.core import inkpca as tink  # noqa: E402
from repro_torch.core import kernels_fn as tkf  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

PLAN = dict(matmul="pallas", fuse_krow=True, dispatch="bucketed",
            min_bucket=16)
CAPACITY = 64
N_SEED, N_STREAM = 4, 40


def _data(seed=0, n=N_SEED + N_STREAM, d=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    sigma = float(np.median(((X[:, None] - X[None]) ** 2).sum(-1)))
    return X, rng.normal(size=(9, d)), sigma


def _streams(adjusted, kernel="rbf", plan=PLAN):
    X, Q, sigma = _data()
    if kernel == "matern32":
        # Matern's bandwidth is a distance, not a squared one.  At the
        # squared-distance median the gram is near-singular and the
        # reference drifts (see the test below).
        sigma = float(np.sqrt(sigma))
    jspec = jkf.KernelSpec(name=kernel, sigma=sigma)
    tspec = tkf.KernelSpec(name=kernel, sigma=sigma)
    js = jink.KPCAStream(jnp.asarray(X[:N_SEED]), CAPACITY, jspec,
                         adjusted=adjusted, plan=jeng.UpdatePlan(**plan),
                         dtype=jnp.float64)
    ts = tink.KPCAStream(X[:N_SEED], CAPACITY, tspec, adjusted=adjusted,
                         plan=teng.UpdatePlan(**plan), dtype=torch.float64,
                         device="cpu")
    for x in X[N_SEED:]:
        js.update(jnp.asarray(x))
        ts.update(x)
    return X, Q, js, ts, tspec


def _assert_components_match(got, want, atol):
    """Transform outputs agree up to the sign of each component."""
    for c in range(want.shape[1]):
        sign = np.sign(np.dot(got[:, c], want[:, c])) or 1.0
        np.testing.assert_allclose(sign * got[:, c], want[:, c], atol=atol)


@pytest.mark.parametrize("adjusted", [True, False],
                         ids=["algorithm2", "algorithm1"])
def test_stream_matches_reference_and_batch_oracle(adjusted):
    X, Q, js, ts, tspec = _streams(adjusted)
    jst, tst = js.state, ts.state
    m = N_SEED + N_STREAM
    assert ts.m == int(tst.m) == int(jst.m) == m
    np.testing.assert_allclose(np.sort(tst.L.numpy()[:m]),
                               np.sort(np.asarray(jst.L)[:m]), atol=1e-9)
    np.testing.assert_allclose(float(tst.S), float(jst.S), rtol=1e-10)
    np.testing.assert_allclose(tst.K1.numpy(), np.asarray(jst.K1),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(tst.X.numpy(), np.asarray(jst.X))

    # Against the batch eigh oracle of the same points.
    K = tkf.gram_block(torch.tensor(X), torch.tensor(X), spec=tspec)
    lam_ref = tbatch.batch_kpca(K, adjusted=adjusted)[0].numpy()
    scale = max(1.0, np.abs(lam_ref).max())
    assert np.abs(np.sort(tst.L.numpy()[:m]) - lam_ref).max() / scale < 5e-5

    k = 4
    _assert_components_match(ts.transform(Q, k).numpy(),
                             np.asarray(js.transform(jnp.asarray(Q), k)),
                             atol=1e-8)


def test_matern_stream_matches_reference():
    X, Q, js, ts, tspec = _streams(True, kernel="matern32")
    m = N_SEED + N_STREAM
    lam = np.sort(ts.state.L.numpy()[:m])
    np.testing.assert_allclose(lam, np.sort(np.asarray(js.state.L)[:m]),
                               atol=1e-9)
    K = tkf.gram_block(torch.tensor(X), torch.tensor(X), spec=tspec)
    lam_ref = tbatch.batch_kpca(K, adjusted=True)[0].numpy()
    assert np.abs(lam - lam_ref).max() / max(1.0, lam_ref.max()) < 5e-5


@pytest.mark.parametrize("duplicates", [False, True],
                         ids=["iid", "near_duplicates"])
def test_f32_stream_tracks_the_oracle(duplicates):
    """An f32 state under ``precise`` stays close to the eigh oracle: its
    displacement deflation uses the f64 solve's eps (the reference's uses
    the state's, and drifts 1.3e-2 relative within 50 points of this
    data).  Near-duplicate points exercise the cluster merge, which keeps
    the state's eps so that U stays orthogonal in f32."""
    rng = np.random.default_rng(0)
    d = 16
    pts = rng.normal(size=(100, d))
    if duplicates:
        pts = np.repeat(pts[:50], 2, axis=0) + 1e-7 * rng.normal(size=pts.shape)
    s = tink.KPCAStream(rng.normal(size=(4, d)), 128,
                        tkf.KernelSpec(sigma=float(d)),
                        plan=teng.UpdatePlan(**PLAN), dtype=torch.float32,
                        device="cpu")
    s.update_block(pts)
    m = s.m
    X = s.state.X[:m].double()
    lam_ref = tbatch.batch_kpca(tkf.gram_block(X, X, spec=s.spec),
                                adjusted=True)[0].flip(0)[:8]
    lam = s.eigpairs()[0][:8].double()
    assert float(((lam - lam_ref).abs() / lam_ref).max()) < 1e-4
    U = s.state.U[:m, :m].double()
    assert float((U.T @ U - torch.eye(m, dtype=torch.float64)).abs().max()) \
        < 1e-4


def _f32_streams(adjusted, d, points, seed=0):
    """Both packages' f32 streams under the slice's plan, RBF with σ = d,
    over ``points`` points after 4 seed points, on the same numpy data."""
    rng = np.random.default_rng(seed)
    X0 = rng.normal(size=(4, d))
    pts = rng.normal(size=(points, d))
    js = jink.KPCAStream(jnp.asarray(X0, jnp.float32), CAPACITY,
                         jkf.KernelSpec(sigma=float(d)), adjusted=adjusted,
                         plan=jeng.UpdatePlan(**PLAN), dtype=jnp.float32)
    ts = tink.KPCAStream(X0, CAPACITY, tkf.KernelSpec(sigma=float(d)),
                         adjusted=adjusted, plan=teng.UpdatePlan(**PLAN),
                         dtype=torch.float32, device="cpu")
    for x in pts:
        js.update(jnp.asarray(x, jnp.float32))
        ts.update(x)
    return js, ts, rng.normal(size=(9, d))


def _top8_rel_err(lam, X, spec):
    """Largest relative error of the top-8 eigenvalues ``lam`` (descending)
    against the f64 eigh of the batch Algorithm 2 gram of ``X``."""
    X = torch.as_tensor(X, dtype=torch.float64)
    lam_ref = tbatch.batch_kpca(tkf.gram_block(X, X, spec=spec),
                                adjusted=True)[0].flip(0)[:8]
    lam = torch.as_tensor(np.asarray(lam[:8]), dtype=torch.float64)
    return float(((lam - lam_ref).abs() / lam_ref).max())


@pytest.mark.parametrize("adjusted,d,points", [(True, 4, 1), (False, 16, 5)],
                         ids=["algorithm2", "algorithm1"])
def test_f32_stream_matches_reference_over_its_agreeing_prefix(adjusted, d,
                                                               points):
    """The port's f32 stream against the reference's, under the slice's
    plan, over the prefix on which the reference's spectrum has not yet
    drifted.  The reference's f32 Algorithm 2 drops components the f64
    solve resolves (see the test below) and parts from the oracle by 1e-3
    of the scale within one or two points on most data; on this data its
    spectrum holds for the first point (Algorithm 1: five points).  There
    both spectra sit within 3e-6 of the scale of each other; the bar is
    1e-5, about 80 f32 ulps of the largest eigenvalue.

    The reference's eigenvectors part earlier: its transforms are 5e-4
    (Algorithm 1: 8e-5) of their largest entry off the f64 stream's at the
    end of this prefix.  The port's transforms are held to the f64
    stream's (which matches the reference's f64 stream at 1e-8, above)
    at 1e-5."""
    js, ts, Q = _f32_streams(adjusted, d, points)
    m = 4 + points
    assert ts.m == int(js.state.m) == m
    lam_j = np.sort(np.asarray(js.state.L)[:m])
    lam_t = np.sort(ts.state.L.numpy()[:m])
    scale = float(np.abs(lam_j).max())
    np.testing.assert_allclose(lam_t, lam_j, atol=1e-5 * scale)
    np.testing.assert_allclose(float(ts.state.S), float(js.state.S),
                               rtol=1e-6)
    np.testing.assert_allclose(ts.state.K1.numpy(), np.asarray(js.state.K1),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ts.state.X.numpy(), np.asarray(js.state.X))

    rng = np.random.default_rng(0)
    X0 = rng.normal(size=(4, d))
    t64 = tink.KPCAStream(X0, CAPACITY, tkf.KernelSpec(sigma=float(d)),
                          adjusted=adjusted, plan=teng.UpdatePlan(**PLAN),
                          dtype=torch.float64, device="cpu")
    t64.update_block(rng.normal(size=(points, d)))
    want = t64.transform(Q, 3).numpy()
    _assert_components_match(ts.transform(Q, 3).numpy().astype(np.float64),
                             want, atol=1e-5 * np.abs(want).max())


def test_reference_f32_stream_drifts_where_the_port_does_not():
    """Witness of the reference's f32 fault (ROADMAP.md, "Faults found"):
    under ``precise`` its displacement deflation uses the f32 state's eps,
    so over 50 points of this data its top-8 eigenvalues part from the
    eigh oracle by more than 1e-3 relative (1.5e-2 when written), while
    the port's, deflating at the f64 solve's eps, stay under
    ``test_f32_stream_tracks_the_oracle``'s 1e-4 (5.6e-7 when written).
    Once the reference is fixed, this test fails and goes with the fix."""
    d = 16
    js, ts, _ = _f32_streams(True, d, 50)
    m = ts.m
    X = ts.state.X[:m].numpy()
    spec = tkf.KernelSpec(sigma=float(d))
    lam_j = np.sort(np.asarray(js.state.L)[:m])[::-1].astype(np.float64)
    assert _top8_rel_err(lam_j, X, spec) > 1e-3
    assert _top8_rel_err(ts.eigpairs()[0].numpy(), X, spec) < 1e-4


def test_matern_near_singular_gram_tracks_the_oracle():
    """At the squared-distance median the Matern gram is near-singular and
    roots come within eps of their poles.  The reference's rotation (no
    eps guard) drifts 1.2e-2 from the oracle here, so the port is held to
    the oracle alone (ROADMAP.md, "Faults found")."""
    X, _, sigma = _data()
    spec = tkf.KernelSpec(name="matern32", sigma=sigma)
    s = tink.KPCAStream(X[:N_SEED], CAPACITY, spec, plan=teng.UpdatePlan(**PLAN),
                        dtype=torch.float64, device="cpu")
    s.update_block(X[N_SEED:])
    K = tkf.gram_block(torch.tensor(X), torch.tensor(X), spec=spec)
    lam_ref = tbatch.batch_kpca(K, adjusted=True)[0].numpy()
    lam = np.sort(s.state.L.numpy()[:N_SEED + N_STREAM])
    assert np.abs(lam - lam_ref).max() / max(1.0, lam_ref.max()) < 5e-5


def test_unfused_fixed_plan_matches_fused_bucketed():
    """The dense route with the unfused prologue at fixed capacity reaches
    the same eigensystem as the slice's plan."""
    X, _, sigma = _data(seed=5, n=24)
    spec = tkf.KernelSpec(sigma=sigma)
    out = []
    for plan in (teng.UpdatePlan(**PLAN),
                 teng.UpdatePlan(matmul="jnp", dispatch="fixed")):
        s = tink.KPCAStream(X[:4], 32, spec, plan=plan, dtype=torch.float64,
                            device="cpu")
        s.update_block(X[4:])
        out.append(s.eigpairs()[0].numpy()[:24])
    np.testing.assert_allclose(out[0], out[1], atol=1e-9)


def test_unported_plans_raise_with_their_roadmap_item():
    """The health and metrics plans are ported (ROADMAP.md item 7): a
    stream with either runs and ends bit for bit equal to the plain
    stream, with its lane riding beside it; a health field that is not a
    policy raises."""
    from repro_torch.core import health as thl

    X, _, sigma = _data(n=10)
    spec = tkf.KernelSpec(sigma=sigma)
    states = []
    for plan in (teng.UpdatePlan(), teng.UpdatePlan(health=thl.HealthPolicy()),
                 teng.UpdatePlan(metrics=True)):
        s = tink.KPCAStream(X[:4], 16, spec, plan=plan, device="cpu")
        s.update_block(torch.tensor(X[4:], dtype=torch.float32))
        states.append(s)
    for s in states[1:]:
        assert all(torch.equal(a, b) for a, b in zip(s.state,
                                                     states[0].state))
    assert states[1].health_report()["probes"] == 6
    assert states[2].metrics_report()["ingests"] == 6
    with pytest.raises(TypeError, match="HealthPolicy"):
        tink.KPCAStream(X[:4], 8, spec, plan=teng.UpdatePlan(health=True),
                        device="cpu")


def test_full_state_raises_under_both_dispatches():
    X, _, sigma = _data(n=6)
    for dispatch in ("fixed", "bucketed"):
        s = tink.KPCAStream(X[:4], 5, tkf.KernelSpec(sigma=sigma),
                            dispatch=dispatch, device="cpu")
        s.update(X[4])
        with pytest.raises(ValueError, match="need room"):
            s.update(X[5])


def test_cuda_is_the_default_device_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tink.KPCAStream(np.zeros((2, 3)), 8, tkf.KernelSpec())
