"""The port's incremental kernel ridge regression (``core/krr.py``)
against the reference's, on the same numpy inputs, in f64.

Mirrors ``tests/test_krr.py``: coefficients against the reference's
(atol 1e-9) and a dense solve (the reference's atol 1e-7), held-out
predictions better than the mean, a λ path of LOOCV scores, and LOOCV
residuals against brute-force refits (the reference's atol 1e-6).  A KRR
state also crosses over as numpy arrays (``convert.krr_from_numpy``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import kernels_fn as jkf, krr as jkrr  # noqa: E402
from repro_torch.core import convert, engine as teng  # noqa: E402
from repro_torch.core import kernels_fn as tkf, krr as tkrr  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401


def _problem(n, d=3, noise=0.05, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = np.sin(X[:, 0]) + 0.5 * np.cos(2 * X[:, 1]) + noise * rng.normal(
        size=n)
    sigma = float(np.median(((X[:, None] - X[None]) ** 2).sum(-1)))
    return X, y, jkf.KernelSpec(sigma=sigma), tkf.KernelSpec(sigma=sigma)


def _fit(X, y, n0, capacity, jspec, tspec, plan=None):
    js = jkrr.init_krr(jnp.asarray(X[:n0]), jnp.asarray(y[:n0]), capacity,
                       jspec)
    ts = tkrr.init_krr(torch.tensor(X[:n0]), torch.tensor(y[:n0]), capacity,
                       tspec)
    tplan = teng.UpdatePlan(**plan) if plan else teng.DEFAULT_PLAN
    for i in range(n0, X.shape[0]):
        js = jkrr.add_point(js, jnp.asarray(X[i]), y[i], jspec)
        ts = tkrr.add_point(ts, torch.tensor(X[i]), y[i], tspec, plan=tplan)
    return js, ts


@pytest.mark.parametrize("plan", [None, dict(matmul="pallas"),
                                  dict(matmul="pallas2")],
                         ids=["jnp", "pallas", "pallas2"])
def test_incremental_krr_matches_reference_and_direct_solve(plan):
    X, y, jspec, tspec = _problem(30)
    js, ts = _fit(X, y, 6, 30, jspec, tspec, plan)
    assert ts.kpca.L.dtype == torch.float64
    lam = 0.1
    alpha = tkrr.coefficients(ts, lam).numpy()[:30]
    np.testing.assert_allclose(alpha, np.asarray(jkrr.coefficients(
        js, lam))[:30], atol=1e-9)
    K = tkf.gram_block(torch.tensor(X), torch.tensor(X), spec=tspec).numpy()
    np.testing.assert_allclose(alpha, np.linalg.solve(K + lam * np.eye(30),
                                                      y), atol=1e-7)
    a_full = tkrr.coefficients(ts, lam)
    np.testing.assert_allclose(tkrr.lam_safe_dot(ts, a_full).numpy()[:30],
                               K @ alpha, atol=1e-9)


def _heldout(lam):
    """Both packages' KRR on 50 of 60 points, their predictions of the
    other 10 at ``lam``, and the dense-solve predictions."""
    X, y, jspec, tspec = _problem(60)
    js, ts = _fit(X[:50], y[:50], 10, 50, jspec, tspec)
    pred = tkrr.predict(ts, torch.tensor(X[50:]), lam, tspec).numpy()
    jpred = np.asarray(jkrr.predict(js, jnp.asarray(X[50:]), lam, jspec))
    K = tkf.gram_block(torch.tensor(X), torch.tensor(X), spec=tspec).numpy()
    dense = K[50:, :50] @ np.linalg.solve(K[:50, :50] + lam * np.eye(50),
                                          y[:50])
    return pred, jpred, dense, y[50:]


def test_krr_predicts_heldout_as_the_reference():
    """Held-out predictions: the dense solve's (atol 1e-9), better than
    the mean (the reference's bar), and the reference's within 1e-5 (its
    own distance from the dense solve here, see the next test)."""
    pred, jpred, dense, y = _heldout(0.05)
    np.testing.assert_allclose(pred, dense, atol=1e-9)
    np.testing.assert_allclose(pred, jpred, atol=1e-5)
    assert np.mean((pred - y) ** 2) < 0.5 * np.var(y)


def test_reference_krr_drifts_where_the_port_does_not():
    """Witness (ROADMAP.md §3): at n = 50 with the median-heuristic RBF
    the gram's smallest eigenvalues cluster near 1e-5, and the
    reference's streamed eigensystem leaves its predictions more than
    1e-7 off the dense solve (2.6e-6 when written); the port's stay
    within 1e-10.  It fails once the reference is repaired."""
    pred, jpred, dense, _ = _heldout(0.1)
    assert np.abs(pred - dense).max() < 1e-10
    assert np.abs(jpred - dense).max() > 1e-7


def test_lambda_sweep_and_loocv_match_reference_and_brute_force():
    """LOOCV residuals across a λ path from one eigensystem: the
    reference's (atol 1e-9), finite, over-regularisation worse than the
    best λ, and at λ = 0.1 the brute-force refit without each point
    (atol 1e-6)."""
    X, y, jspec, tspec = _problem(20)
    js, ts = _fit(X, y, 5, 24, jspec, tspec)
    scores = []
    for lam in (1e-3, 1e-2, 1e-1, 1.0, 10.0):
        e = tkrr.loocv_residuals(ts, lam).numpy()[:20]
        np.testing.assert_allclose(e, np.asarray(jkrr.loocv_residuals(
            js, lam))[:20], atol=1e-9)
        scores.append(float(np.mean(e ** 2)))
    assert np.isfinite(scores).all() and min(scores) < scores[-1]
    e = tkrr.loocv_residuals(ts, 0.1).numpy()
    K = tkf.gram_block(torch.tensor(X), torch.tensor(X), spec=tspec).numpy()
    for i in (0, 7, 19):
        idx = [j for j in range(20) if j != i]
        a = np.linalg.solve(K[np.ix_(idx, idx)] + 0.1 * np.eye(19), y[idx])
        np.testing.assert_allclose(e[i], y[i] - K[i, idx] @ a, atol=1e-6)
    assert np.abs(e[20:]).max() == 0.0


def test_krr_state_carried_across_continues_as_the_reference():
    X, y, jspec, tspec = _problem(24)
    js, _ = _fit(X[:16], y[:16], 5, 24, jspec, tspec)
    fields = {k: np.asarray(getattr(js.kpca, k)) for k in convert.FIELDS}
    fields["y"] = np.asarray(js.y)
    ts = convert.krr_from_numpy(fields, device="cpu")
    back = convert.krr_to_numpy(ts)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v)
    for i in range(16, 24):
        js = jkrr.add_point(js, jnp.asarray(X[i]), y[i], jspec)
        ts = tkrr.add_point(ts, torch.tensor(X[i]), y[i], tspec)
    np.testing.assert_allclose(tkrr.coefficients(ts, 0.1).numpy(),
                               np.asarray(jkrr.coefficients(js, 0.1)),
                               atol=1e-9)
    with pytest.raises(ValueError, match="inconsistent"):
        convert.krr_from_numpy({**fields, "y": np.zeros(3)}, device="cpu")
