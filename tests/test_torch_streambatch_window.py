"""The port's multi-tenant cohort (``engine.StreamBatch``) against the
reference's: sliding windows, the quarantine gate and the metric lanes.

The helpers and the conventions are ``test_torch_streambatch.py``'s (f64
cohorts of 3–6 tenants, d = 4, capacity <= 64, ``min_bucket`` 8; the
reference's tolerances).  The tests mirror ``tests/test_window.py``'s
windowed cohorts, ``tests/test_health.py``'s quarantine,
``tests/test_telemetry.py``'s metric lanes and
``tests/test_fused_ingest_transform.py``'s windowed block.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import health as thl  # noqa: E402
from repro_torch.core import kernels_fn as tkf, rankone as trk  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401
from test_torch_streambatch import (  # noqa: E402
    D, JSPEC, TSPEC, _bitwise, _cohorts, _masked_steps, _plans,
    _same_as_reference, _same_as_singles, _singles)


# ---------------------------------------------------------------- windows --
@pytest.mark.parametrize("cohorts", ["max", "bucket"])
def test_window_cohort_matches_reference(cohorts):
    """Windowed cohorts under spreading masks (masked batched downdates of
    row 0, the lockstep FIFO) equal the reference's."""
    rng = np.random.default_rng(13)
    B, W = 3, 8
    x0 = rng.normal(size=(B, 4, D))
    jb, tb = _cohorts(x0, 16, cohorts, window=W)
    for xs, act in _masked_steps(rng, B, 11):
        jb.update(jnp.asarray(xs), active=jnp.asarray(act))
        tb.update(xs, active=act)
    _same_as_reference(tb, jb)


@pytest.mark.parametrize("cohorts", ["max", "bucket", "bucket-padded"])
def test_window_block_matches_single_windows(cohorts):
    """A windowed block (the growers step point by point, then every lane
    scans evict + ingest pairs) equals per-point windowed single streams
    under every geometry; each tenant's rows are its last W points."""
    rng = np.random.default_rng(73)
    B, W = 3, 6
    x0 = rng.normal(size=(B, 4, D))
    xs = rng.normal(size=(9, B, D))
    tb = teng.StreamBatch(torch.tensor(x0), 16, TSPEC, plan=_plans()[1],
                          dtype=torch.float64, window=W, cohorts=cohorts,
                          device="cpu")
    tb.update_block(xs)
    singles = _singles(x0, 16, window=W)
    for t in range(xs.shape[0]):
        for i, s in enumerate(singles):
            s.update(xs[t, i])
    _same_as_singles(tb, singles, atol=1e-10)
    ts = tb.states
    for i in range(B):
        allpts = np.concatenate([x0[i], xs[:, i]])
        np.testing.assert_array_equal(ts.X[i, :W].numpy(), allpts[-W:])


def test_window_steady_lanes_scan_as_per_point():
    """Mixed cohort at a window: the steady lane folds the block in one
    scan, the growers step to W and then scan: equal to the per-point
    cohort (``tests/test_fused_ingest_transform.py``)."""
    rng = np.random.default_rng(13)
    B, W = 3, 6
    x0 = rng.normal(size=(B, 4, D))
    kw = dict(plan=_plans()[1], dtype=torch.float64, cohorts="bucket",
              window=W, device="cpu")
    blk = teng.StreamBatch(torch.tensor(x0), 16, TSPEC, **kw)
    ref = teng.StreamBatch(torch.tensor(x0), 16, TSPEC, **kw)
    pre = rng.normal(size=(2, B, D))
    for t in range(2):
        blk.update(pre[t], active=[True, False, False])
        ref.update(pre[t], active=[True, False, False])
    assert list(blk._m_host) == [6, 4, 4]
    xs = rng.normal(size=(5, B, D))
    blk.update_block(xs)
    for t in range(5):
        ref.update(xs[t])
    np.testing.assert_array_equal(blk._m_host, ref._m_host)
    for a, b in zip(blk.states, ref.states):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-9)


def test_window_at_capacity_never_exhausts():
    """window == capacity: an idle tenant parked at the full window does
    not trip the exhaustion raise, and the active one keeps evicting."""
    rng = np.random.default_rng(19)
    x0 = rng.normal(size=(2, 4, 3))
    tb = teng.StreamBatch(torch.tensor(x0), 8, TSPEC, dtype=torch.float64,
                          window=8, device="cpu")
    for _ in range(10):
        tb.update(rng.normal(size=(2, 3)))
    for _ in range(4):
        tb.update(rng.normal(size=(2, 3)), active=[True, False])
    assert tb.states.m.tolist() == [8, 8]
    assert bool(torch.isfinite(tb.states.L).all())


def test_window_block_then_update_consistent():
    """Blocks and single steps interleaved keep the host counts and the
    state in step; the window holds batch KPCA of its rows."""
    rng = np.random.default_rng(79)
    W = 6
    x0 = rng.normal(size=(2, 4, 3))
    tb = teng.StreamBatch(torch.tensor(x0), 8, TSPEC, adjusted=False,
                          dtype=torch.float64, window=W, device="cpu")
    tb.update_block(rng.normal(size=(5, 2, 3)))
    tb.update(rng.normal(size=(2, 3)))
    tb.update_block(rng.normal(size=(4, 2, 3)))
    ts = tb.states
    assert ts.m.tolist() == [W, W]
    for i in range(2):
        K = tkf.gram_block(ts.X[i, :W], ts.X[i, :W], spec=TSPEC).numpy()
        rec = trk.reconstruct(ts.L[i], ts.U[i], ts.m[i]).numpy()[:W, :W]
        np.testing.assert_allclose(rec, K, atol=1e-9)


# ------------------------------------------------------------ quarantine --
@pytest.mark.parametrize("cohorts,window", [("max", None), ("max", 6),
                                            ("bucket", None),
                                            ("bucket-padded", 6)])
def test_quarantine_bitwise(cohorts, window):
    """A gated cohort fed two non-finite points equals, bit for bit, an
    ungated cohort fed the clean runs as blocks and each poisoned step as
    a masked update of the zeroed points: a rejected lane is untouched,
    the others advance; the tally is per tenant."""
    rng = np.random.default_rng(0)
    B = 3
    x0 = rng.normal(size=(B, 4, D))
    kw = dict(dtype=torch.float64, cohorts=cohorts, window=window,
              device="cpu")
    sb = teng.StreamBatch(torch.tensor(x0), 16, TSPEC,
                          plan=teng.UpdatePlan(health=thl.DEFAULT_POLICY),
                          **kw)
    rf = teng.StreamBatch(torch.tensor(x0), 16, TSPEC, **kw)
    bad = rng.normal(size=(8, B, D))
    bad[3, 1, 0] = np.nan
    bad[6, 0, 2] = np.inf
    sb.update_block(bad)
    finite = np.isfinite(bad).all(axis=(1, 2))
    t = 0
    while t < len(bad):
        if finite[t]:
            u = t
            while u < len(bad) and finite[u]:
                u += 1
            rf.update_block(bad[t:u])
            t = u
        else:
            ok = np.isfinite(bad[t]).all(axis=1)
            rf.update(np.where(ok[:, None], bad[t], 0.0), active=ok)
            t += 1
    assert _bitwise(sb.states, rf.states)
    assert sb.health_summary()["quarantined"] == 2
    np.testing.assert_array_equal(sb.quarantined, [1, 1, 0])
    np.testing.assert_array_equal(sb._m_host, rf._m_host)


def test_quarantine_matches_reference():
    """The gated window cohort against the reference's gated cohort."""
    rng = np.random.default_rng(2)
    B, W = 3, 6
    x0 = rng.normal(size=(B, 4, D))
    jp, tp = _plans(health=True)
    jb = jeng.StreamBatch(jnp.asarray(x0), 16, JSPEC, plan=jp,
                          dtype=jnp.float64, window=W)
    tb = teng.StreamBatch(torch.tensor(x0), 16, TSPEC, plan=tp,
                          dtype=torch.float64, window=W, device="cpu")
    for t in range(6):
        xs = rng.normal(size=(B, D))
        if t in (2, 4):
            xs[t % B, 1] = np.nan
        jb.update(jnp.asarray(xs))
        tb.update(xs)
    _same_as_reference(tb, jb)
    np.testing.assert_array_equal(tb.quarantined, jb.quarantined)


# ----------------------------------------------------------- metric lanes --
def test_metrics_on_off_bitwise():
    """The metric lanes never touch the eigensystem: metered and
    unmetered gated windows are equal bit for bit, and the lanes count the
    rejection, the ingests and the publication exactly."""
    rng = np.random.default_rng(4)
    B = 3
    x0 = rng.normal(size=(B, 4, D))
    steps = [rng.normal(size=(B, D)) for _ in range(12)]
    steps[5][1] = np.nan
    out = []
    for metrics in (False, True):
        plan = teng.UpdatePlan(health=thl.DEFAULT_POLICY, metrics=metrics)
        b = teng.StreamBatch(torch.tensor(x0), 16, TSPEC, plan=plan,
                             dtype=torch.float64, window=8, device="cpu")
        for xs in steps[:8]:
            b.update(xs)
        b.update_block(np.stack(steps[8:]))
        b.publish(4)
        out.append(b)
    off, on = out
    assert _bitwise(off.states, on.states)
    rep = on.metrics_report()
    np.testing.assert_array_equal(rep["rejections"], [0, 1, 0])
    np.testing.assert_array_equal(rep["ingests"], [12, 11, 12])
    np.testing.assert_array_equal(rep["publishes"], [1, 1, 1])
    assert rep["ingests_total"] == 35
    assert off.metrics_report() == {}


def test_stacked_lanes_match_single_streams():
    """B metric lanes through the cohort equal B metered single windowed
    streams over the same per-tenant points (NaNs on two lanes)."""
    rng = np.random.default_rng(6)
    B, W = 3, 8
    x0 = rng.normal(size=(B, 4, D))
    steps = rng.normal(size=(12, B, D))
    steps[4, 2] = np.nan
    steps[9, 0] = np.nan
    plan = teng.UpdatePlan(health=thl.DEFAULT_POLICY, metrics=True)
    tb = teng.StreamBatch(torch.tensor(x0), 16, TSPEC, plan=plan,
                          dtype=torch.float64, window=W, device="cpu")
    for xs in steps:
        tb.update(xs)
    got = tb.metrics_report()
    for t, s in enumerate(_singles(x0, 16, window=W, plan=plan)):
        for i in range(steps.shape[0]):
            s.update(steps[i, t])
        rep = s.metrics_report()
        for k in ("ingests", "rejections", "evictions", "m"):
            assert got[k][t] == rep[k], k
        assert got["window_fill"][t] == pytest.approx(rep["m"] / W)
