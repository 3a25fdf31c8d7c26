"""The port's multi-tenant cohort (``engine.StreamBatch``) against the
reference's, on the same numpy inputs.

Both packages run f64 cohorts of 3–6 tenants (d = 4, capacity <= 64,
``min_bucket`` 8) under the same plan and masks; the port is held to the
reference's own tolerances (eigenvalues 1e-9, reconstruction 1e-8, the
reference's ``tests/test_engine.py``), the reference running its jnp
oracles (``REPRO_PALLAS_FORCE=ref``) and the port its plain kernel
versions.  The reference's ``bucket-padded`` cohort is not the oracle (its
``test_streambatch_bucket_padded_identical_states`` fails under the
suite's command): the port's padded cohort is held to a loop of the port's
single streams instead.  The tests mirror ``tests/test_engine.py``'s
StreamBatch block, ``tests/test_window.py``'s windowed cohorts,
``tests/test_health.py``'s quarantine, ``tests/test_telemetry.py``'s
metric lanes, ``tests/test_serving.py``'s publish and
``tests/test_fused_ingest_transform.py``'s windowed block.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng, health as jhl  # noqa: E402
from repro.core import kernels_fn as jkf, rankone as jrk  # noqa: E402
from repro_torch.core import convert, engine as teng  # noqa: E402
from repro_torch.core import health as thl, inkpca as tink  # noqa: E402
from repro_torch.core import kernels_fn as tkf, rankone as trk  # noqa: E402
from repro_torch.core import serving as tsrv  # noqa: E402
from repro_torch.core import window as twnd  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

SIGMA = 5.0
JSPEC, TSPEC = jkf.KernelSpec(sigma=SIGMA), tkf.KernelSpec(sigma=SIGMA)
D = 4


def _plans(health: bool = False):
    return (jeng.UpdatePlan(dispatch="bucketed", min_bucket=8,
                            health=jhl.DEFAULT_POLICY if health else None),
            teng.UpdatePlan(dispatch="bucketed", min_bucket=8,
                            health=thl.DEFAULT_POLICY if health else None))


def _cohorts(x0, capacity, cohorts="max", window=None, adjusted=True):
    jp, tp = _plans()
    jb = jeng.StreamBatch(jnp.asarray(x0), capacity, JSPEC, plan=jp,
                          adjusted=adjusted, dtype=jnp.float64,
                          cohorts=cohorts, window=window)
    tb = teng.StreamBatch(torch.tensor(x0), capacity, TSPEC, plan=tp,
                          adjusted=adjusted, dtype=torch.float64,
                          cohorts=cohorts, window=window, device="cpu")
    return jb, tb


def _singles(x0, capacity, window=None, adjusted=True, plan=None,
             spec=TSPEC):
    plan = plan or _plans()[1]
    return [tink.KPCAStream(torch.tensor(x), capacity, spec,
                            adjusted=adjusted, plan=plan,
                            dtype=torch.float64, window=window, device="cpu")
            for x in x0]


def _close_tenant(tl, tu, tm, ref_L, ref_rec, atol_l=1e-9, atol_r=1e-8):
    """One tenant of the port's stacked state against a reference
    eigensystem: m, the active eigenvalues, the reconstruction."""
    m = int(tm)
    np.testing.assert_allclose(tl.numpy()[:m], np.asarray(ref_L)[:m],
                               atol=atol_l)
    np.testing.assert_allclose(trk.reconstruct(tl, tu, tm).numpy(),
                               np.asarray(ref_rec), atol=atol_r)


def _same_as_reference(tb, jb):
    ts, js = tb.states, jb.states
    np.testing.assert_array_equal(ts.m.numpy(), np.asarray(js.m))
    for i in range(tb.n_tenants):
        _close_tenant(ts.L[i], ts.U[i], ts.m[i], js.L[i],
                      jrk.reconstruct(js.L[i], js.U[i], js.m[i]))
    np.testing.assert_array_equal(tb._m_host, np.asarray(jb._m_host))


def _same_as_singles(tb, singles, atol=1e-9, tenants=None):
    ts = tb.states
    for i, s in zip(tenants or range(len(singles)), singles):
        st = s.kpca_state
        assert int(ts.m[i]) == int(st.m)
        _close_tenant(ts.L[i], ts.U[i], ts.m[i], st.L,
                      trk.reconstruct(st.L, st.U, st.m), atol, atol)


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _masked_steps(rng, B, steps):
    """(points, mask) per step: tenant i steps when step % (i + 1) == 0,
    so the tenants' sizes spread (the reference's cohort test)."""
    return [(rng.normal(size=(B, D)),
             np.array([(t % (i + 1)) == 0 for i in range(B)]))
            for t in range(steps)]


# ------------------------------------------------------ cohort geometries --
@pytest.mark.parametrize("cohorts", ["max", "bucket"])
def test_cohort_matches_reference(cohorts):
    """Masked steps spreading the tenants over two buckets, then a block:
    every tenant equals the reference cohort's (1e-9 / 1e-8), the host
    counts agree, and a bucket cohort formed more than one group."""
    rng = np.random.default_rng(23)
    B = 3
    x0 = rng.normal(size=(B, 3, D))
    jb, tb = _cohorts(x0, 16, cohorts)
    for xs, act in _masked_steps(rng, B, 9):
        jb.update(jnp.asarray(xs), active=jnp.asarray(act))
        tb.update(xs, active=act)
    if cohorts == "bucket":
        assert len(tb._groups) > 1
        assert len({g["Mb"] for g in tb._groups}) == len(tb._groups)
    blk = rng.normal(size=(3, B, D))
    jb.update_block(jnp.asarray(blk))
    tb.update_block(blk)
    _same_as_reference(tb, jb)


def test_bucket_padded_matches_single_streams():
    """The padded cohort (pad lanes inert copies of each group's first
    tenant, power-of-two group sizes) equals a loop of the port's single
    streams fed the same points, through masked steps, regroups and a
    block; pad lanes never reach the capacity-M state."""
    rng = np.random.default_rng(43)
    B = 6
    x0 = rng.normal(size=(B, 3, D))
    tb = teng.StreamBatch(torch.tensor(x0), 64, TSPEC, plan=_plans()[1],
                          dtype=torch.float64, cohorts="bucket-padded",
                          device="cpu")
    singles = _singles(x0, 64)
    padded_seen = False
    for xs, act in _masked_steps(rng, B, 18):
        tb.update(xs, active=act)
        padded_seen |= any(len(g["idx_pad"]) > g["n_real"]
                           for g in tb._groups)
        for i, s in enumerate(singles):
            if act[i]:
                s.update(xs[i])
    blk = rng.normal(size=(6, B, D))
    tb.update_block(blk)
    for i, s in enumerate(singles):
        s.update_block(blk[:, i])
    assert padded_seen
    for g in tb._groups:
        assert len(g["idx_pad"]) & (len(g["idx_pad"]) - 1) == 0
    _same_as_singles(tb, singles)
    # Every tenant's count is its own (a pad lane's would be its source's).
    np.testing.assert_array_equal(tb.states.m.numpy(), tb._m_host)


def test_idle_tenant_bitwise_and_counts():
    """A masked step leaves an idle tenant's state bit for bit."""
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(3, 4, D))
    tb = teng.StreamBatch(torch.tensor(x0), 16, TSPEC, plan=_plans()[1],
                          dtype=torch.float64, device="cpu")
    tb.update(rng.normal(size=(3, D)))
    before = tb.state_of(1)
    tb.update(rng.normal(size=(3, D)), active=[True, False, True])
    assert tb.states.m.tolist() == [6, 5, 6]
    assert _bitwise(tb.state_of(1), before)


@pytest.mark.parametrize("cohorts", ["max", "bucket"])
def test_capacity_exhaustion_raises_before_any_change(cohorts):
    """A step that would pass the capacity raises, and the cohort's state
    and host counts are as they were."""
    rng = np.random.default_rng(31)
    x0 = rng.normal(size=(2, 4, 3))
    tb = teng.StreamBatch(torch.tensor(x0), 8, TSPEC,
                          plan=teng.UpdatePlan(dispatch="bucketed",
                                               min_bucket=4),
                          dtype=torch.float64, cohorts=cohorts, device="cpu")
    tb.update_block(rng.normal(size=(4, 2, 3)))
    before, m_host = tb.states, tb._m_host.copy()
    with pytest.raises(ValueError, match="exhausted capacity"):
        tb.update(rng.normal(size=(2, 3)))
    assert _bitwise(tb.states, before)
    np.testing.assert_array_equal(tb._m_host, m_host)


def test_rejects_non_batched_seeds():
    with pytest.raises(ValueError):
        teng.StreamBatch(torch.zeros((4, 3)), 16, TSPEC, device="cpu")
    with pytest.raises(ValueError):
        teng.StreamBatch(torch.zeros((2, 4, 3)), 16, TSPEC, device="cpu",
                         cohorts="nope")


def test_transform_agrees_across_geometries():
    """``transform`` of one set of states through the three geometries
    (the bucket and padded cohorts' groups, the max cohort's one state)."""
    rng = np.random.default_rng(29)
    B = 4
    x0 = rng.normal(size=(B, 3, D))
    xs = rng.normal(size=(8, B, D))
    q = rng.normal(size=(B, 5, D))
    ys = []
    for cohorts in ("max", "bucket", "bucket-padded"):
        tb = teng.StreamBatch(torch.tensor(x0), 32, TSPEC,
                              plan=_plans()[1], dtype=torch.float64,
                              cohorts=cohorts, device="cpu")
        tb.update_block(xs)
        ys.append(tb.transform(q, n_components=3).numpy())
    assert ys[0].shape == (B, 5, 3) and np.isfinite(ys[0]).all()
    for y in ys[1:]:
        np.testing.assert_allclose(y, ys[0], atol=1e-8)


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


# ------------------------------------------------------ serving and reads --
@pytest.mark.parametrize("fuse", [False, True])
def test_publish_matches_transform(fuse):
    """Stacked snapshots from ``publish`` answer ``query_batch`` bit for
    bit as ``transform`` does, with the generation on every tenant; and
    the transform agrees with the reference's within 1e-8."""
    rng = np.random.default_rng(4)
    B = 3
    x0 = rng.normal(size=(B, 4, D))
    jb, tb = _cohorts(x0, 32)
    tb.plan = tb.plan._replace(serve_components=4, fuse_krow=fuse)
    for _ in range(4):
        xs = rng.normal(size=(B, D))
        jb.update(jnp.asarray(xs))
        tb.update(xs)
    snaps = tb.publish()
    q = rng.normal(size=(B, 6, D))
    y = tsrv.query_batch(snaps, torch.tensor(q), spec=TSPEC, plan=tb.plan)
    assert torch.equal(y, tb.transform(q, n_components=4))
    assert snaps.generation.tolist() == [0] * B
    assert tb.publish().generation.tolist() == [1] * B
    want = np.asarray(jb.transform(jnp.asarray(q), n_components=4))
    np.testing.assert_allclose(np.abs(y.numpy()), np.abs(want), atol=1e-8)


def test_probe_all_and_heal():
    """``probe_all`` flags the one corrupted tenant (and measures drift
    against a frozen spectrum); ``heal`` repairs it alone and counts the
    rung on its lane."""
    rng = np.random.default_rng(8)
    B = 3
    x0 = rng.normal(size=(B, 4, D))
    plan = teng.UpdatePlan(health=thl.DEFAULT_POLICY, metrics=True)
    tb = teng.StreamBatch(torch.tensor(x0), 16, TSPEC, plan=plan,
                          dtype=torch.float64, device="cpu")
    tb.update_block(rng.normal(size=(6, B, D)))
    ref = thl.top_spectrum(tb.state_of(0), 4)
    healthy, drift = tb.probe_all(ref_lam=torch.stack([ref] * B))
    assert healthy.all() and drift[0] == 0.0 and (drift[1:] > 0).all()
    full = tb.states
    U = full.U.clone()
    U[1, :, 0] *= 1.004       # tenant 1 off orthogonality, polish band
    tb._full = full._replace(U=U)
    healthy, _ = tb.probe_all()
    assert healthy.tolist() == [True, False, True]
    assert tb.heal() == 1
    assert tb.probe_all()[0].all()
    assert tb.metrics_report()["heals_polish"].tolist() == [0, 1, 0]


def test_carried_cohort_continues_as_the_reference():
    """A reference cohort's stacked state crosses over as numpy arrays
    (``convert.stacked_state_from_numpy``, exact round trip) and both
    cohorts then stream on alike; a windowed cohort's carried ring is the
    lockstep FIFO, so a single windowed stream started from one tenant's
    carried state continues as that tenant."""
    rng = np.random.default_rng(11)
    B, W = 3, 6
    x0 = rng.normal(size=(B, 4, D))
    jb = _cohorts(x0, 16, window=W)[0]
    for xs, act in _masked_steps(rng, B, 5):
        jb.update(jnp.asarray(xs), active=jnp.asarray(act))
    fields = {k: np.asarray(getattr(jb.states, k)) for k in convert.FIELDS}
    states = convert.stacked_state_from_numpy(fields, device="cpu")
    back = convert.state_to_numpy(states)
    for k in convert.FIELDS:
        np.testing.assert_array_equal(back[k], fields[k])
    tb = teng.StreamBatch.from_states(states, TSPEC, plan=_plans()[1],
                                      window=W)
    wins = convert.stacked_window_from_numpy(fields, device="cpu")
    single = _singles(x0[:1], 16, window=W)[0]
    single.state = twnd.WindowState(kpca=tink.unstack_state(wins.kpca, 0),
                                    ages=wins.ages[0], clock=wins.clock[0])
    for _ in range(5):
        xs = rng.normal(size=(B, D))
        jb.update(jnp.asarray(xs))
        tb.update(xs)
        single.update(xs[0])
    _same_as_reference(tb, jb)
    _same_as_singles(tb, [single], tenants=[0])
    wb = convert.window_to_numpy(wins)
    again = convert.stacked_window_from_numpy(wb, device="cpu")
    assert torch.equal(again.ages, wins.ages)
    assert torch.equal(again.clock, wins.clock)


# ------------------------------------------------------------ the service --
def test_serve_tenants_runs_the_cohort():
    """``serve --tenants --cohorts`` on the CPU: the reference service's
    result keys, every tenant at 4 + points, and each tenant's state
    equal to the port's single stream fed its points."""
    args = tserve.parse_args(["--mode", "kpca", "--device", "cpu",
                              "--tenants", "3", "--cohorts", "bucket",
                              "--capacity", "32", "--points", "10",
                              "--dim", str(D), "--transform-every", "5",
                              "--dtype", "float64", "--metrics"])
    res, batch = tserve.kpca_multitenant_service(args)
    for k in ("step_ms_p50", "query_ms_p50", "aggregate_updates_per_s",
              "m_final", "finite", "metrics"):
        assert k in res
    assert res["m_final"] == [14] * 3 and res["finite"]
    assert res["metrics"]["ingests"] == [10] * 3
    x0, steps = tserve.multitenant_draws(args)
    singles = _singles(x0, 32, plan=tserve.make_plan(args)._replace(
        metrics=False), spec=tkf.KernelSpec(sigma=float(D)))
    for xs, _ in steps:
        for i, s in enumerate(singles):
            s.update(xs[i])
    _same_as_singles(batch, singles)


@pytest.mark.parametrize("flag,item", [(["--decouple"], "item 6"),
                                       (["--mesh", "2x1"], "item 10")])
def test_serve_unported_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        tserve.main(["--mode", "kpca", "--device", "cpu", "--tenants", "2",
                     *flag])
