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
StreamBatch block and ``tests/test_serving.py``'s publish; the windowed
cohorts, the quarantine and the metric lanes are in
``test_torch_streambatch_window.py``, which shares the helpers here.
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
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

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
    """The flags of ROADMAP.md items 6 and 10, once unported, raise no
    ``NotImplementedError`` any more: ``--decouple`` serves the cohort;
    ``--mesh`` raises a ``ValueError`` without ``--decouple``, and with it
    in a world of another size than P_t·P_r (here one process)."""
    argv = ["--mode", "kpca", "--device", "cpu", "--tenants", "2",
            "--capacity", "16", "--points", "4", "--dim", str(D), *flag]
    if item == "item 6":
        assert tserve.main(argv)["mode"] == "kpca-decoupled"
        return
    with pytest.raises(ValueError, match="--decouple"):
        tserve.main(argv)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        tserve.main(argv + ["--decouple"])
