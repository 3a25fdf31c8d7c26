"""The port's decoupled ingest/serve loop (``launch/serve.IngestServeLoop``,
``serve --decouple``) against the reference's, on the same numpy inputs.

The three loop tests mirror the reference's ``tests/test_health.py``
(stale serving under corruption beyond repair, heal then publish,
staleness-aware publication) at their sizes and seeds, f64, with both
loops run side by side: the same publications, refusals, heals and drift
probes, and the same answers on every published generation (1e-10).  The
service is held to the reference's loop driven as its
``kpca_decoupled_main`` drives it (f64), and to ``kpca_decoupled_main``
itself (f32, the reference's type there) on its counters and final
counts.
"""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng, health as jhl  # noqa: E402
from repro.core import kernels_fn as jkf  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.core import batch as tbatch  # noqa: E402
from repro_torch.core import engine as teng, health as thl  # noqa: E402
from repro_torch.core import kernels_fn as tkf  # noqa: E402
from repro_torch.core import serving as tsrv  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

JSPEC, TSPEC = jkf.KernelSpec(sigma=2.0), tkf.KernelSpec(sigma=2.0)


def _loops(x0, cap, *, serve_every=1, publish_on_drift=None):
    """The reference's and the port's loop over f64 cohorts of ``x0``."""
    jp = jeng.UpdatePlan(serve_every=serve_every, serve_components=4,
                         health=jhl.DEFAULT_POLICY)
    tp = teng.UpdatePlan(serve_every=serve_every, serve_components=4,
                         health=thl.DEFAULT_POLICY)
    jb = jeng.StreamBatch(jnp.asarray(x0), cap, JSPEC, plan=jp,
                          dtype=jnp.float64)
    tb = teng.StreamBatch(torch.tensor(x0), cap, TSPEC, plan=tp,
                          dtype=torch.float64, device="cpu")
    jl = jserve.IngestServeLoop(jb, JSPEC, n_components=4,
                                publish_on_drift=publish_on_drift)
    tl = tserve.IngestServeLoop(tb, TSPEC, n_components=4,
                                publish_on_drift=publish_on_drift)
    return jl, tl


def _same_counts(jl, tl):
    for key in ("generation", "skipped", "heals", "drift_probes",
                "drift_publishes"):
        assert getattr(tl, key) == getattr(jl, key), key


def _same_answers(jl, tl, q, *, up_to_sign: bool = False):
    """Both loops' answers to ``q`` within 1e-10; ``up_to_sign`` after a
    resync, whose eigh may return a component with the other sign."""
    yj = np.asarray(jl.query(jnp.asarray(q)))
    yt = tl.query(q).numpy()
    if up_to_sign:
        yj = yj * np.sign(np.sum(yt * yj, axis=1, keepdims=True))
    np.testing.assert_allclose(yt, yj, atol=1e-10)
    return yt


def _corrupt(jb, tb, fn):
    """Apply ``fn(U, X)`` (numpy, in place) to both cohorts' full states."""
    jb._flush()
    tb._flush()
    U, X = np.array(jb._full.U), np.array(jb._full.X)
    fn(U, X)
    jb._full = jb._full._replace(U=jnp.asarray(U), X=jnp.asarray(X))
    tb._full = tb._full._replace(U=torch.tensor(U), X=torch.tensor(X))


def test_ingest_serve_loop_serves_stale_under_faults():
    rng = np.random.default_rng(0)
    B, d, cap = 2, 4, 16
    jl, tl = _loops(rng.normal(size=(B, 4, d)), cap)
    x = rng.normal(size=(B, d))
    assert tl.ingest(x) == jl.ingest(jnp.asarray(x))
    gen, snap = tl.generation, tl.snaps

    # Tenant 0 beyond repair: U and a stored row poisoned, so the heal
    # ladder cannot run and the publication must be refused.
    def poison(U, X):
        U[0, :, 0] = np.nan
        X[0, 0] = np.nan

    _corrupt(jl.batch, tl.batch, poison)
    x = rng.normal(size=(B, d))
    published = tl.ingest(x)
    assert published == jl.ingest(jnp.asarray(x)) is False
    assert tl.skipped == 1
    assert tl.generation == gen
    assert tl.snaps is snap      # the same object: the last healthy snapshot
    _same_counts(jl, tl)
    y = _same_answers(jl, tl, rng.normal(size=(B, 3, d)))
    assert np.isfinite(y).all()


def test_ingest_serve_loop_heals_and_publishes():
    rng = np.random.default_rng(1)
    B, d, cap = 2, 4, 16
    jl, tl = _loops(rng.normal(size=(B, 4, d)), cap)
    gen = tl.generation

    def tilt(U, X):              # recoverable: the stored rows are intact
        U[1, :3, :3] += 0.4

    _corrupt(jl.batch, tl.batch, tilt)
    x = rng.normal(size=(B, d))
    assert tl.ingest(x)
    assert jl.ingest(jnp.asarray(x))
    assert tl.heals >= 1
    assert tl.skipped == 0
    assert tl.generation == gen + 1
    _same_counts(jl, tl)
    _same_answers(jl, tl, rng.normal(size=(B, 3, d)), up_to_sign=True)


def test_staleness_aware_publication():
    rng = np.random.default_rng(2)
    B, d, cap = 2, 4, 32
    jl, tl = _loops(rng.normal(size=(B, 4, d)), cap, serve_every=1000,
                    publish_on_drift=0.05)
    gen = tl.generation
    published = 0
    for t in range(12):
        # A growing spectrum: the drift builds until the trigger fires.
        x = rng.normal(size=(B, d)) * (1.0 + 0.5 * t)
        p = tl.ingest(x)
        assert p == jl.ingest(jnp.asarray(x))
        published += int(p)
        _same_counts(jl, tl)
    assert tl.drift_publishes >= 1
    assert published == tl.drift_publishes     # the cadence never fired
    assert tl.generation > gen
    np.testing.assert_allclose(tl.ref_lam.numpy(), np.asarray(jl.ref_lam),
                               atol=1e-10)


def _args(**kw):
    argv = ["--mode", "kpca", "--decouple", "--device", "cpu",
            "--capacity", "16", "--points", "10", "--dim", "4",
            "--tenants", "2", "--batch", "3", "--query-rate", "2",
            "--serve-every", "3", "--serve-components", "4"]
    for k, v in kw.items():
        flag = "--" + k.replace("_", "-")
        argv += [flag] if v is True else [flag, str(v)]
    return tserve.parse_args(argv)


def _reference_run(args):
    """The reference's loop driven as its ``kpca_decoupled_main`` drives
    it, on the port service's draws (f64): the answers of every step."""
    x0, steps = tserve.decoupled_draws(args)
    plan = jserve._make_plan(argparse.Namespace(
        **{**vars(args), "matmul": "jnp", "dispatch": args.dispatch,
           "fuse_krow": False}))
    spec = jkf.KernelSpec(name="rbf", sigma=float(args.dim))
    batch = jeng.StreamBatch(jnp.asarray(x0), args.capacity, spec, plan=plan,
                             adjusted=True, dtype=jnp.float64,
                             cohorts=args.cohorts, window=args.window)
    loop = jserve.IngestServeLoop(batch, spec, plan=plan,
                                  publish_on_drift=args.publish_on_drift,
                                  drift_probe_every=args.drift_probe_every)
    answers = []
    for xs, qs in steps:
        answers += [(loop.generation, np.asarray(loop.query(jnp.asarray(q))))
                    for q in qs]
        batch.update(jnp.asarray(xs))
        loop._since += 1
        if loop._publish_due():
            loop.publish()
    return loop, batch, answers


def _port_run(args):
    answers = []
    orig = tserve.IngestServeLoop.query

    def query(self, q):
        y = orig(self, q)
        answers.append((self.generation, y.numpy()))
        return y

    tserve.IngestServeLoop.query = query
    try:
        result, loop = tserve.kpca_decoupled_service(args)
    finally:
        tserve.IngestServeLoop.query = orig
    return result, loop, answers


@pytest.mark.parametrize("extra", [
    {"matmul": "jnp", "no_fuse_krow": True},
    {"health": True, "publish_on_drift": 0.05, "drift_probe_every": 2},
], ids=["cadence-jnp", "health-drift-pallas"])
def test_decoupled_service_matches_the_reference_loop(extra):
    args = _args(dtype="float64", **extra)
    result, loop, answers = _port_run(args)
    jloop, jbatch, janswers = _reference_run(args)
    assert len(answers) == len(janswers) == args.points * args.query_rate
    for (gt, yt), (gj, yj) in zip(answers, janswers):
        assert gt == gj
        if gt == 0:
            # The seed's snapshot is each package's eigh of the seed gram:
            # a component may come with the other sign, and the centered
            # gram's null direction is rounding noise (~1e-8).
            yj = yj * np.sign(np.sum(yt * yj, axis=1, keepdims=True))
            np.testing.assert_allclose(yt, yj, atol=1e-7)
        else:
            np.testing.assert_allclose(yt, yj, atol=1e-10)
    assert result["generations"] == jloop.generation
    assert result["skipped_publishes"] == jloop.skipped
    assert result["heals"] == jloop.heals
    assert result["drift_probes"] == jloop.drift_probes
    assert result["drift_publishes"] == jloop.drift_publishes
    assert result["m_final"] == [int(v) for v in np.asarray(
        jbatch.states.m)]
    assert result["quarantined"] == int(jbatch.quarantined.sum())


def test_decoupled_service_counts_match_the_reference_main():
    """``kpca_decoupled_main`` (f32) and the port's service on the same
    flags: the same generations, refusals, heals, probes, final counts
    and quarantine."""
    flags = dict(health=True, publish_on_drift=0.05, drift_probe_every=2)
    args = _args(dtype="float32", **flags)
    ref = jserve.kpca_decoupled_main(jserve_args(args))
    result, _ = tserve.kpca_decoupled_service(args)
    for key in ("generations", "skipped_publishes", "heals", "drift_probes",
                "drift_publishes", "m_final", "quarantined",
                "queries_served"):
        assert result[key] == ref[key], key
    assert set(ref) <= set(result)


def jserve_args(args):
    """The reference service's namespace for the port's flags (its own
    defaults: the jnp route, no fused k-row)."""
    return argparse.Namespace(
        mode="kpca", decouple=True, seed=args.seed, capacity=args.capacity,
        points=args.points, dim=args.dim, tenants=args.tenants,
        batch=args.batch, query_rate=args.query_rate,
        serve_every=args.serve_every, serve_components=args.serve_components,
        drift_probe_every=args.drift_probe_every,
        publish_on_drift=args.publish_on_drift, health=args.health,
        metrics=False, metrics_jsonl=None, metrics_port=None,
        dispatch=args.dispatch, matmul="jnp", fuse_krow=False,
        window=args.window, cohorts=args.cohorts, mesh=None,
        landmark_policy="append")


@pytest.mark.parametrize("extra", [
    {"window": 8}, {"cohorts": "bucket"}, {"health": True, "metrics": True},
], ids=["window", "cohorts", "health-metrics"])
def test_decoupled_service_runs_its_variants(extra):
    args = _args(dtype="float64", **extra)
    result, loop = tserve.kpca_decoupled_service(args)
    assert result["finite"]
    assert result["generations"] == loop.generation == args.points // 3
    assert result["queries_served"] == (args.points * args.query_rate
                                        * args.tenants * args.batch)
    if "window" in extra:
        assert result["m_final"] == [8, 8]
    if "metrics" in extra:
        # Each tenant's lane counts every publication, the seed's too.
        assert result["metrics"]["publishes_total"] == (
            args.tenants * (loop.generation + 1))


def test_decoupled_fault_seam_refuses_then_heals():
    """``on_step`` corrupts tenant 1 beyond repair at step 4: every later
    publication is refused (steps 5, 6 and 7: a refusal does not restart
    the cadence) and the answers stay the frozen snapshot's."""
    args = _args(dtype="float64", health=True, serve_every=2, points=8)

    def on_step(i, batch, xs):
        if i == 4:
            batch._flush()
            full = batch._full
            U, X = full.U.clone(), full.X.clone()
            U[1, :, 0] = float("nan")
            X[1, 0, 0] = float("nan")
            batch._full = full._replace(U=U, X=X)
        return xs

    result, loop = tserve.kpca_decoupled_service(args, on_step=on_step)
    assert result["generations"] == 2
    assert result["skipped_publishes"] == 3
    assert int(loop.snaps.generation[0]) == 2
    q = torch.randn(2, 3, 4, dtype=torch.float64)
    y = loop.query(q)
    assert torch.isfinite(y).all()
    assert torch.equal(y, tsrv.query_batch(loop.snaps, q, spec=loop.spec,
                                           plan=loop.plan))


def test_mesh_with_the_wrong_world_size_raises(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = _args(dtype="float64", mesh="2x1")
    with pytest.raises(ValueError, match="needs WORLD_SIZE == P_t·P_r == 2, "
                                         "but WORLD_SIZE is 1"):
        tserve.kpca_decoupled_service(args)
    with pytest.raises(ValueError, match="--decouple"):
        tserve.main(["--mode", "kpca", "--device", "cpu", "--mesh", "2x1"])


def test_mesh_outside_torchrun_raises(monkeypatch):
    """A 1x1 mesh with no process group and no ``torchrun`` environment
    says where it runs instead of failing on a missing variable."""
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="runs under torchrun"):
        tserve.kpca_decoupled_service(_args(dtype="float64", mesh="1x1"))


@pytest.mark.parametrize("device,env,cards,want", [
    ("cuda", {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, 2, "cuda:1"),
    ("cuda", {"LOCAL_RANK": "0", "WORLD_SIZE": "1"}, 1, "cuda:0"),
    ("cuda:0", {"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}, 1, "cuda:0"),
    ("cuda", {"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "2"}, 1,
     "2 ranks on this host, but 1 visible card"),
    ("cuda:0", {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, 2,
     "would put all 2 ranks of this host on one card"),
])
def test_mesh_binds_one_card_a_rank(device, env, cards, want):
    """Under ``torchrun`` on CUDA each rank of ``--mesh`` takes the card
    of its ``LOCAL_RANK`` (NCCL, one rank per card); more ranks than
    cards, or an index shared by every rank, raise."""
    if want.startswith("cuda"):
        assert tserve._rank_device("2x1", torch.device(device), env,
                                   cards) == torch.device(want)
        return
    with pytest.raises(ValueError, match=want):
        tserve._rank_device("2x1", torch.device(device), env, cards)


def test_rotated_eigh_step_and_flop_model_match_the_reference():
    """``core/batch`` and ``configs/paper`` against the reference's
    (``tests/test_inkpca.py``'s baseline step and flop ordering)."""
    from repro.configs import paper as jpaper
    from repro.core import batch as jbatch
    from repro_torch.configs import paper as tpaper

    rng = np.random.default_rng(0)
    X = rng.normal(size=(10, 5))
    m = 9
    K_prev = np.asarray(jkf.gram_block(jnp.asarray(X[:m]), jnp.asarray(X[:m]),
                                       spec=JSPEC))
    K_new = np.asarray(jkf.gram_block(jnp.asarray(X), jnp.asarray(X),
                                      spec=JSPEC))
    lam, vec = tbatch.batch_kpca(torch.tensor(K_prev), adjusted=True)
    lam2, vec2 = tbatch.rotated_eigh_step(lam, vec, torch.tensor(K_prev),
                                          torch.tensor(K_new))
    jl, jv = jbatch.batch_kpca(jnp.asarray(K_prev), adjusted=True)
    jl2, jv2 = jbatch.rotated_eigh_step(jl, jv, jnp.asarray(K_prev),
                                        jnp.asarray(K_new))
    lam_ref = np.asarray(jbatch.batch_kpca(jnp.asarray(K_new),
                                           adjusted=True)[0])
    np.testing.assert_allclose(lam2.numpy(), lam_ref, atol=1e-9)
    np.testing.assert_allclose(lam2.numpy(), np.asarray(jl2), atol=1e-10)
    f, g = tbatch.flop_model(512), jbatch.flop_model(512)
    assert f == g
    assert f["ours_adjusted"] < f["rotated_eigh_baseline"] \
        < f["chin_suter_2007"]
    assert f["ours_unadjusted"] == pytest.approx(f["ours_adjusted"] / 2)
    assert tbatch.hoegaerts_step.__name__ == jbatch.hoegaerts_step.__name__
    assert {k: vars(w) for k, w in tpaper.WORKLOADS.items()} \
        == {k: vars(w) for k, w in jpaper.WORKLOADS.items()}
