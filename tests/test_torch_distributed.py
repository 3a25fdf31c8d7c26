"""The port's row- and tenant-sharded update (``core/distributed.py``) on
gloo ranks against the reference's local path.

Ranks are fresh processes (``repro_torch.testing.spmd``) that meet through
a ``FileStore`` under ``tmp_path``, bounded by a timeout so that a hang
fails.  One world of P = 2 and one of P = 4 ranks each run every check (the
P = 4 world also forms the 2 × 2 tenant mesh), on the jnp and pallas
routes (pallas: the kernels' plain versions here), and report that they
loaded no JAX.  The parent computes the oracles with the reference's
local path — ``rankone.rank_one_update``, ``rank_one_update_pair``,
``Engine.downdate`` and the windowed stream — since the reference's own
multi-device tests fail under the suite's command.  The bars are the
reference's: 1e-10 on L and K, 1e-8 on U (``tests/test_downdate.py``,
``tests/test_sharding_and_hlo.py``), a tenant pair 1e-8, a tenant query
1e-12, the rebalanced update 1e-10 (``tests/test_serving.py``'s sizes:
M = 32, B = 4, d = 5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng, inkpca as jink  # noqa: E402
from repro.core import kernels_fn as jkf, rankone as jrk  # noqa: E402
from repro.core import serving as jsrv, window as jwnd  # noqa: E402
from repro_torch.core import engine as teng, inkpca as tink  # noqa: E402
from repro_torch.core import kernels_fn as tkf, rankone as trk  # noqa: E402
from repro_torch.core import window as twnd  # noqa: E402
from repro_torch.testing import spmd  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

SIGMA = 5.0
SPEC = jkf.KernelSpec(name="rbf", sigma=SIGMA)
TSPEC = tkf.KernelSpec(name="rbf", sigma=SIGMA)
M, D, W = 16, 4, 8
TIMEOUT = 120.0
ROUTES = {"update": [("jnp", {}), ("pallas", {}),
                     ("pallas-bucketed", {"dispatch": "bucketed",
                                          "min_bucket": 8})],
          "pair": [("jnp2", {}), ("pallas2", {}), ("jnp", {}),
                   ("pallas", {})],
          "downdate": [("jnp", {}), ("pallas", {}), ("pallas2", {}),
                       ("pallas-bucketed", {"dispatch": "bucketed",
                                            "min_bucket": 8})],
          "window": [("jnp", {}), ("pallas", {"fuse_krow": True}),
                     ("pallas2-bucketed", {"fuse_krow": True,
                                           "dispatch": "bucketed",
                                           "min_bucket": 8})]}
VICTIMS = (0, 3, 10)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _plan(route, extra):
    return {"matmul": route.split("-")[0], **extra}


def _ages(ages):
    """The reference's ring with the port's sentinel."""
    a = np.asarray(ages).astype(np.int64)
    sent = jwnd.age_sentinel(np.asarray(ages).dtype)
    return np.where(a == sent, twnd.age_sentinel(), a)


def _jstate(st):
    """The reference's ``KPCAState`` of a port state's numbers."""
    return jink.KPCAState(*(jnp.asarray(f.numpy()) for f in st))


def _cases():
    """(jobs, refs): the spmd jobs, built with the port from numpy draws,
    and per job its name and a thunk computing the reference's outputs
    (run while the ranks work)."""
    from functools import cache

    rng = np.random.default_rng(37)
    X = rng.normal(size=(11, D))
    st = tink.init_state(torch.tensor(X), M, TSPEC, adjusted=False,
                         dtype=torch.float64)
    jst = _jstate(st)
    m = int(st.m)
    jobs, refs = [], []

    def add(job, name, thunk):
        jobs.append(job)
        refs.append((name, thunk))

    V = np.zeros((3, M))
    V[:, :m] = rng.normal(size=(3, m))
    S = np.array([1.3, -0.7, 0.4])
    kw = dict(iters=62, method="gu", matmul="jnp", precise=True)

    @cache
    def updates():
        Lr, Ur = jst.L, jst.U
        for v, s in zip(V, S):
            Lr, Ur = jrk.rank_one_update(Lr, Ur, jnp.asarray(v), s, jst.m,
                                         **kw)
        return m, Lr, Ur

    for route, extra in ROUTES["update"]:
        add(dict(kind="update", plan=_plan(route, extra), L=st.L, U=st.U,
                 V=_t(V), S=_t(S), m=st.m), ("update", route), updates)

    Sp = np.array([1.1, 0.6])

    @cache
    def pairs(fused: bool):
        out = (jst.L, jst.U)
        for k in range(2):
            v1, v2 = jnp.asarray(V[k]), jnp.asarray(V[k + 1])
            if fused:
                out = jrk.rank_one_update_pair(*out, v1, Sp[k], v2, -Sp[k],
                                               jst.m, merge_fallback=True,
                                               **kw)
            else:
                out = jrk.rank_one_update(*out, v1, Sp[k], jst.m, **kw)
                out = jrk.rank_one_update(*out, v2, -Sp[k], jst.m, **kw)
        return (m,) + tuple(out)

    for route, extra in ROUTES["pair"]:
        add(dict(kind="pair", plan=_plan(route, extra), L=st.L, U=st.U,
                 V1=_t(V[:2]), S1=_t(Sp), V2=_t(V[1:]), S2=_t(-Sp), m=st.m),
            ("pair", route), lambda f=route.endswith("2"): pairs(f))

    engine = jeng.Engine(SPEC, jeng.UpdatePlan(), adjusted=False)

    @cache
    def removed(victim):
        ref = engine.downdate(jst, victim)
        return m - 1, ref.L, ref.U

    for victim in VICTIMS:
        a = tkf.kernel_row(st.X[victim], st.X, spec=TSPEC)
        a = torch.where(torch.arange(M) < m, a, 0.0)
        routes = list(ROUTES["downdate"] if victim == m - 1
                      else ROUTES["downdate"][1:3])
        if victim == 3:                  # the evict on the jnp route too
            routes.append(("jnp", {}))
        for route, extra in routes:
            kind = "downdate" if victim == m - 1 else "evict"
            job = dict(kind=kind, plan=_plan(route, extra), L=st.L, U=st.U,
                       a=a, k_new=a[victim], m=st.m)
            if kind == "evict":
                job["i"] = torch.tensor(victim, dtype=torch.int32)
            add(job, ("downdate", f"{route}-{victim}"),
                lambda v=victim: removed(v))

    # The sliding window: a full window of W, then 5 steady steps.
    Xw = rng.normal(size=(12, D))
    xs = rng.normal(size=(5, D))
    stream = tink.KPCAStream(torch.tensor(Xw[:4]), M, TSPEC, adjusted=False,
                             dtype=torch.float64, window=W, device="cpu")
    for x in Xw[4:]:
        stream.update(torch.tensor(x))
    ws = stream.state

    def jwindow():
        js = jink.KPCAStream(jnp.asarray(Xw[:4]), M, SPEC, adjusted=False,
                             dtype=jnp.float64, window=W)
        js.state = jwnd.WindowState(kpca=_jstate(ws.kpca),
                                    ages=jnp.asarray(ws.ages.numpy()),
                                    clock=jnp.asarray(ws.clock.numpy()))
        return js

    @cache
    def window_ref(guarded: bool):
        js = jwindow()
        for x in (xg if guarded else xs):
            if np.isfinite(x).all():
                js.update(jnp.asarray(x))
        return (js.state,)

    wjob = dict(kind="window", sigma=SIGMA, L=ws.kpca.L, U=ws.kpca.U,
                X=ws.kpca.X, ages=ws.ages, clock=ws.clock, xs=_t(xs),
                m=ws.kpca.m)
    for route, extra in ROUTES["window"]:
        add(dict(wjob, plan=_plan(route, extra)), ("window", route),
            lambda: window_ref(False))
    add(dict(wjob, plan={"matmul": "pallas", "fuse_krow": True}, block=2),
        ("window", "pallas-blocks-of-2"), lambda: window_ref(False))
    add(dict(wjob, plan={"matmul": "pallas", "fuse_krow": True},
             metered=True), ("window", "pallas-metered"),
        lambda: window_ref(False))

    # Guarded: non-finite points are rejected, the rest fold as a stream
    # that never saw them; a block of poison leaves the state bit for bit.
    xg = xs.copy()
    xg[1, 2] = np.nan
    xg[3, 0] = np.inf
    for route in ("pallas", "pallas2"):
        add(dict(wjob, xs=_t(xg), plan={"matmul": route, "fuse_krow": True,
                                        "health": True}),
            ("window", f"{route}-guarded"), lambda: window_ref(True))
    poison = np.full((3, D), np.nan)
    add(dict(wjob, xs=_t(poison), plan={"matmul": "pallas", "fuse_krow": True,
                                        "health": True}),
        ("unchanged", "pallas-poisoned"), lambda: (wjob,))

    # Near the sentinel: the ring is rebased at block entry.
    sent = twnd.age_sentinel()
    shift = (sent - 3) - int(ws.clock)
    aged = ws.ages.clone()
    aged[aged != sent] += shift
    add(dict(wjob, ages=aged, clock=ws.clock + shift,
             plan={"matmul": "pallas", "fuse_krow": True}),
        ("rebased", "pallas"), lambda: window_ref(False))

    lam = 0.3
    add(dict(kind="expand", L=st.L, U=st.U,
             lam=torch.tensor(lam, dtype=torch.float64), m=st.m),
        ("expand", "-"), lambda: tuple(jrk.expand_eigensystem(
            jst.L, jst.U, jnp.float64(lam), jst.m)))
    Xg = np.zeros((M, D))
    Xg[:m] = X
    xn = rng.normal(size=D)
    add(dict(kind="gram_row", sigma=SIGMA, X=_t(Xg), x_new=_t(xn)),
        ("gram_row", "-"), lambda: (jkf.kernel_row(
            jnp.asarray(xn), jnp.asarray(Xg), spec=SPEC),))

    # A clustered spectrum: the fused pair falls back to two updates.
    mc = 12
    lamc = np.sort(rng.uniform(1.0, 5.0, size=mc))
    lamc[3:7] = lamc[3]
    q, _ = np.linalg.qr(rng.normal(size=(mc, mc)))
    Uc = np.eye(M)
    Uc[:mc, :mc] = q
    Lc = torch.zeros(M, dtype=torch.float64)
    Lc[:mc] = torch.tensor(lamc)
    Lc = trk.sentinelize(Lc, torch.tensor(mc), Lc.new_zeros(()))
    v1, v2 = np.zeros(M), np.zeros(M)
    v1[:mc], v2[:mc] = rng.normal(size=mc), rng.normal(size=mc)

    @cache
    def two():
        jL = jnp.asarray(Lc.numpy())
        assert bool(jrk._merge_fires(jL, jnp.asarray(Uc).T @ jnp.asarray(v1),
                                     jnp.float64(1.7), jnp.int32(mc)))
        out = jrk.rank_one_update(jL, jnp.asarray(Uc), jnp.asarray(v1), 1.7,
                                  jnp.int32(mc), **kw)
        out = jrk.rank_one_update(*out, jnp.asarray(v2), -1.7,
                                  jnp.int32(mc), **kw)
        return (mc,) + tuple(out)

    for route in ("jnp2", "pallas2"):
        add(dict(kind="pair", plan={"matmul": route}, L=Lc, U=_t(Uc),
                 V1=_t(v1[None]), S1=torch.tensor([1.7]), V2=_t(v2[None]),
                 S2=torch.tensor([-1.7]), m=torch.tensor(mc,
                                                         dtype=torch.int32)),
            ("clustered", route), two)

    # The rebalanced update, M = 32, on both sides of the crossover, held
    # to the local update, and the full-group sharded update beside it.
    Mr = 32
    for mr in (5, 30):
        A = rng.normal(size=(mr, mr))
        lam_r, vec_r = np.linalg.eigh(A @ A.T)
        Lr0, Ur0 = np.full(Mr, 2e30), np.eye(Mr)
        Lr0[:mr], Ur0[:mr, :mr] = lam_r, vec_r
        v = np.zeros(Mr)
        v[:mr] = rng.normal(size=mr)

        @cache
        def local(Lr0=Lr0, Ur0=Ur0, v=v, mr=mr):
            return (mr,) + tuple(jrk.rank_one_update(
                jnp.asarray(Lr0), jnp.asarray(Ur0), jnp.asarray(v), 1.3,
                jnp.int32(mr), **kw))

        bplan = {"matmul": "pallas", "dispatch": "bucketed", "min_bucket": 8}
        base = dict(plan=bplan, L=_t(Lr0), U=_t(Ur0),
                    m=torch.tensor(mr, dtype=torch.int32))
        add(dict(base, kind="rebalanced", v=_t(v), sigma=torch.tensor(1.3)),
            ("rebalanced", f"m{mr}"), local)
        add(dict(base, kind="update", V=_t(v[None]), S=torch.tensor([1.3])),
            ("update", f"full-m{mr}"), local)
    return jobs, refs


def _mesh_cases():
    """The 2 × 2 tenant mesh (the reference test's sizes: M = 32, B = 4,
    d = 5): the tenant pair, the tenant query, and the decoupled service
    on the mesh."""
    rng = np.random.default_rng(7)
    Mt, B, d = 32, 4, 5
    jobs, refs = [], []
    Ls, Us, V1, V2, ms = [], [], [], [], []
    for b in range(B):
        mb = 10 + b
        A = rng.normal(size=(mb, mb))
        lam, vec = np.linalg.eigh(A @ A.T)
        L, U = np.full(Mt, 2e30), np.eye(Mt)
        L[:mb], U[:mb, :mb] = lam, vec
        v, w = np.zeros(Mt), np.zeros(Mt)
        v[:mb], w[:mb] = rng.normal(size=mb), rng.normal(size=mb)
        Ls.append(L), Us.append(U), V1.append(v), V2.append(w), ms.append(mb)
    S1 = rng.uniform(1.0, 2.0, size=B)
    kw = dict(iters=62, method="gu", matmul="jnp", precise=True,
              merge_fallback=True)

    def pref():
        return (ms, [jrk.rank_one_update_pair(
            jnp.asarray(Ls[b]), jnp.asarray(Us[b]), jnp.asarray(V1[b]),
            S1[b], jnp.asarray(V2[b]), -S1[b], ms[b], **kw)
            for b in range(B)])

    for route in ("jnp2", "pallas2"):
        jobs.append(dict(kind="tenant_pair", mesh=(2, 2),
                         plan={"matmul": route}, L=_t(Ls), U=_t(Us),
                         V1=_t(V1), S1=_t(S1), V2=_t(V2), S2=_t(-S1),
                         m=torch.tensor(ms, dtype=torch.int32)))
        refs.append((("tenant_pair", route), pref))
    tspec = tkf.KernelSpec(name="rbf", sigma=2.0)
    sb = teng.StreamBatch(torch.tensor(rng.normal(size=(B, 3, d))), Mt,
                          tspec, plan=teng.UpdatePlan(serve_components=4),
                          adjusted=True, dtype=torch.float64, device="cpu")
    for _ in range(4):
        sb.update(torch.tensor(rng.normal(size=(B, d))))
    snaps = sb.publish()
    q = rng.normal(size=(B, 6, d))

    def yq():
        js = jsrv.ServingSnapshot(
            S=jnp.asarray(snaps.S.numpy()), X=jnp.asarray(snaps.X.numpy()),
            m=jnp.asarray(snaps.m.numpy()),
            affine=jsrv.AffineCorrection(*(jnp.asarray(f.numpy())
                                           for f in snaps.affine)),
            generation=jnp.asarray(snaps.generation.numpy()))
        return (jsrv.query_batch(js, jnp.asarray(q),
                                 spec=jkf.KernelSpec(name="rbf", sigma=2.0),
                                 plan=jeng.DEFAULT_PLAN),)

    snap = {"S": snaps.S, "X": snaps.X, "m": snaps.m,
            "affine": tuple(snaps.affine), "generation": snaps.generation}
    for route, extra in (("jnp", {}), ("pallas", {"fuse_krow": True})):
        jobs.append(dict(kind="tenant_query", mesh=(2, 2), sigma=2.0,
                         plan=_plan(route, extra), snaps=snap, xq=_t(q)))
        refs.append((("tenant_query", route), yq))
    argv = ["--mode", "kpca", "--decouple", "--mesh", "2x2", "--device",
            "cpu", "--dtype", "float64", "--tenants", "4", "--capacity",
            "16", "--points", "6", "--dim", "4", "--batch", "3",
            "--serve-every", "2", "--serve-components", "4"]
    jobs.append(dict(kind="decoupled", mesh=(2, 2), argv=argv))
    refs.append((("decoupled", "2x2"), lambda: (argv,)))
    return jobs, refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs, refs = _cases()
    mjobs, mrefs = _mesh_cases()
    started = {P: spmd.start(P, jobs + (mjobs if P == 4 else []),
                             workdir=tmp_path_factory.mktemp(f"p{P}"),
                             timeout=TIMEOUT) for P in (2, 4)}
    # The reference's outputs while the ranks work.
    refs = [(name, thunk()) for name, thunk in refs]
    mrefs = [(name, thunk()) for name, thunk in mrefs]
    out = {P: s.wait() for P, s in started.items()}
    return {"runs": out, "refs": refs, "mrefs": mrefs, "n": len(jobs)}


def _assemble(ranks, j, key="U"):
    return torch.cat([r["outs"][j][key] for r in ranks], dim=-2).numpy()


def _row_params():
    """The cases' names, in ``_cases``'s order, without building them at
    collection."""
    names = []
    for route, _ in ROUTES["update"]:
        names.append(("update", route))
    for route, _ in ROUTES["pair"]:
        names.append(("pair", route))
    for victim in VICTIMS:
        routes = ROUTES["downdate"] if victim == 10 else \
            ROUTES["downdate"][1:3]
        names += [("downdate", f"{r}-{victim}") for r, _ in routes]
        if victim == 3:
            names.append(("downdate", "jnp-3"))
    names += [("window", r) for r, _ in ROUTES["window"]]
    names += [("window", "pallas-blocks-of-2"), ("window", "pallas-metered"),
              ("window", "pallas-guarded"), ("window", "pallas2-guarded"),
              ("unchanged", "pallas-poisoned"), ("rebased", "pallas"),
              ("expand", "-"), ("gram_row", "-"), ("clustered", "jnp2"),
              ("clustered", "pallas2"), ("rebalanced", "m5"),
              ("update", "full-m5"), ("rebalanced", "m30"),
              ("update", "full-m30")]
    return names


ROW_NAMES = _row_params()


def test_the_case_list_is_the_parametrization(runs):
    assert [name for name, _ in runs["refs"]] == ROW_NAMES
    for P, ranks in runs["runs"].items():
        assert [r["rank"] for r in ranks] == list(range(P))


@pytest.mark.parametrize("P", [2, 4])
def test_no_rank_loads_jax_or_the_reference(runs, P):
    assert not any(r["reference_loaded"] for r in runs["runs"][P])


def _check_eigensystem(Lg, Ug, m, Lr, Ur):
    Lr, Ur = np.asarray(Lr), np.asarray(Ur)
    np.testing.assert_allclose(Lg[:m], Lr[:m], atol=1e-10)
    np.testing.assert_allclose(Ug, Ur, atol=1e-8)
    Kg = np.asarray(jrk.reconstruct(jnp.asarray(Lg), jnp.asarray(Ug),
                                    jnp.int32(m)))
    Kr = np.asarray(jrk.reconstruct(jnp.asarray(Lr), jnp.asarray(Ur),
                                    jnp.int32(m)))
    np.testing.assert_allclose(Kg, Kr, atol=1e-10)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("j", range(len(ROW_NAMES)),
                         ids=[f"{a}-{b}" for a, b in ROW_NAMES])
def test_sharded_builder_matches_the_local_path(runs, P, j):
    ranks = runs["runs"][P]
    (kind, name), ref = runs["refs"][j]
    out0 = ranks[0]["outs"][j]
    if kind == "rebalanced" or name.startswith("full-"):
        # Random spectra of A·Aᵀ (eigenvalues up to ~50, some close): the
        # local path within 1e-10 of λmax and K within 1e-8 of it (the
        # tenant pair's bar), the balanced layout within 1e-10 of the
        # full-group update, as the reference's test holds it.
        m, Lr, Ur = ref
        Lg, Ug = out0["L"].numpy(), _assemble(ranks, j)
        scale = float(np.abs(np.asarray(Lr)[:m]).max())
        np.testing.assert_allclose(Lg[:m], np.asarray(Lr)[:m],
                                   atol=1e-10 * scale)
        Kg = Ug[:, :m] @ np.diag(Lg[:m]) @ Ug[:, :m].T
        Kr = np.asarray(Ur)[:, :m] @ np.diag(np.asarray(Lr)[:m]) \
            @ np.asarray(Ur)[:, :m].T
        np.testing.assert_allclose(Kg, Kr, atol=1e-8 * scale)
        if kind == "rebalanced":
            full = ROW_NAMES.index(("update", f"full-{name}"))
            np.testing.assert_allclose(
                Lg, ranks[0]["outs"][full]["L"].numpy(), atol=1e-10)
            np.testing.assert_allclose(Ug, _assemble(ranks, full),
                                       atol=1e-10)
    elif kind in ("update", "pair"):
        m, Lr, Ur = ref
        _check_eigensystem(out0["L"].numpy(), _assemble(ranks, j), m, Lr, Ur)
    elif kind == "downdate":
        m, Lr, Ur = ref
        assert all(int(r["outs"][j]["m"]) == m for r in ranks)
        _check_eigensystem(out0["L"].numpy(), _assemble(ranks, j), m, Lr, Ur)
    elif kind == "clustered":
        m, Lr, Ur = ref
        Lg, Ug = out0["L"].numpy(), _assemble(ranks, j)
        np.testing.assert_allclose(Lg[:m], np.asarray(Lr)[:m], atol=1e-10)
        np.testing.assert_allclose(np.abs(Ug), np.abs(np.asarray(Ur)),
                                   atol=1e-8)
        orth = np.abs(Ug[:m, :m] @ Ug[:m, :m].T - np.eye(m)).max()
        assert orth < 1e-10, orth
    elif kind in ("window", "rebased"):
        wref, = ref
        Lg, Ug = out0["L"].numpy(), _assemble(ranks, j)
        _check_eigensystem(Lg, Ug, W, wref.kpca.L, wref.kpca.U)
        np.testing.assert_allclose(out0["X"].numpy(),
                                   np.asarray(wref.kpca.X), atol=1e-12)
        ages = out0["ages"].numpy()
        if kind == "rebased":
            assert int(out0["clock"]) < twnd.age_sentinel() // 2
            np.testing.assert_array_equal(np.argsort(ages[:W]),
                                          np.argsort(np.asarray(
                                              wref.ages[:W])))
        else:
            np.testing.assert_array_equal(ages, _ages(wref.ages))
            assert int(out0["clock"]) == int(wref.clock)
        if "metrics" in out0:
            met = out0["metrics"]
            assert met["ingests"] == met["evictions"] == 5
            assert met["window_fill"] == 1.0
        for r in ranks[1:]:          # the replicated values agree
            for key in ("L", "X", "ages", "clock"):
                assert torch.equal(r["outs"][j][key], out0[key]), key
    elif kind == "unchanged":
        job, = ref
        assert torch.equal(out0["L"], job["L"])
        assert np.array_equal(_assemble(ranks, j), job["U"].numpy())
        for key in ("X", "ages", "clock"):
            assert torch.equal(out0[key], job[key]), key
    elif kind == "expand":
        Lr, Ur, mr = ref
        assert np.array_equal(out0["L"].numpy(), np.asarray(Lr))
        assert np.array_equal(_assemble(ranks, j), np.asarray(Ur))
        assert int(out0["m"]) == int(mr)
    elif kind == "gram_row":
        a = torch.cat([r["outs"][j]["a"] for r in ranks]).numpy()
        np.testing.assert_allclose(a, np.asarray(ref[0]), atol=1e-12)
    else:
        raise AssertionError(kind)


@pytest.mark.parametrize("P", [2, 4])
def test_collective_schedule_is_fixed(runs, P):
    """Every rank issued the same count of all-reduces in every job (no
    rank branched around a collective), the counts the module states."""
    ranks = runs["runs"][P]
    for j in range(runs["n"]):
        counts = {r["outs"][j]["collectives"] for r in ranks}
        assert len(counts) == 1, (ROW_NAMES[j], counts)
    by_name = {n: ranks[0]["outs"][j]["collectives"]
               for j, n in enumerate(ROW_NAMES)}
    assert by_name["update", "pallas"] == 3          # one an update
    assert by_name["pair", "pallas2"] == 4           # two a pair
    assert by_name["pair", "pallas"] == 4
    assert by_name["downdate", "pallas-10"] == 3
    assert by_name["downdate", "pallas-0"] == 5      # + permute + row i
    # A window step: the evict's 5, the ingest's fused k-row all-reduce and
    # the pair's second.
    assert by_name["window", "pallas"] == 5 * 7
    assert by_name["window", "pallas-guarded"] == 5 * 7
    assert by_name["rebalanced", "m5"] == 3           # gather, z, gather


def _mesh_out(runs, k):
    ranks = runs["runs"][4]
    j = runs["n"] + k
    return ranks, [r["outs"][j] for r in ranks]


@pytest.mark.parametrize("k", [0, 1], ids=["jnp2", "pallas2"])
def test_tenant_pair_on_the_2x2_mesh(runs, k):
    ranks, outs = _mesh_out(runs, k)
    ms, pref = runs["mrefs"][k][1]
    # rank = t·P_r + r: slice t holds tenants 2t, 2t + 1, rows split by r.
    for t in range(2):
        L = outs[2 * t]["L"].numpy()
        U = torch.cat([outs[2 * t]["U"], outs[2 * t + 1]["U"]],
                      dim=-2).numpy()
        assert torch.equal(outs[2 * t]["L"], outs[2 * t + 1]["L"])
        for i in range(2):
            b = 2 * t + i
            Lr, Ur = (np.asarray(x) for x in pref[b])
            act = np.arange(L.shape[-1]) < ms[b]
            Ko = U[i] @ np.diag(act * L[i]) @ U[i].T
            Kr = Ur @ np.diag(act * Lr) @ Ur.T
            np.testing.assert_allclose(Ko, Kr, atol=1e-8)
    assert all(o["collectives"] == 2 for o in outs)


@pytest.mark.parametrize("k", [2, 3], ids=["jnp", "pallas"])
def test_tenant_query_on_the_2x2_mesh(runs, k):
    ranks, outs = _mesh_out(runs, k)
    yq = np.asarray(runs["mrefs"][k][1][0])
    y = np.concatenate([outs[0]["y"].numpy(), outs[2]["y"].numpy()])
    np.testing.assert_allclose(y, yq, atol=1e-12)
    assert torch.equal(outs[0]["y"], outs[1]["y"])
    assert all(o["collectives"] == 0 for o in outs)


def test_decoupled_mesh_answers_equal_the_single_process_run(runs):
    """``serve --decouple --mesh 2x2`` on four ranks: each slice's answers
    are those of the one-process service for the same tenants, and the
    gathered report is the one-process report's."""
    from repro_torch.launch import serve as tserve

    ranks, outs = _mesh_out(runs, 4)
    argv, = runs["mrefs"][4][1]
    args = tserve.parse_args([a for a in argv if a not in ("--mesh", "2x2")])
    answers = []
    orig = tserve.IngestServeLoop.query

    def query(self, q):
        y = orig(self, q)
        answers.append(y)
        return y

    tserve.IngestServeLoop.query = query
    try:
        single, _ = tserve.kpca_decoupled_service(args)
    finally:
        tserve.IngestServeLoop.query = orig
    ys = torch.stack(answers)
    for rank, o in enumerate(outs):
        t = rank // 2
        np.testing.assert_allclose(o["answers"].numpy(),
                                   ys[:, 2 * t:2 * t + 2].numpy(),
                                   atol=1e-12)
    rep = outs[0]["result"]
    for key in ("generations", "m_final", "queries_served",
                "skipped_publishes"):
        assert rep[key] == single[key], key
    assert rep["world_size"] == 4 and rep["tenant_sharded_queries"]
    assert rep["staging"] == "device (gloo)"


def test_a_failing_rank_fails_the_launch_at_once(tmp_path):
    """A rank that raises ends the launch (its peers, which would wait in
    a collective, are killed) well before the timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed"):
        spmd.launch(2, [{"kind": "no such job"}], workdir=tmp_path,
                    timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2
