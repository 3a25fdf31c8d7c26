"""The rank-one path over a leading tenant axis, against per-tenant calls.

Every function of the update takes stacked operands (``core/rankone.py``):
L (B, M), U (B, M, M), m (B,).  On the CPU a batched call is held to B
unbatched calls on each tenant's operands (f64, tenants at different m):

* the plain kernel versions (the kernels' CPU route, ``tenantwise``) bit
  for bit, as each kernel promises on the card;
* the rank-one update, the fused pair, the ingest variants and the
  downdate within 1e-12 of the state's scale: a stacked matmul may round
  otherwise than one tenant's, nothing else differs;
* the fused pair where the cluster merge fires for one tenant and not for
  the next: each takes its own branch (the select ``lax.cond`` becomes
  under ``jax.vmap``), one host read for the pair;
* the batched update against the reference's ``jax.vmap`` of its own
  (the reference's 1e-10 of ``tests/test_rankone.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import rankone as jr  # noqa: E402
from repro_torch.core import downdate as tdd, engine as teng  # noqa: E402
from repro_torch.core import inkpca as tink, kernels_fn as tkf  # noqa: E402
from repro_torch.core import rankone as tr  # noqa: E402
from repro_torch.kernels.eigvec_update import ops as eops  # noqa: E402
from repro_torch.kernels.nystrom_recon import ops as nops  # noqa: E402
from repro_torch.kernels.rbf_gram import ops as kops  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

M, D = 16, 4
MS = (5, 9, 16, 12)                     # per-tenant active counts
SPEC = tkf.KernelSpec(sigma=5.0)


def _padded(lam, vec, M):
    m = len(lam)
    L = np.zeros(M)
    L[:m] = lam
    U = np.eye(M)
    U[:m, :m] = vec
    return tr.sentinelize(torch.tensor(L), torch.tensor(m, dtype=torch.int32),
                          torch.zeros((), dtype=torch.float64)).numpy(), U


def _systems(seed=0, ms=MS, cluster=None):
    """Per-tenant (L, U, v1, v2) on the padding contract; ``cluster``
    puts tenant 0's first three eigenvalues within 1e-13 of each other
    (a cluster merge fires there)."""
    rng = np.random.default_rng(seed)
    out = []
    for b, m in enumerate(ms):
        lam = np.sort(rng.uniform(0.5, 6.0, size=m))
        if cluster is not None and b == cluster:
            lam[:3] = 2.0 + rng.normal(size=3) * 1e-13
            lam = np.sort(lam)
        vec = np.linalg.qr(rng.normal(size=(m, m)))[0]
        L, U = _padded(lam, vec, M)
        v1, v2 = np.zeros(M), np.zeros(M)
        v1[:m], v2[:m] = rng.normal(size=m), rng.normal(size=m)
        out.append((L, U, v1, v2))
    return [torch.tensor(np.stack(a)) for a in zip(*out)]


def _m(ms=MS):
    return torch.tensor(ms, dtype=torch.int32)


def _close(a, b, scale=1.0, tol=1e-12):
    assert float((a - b).abs().max()) <= tol * scale


# ------------------------------------------------------- plain versions --
def _rotate_operands(rng, ms=MS):
    B = len(ms)
    m = _m(ms)
    U = torch.tensor(rng.normal(size=(B, M, M)))
    z = torch.tensor(rng.normal(size=(B, M)))
    d = torch.tensor(np.sort(rng.normal(size=(B, M)), axis=1))
    org = d + 0.25
    tau = torch.tensor(rng.uniform(0.01, 0.1, size=(B, M)))
    inv = torch.tensor(rng.uniform(0.5, 2.0, size=(B, M)))
    return U, z, d, org, inv, tau, m


def test_plain_kernel_versions_equal_stacked_single_calls():
    """Each of the five kernels' plain versions over a tenant axis equals
    the single calls on each tenant's operands bit for bit, pruning by
    the tenant's own m (row blocks too)."""
    rng = np.random.default_rng(1)
    U, z, d, org, inv, tau, m = _rotate_operands(rng)
    got = eops.rotate_vectors(U, z, d, org, inv, m, tau=tau)
    blk = eops.rotate_vectors(U[:, 4:12].contiguous(), z, d, org, inv, m,
                              tau=tau, row_offset=4)
    defl = (torch.arange(M) % 5 == 2).to(torch.float64).expand(len(MS), M)
    cid = torch.arange(M, dtype=torch.int32).expand(len(MS), M).contiguous()
    got2 = eops.rotate_vectors2(U, z, d, org, inv, defl, cid, z * 0.5, d,
                                org + 0.1, inv, defl, cid, m, tau1=tau,
                                tau2=tau)
    V = torch.tensor(rng.normal(size=(len(MS), M, 2)))
    proj = eops.project_vectors(U, V, m)
    X = torch.tensor(rng.normal(size=(len(MS), M, D)))
    xq = torch.tensor(rng.normal(size=(len(MS), D)))
    aux = torch.tensor(rng.normal(size=(len(MS), M, 2)))
    a, P = kops.krow_project(U, X, xq, aux, m, spec=SPEC)
    q = torch.tensor(rng.normal(size=(len(MS), 6, D)))
    S = torch.tensor(rng.normal(size=(len(MS), M, 3)))
    y, rs = nops.transform_project(q, X, S, m, spec=SPEC)
    for b in range(len(MS)):
        assert torch.equal(got[b], eops.rotate_vectors(
            U[b], z[b], d[b], org[b], inv[b], m[b], tau=tau[b]))
        assert torch.equal(blk[b], eops.rotate_vectors(
            U[b, 4:12], z[b], d[b], org[b], inv[b], m[b], tau=tau[b],
            row_offset=4))
        assert torch.equal(got2[b], eops.rotate_vectors2(
            U[b], z[b], d[b], org[b], inv[b], defl[b], cid[b], z[b] * 0.5,
            d[b], org[b] + 0.1, inv[b], defl[b], cid[b], m[b], tau1=tau[b],
            tau2=tau[b]))
        assert torch.equal(proj[b], eops.project_vectors(U[b], V[b], m[b]))
        a1, P1 = kops.krow_project(U[b], X[b], xq[b], aux[b], m[b],
                                   spec=SPEC)
        assert torch.equal(a[b], a1) and torch.equal(P[b], P1)
        y1, rs1 = nops.transform_project(q[b], X[b], S[b], m[b], spec=SPEC)
        assert torch.equal(y[b], y1) and torch.equal(rs[b], rs1)
        # Pruned by its own m: columns past ceil(m/64)·64 (here none) and
        # the krow rows past m.
        assert torch.equal(a[b, MS[b]:], torch.zeros(M - MS[b],
                                                     dtype=a.dtype))


def test_batched_indexing_clamps_and_matches_single():
    """``index_set``/``index_get`` per tenant, clamped into range (a lane
    a masked step discards may sit at m = M)."""
    vec = torch.arange(12.0).reshape(3, 4)
    i = torch.tensor([0, 3, 4], dtype=torch.int32)
    out = tr.index_set(vec, i, torch.tensor([-1.0, -2.0, -3.0]))
    assert out.tolist() == [[-1, 1, 2, 3], [4, 5, 6, -2], [8, 9, 10, -3]]
    assert tr.index_get(vec, i).tolist() == [0.0, 7.0, 11.0]
    X = torch.arange(24.0).reshape(2, 3, 4)
    rows = tr.index_set(X, torch.tensor([1, 2]), torch.zeros(2, 4))
    for b, r in enumerate((1, 2)):
        assert torch.equal(rows[b], tr.index_set(X[b], torch.tensor(r),
                                                 torch.zeros(4)))
        assert torch.equal(tr.index_get(X, torch.tensor([1, 2]))[b], X[b, r])
    assert torch.equal(tr.active_mask(4, torch.tensor([0, 2])),
                       torch.tensor([[False] * 4, [True, True, False,
                                                   False]]))


# ------------------------------------------------------- rank-one updates --
@pytest.mark.parametrize("matmul", ["jnp", "pallas"])
@pytest.mark.parametrize("sigma", [0.7, -1.3])
def test_rank_one_update_batched_equals_per_tenant(matmul, sigma):
    L, U, v1, _ = _systems()
    m = _m()
    bl, bu = tr.rank_one_update(L, U, v1, sigma, m, matmul=matmul)
    for b in range(len(MS)):
        sl, su = tr.rank_one_update(L[b], U[b], v1[b], sigma, MS[b],
                                    matmul=matmul)
        _close(bl[b], sl, float(L[b, :MS[b]].abs().max()))
        _close(bu[b], su)


def test_rank_one_update_batched_per_tenant_sigma():
    """sigma may differ per tenant (Algorithm 1's 4/k)."""
    L, U, v1, _ = _systems(seed=3)
    sig = torch.tensor([0.5, -0.8, 1.7, -0.2])
    bl, bu = tr.rank_one_update(L, U, v1, sig, _m(), matmul="pallas")
    for b in range(len(MS)):
        sl, su = tr.rank_one_update(L[b], U[b], v1[b], float(sig[b]), MS[b],
                                    matmul="pallas")
        _close(bl[b], sl, 10.0)
        _close(bu[b], su)


@pytest.mark.parametrize("matmul", ["jnp", "pallas"])
@pytest.mark.parametrize("cluster", [None, 0], ids=["clean", "merge0"])
def test_pair_batched_equals_per_tenant(matmul, cluster):
    """The fused pair over the cohort; with tenant 0 clustered its merge
    fires (it takes the sequential branch) while the next tenant's does
    not (the fused rotation), each as its own single call."""
    L, U, v1, v2 = _systems(seed=5, cluster=cluster)
    m = _m()
    sig = 0.7
    half = torch.tensor(sig, dtype=torch.float64)
    fired = tr._pair_solve(L, tr.tmatvec(U, v1), half.expand(len(MS)),
                           tr.tmatvec(U, v2), -half.expand(len(MS)), m,
                           iters=62, method="gu", precise=True).merge_fired
    if cluster is None:
        assert not bool(fired.any())
    else:
        assert fired.tolist()[:2] == [True, False]
    bl, bu = tr.rank_one_update_pair(L, U, v1, sig, v2, -sig, m,
                                     matmul=matmul)
    for b in range(len(MS)):
        sl, su = tr.rank_one_update_pair(L[b], U[b], v1[b], sig, v2[b], -sig,
                                         MS[b], matmul=matmul)
        _close(bl[b], sl, 10.0)
        _close(bu[b], su)


def test_rank_one_update_matches_reference_vmap():
    """The port's batched update against ``jax.vmap`` of the reference's
    (1e-10, the reference's own ``tests/test_rankone.py``)."""
    L, U, v1, _ = _systems(seed=7)
    want_l, want_u = jax.vmap(lambda l, u, v, m: jr.rank_one_update(
        l, u, v, 0.9, m))(jnp.asarray(L.numpy()), jnp.asarray(U.numpy()),
                          jnp.asarray(v1.numpy()), jnp.asarray(MS))
    bl, bu = tr.rank_one_update(L, U, v1, 0.9, _m())
    for b, m in enumerate(MS):
        np.testing.assert_allclose(bl[b, :m].numpy(),
                                   np.asarray(want_l[b, :m]), atol=1e-10)
        rec = tr.reconstruct(bl[b], bu[b], torch.tensor(m)).numpy()
        wrec = np.asarray(jr.reconstruct(want_l[b], want_u[b], m))
        np.testing.assert_allclose(rec, wrec, atol=1e-10)


# ------------------------------------------------ ingest and downdate --
def _stacked(seed=9, ms=(5, 9, 3), M=16, adjusted=True):
    rng = np.random.default_rng(seed)
    sts = [tink.init_state(torch.tensor(rng.normal(size=(m, D))), M, SPEC,
                           adjusted=adjusted, dtype=torch.float64)
           for m in ms]
    return tink.stack_states(sts), sts, rng


@pytest.mark.parametrize("matmul", ["pallas", "pallas2"])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("adjusted", [True, False],
                         ids=["algorithm2", "algorithm1"])
def test_ingest_batched_equals_per_tenant(matmul, fuse, adjusted):
    stk, sts, rng = _stacked(adjusted=adjusted)
    plan = teng.UpdatePlan(matmul=matmul, fuse_krow=fuse)
    xs = torch.tensor(rng.normal(size=(len(sts), D)))
    out = teng._ingest(stk, xs, SPEC, adjusted, plan)
    for b, st in enumerate(sts):
        one = teng._ingest(st, xs[b], SPEC, adjusted, plan)
        for got, want in zip(tink.unstack_state(out, b), one):
            _close(got, want, 10.0)


@pytest.mark.parametrize("matmul", ["pallas", "pallas2"])
def test_downdate_batched_equals_per_tenant(matmul):
    """Per-tenant rows, row 0 among them (the lockstep FIFO's)."""
    stk, sts, _ = _stacked(seed=11, ms=(5, 9, 4, 7))
    rows = torch.tensor([0, 4, 2, 0], dtype=torch.int32)
    plan = teng.UpdatePlan(matmul=matmul)
    out = tdd.downdate(stk, rows, SPEC, adjusted=True, plan=plan)
    for b, st in enumerate(sts):
        one = tdd.downdate(st, rows[b], SPEC, adjusted=True, plan=plan)
        for got, want in zip(tink.unstack_state(out, b), one):
            _close(got, want, 10.0)


def test_masked_steps_keep_idle_lanes_bitwise():
    """The masked update and downdate select the whole state per lane: an
    idle lane is bit for bit its input, even one at m = M (whose
    discarded update indexes past the capacity, clamped)."""
    stk, sts, rng = _stacked(seed=13, ms=(5, 16, 8))
    act = torch.tensor([True, False, True])
    xs = torch.tensor(rng.normal(size=(3, D)))
    plan = teng.UpdatePlan(matmul="pallas")
    out = teng.batched_update_masked(stk, xs, act, SPEC, True, plan)
    assert all(torch.equal(a, b) for a, b in zip(
        tink.unstack_state(out, 1), sts[1]))
    assert out.m.tolist() == [6, 16, 9]
    rows = torch.zeros(3, dtype=torch.int32)
    out = teng.batched_downdate_masked(stk, rows, ~act, SPEC, True, plan)
    for b in (0, 2):
        assert all(torch.equal(a, c) for a, c in zip(
            tink.unstack_state(out, b), sts[b]))
    assert out.m.tolist() == [5, 15, 8]


def test_slice_and_scatter_stacked_per_tenant():
    """``slice_state``/``scatter_state`` on a stacked state act on every
    tenant as on one state (the reference's ``_slice_stacked`` /
    ``_scatter_stacked``)."""
    stk, sts, rng = _stacked(seed=17, ms=(5, 7), M=32)
    sub = teng.slice_state(stk, 16)
    plan = teng.UpdatePlan(matmul="pallas")
    sub = teng._ingest(sub, torch.tensor(rng.normal(size=(2, D))), SPEC,
                       True, plan)
    full = teng.scatter_state(stk, sub)
    for b, st in enumerate(sts):
        one = teng.scatter_state(st, tink.unstack_state(sub, b))
        assert all(torch.equal(a, c) for a, c in zip(
            tink.unstack_state(full, b), one))
        assert torch.equal(tink.unstack_state(teng.slice_state(stk, 16),
                                              b).U,
                           teng.slice_state(st, 16).U)
