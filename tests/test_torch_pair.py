"""The fused ±sigma pair of the port against the reference's.

* ``eigvec_rotate2``'s plain version (the CPU route of
  ``ops.rotate_vectors2``) against the reference's ``eigvec_rotate2_ref``
  and its Pallas kernel in interpret mode, with deflated columns under a
  permuted cid: 1e-12 relative in f64 (1e-10 against the interpret
  kernel, which sums by tiles), and the reference's own 5e-3 in f32
  (``tests/test_kernels_pallas.py::test_eigvec_rotate2_matches_two_rotations``).
* ``rank_one_update_pair`` against the reference's on clean spectra, f64,
  both routes, at ``tests/test_rankone.py``'s 1e-10.
* On clustered spectra, where the reference is at fault (ROADMAP.md,
  "Faults found"), against the port's own sequential route and the eigh
  oracle: orthogonality < 1e-9 and reconstruction <= 1e-9·‖A‖.
* A 40-point stream under ``matmul="pallas2"`` against the reference's
  (``tests/test_inkpca.py``'s tolerances: eigenvalues atol 1e-9, S and K1
  rtol 1e-10, 5e-5 of the scale against the batch eigh oracle).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng, inkpca as jink  # noqa: E402
from repro.core import kernels_fn as jkf, rankone as jr  # noqa: E402
from repro.kernels.eigvec_update import ref as jref  # noqa: E402
from repro.kernels.eigvec_update.eigvec_update import (  # noqa: E402
    eigvec_rotate2 as j_rotate2_kernel)
from repro_torch.core import batch as tbatch, engine as teng  # noqa: E402
from repro_torch.core import inkpca as tink, kernels_fn as tkf  # noqa: E402
from repro_torch.core import rankone as tr  # noqa: E402
from repro_torch.kernels.eigvec_update import ops as eops  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401


def _rotation2_inputs(M, m, np_dtype, seed=0):
    """Two factors on the padding contract (the reference test's inputs):
    column 5 of factor 1 deflated onto e_12, column 9 of factor 2 onto
    e_9."""
    rng = np.random.default_rng(seed)
    U = np.eye(M)
    U[:m, :m] = np.linalg.qr(rng.normal(size=(m, m)))[0]
    mask = np.arange(M) < m

    def factor(shift):
        z = np.where(mask, rng.normal(size=M), 0.0)
        d = np.sort(rng.normal(size=M))
        inv = rng.uniform(0.5, 2.0, size=M)
        return (z, np.where(mask, d, 2e30), np.where(mask, d + shift, 1e30),
                np.where(mask, inv, 0.0))

    z1, d1, lam1, inv1 = factor(0.4)
    z2, d2, lam2, inv2 = factor(0.9)
    defl1, defl2 = np.zeros(M), np.zeros(M)
    defl1[5], defl2[9] = 1.0, 1.0
    cid1, cid2 = np.arange(M, dtype=np.int32), np.arange(M, dtype=np.int32)
    cid1[5] = 12
    floats = [a.astype(np_dtype) for a in (U, z1, d1, lam1, inv1, defl1)]
    floats2 = [a.astype(np_dtype) for a in (z2, d2, lam2, inv2, defl2)]
    return floats + [cid1] + floats2 + [cid2]


@pytest.mark.parametrize("dt,rtol,rtol_kernel", [
    ("f64", 1e-12, 1e-10), ("f32", 5e-3, 5e-3)])
def test_eigvec_rotate2_plain_matches_reference(dt, rtol, rtol_kernel):
    M, m = 200, 70
    np_dtype = np.float64 if dt == "f64" else np.float32
    args = _rotation2_inputs(M, m, np_dtype)
    # The reference's absolute roots are the offset form with tau = 0.
    zero = torch.zeros(M, dtype=torch.float64)
    got = eops.rotate_vectors2(*[torch.from_numpy(a) for a in args], m,
                               tau1=zero, tau2=zero)
    assert got.dtype == torch.from_numpy(args[0]).dtype
    got = got.double().numpy()
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jref.eigvec_rotate2_ref(*jargs), np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)
    for na in (None, jnp.int32(m)):
        kern = np.asarray(j_rotate2_kernel(*jargs, na, interpret=True,
                                           block=64), np.float64)
        np.testing.assert_allclose(got[:, :m], kern[:, :m], rtol=rtol_kernel,
                                   atol=rtol_kernel * scale)


def test_eigvec_rotate2_offset_form_is_the_absolute_form():
    """With tau the roots' offsets from lam, the plain version equals the
    reference's absolute form, lam + tau with a zero offset, wherever the
    sum is exact."""
    M, m = 64, 40
    args = [torch.from_numpy(a) for a in _rotation2_inputs(M, m, np.float64)]
    tau1 = torch.where(torch.arange(M) < m, 0.25, 0.0).double()
    tau2 = torch.where(torch.arange(M) < m, -0.125, 0.0).double()
    shifted = list(args)
    shifted[3] = args[3] + tau1
    shifted[9] = args[9] + tau2
    zero = torch.zeros(M, dtype=torch.float64)
    np.testing.assert_allclose(
        eops.rotate_vectors2(*args, m, tau1=tau1, tau2=tau2).numpy(),
        eops.rotate_vectors2(*shifted, m, tau1=zero, tau2=zero).numpy(),
        rtol=1e-12, atol=1e-12)
    with pytest.raises(TypeError, match="tau2"):
        eops.rotate_vectors2(*args, m, tau1=tau1)


def _padded(lam, vec, M):
    m = lam.shape[0]
    L, U = np.zeros(M), np.eye(M)
    L[:m], U[:m, :m] = lam, vec
    return (np.asarray(jr.sentinelize(jnp.asarray(L), jnp.int32(m),
                                      jnp.float64(0.0))), U)


def _generic(m, M, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, m))
    L, U = _padded(*np.linalg.eigh(A @ A.T), M)
    v1, v2 = np.zeros(M), np.zeros(M)
    v1[:m], v2[:m] = rng.normal(size=m), rng.normal(size=m)
    return L, U, v1, v2


def _recon(L, U, m):
    return (U[:m, :m] * L[:m]) @ U[:m, :m].T


@pytest.mark.parametrize("precomputed", [False, True])
@pytest.mark.parametrize("sigma", [1.3, -0.8])
@pytest.mark.parametrize("matmul", ["jnp", "pallas"])
def test_rank_one_update_pair_matches_reference(matmul, sigma, precomputed):
    m, M = 10, 16
    L, U, v1, v2 = _generic(m, M, seed=5)
    zkw_j, zkw_t = {}, {}
    if precomputed:
        zkw_j = dict(z1=jnp.asarray(U.T @ v1), z2=jnp.asarray(U.T @ v2))
        zkw_t = dict(z1=torch.tensor(U.T @ v1), z2=torch.tensor(U.T @ v2))
    jl, ju = jr.rank_one_update_pair(
        jnp.asarray(L), jnp.asarray(U), jnp.asarray(v1), jnp.float64(sigma),
        jnp.asarray(v2), jnp.float64(-sigma), jnp.int32(m), matmul=matmul,
        **zkw_j)
    tl, tu = tr.rank_one_update_pair(
        torch.tensor(L), torch.tensor(U), torch.tensor(v1), sigma,
        torch.tensor(v2), -sigma, m, matmul=matmul, **zkw_t)
    jl, ju, tl, tu = np.asarray(jl), np.asarray(ju), tl.numpy(), tu.numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(np.abs(tu), np.abs(ju), atol=1e-10)
    np.testing.assert_allclose(_recon(tl, tu, m), _recon(jl, ju, m),
                               atol=1e-10)
    np.testing.assert_array_equal(tu[:, m:], np.eye(M)[:, m:])


def test_pair_solve_pieces_match_reference():
    """``_merge_fires`` and ``_factor_tmatvec`` against the reference's."""
    m, M = 10, 16
    L, U, v1, v2 = _generic(m, M, seed=9)
    z1, z2 = U.T @ v1, U.T @ v2
    pt = tr._pair_solve(torch.tensor(L), torch.tensor(z1),
                        torch.tensor(0.7, dtype=torch.float64),
                        torch.tensor(z2),
                        torch.tensor(-0.7, dtype=torch.float64),
                        torch.tensor(m, dtype=torch.int32), iters=62,
                        method="gu", precise=True)
    pj = jr._pair_solve(jnp.asarray(L), jnp.asarray(z1), jnp.float64(0.7),
                        jnp.asarray(z2), jnp.float64(-0.7), jnp.int32(m),
                        iters=62, method="gu", precise=True)
    np.testing.assert_allclose((pt.org1 + pt.tau1).numpy(),
                               np.asarray(pj.lam1), atol=1e-12)
    np.testing.assert_allclose((pt.org2 + pt.tau2).numpy(),
                               np.asarray(pj.lam2), atol=1e-12)
    np.testing.assert_allclose(np.abs(pt.z2.numpy()), np.abs(np.asarray(pj.z2)),
                               atol=1e-12)
    np.testing.assert_array_equal(pt.cid1.numpy(), np.asarray(pj.cid1))
    assert bool(pt.merge_fired) == bool(pj.merge_fired)
    dc = L.copy()
    dc[2:5] = dc[2]
    for arr in (L, dc):
        assert bool(tr._merge_fires(torch.tensor(arr), torch.tensor(z1),
                                    torch.tensor(0.7, dtype=torch.float64),
                                    torch.tensor(m, dtype=torch.int32))) == \
            bool(jr._merge_fires(jnp.asarray(arr), jnp.asarray(z1),
                                 jnp.float64(0.7), jnp.int32(m)))


def _clustered(seed, n_cluster, width, m=9, M=12):
    rng = np.random.default_rng(seed)
    lam = np.sort(np.concatenate([2.0 + rng.normal(size=n_cluster) * width,
                                  rng.uniform(3.0, 6.0, size=m - n_cluster)]))
    L, U = _padded(lam, np.linalg.qr(rng.normal(size=(m, m)))[0], M)
    v1, v2 = np.zeros(M), np.zeros(M)
    v1[:m], v2[:m] = rng.normal(size=m), rng.normal(size=m)
    return L, U, v1, v2


# Without the merge fallback the fused pair has no cluster merge, so poles
# that coincide exactly (width 1e-16 rounds the cluster onto 2.0) are
# outside its contract, as in the reference; distinct poles are not.
_CLUSTERS = [(729, 5, 1e-12, True), (0, 4, 1e-14, True), (1, 3, 1e-16, True),
             (2, 6, 1e-13, True), (729, 5, 1e-12, False),
             (2, 6, 1e-13, False)]


@pytest.mark.parametrize("matmul", ["jnp", "pallas"])
@pytest.mark.parametrize("seed,n_cluster,width,merge_fallback", _CLUSTERS)
def test_pair_on_clustered_spectra_matches_sequential_and_eigh(
        seed, n_cluster, width, merge_fallback, matmul):
    m, sigma = 9, 0.7
    L, U, v1, v2 = _clustered(seed, n_cluster, width, m=m)
    A = _recon(L, U, m)
    B = A + sigma * (np.outer(v1[:m], v1[:m]) - np.outer(v2[:m], v2[:m]))
    tl, tu = tr.rank_one_update_pair(
        torch.tensor(L), torch.tensor(U), torch.tensor(v1), sigma,
        torch.tensor(v2), -sigma, m, matmul=matmul,
        merge_fallback=merge_fallback)
    tl, tu = tl.numpy(), tu.numpy()
    G = tu[:m, :m].T @ tu[:m, :m]
    assert np.abs(G - np.eye(m)).max() < 1e-9
    norm = np.linalg.norm(A, 2)
    assert np.abs(_recon(tl, tu, m) - B).max() <= 1e-9 * norm
    np.testing.assert_allclose(np.sort(tl[:m]), np.linalg.eigvalsh(B),
                               atol=1e-9 * norm)
    sl, su = tr.rank_one_update(torch.tensor(L), torch.tensor(U),
                                torch.tensor(v1), sigma, m, matmul=matmul)
    sl, su = tr.rank_one_update(sl, su, torch.tensor(v2), -sigma, m,
                                matmul=matmul)
    np.testing.assert_allclose(tl[:m], sl.numpy()[:m], atol=1e-9 * norm)


PLAN = dict(matmul="pallas2", fuse_krow=True, dispatch="bucketed",
            min_bucket=16)


@pytest.mark.parametrize("adjusted", [True, False],
                         ids=["algorithm2", "algorithm1"])
def test_pallas2_stream_matches_reference_and_batch_oracle(adjusted):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(44, 5))
    sigma = float(np.median(((X[:, None] - X[None]) ** 2).sum(-1)))
    js = jink.KPCAStream(jnp.asarray(X[:4]), 64,
                         jkf.KernelSpec(sigma=sigma), adjusted=adjusted,
                         plan=jeng.UpdatePlan(**PLAN), dtype=jnp.float64)
    ts = tink.KPCAStream(X[:4], 64, tkf.KernelSpec(sigma=sigma),
                         adjusted=adjusted, plan=teng.UpdatePlan(**PLAN),
                         dtype=torch.float64, device="cpu")
    for x in X[4:]:
        js.update(jnp.asarray(x))
        ts.update(x)
    m = 44
    lam_t = np.sort(ts.state.L.numpy()[:m])
    np.testing.assert_allclose(lam_t, np.sort(np.asarray(js.state.L)[:m]),
                               atol=1e-9)
    np.testing.assert_allclose(float(ts.state.S), float(js.state.S),
                               rtol=1e-10)
    np.testing.assert_allclose(ts.state.K1.numpy(), np.asarray(js.state.K1),
                               rtol=1e-10, atol=1e-12)
    K = tkf.gram_block(torch.tensor(X), torch.tensor(X),
                       spec=tkf.KernelSpec(sigma=sigma))
    lam_ref = tbatch.batch_kpca(K, adjusted=adjusted)[0].numpy()
    assert np.abs(lam_t - lam_ref).max() / max(1.0, lam_ref.max()) < 5e-5


def test_fused_plans_are_accepted_and_match_the_sequential_route():
    """``jnp2``/``pallas2`` run (they raised before the pair was ported)
    and reach the sequential route's eigensystem."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(20, 3))
    spec = tkf.KernelSpec(sigma=6.0)
    out = []
    for matmul in ("pallas", "pallas2", "jnp2"):
        s = tink.KPCAStream(X[:4], 32, spec, plan=teng.UpdatePlan(
            matmul=matmul, dispatch="bucketed", min_bucket=8),
            dtype=torch.float64, device="cpu")
        s.update_block(X[4:])
        out.append(s.eigpairs()[0].numpy()[:20])
    for o in out[1:]:
        np.testing.assert_allclose(o, out[0], atol=1e-9)
    assert teng.UpdatePlan(matmul="pallas2").inner_matmul == "pallas"
    assert teng.UpdatePlan(matmul="jnp").inner_matmul == "jnp"
