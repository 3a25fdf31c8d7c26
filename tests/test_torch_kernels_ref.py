"""Plain PyTorch kernel versions of the port against the reference's
``ref.py`` oracles, on the same numpy inputs.

Each plain version runs on the CPU through its wrapper in ``ops.py`` (the
CPU route is the plain version) and is held against the JAX oracle at
f64 rounding level (1e-12 relative) or f32 rounding level (2e-5 relative:
different summation orders in two BLAS libraries over <= 100 terms).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import kernels_fn as jkf  # noqa: E402
from repro.kernels.eigvec_update import ref as jref  # noqa: E402
from repro.kernels.nystrom_recon.ref import \
    transform_project_ref as j_transform  # noqa: E402
from repro.kernels.rbf_gram.ref import krow_project_ref as j_krow  # noqa: E402
from repro_torch.core import kernels_fn as tkf  # noqa: E402
from repro_torch.kernels.eigvec_update import ops as eops  # noqa: E402
from repro_torch.kernels.eigvec_update import ref as tref  # noqa: E402
from repro_torch.kernels.nystrom_recon import ops as nops  # noqa: E402
from repro_torch.kernels.rbf_gram import ops as kops  # noqa: E402

DTYPES = {"f32": (np.float32, torch.float32, jnp.float32, 2e-5),
          "f64": (np.float64, torch.float64, jnp.float64, 1e-12)}
M = 100                       # not a multiple of the 64-wide tiles
ACTIVE = [0, 64, M]           # empty, a tile edge, capacity


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _rotation_inputs(m, np_dtype, seed=0):
    """Inputs on the padding contract: U identity beyond the active block,
    zhat/inv zero and d/lam sentinels beyond m."""
    rng = np.random.default_rng(seed)
    U = np.eye(M)
    if m:
        U[:m, :m] = np.linalg.qr(rng.normal(size=(m, m)))[0]
    live = np.arange(M) < m
    d = np.sort(rng.normal(size=M))
    z = np.where(live, rng.normal(size=M), 0.0)
    lam = np.where(live, d + 0.4, 1e30)
    inv = np.where(live, rng.uniform(0.5, 2.0, size=M), 0.0)
    d = np.where(live, d, 2e30)
    return [np.asarray(a, np_dtype) for a in (U, z, d, lam, inv)]


@pytest.mark.parametrize("m", ACTIVE)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_eigvec_rotate_plain_matches_reference(m, dt):
    np_dtype, t_dtype, j_dtype, rtol = DTYPES[dt]
    args = _rotation_inputs(m, np_dtype)
    want = jref.eigvec_rotate_ref(*[jnp.asarray(a, j_dtype) for a in args])
    # The reference's absolute roots are the offset form with tau = 0.
    got = eops.rotate_vectors(*[torch.from_numpy(a) for a in args], m,
                              tau=torch.zeros(M, dtype=t_dtype))
    assert got.dtype == t_dtype
    _close(got, want, rtol)


@pytest.mark.parametrize("m", ACTIVE)
def test_rotation_is_zero_outside_the_pruned_region(m):
    """The CUDA kernel writes exact zeros outside ``pruned_region_mask``;
    on contract inputs the plain product is zero there too, so the pruned
    kernel and the unpruned product agree everywhere."""
    args = _rotation_inputs(m, np.float64)
    out = tref.eigvec_rotate_ref(*[torch.from_numpy(a) for a in args],
                                 torch.zeros(M, dtype=torch.float64))
    rows, cols = tref.pruned_region_mask(M, M, m,
                                         block=eops.ROTATE_TILE)
    outside = ~(rows[:, None] & cols[None, :])
    assert torch.all(out[outside] == 0)


@pytest.mark.parametrize("R,Mc,m,r0,block", [
    (100, 100, 0, None, 64), (100, 100, 64, None, 64),
    (100, 100, 65, None, 64), (100, 100, 100, None, 32),
    (50, 100, 70, 40, 64), (50, 100, 30, 40, 16)])
def test_pruned_region_mask_matches_reference(R, Mc, m, r0, block):
    jr, jc = jref.pruned_region_mask(R, Mc, jnp.int32(m), r0, block=block)
    tr, tc = tref.pruned_region_mask(R, Mc, m, r0, block=block)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("m", ACTIVE)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_eigvec_project_plain_matches_reference(m, dt):
    np_dtype, _, j_dtype, rtol = DTYPES[dt]
    U = _rotation_inputs(m, np_dtype)[0]
    V = np.random.default_rng(1).normal(size=(M, 2)).astype(np_dtype)
    want = jref.eigvec_project_ref(jnp.asarray(U, j_dtype),
                                   jnp.asarray(V, j_dtype), jnp.int32(m))
    got = eops.project_vectors(torch.from_numpy(U), torch.from_numpy(V), m)
    _close(got, want, rtol)


def test_cauchy_factor_plain_matches_reference():
    """The reference's absolute roots are the offset form with tau = 0.
    Off the ties the factors agree to rounding; on an exact tie each
    guards the zero denominator with its own rule, the reference at +eps
    and the port at +``offset_guard``, so there the entries differ by the
    ratio of the two guards."""
    rng = np.random.default_rng(2)
    n = 24
    z, inv = rng.normal(size=n), rng.uniform(0.5, 2.0, size=n)
    d = np.sort(rng.normal(size=n))
    lam = d + np.where(np.arange(n) % 5 == 0, 0.0, 0.3)   # guarded ties
    defl = (np.arange(n) % 7 == 3).astype(np.float64)
    cid = rng.permutation(n).astype(np.int32)
    tie = d[:, None] == lam[None, :]
    assert tie.any()
    ratio = np.finfo(np.float64).eps / tref.offset_guard(torch.float64)
    for extra in ((), (defl,), (defl, cid)):
        want = np.asarray(jref.cauchy_factor_ref(
            *[jnp.asarray(a) for a in (z, d, lam, inv) + extra]))
        got = tref.cauchy_factor_ref(
            *[torch.from_numpy(a) for a in (z, d, lam, inv) + extra],
            tau=torch.zeros(n, dtype=torch.float64)).numpy()
        on_tie = tie & (defl[None, :] == 0) if extra else tie
        _close(np.where(on_tie, 0.0, got), np.where(on_tie, 0.0, want),
               1e-12)
        np.testing.assert_allclose(got[on_tie], want[on_tie] * ratio,
                                   rtol=1e-12)


def _point_inputs(np_dtype, seed=3, d=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(M, d))
    return X.astype(np_dtype), rng.normal(size=d).astype(np_dtype)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("m", ACTIVE)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_krow_project_plain_matches_reference(kernel, m, dt):
    np_dtype, _, j_dtype, rtol = DTYPES[dt]
    U = _rotation_inputs(m, np_dtype)[0]
    X, xq = _point_inputs(np_dtype)
    aux = np.stack([np.ones(M), np.linspace(1.0, 9.0, M)],
                   axis=1).astype(np_dtype)
    jspec = jkf.KernelSpec(name=kernel, sigma=6.0, scale=1.5)
    tspec = tkf.KernelSpec(name=kernel, sigma=6.0, scale=1.5)
    ja, jP = j_krow(*[jnp.asarray(a, j_dtype) for a in (U, X, xq, aux)],
                    jnp.int32(m), spec=jspec)
    ta, tP = kops.krow_project(*[torch.from_numpy(a) for a in (U, X, xq,
                                                               aux)],
                               m, spec=tspec)
    _close(ta, ja, rtol)
    _close(tP, jP, rtol)
    assert torch.all(ta[m:] == 0)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("m", ACTIVE)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_transform_project_plain_matches_reference(kernel, m, dt):
    np_dtype, _, j_dtype, rtol = DTYPES[dt]
    X, _ = _point_inputs(np_dtype)
    rng = np.random.default_rng(4)
    xq = rng.normal(size=(10, X.shape[1])).astype(np_dtype)
    S = np.where((np.arange(M) < m)[:, None], rng.normal(size=(M, 5)),
                 0.0).astype(np_dtype)
    jspec = jkf.KernelSpec(name=kernel, sigma=6.0)
    tspec = tkf.KernelSpec(name=kernel, sigma=6.0)
    jy, jrs = j_transform(*[jnp.asarray(a, j_dtype) for a in (xq, X, S)],
                          jnp.int32(m), spec=jspec)
    ty, trs = nops.transform_project(*[torch.from_numpy(a)
                                       for a in (xq, X, S)], m, spec=tspec)
    _close(ty, jy, rtol)
    _close(trs, jrs, rtol)


@pytest.mark.parametrize("kernel", ["rbf", "matern32", "linear", "poly"])
def test_gram_block_matches_reference(kernel):
    rng = np.random.default_rng(5)
    x, y = rng.normal(size=(7, 3)), rng.normal(size=(5, 3))
    jspec = jkf.KernelSpec(name=kernel, sigma=2.5, degree=2, coef0=0.5)
    tspec = tkf.KernelSpec(name=kernel, sigma=2.5, degree=2, coef0=0.5)
    _close(tkf.gram_block(torch.from_numpy(x), torch.from_numpy(y),
                          spec=tspec),
           jkf.gram_block(jnp.asarray(x), jnp.asarray(y), spec=jspec), 1e-12)
    _close(tkf.kernel_diag(torch.from_numpy(x), spec=tspec),
           jkf.kernel_diag(jnp.asarray(x), spec=jspec), 1e-12)
    _close(tkf.median_heuristic(torch.from_numpy(x)),
           jkf.median_heuristic(jnp.asarray(x)), 1e-12)


def test_fused_kernels_refuse_other_kernels_on_cuda():
    """The CUDA epilogues implement RBF and Matern-3/2 only; any other
    kernel is refused before a launch (not routed to the plain version)."""
    with pytest.raises(ValueError, match="fused CUDA kernel"):
        kops.fused_kind(tkf.KernelSpec(name="poly"), "krow_project")
    assert kops.fused_kind(tkf.KernelSpec(name="matern32"), "x") == 1
