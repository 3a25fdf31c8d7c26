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
from repro.kernels.eigvec_update.eigvec_update import \
    eigvec_project as j_project_kernel  # noqa: E402
from repro.kernels.eigvec_update.eigvec_update import \
    eigvec_rotate as j_rotate_kernel  # noqa: E402
from repro.kernels.eigvec_update.eigvec_update import \
    eigvec_rotate2 as j_rotate2_kernel  # noqa: E402
from repro.kernels.nystrom_recon.ref import \
    transform_project_ref as j_transform  # noqa: E402
from repro.kernels.nystrom_recon.transform_batch import \
    transform_project as j_transform_kernel  # noqa: E402
from repro.kernels.rbf_gram.krow_fused import \
    krow_project as j_krow_kernel  # noqa: E402
from repro.kernels.rbf_gram.rbf_gram import \
    rbf_gram as j_rbf_kernel  # noqa: E402
from repro.kernels.rbf_gram.ref import krow_project_ref as j_krow  # noqa: E402
from repro.kernels.rbf_gram.ref import rbf_gram_ref as j_rbf_ref  # noqa: E402
from repro_torch.core import kernels_fn as tkf  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels.eigvec_update import ops as eops  # noqa: E402
from repro_torch.kernels.eigvec_update import ref as tref  # noqa: E402
from repro_torch.kernels.nystrom_recon import ops as nops  # noqa: E402
from repro_torch.kernels.rbf_gram import ops as kops  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

DTYPES = {"f32": (np.float32, torch.float32, jnp.float32, 2e-5),
          "f64": (np.float64, torch.float64, jnp.float64, 1e-12)}
M = 100                       # not a multiple of the 64-wide tiles
ACTIVE = [0, 64, M]           # empty, a tile edge, capacity


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _rotation_inputs(m, np_dtype, seed=0, size=M):
    """Inputs on the padding contract: U identity beyond the active block,
    zhat/inv zero and d/lam sentinels beyond m."""
    rng = np.random.default_rng(seed)
    U = np.eye(size)
    if m:
        U[:m, :m] = np.linalg.qr(rng.normal(size=(m, m)))[0]
    live = np.arange(size) < m
    d = np.sort(rng.normal(size=size))
    z = np.where(live, rng.normal(size=size), 0.0)
    lam = np.where(live, d + 0.4, 1e30)
    inv = np.where(live, rng.uniform(0.5, 2.0, size=size), 0.0)
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


# Row blocks (R rows from global row off) of a 200-wide state with 70
# active pairs: the shapes of tests/test_kernels_pallas.py's row-block
# test.
BLOCK_M, BLOCK_ACTIVE = 200, 70
ROW_BLOCKS = [(100, 0), (100, 100), (64, 64), (90, 30)]


@pytest.mark.parametrize("R,off", ROW_BLOCKS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_eigvec_rotate_row_block_matches_reference(R, off, dt):
    """The plain version on U's rows off .. off + R against the reference's
    kernel in interpret mode on the same block, at f32/f64 rounding level,
    with exact zeros outside the pruned region.  At (100, 0) in f32 the
    oracle is the reference's ``eigvec_rotate_ref`` on the dense U (that
    reference case fails under pytest-xdist)."""
    np_dtype, t_dtype, j_dtype, rtol = DTYPES[dt]
    m = BLOCK_ACTIVE
    U, z, d, lam, inv = _rotation_inputs(m, np_dtype, size=BLOCK_M)
    blk = U[off:off + R]
    vecs = [jnp.asarray(a, j_dtype) for a in (z, d, lam, inv)]
    if (R, off, dt) == (100, 0, "f32"):
        want = jref.eigvec_rotate_ref(jnp.asarray(U, j_dtype),
                                      *vecs)[off:off + R]
    else:
        want = j_rotate_kernel(jnp.asarray(blk, j_dtype), *vecs,
                               jnp.int32(m), jnp.int32(off), interpret=True,
                               block=eops.ROTATE_TILE)
    got = eops.rotate_vectors(*[torch.from_numpy(a)
                                for a in (blk, z, d, lam, inv)], m,
                              tau=torch.zeros(BLOCK_M, dtype=t_dtype),
                              row_offset=off)
    assert got.dtype == t_dtype and got.shape == (R, BLOCK_M)
    _close(got, want, rtol)
    rows, cols = tref.pruned_region_mask(R, BLOCK_M, m, off,
                                         block=eops.ROTATE_TILE)
    assert torch.all(got[~(rows[:, None] & cols[None, :])] == 0)


@pytest.mark.parametrize("R,off", ROW_BLOCKS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_eigvec_project_row_block_matches_reference(R, off, dt):
    """The (M, C) partial of U's rows off .. off + R against the
    reference's kernel in interpret mode (the same 32-row granule), rows
    at or beyond m masked, output rows past the active slabs exact zeros."""
    np_dtype, _, j_dtype, rtol = DTYPES[dt]
    m = BLOCK_ACTIVE
    U = _rotation_inputs(m, np_dtype, size=BLOCK_M)[0]
    V = np.random.default_rng(1).normal(size=(BLOCK_M, 2)).astype(np_dtype)
    blk, vb = U[off:off + R], V[off:off + R]
    want = j_project_kernel(jnp.asarray(blk, j_dtype),
                            jnp.asarray(vb, j_dtype), jnp.int32(m),
                            jnp.int32(off), interpret=True,
                            block=eops.PROJECT_SLAB)
    got = eops.project_vectors(torch.from_numpy(blk), torch.from_numpy(vb),
                               m, row_offset=off)
    assert got.shape == (BLOCK_M, 2)
    _close(got, want, rtol)
    live = -(-m // eops.PROJECT_SLAB) * eops.PROJECT_SLAB
    assert torch.all(got[live:] == 0)


def _rotation2_inputs(m, np_dtype, size=BLOCK_M):
    """Two factors on the padding contract (the inputs of
    tests/test_kernels_pallas.py's row-block test): factor 1's column 5
    deflated onto e_12, factor 2's column 9 onto e_9."""
    U, z1, d1, lam1, inv1 = _rotation_inputs(m, np_dtype, seed=0, size=size)
    _, z2, d2, lam2, inv2 = _rotation_inputs(m, np_dtype, seed=1, size=size)
    lam2 = np.where(np.arange(size) < m, d2 + 0.9, lam2).astype(np_dtype)
    defl1, defl2 = np.zeros(size, np_dtype), np.zeros(size, np_dtype)
    defl1[5], defl2[9] = 1.0, 1.0
    cid1, cid2 = (np.arange(size, dtype=np.int32) for _ in range(2))
    cid1[5] = 12
    return U, [z1, d1, lam1, inv1, defl1, cid1, z2, d2, lam2, inv2, defl2,
               cid2]


@pytest.mark.parametrize("R,off", [(100, 0), (100, 100), (90, 30),
                                   (64, 136)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_eigvec_rotate2_row_block_matches_reference(R, off, dt):
    """The fused pair's plain version on U's rows off .. off + R against
    the reference's kernel in interpret mode on the same block (its
    64-wide tiles, the port's granule), deflated columns included, at
    f32/f64 rounding level; entries outside the pruned region are exact
    zeros, and a block wholly past m ((100, 100), (64, 136) at m = 70) is
    all zeros."""
    np_dtype, t_dtype, j_dtype, rtol = DTYPES[dt]
    m = BLOCK_ACTIVE
    U, vecs = _rotation2_inputs(m, np_dtype)
    blk = U[off:off + R]
    want = j_rotate2_kernel(jnp.asarray(blk, j_dtype),
                            *[jnp.asarray(v) for v in vecs], jnp.int32(m),
                            jnp.int32(off), interpret=True,
                            block=eops.ROTATE2_TILE)
    zero = torch.zeros(BLOCK_M, dtype=torch.float64)
    got = eops.rotate_vectors2(torch.from_numpy(blk),
                               *[torch.from_numpy(v) for v in vecs], m,
                               tau1=zero, tau2=zero, row_offset=off)
    assert got.dtype == t_dtype and got.shape == (R, BLOCK_M)
    _close(got, want, rtol)
    rows, cols = tref.pruned_region_mask(R, BLOCK_M, m, off,
                                         block=eops.ROTATE2_TILE)
    assert torch.all(got[~(rows[:, None] & cols[None, :])] == 0)
    if off >= m:
        assert not rows.any() and torch.all(got == 0)


# ------------------------------------------- three-pass TF32 (the kernel) --
def _tf32(x):
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, over the 13 mantissa bits TF32 drops."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_rotation(passes):
    """A stand-in for the float32 CUDA rotation that does its arithmetic:
    W formed as the kernel forms it, each operand split into a TF32 head
    and tail, and per 32-wide slab of k the ``passes`` products (("lo",
    "hi") is U's tail times W's head) summed in float32 and added into a
    float32 accumulator, then scaled by inv; the pruned region zero."""
    def rotate(u, zhat, d, lam, inv, m, *, tau, row_offset=None):
        n = u.shape[1]
        W = tref.eigvec_rotate_ref(torch.eye(n, dtype=u.dtype), zhat, d, lam,
                                   torch.ones_like(inv), tau)
        parts = {}
        for key, x in (("u", u), ("w", W)):
            parts[key, "hi"] = _tf32(x)
            parts[key, "lo"] = _tf32(x - parts[key, "hi"])
        acc = torch.zeros((u.shape[0], n), dtype=torch.float32)
        for k0 in range(0, n, 32):
            ks = slice(k0, k0 + 32)
            part = torch.zeros_like(acc)
            for a, b in passes:
                part += parts["u", a][:, ks] @ parts["w", b][ks]
            acc += part
        rows, cols = tref.pruned_region_mask(*u.shape, m, row_offset,
                                             block=eops.ROTATE_TILE)
        return torch.where(rows[:, None] & cols[None, :], acc * inv, 0.0)
    return rotate


THREE_PASS = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))


@pytest.mark.parametrize("m", [1000, 300])
def test_three_pass_tf32_is_as_good_as_float32(monkeypatch, m):
    """The float32 kernel's arithmetic, modelled on the CPU at the main
    path's bucket 1024: three TF32 products a slab at a time stay within
    ``_rotate_case``'s per-entry bound of the plain float32 product, and
    their largest error against the float64 product of the same operands
    is at most 2x the plain product's."""
    monkeypatch.setattr(eops, "rotate_vectors", _tf32_rotation(THREE_PASS))
    case = next(c for c in checks.cases(1024, m, torch.float32, "cpu")
                if c.name == "eigvec_rotate" and not c.variant)
    res = checks.compare(case)
    assert res["max_err_over_tol"] <= 1.0
    err = checks.error_vs_exact(case)
    assert 0 < err["kernel_err_vs_f64"] <= 2.0 * err["plain_err_vs_f64"], err


@pytest.mark.parametrize("m", [1000, 300])
def test_one_tf32_pass_is_not(monkeypatch, m):
    """The head product alone (one TF32 pass) misses the float32 product's
    accuracy by far more than 2x: why the kernel takes three."""
    monkeypatch.setattr(eops, "rotate_vectors",
                        _tf32_rotation((("hi", "hi"),)))
    case = next(c for c in checks.cases(1024, m, torch.float32, "cpu")
                if c.name == "eigvec_rotate" and not c.variant)
    err = checks.error_vs_exact(case)
    assert err["kernel_err_vs_f64"] > 2.0 * err["plain_err_vs_f64"], err


def _tf32_gram(passes):
    """A stand-in for the float32 CUDA ``scaled_gram`` that does its
    arithmetic: a = B·s rounded to float32 (as the plain version rounds
    it), a and B each split into a TF32 head and tail, per 32-wide slab of
    k the ``passes`` products (("lo", "hi") is a's tail times B's head)
    summed in float32 and added into a float32 accumulator; the upper
    triangle kept and mirrored, as the kernel writes it."""
    def gram(b, s):
        parts = {}
        for key, x in (("a", b * s), ("b", b)):
            parts[key, "hi"] = _tf32(x)
            parts[key, "lo"] = _tf32(x - parts[key, "hi"])
        n, k = b.shape
        acc = torch.zeros((n, n), dtype=torch.float32)
        for k0 in range(0, k, 32):
            ks = slice(k0, k0 + 32)
            part = torch.zeros_like(acc)
            for pa, pb in passes:
                part += parts["a", pa][:, ks] @ parts["b", pb][:, ks].T
            acc += part
        return acc.triu() + acc.triu(1).T
    return gram


@pytest.mark.parametrize("k", [512, 200])
def test_three_pass_tf32_gram_is_as_good_as_float32(monkeypatch, k):
    """The float32 ``scaled_gram`` kernel's arithmetic, modelled on the CPU
    at n = 512: three TF32 products a slab at a time stay within
    ``scaled_gram_tol`` of the plain float32 product entry by entry, their
    largest error against the float64 product of the same operands is at
    most 2x the plain product's, and the mirrored K̃ is exactly
    symmetric."""
    monkeypatch.setattr(nops, "scaled_gram", _tf32_gram(THREE_PASS))
    case = checks.gram_cases(512, k, torch.float32, "cpu")[0]
    res = checks.compare(case)
    assert res["max_err_over_tol"] <= 1.0
    err = checks.error_vs_exact(case)
    assert 0 < err["kernel_err_vs_f64"] <= 2.0 * err["plain_err_vs_f64"], err
    K = case.kernel()[0]
    assert torch.equal(K, K.T)


@pytest.mark.parametrize("k", [512, 200])
def test_one_tf32_pass_gram_is_not(monkeypatch, k):
    """The head product alone misses the float32 product's accuracy by far
    more than 2x: why the float32 kernel takes three."""
    monkeypatch.setattr(nops, "scaled_gram", _tf32_gram((("hi", "hi"),)))
    case = checks.gram_cases(512, k, torch.float32, "cpu")[0]
    err = checks.error_vs_exact(case)
    assert err["kernel_err_vs_f64"] > 2.0 * err["plain_err_vs_f64"], err


def _fma_rbf_gram(x, y, sigma):
    """A stand-in for the float32 CUDA ``rbf_gram`` that does its
    arithmetic: each dot product and each squared norm a chain of float32
    FMAs in k order (an FMA modelled as its float64 value rounded to
    float32), then exp(-max(d2, 0)·(1/sigma)) with 1/sigma in float32;
    where y is x the upper triangle kept and mirrored."""
    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    acc = torch.zeros((x.shape[0], y.shape[0]), dtype=torch.float32)
    xn, yn = torch.zeros(x.shape[0]), torch.zeros(y.shape[0])
    for k in range(x.shape[1]):
        acc = fma(x[:, k, None], y[None, :, k], acc)
        xn, yn = fma(x[:, k], x[:, k], xn), fma(y[:, k], y[:, k], yn)
    inv = torch.tensor(1.0, dtype=torch.float32) / sigma
    G = torch.exp(-torch.clamp_min(xn[:, None] + yn[None, :] - 2 * acc, 0.0)
                  * inv)
    return G.triu() + G.triu(1).T if y is x else G


@pytest.mark.parametrize("n,m,dim,seed", [
    (1024, 1024, 64, 0), (1000, 300, 16, 0), (130, 129, 3, 0),
    (130, 129, 3, 1)])
def test_fma_rbf_gram_is_as_good_as_float32(monkeypatch, n, m, dim, seed):
    """The float32 ``rbf_gram`` kernel's arithmetic, modelled on the CPU at
    the roofline's k(X, X) and ``chip_smoke.py``'s ragged pairs: every
    entry within ``rbf_gram_tol`` of the plain float32 version, the
    largest error against the float64 gram of the same operands at most
    2x the plain version's, and k(X, X) exactly symmetric."""
    monkeypatch.setattr(kops, "gram", _fma_rbf_gram)
    case = checks.rbf_gram_cases(n, m, dim, torch.float32, "cpu",
                                 seed=seed)[0]
    res = checks.compare(case)
    assert res["max_err_over_tol"] <= 1.0
    err = checks.error_vs_exact(case)
    assert 0 < err["kernel_err_vs_f64"] <= 2.0 * err["plain_err_vs_f64"], err
    if n == m:
        G = case.kernel()[0]
        assert torch.equal(G, G.T)


def test_tf32_rounding_matches_the_conversion():
    """``_tf32`` keeps 10 mantissa bits, rounds half away from zero, and
    the tail of a split is exact: head + tail is x to 2^-22 relative."""
    one = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 2.0 ** -11 - 2.0 ** -20, 3.0],
                       dtype=torch.float32)
    assert _tf32(one).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                   1.0, 3.0]
    x = torch.from_numpy(np.random.default_rng(0).normal(size=1000)
                         .astype(np.float32))
    head = _tf32(x)
    tail = _tf32(x - head)
    assert torch.all((head.view(torch.int32) & 0x1FFF) == 0)
    rel = ((head.double() + tail.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -22


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


@pytest.mark.parametrize("naux", [0, 2])
@pytest.mark.parametrize("m", [BLOCK_ACTIVE, BLOCK_M])
@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_krow_project_row_block_matches_reference(naux, m, kernel, dt):
    """The plain version on a rectangular row block (R = M/2 rows from
    global row M/4) against the reference's kernel in interpret mode on the
    same block, at f32/f64 rounding level: a on the block's rows (exact
    zeros where r0 + i >= m) and the block's partial P = Uᵀ[a | aux], with
    and without aux columns."""
    np_dtype, _, j_dtype, rtol = DTYPES[dt]
    R, r0 = BLOCK_M // 2, BLOCK_M // 4
    U = _rotation_inputs(m, np_dtype, size=BLOCK_M)[0]
    rng = np.random.default_rng(6)
    X = rng.normal(size=(BLOCK_M, 6)).astype(np_dtype)
    xq = rng.normal(size=6).astype(np_dtype)
    aux = np.stack([np.ones(BLOCK_M), np.linspace(1.0, 9.0, BLOCK_M)],
                   axis=1)[:, :naux].astype(np_dtype)
    blk = [a[r0:r0 + R] for a in (U, X)] + [xq, aux[r0:r0 + R]]
    jspec = jkf.KernelSpec(name=kernel, sigma=6.0, scale=1.5)
    tspec = tkf.KernelSpec(name=kernel, sigma=6.0, scale=1.5)
    ja, jP = j_krow_kernel(*[jnp.asarray(a, j_dtype) for a in blk],
                           jnp.int32(m), jnp.int32(r0), spec=jspec,
                           interpret=True)
    ta, tP = kops.krow_project(*[torch.from_numpy(np.ascontiguousarray(a))
                                 for a in blk], m, spec=tspec,
                               row_offset=r0)
    assert ta.shape == (R,) and tP.shape == (BLOCK_M, 1 + naux)
    _close(ta, ja, rtol)
    _close(tP, jP, rtol)
    assert torch.all(ta[max(m - r0, 0):] == 0)
    live = -(-m // eops.PROJECT_SLAB) * eops.PROJECT_SLAB
    assert torch.all(tP[live:] == 0)


@pytest.mark.parametrize("C", [20, 64])
@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_transform_project_wide_matches_reference(C, kernel, dt):
    """The plain version at C = 20 (the reference pads it to 24) and at
    the roofline's C = 64 against the reference's kernel in interpret mode
    (Q = 10 queries, m = 70 of 100 points active), at f32/f64 rounding
    level."""
    np_dtype, _, j_dtype, rtol = DTYPES[dt]
    m = 70
    X, _ = _point_inputs(np_dtype)
    rng = np.random.default_rng(7)
    xq = rng.normal(size=(10, X.shape[1])).astype(np_dtype)
    S = np.where((np.arange(M) < m)[:, None], rng.normal(size=(M, C)),
                 0.0).astype(np_dtype)
    jspec = jkf.KernelSpec(name=kernel, sigma=6.0)
    tspec = tkf.KernelSpec(name=kernel, sigma=6.0)
    jy, jrs = j_transform_kernel(*[jnp.asarray(a, j_dtype)
                                   for a in (xq, X, S)],
                                 jnp.int32(m), spec=jspec, interpret=True)
    ty, trs = nops.transform_project(*[torch.from_numpy(a)
                                       for a in (xq, X, S)], m, spec=tspec)
    assert ty.shape == (10, C) and trs.shape == (10,)
    _close(ty, jy, rtol)
    _close(trs, jrs, rtol)


# ------------------------------------------------- the kernels' geometry --
@pytest.mark.parametrize("nq,C,m", [
    (64, 8, 1000), (64, 512, 512), (512, 64, 1024),     # service, Nyström,
    (1, 1, 1), (13, 20, 37), (9, 65, 130), (64, 17, 0)])  # roofline; ragged
def test_transform_geometry_covers_each_entry_once(nq, C, m):
    """``transform_geometry``: the grid's blocks write every entry of Y and
    every row sum exactly once (a cluster per query tile x component tile,
    one rank per entry), and within a cluster the ranks sum every active
    point exactly once."""
    geo = nops.transform_geometry(nq, C)
    assert geo.grid[0] % geo.ranks == 0
    writes = np.zeros((nq, C + 1), dtype=int)
    for bx in range(geo.grid[0]):
        for by in range(geo.grid[1]):
            rank = bx % geo.ranks
            for q, c in geo.entries(bx, by, rank, nq, C):
                writes[q, c] += 1
    assert (writes == 1).all()
    summed = np.zeros(m, dtype=int)
    for rank in range(geo.ranks):
        for chunk in geo.points(rank, m):
            assert len(chunk) <= geo.chunk
            summed[list(chunk)] += 1
    assert (summed == 1).all()
    assert geo.c_tile in nops.TRANSFORM_TILES
    assert geo.c_tile >= min(C, nops.TRANSFORM_TILES[-1])
    if (nq, C) == (64, 8):
        assert geo.grid[0] * geo.grid[1] >= 64     # the card's SMs busy


@pytest.mark.parametrize("R,n,m,r0", [
    (1024, 1024, 1000, 0), (512, 1024, 1000, 256), (512, 512, 300, 0),
    (100, 131, 70, 30), (64, 200, 10, 100), (1, 1, 1, 0), (90, 90, 0, 0)])
def test_project_geometry_covers_each_entry_once(R, n, m, r0):
    """``project_geometry`` (``krow_project``): every output row of P is
    written exactly once (live slabs: each rank its share; pruned slabs:
    rank 0), every entry of a exactly once (computed rows by the rank of
    slab 0 that sums them, masked rows as zeros), and within each slab the
    ranks sum every live row exactly once."""
    geo = kops.project_geometry(n)
    live_rows = min(max(m - r0, 0), R)
    live_cols = min(n, -(-m // eops.PROJECT_SLAB) * eops.PROJECT_SLAB)
    p_writes = np.zeros(n, dtype=int)
    a_writes = np.zeros(R, dtype=int)
    for slab in range(geo.slabs):
        summed = np.zeros(R, dtype=int)
        for rank in range(geo.ranks):
            for col in geo.columns(slab, rank, n, m):
                p_writes[col] += 1
            if slab == 0:
                a_writes[list(geo.zero_rows(rank, live_rows, R))] += 1
            if slab * geo.cols >= live_cols:
                continue
            for rows in geo.rows(rank, live_rows):
                summed[list(rows)] += 1
                if slab == 0:
                    a_writes[list(rows)] += 1
        if slab * geo.cols < live_cols:
            assert (summed[:live_rows] == 1).all()
            assert (summed[live_rows:] == 0).all()
    assert (p_writes == 1).all()
    assert (a_writes == 1).all()


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


# ------------------------------------------------------------- rbf_gram --
RBF_SHAPES = [(100, 100, 16), (130, 129, 3), (37, 200, 1), (64, 65, 10)]


def _rbf_inputs(n, m, dim, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim))
    y = x if n == m else rng.normal(size=(m, dim))
    return x, y, float(dim)


@pytest.mark.parametrize("n,m,dim", RBF_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rbf_gram_plain_matches_reference(n, m, dim, dt):
    """The plain version through ``ops.gram`` against the reference's
    ``rbf_gram_ref`` (same norm expansion and clamp) at ragged shapes,
    d = 1 and 3 included; n = m is the gram of x with itself."""
    np_dtype, t_dtype, j_dtype, rtol = DTYPES[dt]
    x, y, sigma = _rbf_inputs(n, m, dim)
    want = j_rbf_ref(jnp.asarray(x, j_dtype), jnp.asarray(y, j_dtype),
                     sigma)
    got = kops.gram(torch.as_tensor(x, dtype=t_dtype),
                    torch.as_tensor(y, dtype=t_dtype), sigma)
    assert got.dtype == t_dtype and got.shape == (n, m)
    _close(got.numpy(), want, rtol)


@pytest.mark.parametrize("n,m,dim", RBF_SHAPES)
def test_rbf_gram_plain_matches_the_interpreted_kernel_f32(n, m, dim):
    """f32 against the reference's Pallas kernel in interpret mode (which
    pads n, m to 128 and d to a multiple of 8), rtol 1e-5."""
    x, y, sigma = _rbf_inputs(n, m, dim, seed=1)
    want = np.asarray(j_rbf_kernel(jnp.asarray(x, jnp.float32),
                                   jnp.asarray(y, jnp.float32),
                                   jnp.asarray(sigma, jnp.float32),
                                   interpret=True))
    got = kops.gram(torch.as_tensor(x, dtype=torch.float32),
                    torch.as_tensor(y, dtype=torch.float32), sigma)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_reference_rbf_gram_accumulates_f64_in_f32():
    """Witness (ROADMAP.md, "Faults found"): the reference's kernel sums
    f64 operands in float32 (``preferred_element_type=jnp.float32``, f32
    scratch, 1/sigma cast to f32), so its f64 gram is off its own f64
    oracle by more than 1e-9; the port's plain version sums in f64 and
    holds 1e-12.  Once the reference is fixed, this test fails and goes
    with the fix."""
    x, y, sigma = _rbf_inputs(130, 129, 16, seed=2)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    want = np.asarray(j_rbf_ref(xj, yj, sigma))
    kern = np.asarray(j_rbf_kernel(xj, yj, jnp.asarray(sigma),
                                   interpret=True))
    assert kern.dtype == np.float64
    assert np.abs(kern - want).max() > 1e-9
    got = kops.gram(torch.from_numpy(x), torch.from_numpy(y), sigma).numpy()
    assert np.abs(got - want).max() <= 1e-12
