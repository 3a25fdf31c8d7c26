"""The CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU and skip
without one.  They import nothing of JAX; run them on the machine with the
card with ``python -m pytest -q --noconftest -m cuda
tests/test_torch_kernels_cuda.py`` (the repository's conftest imports JAX).

Shapes are the small, ragged ones ``chip_smoke.py`` does not cover
(capacities that are no multiple of the 64-wide tiles, m = 0, m at a tile
edge and at capacity); the tolerances are ``kernels.checks``'s.  The
streams (KPCA on both routes, Nyström landmarks) run on the card and on
the CPU and are held to each other and to the eigh oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import batch, engine, inkpca  # noqa: E402
from repro_torch.core import kernels_fn as kf  # noqa: E402
from repro_torch.kernels import checks, cuda  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,m", [(100, 0), (100, 64), (100, 100),
                                 (200, 37), (256, 129), (131, 100)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernels_match_plain_versions(device, n, m, dtype):
    """Every KPCA kernel's cases, the row blocks among them; n = 131 is no
    multiple of 16 bytes, so the float32 rotation takes U through its
    padded copy and the projection loads one value at a time."""
    for case in checks.cases(n, m, getattr(torch, dtype), device, seed=n + m):
        checks.compare(case)


@pytest.mark.parametrize("n,m", [(100, 1), (131, 100), (256, 256),
                                 (512, 500)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_transform_feature_head_matches_plain_version(device, n, m, dtype):
    """``transform_project`` as the Nyström feature head calls it: C = n
    columns, zero past m, including a capacity that is no multiple of
    the 64-wide tiles."""
    checks.compare(checks.features_case(n, m, getattr(torch, dtype), device,
                                        seed=n + m))


@pytest.mark.parametrize("n,m", [(200, 1), (200, 65), (300, 129),
                                 (256, 256), (130, 130), (131, 100)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rotate2_matches_plain_version(device, n, m, dtype):
    """The fused pair at m = 1, one past a 64 granule (65) and past a
    128-row tile (129), m = n, and capacities whose rows are no multiple of
    16 bytes (130 in float32, 131 in both: one value per copy)."""
    rot2 = [c for c in checks.cases(n, m, getattr(torch, dtype), device,
                                    seed=n + m) if c.name == "eigvec_rotate2"]
    checks.compare(rot2[0])


def test_flash_attention_bf16_runs_on_the_tensor_cores(device):
    """The bfloat16 attention kernel's SASS holds wgmma instructions."""
    cuda.library()
    counts = cuda.sass_counts()
    wgmma = {k: v for k, v in counts.items()
             if "flash_attention_kernel_wgmma" in k}
    assert wgmma and all(v["HGMMA"] > 0 for v in wgmma.values()), counts


def test_rotate_f32_runs_on_the_tensor_cores(device):
    """The float32 rotation's product kernel holds TF32 wgmma (HGMMA), and
    at the main path's shape its error against the float64 product of the
    same operands stays within ``chip_smoke.TF32_ERR_RATIO`` (2x) of the
    plain float32 product's, on the square state and on a row block."""
    cuda.library()
    counts = cuda.sass_counts()
    tf32 = {k: v for k, v in counts.items() if "rotate_tf32_kernel" in k}
    assert tf32 and all(v["HGMMA"] > 0 for v in tf32.values()), counts
    for case in checks.cases(1024, 1000, torch.float32, device, seed=0):
        if case.name == "eigvec_rotate":
            err = checks.error_vs_exact(case)
            assert err["err_ratio"] <= 2.0, (case.variant, err)


def test_device_ms_falls_back_to_queued_events(device, monkeypatch):
    """Where the profiler records no device activity, ``device_ms`` times
    the calls queued behind a spin kernel, with the launches not measured;
    that time agrees with the profiler's records where it has them (the
    events also count the gaps between the fused pair's three launches)."""
    case = next(c for c in checks.cases(1024, 1000, torch.float32, device,
                                        seed=0)
                if c.name == "eigvec_rotate2")
    prof_ms, launches = checks.device_ms(case.kernel)
    assert launches == 3

    class Silent:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return []

    monkeypatch.setattr(checks, "profile", Silent)
    queued, none = checks.device_ms(case.kernel)
    assert none is None
    assert 0.8 * prof_ms <= queued <= 1.25 * prof_ms + 0.01, (queued,
                                                              prof_ms)


def test_stream_on_cuda_matches_cpu(device):
    """The slice's plan on the card (all four kernels) against the same
    stream on the CPU (their plain versions), f64, 40 points.  The two
    sum in different orders, and this stream passes roots within 1e-16 of
    their poles (ROADMAP.md, "Faults found"), so each run is held to the
    batch eigh oracle at ``tests/test_inkpca.py``'s bar (5e-5 of the
    scale) and the two to each other at 1e-6."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(44, 5))
    Q = rng.normal(size=(7, 5))
    spec = kf.KernelSpec(sigma=10.0)
    plan = engine.UpdatePlan(matmul="pallas", fuse_krow=True,
                             dispatch="bucketed", min_bucket=16)
    out = {}
    cuda.reset_launches()
    for dev in ("cpu", device):
        s = inkpca.KPCAStream(X[:4], 64, spec, plan=plan,
                              dtype=torch.float64, device=dev)
        s.update_block(X[4:])
        out[str(dev)] = (torch.sort(s.state.L[:44]).values.cpu().numpy(),
                         s.transform(Q, 4).abs().cpu().numpy())
    assert cuda.LAUNCHES == {"eigvec_rotate": 160, "eigvec_rotate2": 0,
                             "krow_project": 40, "eigvec_project": 40,
                             "transform_project": 1, "scaled_gram": 0,
                             "rbf_gram": 0, "flash_attention": 0,
                             "flash_attention_bwd": 0,
                             "ssd_intra_chunk": 0}
    K = kf.gram_block(torch.tensor(X), torch.tensor(X), spec=spec)
    lam_ref = batch.batch_kpca(K, adjusted=True)[0].numpy()
    scale = max(1.0, np.abs(lam_ref).max())
    (lam_cpu, y_cpu), (lam_gpu, y_gpu) = out["cpu"], out[str(device)]
    for lam in (lam_cpu, lam_gpu):
        assert np.abs(lam - lam_ref).max() / scale < 5e-5
    np.testing.assert_allclose(lam_gpu, lam_cpu, atol=1e-6 * scale)
    np.testing.assert_allclose(y_gpu, y_cpu, atol=1e-6 * np.abs(y_cpu).max())


@pytest.mark.parametrize("n,k", [(100, 1), (130, 129), (300, 64)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_scaled_gram_matches_plain_version(device, n, k, dtype):
    for case in checks.gram_cases(n, k, getattr(torch, dtype), device,
                                  seed=n + k):
        checks.compare(case)


def _sass_kernels(name):
    """The SASS instruction counts of the kernels whose names hold
    ``name``."""
    cuda.library()
    counts = cuda.sass_counts()
    return {k: v for k, v in counts.items() if name in k}, counts


def test_scaled_gram_runs_on_the_tensor_cores(device):
    """The float32 product kernel holds TF32 wgmma (HGMMA) and the float64
    one DMMA; at Fig. 2's n = 4096, k = 512 the float32 K̃'s error against
    the float64 product of the same operands stays within
    ``chip_smoke.TF32_ERR_RATIO`` (2x) of the plain float32 product's."""
    tf32, counts = _sass_kernels("gram_tf32_kernel")
    assert tf32 and all(v["HGMMA"] > 0 for v in tf32.values()), counts
    dmma, _ = _sass_kernels("gram_dmma_kernel")
    assert dmma and all(v["DMMA"] > 0 for v in dmma.values()), counts
    case = checks.gram_cases(4096, 512, torch.float32, device, seed=0)[0]
    err = checks.error_vs_exact(case)
    assert err["err_ratio"] <= 2.0, err


@pytest.mark.parametrize("n,k", [(100, 1), (130, 129), (300, 64),
                                 (4096, 200)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_scaled_gram_is_exactly_symmetric(device, n, k, dtype):
    """One triangle is computed and mirrored: K̃ equals its transpose bit
    for bit, also on cells cut by the ragged edge."""
    case = checks.gram_cases(n, k, getattr(torch, dtype), device, seed=n)[0]
    K = case.kernel()[0]
    assert torch.equal(K, K.T)


@pytest.mark.parametrize("decay", [1.0, 200.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_intra_chunk_steep_decay(device, decay, dtype):
    """Steep decays: at 1.0 per step the far s tiles' exp(cum_t - cum_s)
    falls below float32's normal range and the near ones do not, at 200
    nearly every entry below the diagonal underflows; each entry stays
    within its bound (subnormal decays kept, as the plain version keeps
    them) and the output is finite."""
    case = checks.ssd_intra_chunk_case(2, 256, 128, 20, 64,
                                       getattr(torch, dtype), device,
                                       seed=7, decay=decay)
    checks.compare(case)


def test_ssd_intra_chunk_bf16_runs_on_the_tensor_cores(device):
    """The bfloat16 intra-chunk kernel's SASS holds wgmma instructions."""
    wgmma, counts = _sass_kernels("ssd_intra_chunk_kernel_wgmma")
    assert wgmma and all(v["HGMMA"] > 0 for v in wgmma.values()), counts


@pytest.mark.parametrize("n,m,dim", [(1, 1, 1), (130, 129, 3), (64, 64, 16),
                                     (65, 200, 17), (300, 300, 64),
                                     (70, 90, 100)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rbf_gram_matches_plain_version(device, n, m, dim, dtype):
    """Ragged edges of the 32- and 64-wide cells and of the 128-byte slabs
    of d, and d over several slabs in flight; n = m is the gram of x with
    itself (its diagonal a clamped residue)."""
    for case in checks.rbf_gram_cases(n, m, dim, getattr(torch, dtype),
                                      device, seed=n + m + dim):
        checks.compare(case)


def test_rbf_gram_runs_on_its_units(device):
    """The float64 gram kernel holds DMMA; the float32 one runs on the CUDA
    cores (no HGMMA: six TF32 products of a three-way split ran slower
    than its FMAs, PERF.md), and at the roofline's k(X, X) (1024², d = 64)
    its G's error against the float64 gram of the same operands stays
    within ``chip_smoke.TF32_ERR_RATIO`` (2x) of the plain float32
    version's."""
    f32, counts = _sass_kernels("rbf_gram_f32_kernel")
    assert f32 and all(v["HGMMA"] == 0 for v in f32.values()), counts
    dmma, _ = _sass_kernels("rbf_gram_dmma_kernel")
    assert dmma and all(v["DMMA"] > 0 for v in dmma.values()), counts
    case = checks.rbf_gram_cases(1024, 1024, 64, torch.float32, device)[0]
    err = checks.error_vs_exact(case)
    assert err["err_ratio"] <= 2.0, err


@pytest.mark.parametrize("n,dim", [(1, 1), (63, 3), (65, 10), (130, 17),
                                   (1000, 64), (97, 100)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rbf_gram_is_exactly_symmetric(device, n, dim, dtype):
    """k(X, X) computes one triangle and mirrors it: G equals its transpose
    bit for bit, also on cells cut by the ragged edge, and its entries
    stay within their bounds of the plain version."""
    case = checks.rbf_gram_cases(n, n, dim, getattr(torch, dtype), device,
                                 seed=n + dim)[0]
    G = case.kernel()[0]
    assert torch.equal(G, G.T)
    checks.compare(case)


@pytest.mark.parametrize("n,m", [(200, 1), (200, 65), (300, 129),
                                 (256, 256), (131, 100), (1024, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rotate2_row_blocks_match_plain_version(device, n, m, dtype):
    """The fused pair on row blocks: rows n/4 .. 3n/4 and rows m .. n
    (wholly past the active rows: all zeros, nothing of U read), each
    entry within its bound of the plain version, pruned rows and columns
    exact zeros, two runs bit for bit equal."""
    blocks = [c for c in checks.cases(n, m, getattr(torch, dtype), device,
                                      seed=n + m)
              if c.name == "eigvec_rotate2" and c.variant]
    assert [c.variant for c in blocks] == (
        [f"rows {n // 4}:{n // 4 + n // 2}"]
        + ([f"rows {m}:{n}"] if m < n else []))
    for case in blocks:
        checks.compare(case)
        assert checks.repeats_bitwise(case)
        if case.variant == f"rows {m}:{n}":
            assert torch.all(case.kernel()[0] == 0)


@pytest.mark.parametrize("adjusted", [True, False])
def test_pallas2_stream_on_cuda_matches_cpu(device, adjusted):
    """The fused-pair plan on the card (rotate2, or two rotations where a
    cluster merge fires) against the same stream on the CPU, f64,
    40 points; the same bars as ``test_stream_on_cuda_matches_cpu``."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(44, 5))
    spec = kf.KernelSpec(sigma=10.0)
    plan = engine.UpdatePlan(matmul="pallas2", fuse_krow=True,
                             dispatch="bucketed", min_bucket=16)
    out = {}
    cuda.reset_launches()
    for dev in ("cpu", device):
        s = inkpca.KPCAStream(X[:4], 64, spec, plan=plan, adjusted=adjusted,
                              dtype=torch.float64, device=dev)
        s.update_block(X[4:])
        out[str(dev)] = torch.sort(s.state.L[:44]).values.cpu().numpy()
    pairs = cuda.LAUNCHES["eigvec_rotate2"] + cuda.LAUNCHES["eigvec_rotate"] / 2
    assert pairs == (80 if adjusted else 40)
    assert cuda.LAUNCHES["eigvec_rotate2"] > 0
    K = kf.gram_block(torch.tensor(X), torch.tensor(X), spec=spec)
    lam_ref = batch.batch_kpca(K, adjusted=adjusted)[0].numpy()
    scale = max(1.0, np.abs(lam_ref).max())
    for lam in out.values():
        assert np.abs(lam - lam_ref).max() / scale < 5e-5
    np.testing.assert_allclose(out[str(device)], out["cpu"],
                               atol=1e-6 * scale)


def test_nystrom_on_cuda_matches_cpu(device):
    """Landmarks grown on the card (fused pair, k-row prologue) and the
    reconstruction through scaled_gram, against the CPU run, f64."""
    from repro_torch.core import nystrom

    rng = np.random.default_rng(2)
    X = rng.normal(size=(90, 4))
    spec = kf.KernelSpec(sigma=8.0)
    plan = engine.UpdatePlan(matmul="pallas2", fuse_krow=True,
                             dispatch="bucketed", min_bucket=16)
    res = {}
    cuda.reset_launches()
    for dev in ("cpu", device):
        Xd = torch.tensor(X, device=dev)
        eng = engine.Engine(spec, plan, adjusted=False)
        st = nystrom.init_nystrom(Xd, Xd[:5], 48, spec, dtype=torch.float64)
        for i in range(5, 40):
            st = eng.add_landmark(st, Xd, Xd[i])
        res[str(dev)] = (nystrom.reconstruct_tilde(st, use_pallas=True)
                         .cpu().numpy(),
                         float(nystrom.trace_error(st, spec, Xd)))
    assert cuda.LAUNCHES["scaled_gram"] == 1
    assert cuda.LAUNCHES["krow_project"] == 35
    (k_cpu, t_cpu), (k_gpu, t_gpu) = res["cpu"], res[str(device)]
    np.testing.assert_allclose(k_gpu, k_cpu, atol=1e-8)
    np.testing.assert_allclose(t_gpu, t_cpu, rtol=1e-8)


@pytest.mark.parametrize("matmul", ["pallas", "pallas2"])
def test_window_stream_on_cuda_matches_cpu(device, matmul):
    """A windowed stream past its first evictions (the downdate's inverse
    pairs on the rotation kernels) on the card against the CPU, f64, at
    the bars of ``test_stream_on_cuda_matches_cpu``; the card's launches
    follow the reckoning: a growth point is one pair of pairs, a
    steady-state point two more for the evicted one."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(44, 5))
    W = 20
    spec = kf.KernelSpec(sigma=10.0)
    plan = engine.UpdatePlan(matmul=matmul, fuse_krow=True,
                             dispatch="bucketed", min_bucket=16, window=W)
    out = {}
    for dev in ("cpu", device):
        cuda.reset_launches()
        s = inkpca.KPCAStream(X[:4], 32, spec, plan=plan,
                              dtype=torch.float64, device=dev)
        for x in X[4:]:
            s.update(x)
        st = s.kpca_state
        out[str(dev)] = (torch.sort(st.L[:W]).values.cpu().numpy(),
                         st.X[:W].cpu().numpy(), s.state.ages[:W].cpu())
    pairs = 2 * (W - 4) + 4 * (44 - W)
    got = cuda.LAUNCHES
    assert got["eigvec_rotate2"] + got["eigvec_rotate"] / 2 == pairs
    assert got["krow_project"] == got["eigvec_project"] == 40
    Xw = torch.tensor(X[44 - W:])
    lam_ref = batch.batch_kpca(kf.gram_block(Xw, Xw, spec=spec),
                               adjusted=True)[0].numpy()
    scale = max(1.0, np.abs(lam_ref).max())
    for lam, rows, ages in out.values():
        assert np.abs(lam - lam_ref).max() / scale < 5e-5
        np.testing.assert_array_equal(rows, X[44 - W:])
        assert ages.tolist() == list(range(44 - W, 44))
    np.testing.assert_allclose(out[str(device)][0], out["cpu"][0],
                               atol=1e-6 * scale)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_query_serves_16_components_on_cuda(device, dtype):
    """``serving.query`` under ``fuse_krow`` on the card answers a snapshot
    of 16 components (more than the 8 the kernel once took) in one
    ``transform_project`` launch, and matches the plain route (the masked
    query gram times S, and the affine correction) on the same snapshot."""
    from repro_torch.core import serving

    rng = np.random.default_rng(5)
    X, Q = rng.normal(size=(60, 6)), rng.normal(size=(13, 6))
    spec = kf.KernelSpec(sigma=10.0)
    plan = engine.UpdatePlan(matmul="pallas", fuse_krow=True,
                             dispatch="bucketed", min_bucket=16)
    s = inkpca.KPCAStream(X[:4], 64, spec, plan=plan,
                          dtype=getattr(torch, dtype), device=device)
    s.update_block(X[4:])
    snap = serving.publish_transform(s.kpca_state, n_components=16,
                                     adjusted=True)
    xq = torch.as_tensor(Q, dtype=s.kpca_state.X.dtype, device=device)
    cuda.reset_launches()
    got = serving.query(snap, xq, spec=spec, plan=plan)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["transform_project"] == 1
    want = serving.query(snap, xq, spec=spec)
    assert got.shape == want.shape == (13, 16)
    tol = 1e-4 if dtype == "float32" else 1e-10
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("nq,C", [(1, 1), (13, 9), (64, 20), (64, 64),
                                  (37, 65), (8, 130), (64, 512)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_transform_project_takes_any_width(device, nq, C, dtype):
    """Any number of components in one launch: widths inside a tile (9,
    20), at and one past the 64-column tile (64, 65), several tiles (130,
    512), and query counts off the 8-query tile; each entry within
    ``checks``' bound, and two runs bit for bit equal."""
    n, m = 600, 577
    dt = getattr(torch, dtype)
    U, L, mt, X, rng = checks._state(n, m, dt, device, seed=nq + C)
    case = checks._transform_case(
        U, L, X, mt, rng, kf.KernelSpec(name="rbf", sigma=16.0), dt,
        nq=nq, comps=C)
    cuda.reset_launches()
    checks.compare(case)
    assert cuda.LAUNCHES["transform_project"] == 1
    assert case.kernel()[0].shape == (nq, C)
    assert checks.repeats_bitwise(case)


@pytest.mark.parametrize("n,m", [(1024, 1000), (256, 200), (131, 100)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_projection_kernels_repeat_bitwise(device, n, m, dtype):
    """``krow_project`` (square, row block, no aux), ``eigvec_project`` and
    ``transform_project`` give bit for bit the same outputs run after run:
    the cluster sums run in rank order, with no atomics."""
    names = ("krow_project", "eigvec_project", "transform_project")
    for case in checks.cases(n, m, getattr(torch, dtype), device, seed=n):
        if case.name in names:
            assert checks.repeats_bitwise(case), (case.name, case.variant)


def test_wrappers_refuse_bad_operands(device):
    from repro_torch.kernels.eigvec_update import ops as eops
    u = torch.eye(8, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        eops.project_vectors(u.T, u[:, :2].contiguous(), 4)
    with pytest.raises(TypeError):
        eops.project_vectors(u.half(), u[:, :2].half(), 4)
    with pytest.raises(ValueError, match="columns"):
        eops.project_vectors(u, torch.zeros(8, 9, device=device), 4)
    from repro_torch.kernels.nystrom_recon import ops as nops
    with pytest.raises(ValueError, match="need b"):
        nops.scaled_gram(u, torch.ones(5, device=device))
    v = torch.zeros(8, device=device)
    i = torch.zeros(8, dtype=torch.int32, device=device)
    with pytest.raises(TypeError, match="tau2"):
        eops.rotate_vectors2(u, v, v, v, v, v, i, v, v, v, v, v, i, 4,
                             tau1=v.double())
    with pytest.raises(ValueError, match="factor vectors"):
        eops.rotate_vectors2(u, v, v, v, v, v, i, v[:4], v, v, v, v, i, 4,
                             tau1=v, tau2=v)
    from repro_torch.kernels.rbf_gram import ops as kops
    with pytest.raises(ValueError, match="need x"):
        kops.gram(u, torch.zeros(3, 5, device=device), 1.0)
    with pytest.raises(TypeError, match="mixed"):
        kops.gram(u, u.double(), 1.0)
    from repro_torch.core import kernels_fn as tkf
    spec = tkf.KernelSpec(sigma=1.0)
    x = torch.zeros(8, 3, device=device)
    with pytest.raises(ValueError, match="at least one component"):
        nops.transform_project(x, x, torch.zeros(8, 0, device=device), 4,
                               spec=spec)
    with pytest.raises(ValueError, match="aux columns"):
        kops.krow_project(u, x, x[0], torch.zeros(8, 8, device=device), 4,
                          spec=spec)
    with pytest.raises(ValueError, match="shapes"):
        kops.krow_project(u[:4].contiguous(), x, x[0],
                          torch.zeros(8, 2, device=device), 4, spec=spec,
                          row_offset=2)


@pytest.mark.parametrize("B,T,H,Hkv,hd", [
    (1, 1, 2, 1, 64), (2, 77, 6, 3, 100), (1, 130, 4, 4, 128),
    (1, 64, 8, 2, 32), (1, 1000, 8, 2, 128), (1, 129, 4, 2, 128),
    (1, 255, 8, 8, 64), (3, 200, 6, 2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_plain_version(device, B, T, H, Hkv, hd,
                                               dtype):
    """Odd T (not a multiple of the 64-row float32 tile or the 128-row
    bfloat16 tile: 129 one row past it, 255 one short of two), T = 1, head
    dims the bfloat16 kernel pads (32, 100) and up to the largest (128),
    GQA groups of 1 to 4 (Hkv = H among them), B = 3."""
    checks.compare(checks.flash_attention_case(
        B, T, H, Hkv, hd, getattr(torch, dtype), device, seed=T + H))


@pytest.mark.parametrize("B,T,H,Hkv,hd", [
    (1, 1, 2, 1, 64), (2, 77, 6, 3, 100), (1, 130, 4, 4, 128),
    (1, 64, 8, 2, 32), (1, 129, 4, 2, 128), (3, 200, 6, 2, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_matches_plain_version(device, B, T, H, Hkv, hd,
                                                   dtype):
    """The backward kernel against its plain version: T = 1, T one past a
    64-row tile and off it, head dims that are no multiple of 4 rows of
    the padded tile (100) and the largest (128), GQA groups of 1 to 4;
    two runs bit for bit (no atomics)."""
    case = checks.flash_attention_bwd_case(
        B, T, H, Hkv, hd, getattr(torch, dtype), device, seed=T + H)
    checks.compare(case)
    assert checks.repeats_bitwise(case)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_gradient_is_the_backward_kernels(device, dtype):
    """Autograd through ``causal_attention`` on the card launches the
    forward kernel once and the backward kernel once, and its gradients
    are the plain backward's on the forward kernel's output; hd = 100 is
    padded for the bf16 forward, the gradients keep hd."""
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.flash_attn.ref import flash_attention_bwd_ref

    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(2, 90, h, 100)),
                            dtype=getattr(torch, dtype), device=device)
               .requires_grad_() for h in (4, 2, 2))
    cuda.reset_launches()
    out = fops.causal_attention(q, k, v)
    dout = torch.ones_like(out)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert (cuda.LAUNCHES["flash_attention"],
            cuda.LAUNCHES["flash_attention_bwd"]) == (1, 1)
    want = fops.attention_backward(q.detach(), k.detach(), v.detach(),
                                   out.detach(), dout)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    assert grads[0].shape == q.shape
    plain = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                    out.detach(), dout)
    tols = checks.flash_attention_bwd_tol(q.detach(), k.detach(), v.detach(),
                                          out.detach(), dout, plain)
    for g, p, t in zip(grads, plain, tols):
        assert bool(((g.double() - p.double()).abs() <= t).all())


def test_kernels_without_a_backward_raise_under_grad(device):
    """With grad mode on, ``ssd_intra_chunk`` refuses an operand that
    requires a gradient (its output would carry none); without grad mode
    it runs."""
    from repro_torch.kernels.ssd_chunk import ops as sops

    c = torch.randn(2, 8, 4, device=device)
    x = torch.randn(2, 8, 3, 16, device=device, requires_grad=True)
    cum = -torch.rand(2, 8, 3, device=device).cumsum(1)
    with pytest.raises(NotImplementedError, match="item 11.4"):
        sops.intra_chunk(c, c, x, cum)
    with torch.no_grad():
        assert sops.intra_chunk(c, c, x, cum).shape == x.shape


def test_train_step_on_cuda_matches_cpu(device):
    """One AdamW train step of MiniCPM-2B's smoke config on the card and on
    the CPU from the same weights: the loss and the gradient norm at 1e-5,
    the launches of one step (forward and recompute per layer, one
    backward per layer)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import optimizers, schedules

    cfg = get_config("minicpm_2b", smoke=True)
    cpu = lm.init_params(cfg, seed=0)
    gpu = lm.init_params(cfg, seed=0, device=device)
    gpu.load_state_dict(cpu.state_dict())
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 33)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    out = {}
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        opt = optimizers.adamw()
        state = steps.TrainState(torch.zeros((), dtype=torch.int32), model,
                                 opt.init(steps.param_dict(model)))
        step = steps.make_train_step(cfg, opt, schedules.constant(1e-3))
        cuda.reset_launches()
        _, m = step(state, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    dict(cuda.LAUNCHES))
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-5 * out["cpu"][1]
    assert (out["cuda"][2]["flash_attention"],
            out["cuda"][2]["flash_attention_bwd"]) == (2 * cfg.n_layers,
                                                       cfg.n_layers)


@pytest.mark.parametrize("G,Q,N,H,P", [
    (1, 1, 8, 3, 8), (3, 40, 16, 5, 8), (2, 256, 128, 20, 64),
    (2, 100, 33, 17, 63)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_intra_chunk_matches_plain_version(device, G, Q, N, H, P,
                                               dtype):
    """Head counts that are no multiple of the kernel's group of 16, Q not
    a multiple of its 64-row tile, N not a multiple of its 32-wide slab."""
    checks.compare(checks.ssd_intra_chunk_case(
        G, Q, N, H, P, getattr(torch, dtype), device, seed=G + Q + H))


def test_lm_on_cuda_matches_cpu(device):
    """Jamba's smoke config (7 mamba + 1 attention layers, float32) on the
    card and on the CPU from the same weights: the forward (1
    flash_attention and 7 ssd_intra_chunk launches) and a decode step agree
    at the reference's flash-vs-naive bar, 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("jamba_1_5_large_398b", smoke=True)
    cpu = lm.init_params(cfg, seed=0)
    gpu = lm.init_params(cfg, seed=0, device=device)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    cuda.reset_launches()
    with torch.inference_mode():        # serving: no graph
        got = lm.forward(gpu, cfg, tokens.to(device))
    torch.cuda.synchronize()
    assert (cuda.LAUNCHES["flash_attention"],
            cuda.LAUNCHES["ssd_intra_chunk"]) == (1, 7)
    with torch.inference_mode():
        want = lm.forward(cpu, cfg, tokens)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)
    outs = []
    for params, dev in ((gpu, device), (cpu, "cpu")):
        caches = lm.init_caches(params, cfg, 2, 16)
        lg, _ = lm.decode_step(params, cfg, caches, tokens[:, :1].to(dev),
                               torch.zeros((2, 1), dtype=torch.int64,
                                           device=dev))
        outs.append(lg.cpu().numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-4)


@pytest.mark.parametrize("arch,flash", [("dbrx_132b", 2), ("xlstm_125m", 0)])
def test_zoo_smoke_on_cuda_matches_cpu(device, arch, flash):
    """DBRX's smoke config (top-2 of 4 experts on both layers) and xLSTM's
    (5 mLSTM + 1 sLSTM layers) on the card and on the CPU from the same
    weights: the forward (one flash_attention launch an attention layer,
    none for xLSTM) and every step of a 16-token teacher-forced decode
    agree at 1e-4, the reference's flash-vs-naive bar."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(arch, smoke=True)
    cpu = lm.init_params(cfg, seed=0)
    gpu = lm.init_params(cfg, seed=0, device=device)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)))
    cuda.reset_launches()
    with torch.inference_mode():        # serving: no graph
        got = lm.forward(gpu, cfg, tokens.to(device))
        want = lm.forward(cpu, cfg, tokens)
    torch.cuda.synchronize()
    assert (cuda.LAUNCHES["flash_attention"],
            cuda.LAUNCHES["ssd_intra_chunk"]) == (flash, 0)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)
    caches = {dev: lm.init_caches(params, cfg, 2, 16)
              for dev, params in (("cuda", gpu), ("cpu", cpu))}
    for t in range(16):
        outs = []
        for dev, params in (("cuda", gpu), ("cpu", cpu)):
            lg, caches[dev] = lm.decode_step(
                params, cfg, caches[dev], tokens[:, t:t + 1].to(dev),
                torch.full((2, 1), t, device=dev))
            outs.append(lg.cpu().numpy())
        np.testing.assert_allclose(outs[0], outs[1], atol=1e-4)


def test_lm_wrappers_refuse_bad_operands(device):
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.ssd_chunk import ops as sops
    q = torch.zeros(1, 8, 4, 16, device=device)
    with pytest.raises(ValueError, match="flash_attention"):
        fops.causal_attention(q, q[:, :, :3].contiguous(),
                              q[:, :, :3].contiguous())
    with pytest.raises(TypeError):
        fops.causal_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 8, 1, 256, device=device)
        fops.causal_attention(z, z, z)
    c = torch.zeros(2, 8, 4, device=device)
    x = torch.zeros(2, 8, 3, 16, device=device)
    with pytest.raises(ValueError, match="cum is float32"):
        sops.intra_chunk(c, c, x,
                         torch.zeros(2, 8, 3, device=device).bfloat16())
    with pytest.raises(ValueError, match="chunk"):
        big = torch.zeros(1, 300, 4, device=device)
        sops.intra_chunk(big, big, torch.zeros(1, 300, 1, 8, device=device),
                         torch.zeros(1, 300, 1, device=device))


def test_stream_runs_repeat_bit_for_bit_on_cuda(device):
    """Two runs of one f32 ``pallas`` stream (capacity 256, 200 points,
    the fused prologue, bucketed) from one state end bit for bit equal, in
    the default (nondeterministic-allowed) mode: the cluster merge's
    segment sums add in a fixed order.  So do a metrics-on and a
    metrics-off run, guarded, with a NaN point among them."""
    from repro_torch.core import health
    from repro_torch.testing import faults

    rng = np.random.default_rng(21)
    X = rng.normal(size=(204, 16))
    pts = [faults.nan_point(16, base=x) if i == 77 else x
           for i, x in enumerate(X[4:])]
    spec = kf.KernelSpec(sigma=16.0)
    assert not torch.are_deterministic_algorithms_enabled()

    def run(points, **plan):
        s = inkpca.KPCAStream(
            torch.tensor(X[:4], dtype=torch.float32, device=device), 256,
            spec, plan=engine.UpdatePlan(matmul="pallas", fuse_krow=True,
                                         dispatch="bucketed", **plan),
            dtype=torch.float32, device=device)
        for x in points:
            s.update(x)
        torch.cuda.synchronize()
        return s

    a, b = run(X[4:]), run(X[4:])
    assert all(torch.equal(x, y) for x, y in zip(a.state, b.state))
    on = run(pts, health=health.DEFAULT_POLICY, metrics=True)
    off = run(pts, health=health.DEFAULT_POLICY)
    assert all(torch.equal(x, y) for x, y in zip(on.state, off.state))
    assert on.metrics_report()["rejections"] == 1
    assert on.health_report()["quarantined"] == 1 and on.m == 203


# ------------------------------------------------------------ tenant axis --
@pytest.mark.parametrize("n,ms", [(131, (8, 37, 100, 131)),
                                  (256, (9, 129, 200)), (64, (64,))])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_kernels_match_plain_and_single_launches(device, n, ms,
                                                         dtype):
    """The five KPCA kernels over a tenant axis (``checks.batched_cases``):
    one launch each, per entry within the single kernels' bounds of the
    plain versions, and each tenant bit for bit the single launch on its
    own operands (its own m read by pointer), at capacities that are no
    multiple of the 64-wide tiles or of 16 bytes, and at B = 1."""
    before = dict(cuda.LAUNCHES)
    cases = checks.batched_cases(n, ms, getattr(torch, dtype), device,
                                 seed=n)
    for case in cases:
        launched = cuda.LAUNCHES[case.name]
        case.kernel()
        assert cuda.LAUNCHES[case.name] == launched + 1
        checks.compare(case)
        assert checks.batched_bitwise(case), case.name
    assert cuda.LAUNCHES != before


def test_batched_wrappers_refuse_mismatched_counts(device):
    """A tenant axis needs one active count per tenant."""
    from repro_torch.kernels.eigvec_update import ops as eops

    u = torch.eye(8, dtype=torch.float64, device=device).expand(3, 8, 8)
    v = torch.ones(3, 8, 1, dtype=torch.float64, device=device)
    with pytest.raises(ValueError, match="active count"):
        eops.project_vectors(u.contiguous(), v, torch.tensor(
            [8, 8], dtype=torch.int32, device=device))


@pytest.mark.parametrize("matmul,cohorts", [("pallas", "max"),
                                            ("pallas2", "bucket")])
def test_cohort_on_cuda_matches_cpu(device, matmul, cohorts):
    """A multi-tenant cohort (f64, B = 3, masked steps spreading the
    tenants, then a block) on the card against the same cohort on the
    CPU: each tenant within the bars of ``test_stream_on_cuda_matches_cpu``
    (1e-6 of the scale), one launch of each kernel per group step."""
    rng = np.random.default_rng(4)
    B, d = 3, 5
    x0 = rng.normal(size=(B, 4, d))
    steps = [(rng.normal(size=(B, d)),
              np.array([t % (i + 1) == 0 for i in range(B)]))
             for t in range(16)]
    blk = rng.normal(size=(4, B, d))
    spec = kf.KernelSpec(sigma=10.0)
    plan = engine.UpdatePlan(matmul=matmul, fuse_krow=True,
                             dispatch="bucketed", min_bucket=16)
    out = {}
    for dev in ("cpu", device):
        cuda.reset_launches()
        b = engine.StreamBatch(torch.tensor(x0), 64, spec, plan=plan,
                               dtype=torch.float64, cohorts=cohorts,
                               device=dev)
        for xs, act in steps:
            b.update(xs, active=act)
        b.update_block(blk)
        out[str(dev)] = b.states
    krow = cuda.LAUNCHES["krow_project"]
    assert 0 < krow <= (16 + 4) * 2        # one per group step, not tenant
    cpu, gpu = out["cpu"], out[str(device)]
    assert gpu.m.tolist() == cpu.m.tolist()
    scale = float(cpu.L.abs().max())
    for i in range(B):
        m = int(cpu.m[i])
        np.testing.assert_allclose(gpu.L[i, :m].cpu().numpy(),
                                   cpu.L[i, :m].numpy(), atol=1e-6 * scale)


@pytest.fixture
def nccl_world(device, tmp_path):
    """A one-rank NCCL world in this process, destroyed after the test."""
    import torch.distributed as tdist

    from repro_torch.core import distributed as dist

    dist.init_world(rank=0, world_size=1, backend="nccl",
                    store=tdist.FileStore(str(tmp_path / "store"), 1),
                    timeout=120)
    yield dist.row_group(device=device)
    tdist.destroy_process_group()


@pytest.mark.parametrize("matmul", ["pallas", "pallas2"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_update_and_pair_at_p1_over_nccl(nccl_world, device, matmul,
                                                 dtype):
    """``make_sharded_update`` and ``make_sharded_update_pair`` at P = 1
    over NCCL (each update one all-reduce, each pair two) against the
    local path on the card: the same kernels on the same operands, so
    equal up to the order the all-reduce adds in (here none)."""
    from repro_torch.core import distributed as dist

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    M, m = 256, 200
    spec = kf.KernelSpec(name="rbf", sigma=16.0)
    st = inkpca.init_state(torch.tensor(rng.normal(size=(m, 16)),
                                        device=device), M, spec,
                           adjusted=False, dtype=dt)
    plan = engine.UpdatePlan(matmul=matmul, dispatch="bucketed")
    V = torch.zeros(3, M, dtype=dt, device=device)
    V[:, :m] = torch.tensor(rng.normal(size=(3, m)), dtype=dt)
    upd = dist.make_sharded_update(nccl_world, plan=plan)
    pair = dist.make_sharded_update_pair(nccl_world, plan=plan)
    c0 = nccl_world.collectives
    Ls, Us = upd(st.L, st.U, V[0], 0.7, st.m)
    Ls, Us = pair(Ls, Us, V[1], 0.9, V[2], -0.9, st.m)
    assert nccl_world.collectives - c0 == 3
    Ll, Ul = engine.rank_one(st.L, st.U, V[0], 0.7, st.m,
                             plan=plan._replace(matmul="pallas"))
    Ll, Ul = engine.apply_pair(Ll, Ul, V[1], torch.tensor(0.9, dtype=dt,
                                                          device=device),
                               V[2], torch.tensor(-0.9, dtype=dt,
                                                  device=device),
                               st.m, plan=plan)
    tol = 1e-10 if dtype == "float64" else 1e-4
    scale = float(Ll[:m].abs().max())
    assert float((Ls - Ll)[:m].abs().max()) <= tol * scale
    assert float((Us - Ul).abs().max()) <= (1e-8 if dtype == "float64"
                                            else 1e-3)


def test_decoupled_answers_are_query_batch_on_the_published_snapshot(device):
    """``serve --decouple`` on the card (f32 ``pallas``, 4 tenants,
    capacity 256): every answer equals ``serving.query_batch`` on the
    snapshot it read, bit for bit, and the generations advance on the
    cadence."""
    from repro_torch.core import serving
    from repro_torch.launch import serve

    log = []
    orig = serve.IngestServeLoop.query

    def query(self, q):
        y = orig(self, q)
        log.append((self.snaps, q, y))
        return y

    serve.IngestServeLoop.query = query
    try:
        result, loop = serve.kpca_decoupled_service(serve.parse_args([
            "--mode", "kpca", "--decouple", "--tenants", "4", "--capacity",
            "256", "--points", "40", "--dim", "16", "--batch", "32",
            "--query-rate", "2", "--serve-every", "4", "--health"]))
    finally:
        serve.IngestServeLoop.query = orig
    assert result["generations"] == 10 and result["finite"]
    assert len(log) == 80
    assert len({int(s.generation[0]) for s, _, _ in log}) == 10
    for s, q, y in log:
        assert y.is_cuda
        assert torch.equal(y, serving.query_batch(s, q, spec=loop.spec,
                                                  plan=loop.plan))


def test_decoupled_mesh_under_torchrun_takes_a_card_over_nccl(device):
    """``torchrun --nproc-per-node 1 ... --decouple --mesh 1x1`` with the
    device left at ``cuda``: the rank binds ``cuda:LOCAL_RANK``, joins the
    world over NCCL (one rank per card) and serves; the kernels are the
    ones this process built."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    cuda.build()
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ,
           "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "repro_torch.launch.serve",
         "--mode", "kpca", "--decouple", "--mesh", "1x1", "--tenants", "2",
         "--capacity", "64", "--points", "12", "--dim", "8", "--batch", "8",
         "--serve-every", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "'staging': 'device (nccl)'" in run.stdout, run.stdout[-3000:]
    assert "'generations': 3" in run.stdout
    assert "'finite': True" in run.stdout
