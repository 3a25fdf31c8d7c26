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
                                 (200, 37), (256, 129)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernels_match_plain_versions(device, n, m, dtype):
    for case in checks.cases(n, m, getattr(torch, dtype), device, seed=n + m):
        checks.compare(case)


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
                             "rbf_gram": 0}
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


@pytest.mark.parametrize("n,m,dim", [(1, 1, 1), (130, 129, 3), (64, 64, 16),
                                     (65, 200, 17), (300, 300, 64)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rbf_gram_matches_plain_version(device, n, m, dim, dtype):
    """Ragged edges of the 64-wide tiles and the 16-wide slabs of d; n = m
    is the gram of x with itself (its diagonal a clamped residue)."""
    for case in checks.rbf_gram_cases(n, m, dim, getattr(torch, dtype),
                                      device, seed=n + m + dim):
        checks.compare(case)


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
