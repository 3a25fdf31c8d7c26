"""The CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU and skip
without one.  They import nothing of JAX; run them on the machine with the
card with ``python -m pytest -q --noconftest -m cuda
tests/test_torch_kernels_cuda.py`` (the repository's conftest imports JAX).

Shapes are the small, ragged ones ``chip_smoke.py`` does not cover
(capacities that are no multiple of the 64-wide tiles, m = 0, m at a tile
edge and at capacity); the tolerances are ``kernels.checks``'s.
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
    assert cuda.LAUNCHES == {"eigvec_rotate": 160, "krow_project": 40,
                             "eigvec_project": 40, "transform_project": 1}
    K = kf.gram_block(torch.tensor(X), torch.tensor(X), spec=spec)
    lam_ref = batch.batch_kpca(K, adjusted=True)[0].numpy()
    scale = max(1.0, np.abs(lam_ref).max())
    (lam_cpu, y_cpu), (lam_gpu, y_gpu) = out["cpu"], out[str(device)]
    for lam in (lam_cpu, lam_gpu):
        assert np.abs(lam - lam_ref).max() / scale < 5e-5
    np.testing.assert_allclose(lam_gpu, lam_cpu, atol=1e-6 * scale)
    np.testing.assert_allclose(y_gpu, y_cpu, atol=1e-6 * np.abs(y_cpu).max())


def test_wrappers_refuse_bad_operands(device):
    from repro_torch.kernels.eigvec_update import ops as eops
    u = torch.eye(8, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        eops.project_vectors(u.T, u[:, :2].contiguous(), 4)
    with pytest.raises(TypeError):
        eops.project_vectors(u.half(), u[:, :2].half(), 4)
    with pytest.raises(ValueError, match="columns"):
        eops.project_vectors(u, torch.zeros(8, 9, device=device), 4)
