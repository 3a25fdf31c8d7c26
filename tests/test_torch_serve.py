"""The port's ``launch/serve.py`` (``--mode kpca`` and ``--mode nystrom``) at
a small size on the CPU."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402


def test_serve_kpca_runs_on_cpu():
    res = serve.main(["--mode", "kpca", "--device", "cpu", "--capacity", "32",
                      "--points", "20", "--dim", "4", "--batch", "4",
                      "--transform-every", "8"])
    assert res["m_final"] == 4 + 20
    assert res["finite"] and res["device"] == "cpu"
    assert res["transforms_served"] == 2 * 4
    for key in ("update_ms_p50", "update_ms_p99", "query_ms_p50"):
        assert math.isfinite(res[key])


def test_serve_kpca_dense_route_f64():
    res, stream = serve.kpca_service(serve.parse_args(
        ["--device", "cpu", "--capacity", "16", "--points", "10", "--dim",
         "3", "--matmul", "jnp", "--no-fuse-krow", "--dtype", "float64"]))
    assert res["m_final"] == 14 and stream.state.L.dtype == torch.float64


def test_serve_unported_flags_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(["--device", "cpu", "--window", "8"])


def test_serve_nystrom_runs_on_cpu():
    """The landmark service (append policy, fused pair) at a small size:
    every point is observed, admitted until the budget fills, and the
    final trace error is the recomputed one."""
    from repro_torch.core import nystrom
    from repro_torch.core import kernels_fn as kf

    res, state = serve.nystrom_service(serve.parse_args(
        ["--mode", "nystrom", "--device", "cpu", "--capacity", "32",
         "--points", "40", "--dim", "4", "--matmul", "pallas2",
         "--dtype", "float64"]))
    assert res["m_final"] == 31 and res["rows"] == 44
    assert res["admitted"] == 27 and res["rejected"] == 13
    assert res["finite"] and res["device"] == "cpu"
    assert res["trace_error"] == pytest.approx(float(nystrom.trace_error(
        state, kf.KernelSpec(sigma=4.0))), rel=1e-12)
    out = serve.main(["--mode", "nystrom", "--device", "cpu", "--capacity",
                      "16", "--points", "12", "--dim", "3"])
    assert out["m_final"] == 15 and math.isfinite(out["step_ms_p50"])


def test_serve_nystrom_leverage_policy_raises():
    with pytest.raises(NotImplementedError, match="item 5"):
        serve.main(["--mode", "nystrom", "--device", "cpu", "--capacity",
                    "16", "--points", "4", "--dim", "3",
                    "--landmark-policy", "leverage"])
