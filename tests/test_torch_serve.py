"""The port's ``launch/serve.py --mode kpca`` at a small size on the CPU."""
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
