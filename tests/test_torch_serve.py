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
    for flag in ("--health", "--metrics"):
        with pytest.raises(NotImplementedError, match="item 7"):
            serve.main(["--device", "cpu", "--window", "8", flag])


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


def test_serve_kpca_window_runs_on_cpu():
    """``--window W``: the stream grows to W, then evicts the oldest point
    per new one; its rows are the last W streamed points in arrival order,
    and the latencies are split by phase."""
    import numpy as np

    args = serve.parse_args(["--mode", "kpca", "--device", "cpu",
                             "--capacity", "32", "--window", "12",
                             "--points", "20", "--dim", "4", "--batch", "4",
                             "--transform-every", "8", "--dtype", "float64"])
    res, stream = serve.kpca_service(args)
    assert res["window"] == 12 and res["m_final"] == 12 and res["finite"]
    assert res["growth_points"] == 8 and res["steady_points"] == 12
    assert res["transforms_served"] == 2 * 4
    for key in ("growth_update_ms_p50", "steady_update_ms_p50",
                "update_ms_p99"):
        assert math.isfinite(res[key])
    x0, draws = serve.kpca_draws(args)
    points = np.concatenate([x0, [x for x, _ in draws]])
    np.testing.assert_array_equal(stream.kpca_state.X[:12].numpy(),
                                  points[-12:])
    np.testing.assert_array_equal(stream.state.ages[:12].numpy(),
                                  np.arange(12, 24))


def test_roofline_smoke_runs_on_cpu():
    """The roofline's ``--smoke`` on the CPU: a row per port kernel under
    the reference driver's names, finite positive rates, nothing
    written."""
    from repro_torch.launch import roofline

    res = roofline.main(smoke=True, device="cpu")
    assert [r["kernel"] for r in res["kernels"]] == [
        "eigvec_rotate", "eigvec_rotate2", "rbf_gram", "krow_fused",
        "eigvec_project", "transform_batch", "nystrom_recon"]
    assert res["device"] == "cpu" and res["timer"] == "wall clock"
    assert res["peak_gbps"] > 0
    for r in res["kernels"]:
        assert r["gbps"] > 0 and r["call_ms"] is None
    assert set(res["fused"]["ingest_ms"]) == {
        "unfused_fixed", "unfused_bucketed", "fused_bucketed"}
    assert res["ingest_speedup_fused"] > 0
