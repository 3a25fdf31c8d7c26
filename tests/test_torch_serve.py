"""The port's ``launch/serve.py`` (``--mode kpca``, ``--mode nystrom`` and
``--mode lm``) at a small size on the CPU."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401


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


def test_serve_unported_flags_raise(tmp_path):
    """``--health`` and ``--metrics`` are ported (ROADMAP.md item 7): on a
    window with every 5th point poisoned through the ``on_point`` seam,
    the quarantined points are counted in the health report and the
    metric lane, the result carries the reference's keys, and
    ``--metrics-jsonl`` writes the scrape."""
    from repro_torch.testing import faults

    path = tmp_path / "m.jsonl"
    res, _ = serve.kpca_service(
        serve.parse_args(["--device", "cpu", "--window", "8", "--capacity",
                          "16", "--points", "20", "--dim", "3", "--health",
                          "--metrics", "--metrics-jsonl", str(path)]),
        on_point=lambda i, stream, x: faults.nonfinite_every(5, i, x))
    assert {"heals", "health", "metrics", "quarantined"} <= res.keys()
    assert res["quarantined"] == res["health"]["quarantined"] == 4
    assert res["metrics"]["rejections"] == 4
    assert res["metrics"]["ingests"] == 16 and res["m_final"] == 8
    assert res["finite"] and res["heals"] == 0
    from repro_torch import obs
    scrape = obs.read_jsonl(path)[-1]
    assert scrape["event"] == "scrape"
    assert scrape["stream_rejections_total"] == 4.0


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


def test_serve_nystrom_health_drops_nonfinite_rows():
    """``--mode nystrom --health --metrics`` with every 6th point made
    non-finite through ``nystrom_service``'s ``on_point`` seam: those rows
    are quarantined before they are observed or offered, the others are
    observed and admitted to the budget, and the trace error is the
    recomputed one."""
    from repro_torch.core import kernels_fn as kf
    from repro_torch.core import nystrom
    from repro_torch.testing import faults

    res, state = serve.nystrom_service(
        serve.parse_args(["--mode", "nystrom", "--device", "cpu",
                          "--capacity", "16", "--points", "30", "--dim", "3",
                          "--dtype", "float64", "--health", "--metrics"]),
        on_point=lambda i, x: faults.nonfinite_every(6, i, x))
    assert res["quarantined"] == 5 and res["rows"] == 4 + 25
    assert res["admitted"] == 11 and res["m_final"] == 15
    assert bool(torch.isfinite(state.Xrows).all()) and res["finite"]
    assert res["trace_error"] == pytest.approx(float(nystrom.trace_error(
        state, kf.KernelSpec(sigma=3.0))), rel=1e-12)


def test_serve_nystrom_leverage_policy_raises():
    """The leverage policy with the stopping rule runs on the CPU and
    reports its lifecycle: every point offered once, the counts summing to
    the points, ``stopped_at`` and the tracker's drift and resyncs."""
    res = serve.main(["--mode", "nystrom", "--device", "cpu",
                      "--landmark-policy", "leverage", "--stop-rel-tol",
                      "1e-2", "--stop-patience", "3", "--capacity", "64",
                      "--landmark-budget", "32", "--points", "200", "--dim",
                      "8"])
    assert res["policy"] == "leverage" and res["finite"]
    assert res["admitted"] + res["replaced"] + res["rejected"] == 200
    assert res["m_final"] == 4 + res["admitted"] <= 32
    assert res["stopped_at"] is not None and res["tracker_drift"] is None
    assert res["tracker_resyncs"] == 0


def _record_offers(monkeypatch, engine_cls):
    """The actions of every ``offer_landmark`` call on ``engine_cls``."""
    log = []
    orig = engine_cls.offer_landmark

    def offer(self, *args, **kw):
        state, action = orig(self, *args, **kw)
        log.append(action)
        return state, action

    monkeypatch.setattr(engine_cls, "offer_landmark", offer)
    return log


LEVERAGE = ["--mode", "nystrom", "--landmark-policy", "leverage", "--matmul",
            "pallas", "--fuse-krow", "--capacity", "16", "--landmark-budget",
            "12", "--points", "16", "--dim", "8"]


def test_leverage_service_takes_the_references_actions(monkeypatch):
    """The leverage service against the reference's ``nystrom_main`` on
    the same seed (both f32; the rule at rel_tol 0, see the next test):
    the same action at every offer, the same counts and stop, and a final
    trace error within 1e-4 of the exact recomputation (f64, from the
    dense grams of the port's landmarks and rows), the reference's within
    1e-2 of it (its f32 eigensystem drifts, ROADMAP.md §3)."""
    import torch

    from repro.core import engine as jeng
    from repro.launch import serve as jserve
    from repro_torch.core import engine as teng
    from repro_torch.core import kernels_fn as kf

    argv = LEVERAGE + ["--stop-rel-tol", "0"]
    tlog = _record_offers(monkeypatch, teng.Engine)
    jlog = _record_offers(monkeypatch, jeng.Engine)
    res, state = serve.nystrom_service(serve.parse_args(
        argv + ["--device", "cpu"]))
    want = jserve.main(argv)
    assert tlog == jlog and len(tlog) == 16
    for k in ("admitted", "replaced", "rejected", "m_final", "rows",
              "stopped_at"):
        assert res[k] == want[k], k
    spec = kf.KernelSpec(sigma=8.0)
    m = res["m_final"]
    R, L = state.Xrows.double(), state.kpca.X[:m].double()
    lam, V = torch.linalg.eigh(kf.gram_block(L, L, spec=spec))
    B = kf.gram_block(R, L, spec=spec) @ V
    exact = float((kf.kernel_diag(R, spec=spec) - (B ** 2 / lam).sum(1)).sum())
    assert abs(res["trace_error"] - exact) <= 1e-4 * exact
    assert abs(want["trace_error"] - exact) <= 1e-2 * exact


def test_stop_rule_reads_rounding_noise_while_every_row_is_admitted(
        monkeypatch):
    """Witness (ROADMAP.md §3): while every offered row has been admitted
    the tracked trace error over the rows is zero up to rounding, so the
    sufficient-subset rule's relative improvements are rounding noise.  At
    the service's defaults (rel_tol 1e-2, patience 3) both packages stop
    on values below 1e-5 before any rejection, at different points (the
    port at its 4th admission, the reference where its f32 noise
    allows)."""
    from repro.core import nystrom as jn
    from repro.launch import serve as jserve
    from repro_torch.core import nystrom as tn

    seen = {}
    for pkg in (tn, jn):
        orig = pkg.SufficientSubsetRule.observe
        seen[pkg] = []

        def observe(self, err, _orig=orig, _log=seen[pkg]):
            _log.append(float(err))
            return _orig(self, err)

        monkeypatch.setattr(pkg.SufficientSubsetRule, "observe", observe)
    argv = LEVERAGE + ["--stop-rel-tol", "1e-2", "--stop-patience", "3"]
    res = serve.main(argv + ["--device", "cpu"])
    want = jserve.main(argv)
    for r, errs in ((res, seen[tn]), (want, seen[jn])):
        assert r["stopped_at"] == r["admitted"] - 1 and r["replaced"] == 0
        assert max(errs) < 1e-5
    assert res["admitted"] == 4


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
    assert res["fused"]["n_components"] == 16


def test_roofline_launch_reckoning():
    """The launches ``chip_smoke.py`` holds the roofline to: each row's
    calls on its wrapper (C = 64 in one ``transform_project`` call), and
    the fused ingest's and transform's calls on theirs."""
    from repro_torch.kernels import cuda
    from repro_torch.launch import roofline

    res = roofline.main(smoke=True, device="cpu")
    calls = {r["kernel"]: r["calls"] for r in res["kernels"]}
    assert all(c >= 2 for c in calls.values())
    fused = res["fused"]["fused_calls"]
    expect = roofline.launch_reckoning(res, cuda.LAUNCHES)
    assert set(expect) == set(cuda.LAUNCHES)
    assert expect["transform_project"] == calls["transform_batch"] + fused
    assert expect["krow_project"] == calls["krow_fused"] + fused
    assert expect["eigvec_project"] == calls["eigvec_project"] + fused
    assert expect["scaled_gram"] == calls["nystrom_recon"]
    assert expect["rbf_gram"] == calls["rbf_gram"]
    assert expect["flash_attention"] == expect["ssd_intra_chunk"] == 0


def test_serve_lm_runs_on_cpu():
    """``--mode lm`` on Jamba's smoke config (experts on the odd layers):
    the prompt through teacher-forced decode steps, then greedy decode; the
    tokens lie in the vocabulary and the logits are finite."""
    res = serve.main(["--mode", "lm", "--device", "cpu", "--arch",
                      "jamba_1_5_large_398b", "--smoke", "--batch", "2",
                      "--prompt-len", "8", "--gen", "6"])
    assert res["generated_shape"] == (2, 6) and res["device"] == "cpu"
    assert res["finite"] and res["tokens_in_vocab"] and res["n_layers"] == 8
    assert math.isfinite(res["tokens_per_s"]) and res["tokens_per_s"] > 0


def test_serve_lm_is_deterministic_in_the_seed():
    """Two runs from one seed decode the same tokens (parameters and
    prompts both come from ``--seed``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = get_config("qwen3_32b", smoke=True)
    outs = []
    for _ in range(2):
        params = lm.init_params(cfg, seed=3)
        step = steps.make_serve_step(cfg)
        caches = lm.init_caches(params, cfg, 1, 4)
        tok = torch.zeros((1, 1), dtype=torch.int64)
        for t in range(4):
            tok, _, caches = step(params, caches, tok, torch.full((1, 1), t))
        outs.append(int(tok))
    assert outs[0] == outs[1]
