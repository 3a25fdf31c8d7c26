"""The port's host-side observability (``repro_torch.obs``: the hub, the
exporters, ``span``) and its spectral monitor, against the reference's.

The same registry renders the same Prometheus text in both packages and
survives the round trips (text, JSONL, ``GET /metrics`` on a local
port); a ``MetricsState`` mirrors into the same scrape; the kernels'
launch counts appear at scrape time; and the monitor tracks eigh of
its trailing window (f64).
"""
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import telemetry as jtm  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import kernels_fn as tkf  # noqa: E402
from repro_torch.core import telemetry as ttm  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.spectral import SpectralMonitor  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401


def _fill(hub):
    hub.counter("pub_total").inc(3)
    hub.counter("lm_total", action="admitted").inc(2)
    hub.gauge("drift").set(0.25)
    hist = hub.histogram("query_ms")
    for v in (4.0, 1.0, 2.0, 3.0):
        hist.add(v, key="warm")        # the first sample per key: warm-up
    hub.emit({"event": "publish", "generation": 1})
    return hub


def _ours(text):
    """The lines of an exposition that do not come from the launch
    mirror (the reference has no such counters)."""
    return [ln for ln in text.splitlines() if "kernel_launches" not in ln]


def test_latency_histogram_split_and_old_import():
    from repro_torch.obs import LatencyHistogram

    assert LatencyHistogram is obs.hub.LatencyHistogram
    h, j = LatencyHistogram("update_ms"), jobs.LatencyHistogram("update_ms")
    for v, k in ((100.0, "r0"), (1.0, "r0"), (2.0, "r0"), (50.0, "r1")):
        h.add(v, key=k)
        j.add(v, key=k)
    assert h.summary() == j.summary() and h.last_ms == 50.0
    with h.timed(key="r0") as t:
        t.sync(torch.ones(2))
    assert len(h.ms) == 3


def test_exporter_round_trip_matches_reference(tmp_path):
    """Text exposition equal to the reference's for the same registry;
    parse, JSONL and HTTP round trips."""
    hub, jhub = _fill(obs.TelemetryHub()), _fill(jobs.TelemetryHub())
    text = hub.to_prometheus()
    assert _ours(text) == jhub.to_prometheus().splitlines()
    parsed = obs.parse_prometheus(text)
    assert parsed == jobs.parse_prometheus(text)
    assert parsed['lm_total{action="admitted"}'] == 2.0
    assert parsed['query_ms{quantile="0.5"}'] == 2.0
    assert parsed["query_ms_count"] == 3.0 and parsed["query_ms_compiles"] == 1
    for k, v in hub.scrape().items():
        if k in parsed:
            assert parsed[k] == pytest.approx(v)

    path = tmp_path / "metrics.jsonl"
    obs.write_jsonl(path, hub)
    events = obs.read_jsonl(path)
    assert events == jobs.read_jsonl(path)
    assert events[0]["event"] == "publish" and events[-1]["event"] == "scrape"
    assert events[-1]["pub_total"] == 3.0

    srv = obs.serve_metrics(hub, 0, host="127.0.0.1")
    try:
        port = srv.server_address[1]
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=10).read().decode()
        assert obs.parse_prometheus(body) == parsed
    finally:
        srv.shutdown()
        srv.server_close()


def test_hub_mirrors_metrics_state_as_the_reference():
    """``observe_metrics_state`` of the same lane (scalar and stacked)
    gives the reference's scrape."""
    pairs = [(ttm.note_publish(ttm.init_metrics(torch.float64), 2),
              jtm.note_publish(jtm.init_metrics(jnp.float64), 2), "stream"),
             (ttm.init_metrics_stacked(2), jtm.init_metrics_stacked(2),
              "lane")]
    for tms, jms, prefix in pairs:
        hub, jhub = obs.TelemetryHub(), jobs.TelemetryHub()
        hub.observe_metrics_state(tms, prefix=prefix)
        jhub.observe_metrics_state(jms, prefix=prefix)
        got = {k: v for k, v in hub.scrape().items()
               if "kernel_launches" not in k}
        assert got == jhub.scrape()
    assert got['lane_m{tenant="1"}'] == 0.0


def test_kernel_launch_counts_are_mirrored_at_scrape(monkeypatch):
    """The wrappers' launch counts appear as counters when the hub is
    read, with nothing counted per launch on the hub's side."""
    monkeypatch.setitem(cuda.LAUNCHES, "krow_project", 7)
    hub = obs.fresh_hub()
    key = 'kernel_launches_total{kernel="krow_project"}'
    assert hub.scrape()[key] == 7.0
    assert obs.parse_prometheus(hub.to_prometheus())[key] == 7.0
    assert set(cuda.LAUNCHES) == {
        k.split('"')[1] for k in hub.scrape() if "kernel_launches" in k}


def test_span_times_and_annotates():
    hist = obs.LatencyHistogram("ingest_ms")
    with obs.span("ingest", hist=hist, key=0) as t:
        t.sync(torch.zeros(3))
    with obs.span("ingest", hist=hist, key=0):
        pass
    with obs.span("query") as none:
        assert none is None
    assert len(hist.compile_ms) == 1 and len(hist.ms) == 1
    with torch.profiler.profile() as prof:
        with obs.span("publish"):
            torch.ones(2).sum()
    assert "publish" in {e.key for e in prof.key_averages()}


def test_monitor_tracks_the_window_and_publishes_gauges():
    """Two observes past the window's fill: the monitor's eigenvalues
    equal eigh of the trailing window within 1e-12, its stats follow
    from them (as the reference's monitor computes them), its drift is
    positive, and the stats land as gauges on the hub."""
    rng = np.random.default_rng(8)
    hub = obs.TelemetryHub()
    mon = SpectralMonitor(capacity=24, hub=hub, dtype=torch.float64,
                          window=16, device="cpu")
    first = mon.observe(rng.normal(size=(12, 6)))
    assert first["drift"] == 0.0 and first["m"] == first["seen"] == 12
    got = mon.observe(rng.normal(size=(12, 6)))
    assert got["drift"] > 0.0 and got["m"] == 16 and got["seen"] == 24
    st = mon._stream.kpca_state
    X = st.X[:16]
    K = tkf.center_gram(tkf.gram_block(X, X, spec=mon._stream.spec))
    lam = torch.linalg.eigvalsh(K).flip(0).numpy()
    np.testing.assert_allclose(mon.eigenvalues(), lam, atol=1e-12)
    p = np.maximum(lam, 0.0) / (np.maximum(lam, 0.0).sum() + 1e-30)
    assert got["top_eig"] == pytest.approx(lam[0], abs=1e-12)
    assert got["effective_rank"] == pytest.approx(
        np.exp(-np.sum(p * np.log(p + 1e-30))), rel=1e-9)
    assert got["explained_90"] == int(np.searchsorted(np.cumsum(p), 0.9)
                                      + 1)
    sc = hub.scrape()
    for k in ("drift", "effective_rank", "m", "top_eig"):
        assert sc[f"spectral_{k}"] == pytest.approx(got[k]), k
