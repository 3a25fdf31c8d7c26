"""Host-side observability: the hub registry, phase tracing, exporters.

The in-stream half is ``repro_torch.core.telemetry`` (a ``MetricsState``
riding the stream); this package is what happens on the host: the
``TelemetryHub`` registry, ``span()`` profiler ranges, the kernels' launch
counts mirrored at scrape time, and the Prometheus / JSONL exporters
``launch/serve.py`` uses.
"""
from repro_torch.obs.export import (parse_prometheus, read_jsonl,
                                    serve_metrics, to_prometheus,
                                    write_jsonl)
from repro_torch.obs.hub import (Counter, Gauge, LatencyHistogram,
                                 TelemetryHub, fresh_hub, get_hub,
                                 render_key, sanitize)
from repro_torch.obs.trace import span, trace_annotation

__all__ = [
    "Counter", "Gauge", "LatencyHistogram", "TelemetryHub", "fresh_hub",
    "get_hub", "render_key", "sanitize", "span", "trace_annotation",
    "to_prometheus", "parse_prometheus", "serve_metrics", "write_jsonl",
    "read_jsonl",
]
