"""TelemetryHub: the host's metric registry for the port's services.

One hub answers "what is the stream doing now": counters, gauges (often
mirrored from a stream's ``core/telemetry.MetricsState``), latency
histograms that keep each key's first sample apart as warm-up, and a
JSONL event log.  ``scrape()`` returns the registry as a flat dict and
``to_prometheus()`` renders the text exposition format
(``obs.export.serve_metrics`` serves it).  Metric identity is a name plus
an optional label set, rendered Prometheus-style
(``kernel_launches_total{kernel="krow_project"}``).

The kernels' launch counts (``kernels.cuda.LAUNCHES``, one increment per
launch in each wrapper) are mirrored into the registry when it is read,
so counting costs the update nothing more.
"""
from __future__ import annotations

import contextlib
import json
import re
import threading
import time

import numpy as np
import torch

from repro_torch.obs.trace import trace_annotation

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

def sanitize(name: str) -> str:
    """A Prometheus-legal metric name."""
    out = _NAME_RE.sub("_", name)
    return out if not out[:1].isdigit() else "_" + out


def render_key(name: str, labels: dict | None = None) -> str:
    name = sanitize(name)
    if not labels:
        return name
    inner = ",".join(f'{sanitize(str(k))}="{v}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone counter handle (hub-registered)."""

    def __init__(self):
        self.value = 0.0

    def inc(self, n=1) -> None:
        self.value += n

    def set(self, v) -> None:
        """Absolute set, to mirror a cumulative counter kept elsewhere."""
        self.value = float(v)


class Gauge:
    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = float(v)


class _TimedHandle:
    """Yielded by ``LatencyHistogram.timed``: ``sync(x)`` marks the tensor
    the phase produced; the clock stops after its device has finished."""

    def __init__(self):
        self._sync = None

    def sync(self, x: torch.Tensor) -> None:
        self._sync = x


class LatencyHistogram:
    """Steady-state vs warm-up latency split for one service phase.

    A phase is timed on the host clock around work that ends in
    ``torch.cuda.synchronize()`` (the handle's ``sync``), so the sample
    holds the device's execution and not just the enqueue.  The first
    sample of each key (a bucket rung, a component count) is kept apart as
    warm-up: it pays the kernel build and the library's first-call set-up.
    """

    def __init__(self, name: str = "phase"):
        self.name = name
        self.ms: list[float] = []
        self.compile_ms: list[float] = []
        self._seen: set = set()
        self.last_ms: float | None = None

    def add(self, sample_ms: float, key=None) -> None:
        self.last_ms = sample_ms
        if key not in self._seen:
            self._seen.add(key)
            self.compile_ms.append(sample_ms)
        else:
            self.ms.append(sample_ms)

    @contextlib.contextmanager
    def timed(self, key=None, name: str | None = None):
        """Time a phase, annotated on the profiler's timeline under
        ``name`` (default the histogram's)."""
        handle = _TimedHandle()
        with trace_annotation(name or self.name):
            t0 = time.perf_counter()
            yield handle
            if handle._sync is not None and handle._sync.is_cuda:
                torch.cuda.synchronize(handle._sync.device)
        self.add((time.perf_counter() - t0) * 1e3, key=key)

    def summary(self, name: str | None = None) -> dict:
        """p50/p90/p99/max of the steady samples, plus the warm-up count
        and total (``{name}_compiles`` / ``{name}_compile_ms``, as the
        reference's serve loop prints them)."""
        name = name if name is not None else self.name
        arr = np.asarray(self.ms, float) if self.ms else np.zeros((1,))
        out = {f"{name}_p50": float(np.percentile(arr, 50)),
               f"{name}_p90": float(np.percentile(arr, 90)),
               f"{name}_p99": float(np.percentile(arr, 99)),
               f"{name}_max": float(arr.max())}
        out[f"{name}_compiles"] = len(self.compile_ms)
        out[f"{name}_compile_ms"] = float(sum(self.compile_ms))
        return out


class TelemetryHub:
    """Registry of counters, gauges and histograms plus a JSONL event
    buffer; registration and reads take one lock (a ``--metrics-port``
    scrape thread shares the hub with the service)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, LatencyHistogram] = {}
        self.events: list[dict] = []
        self._jsonl = None

    # ---- registration ----------------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        key = render_key(name, labels)
        with self._lock:
            return self._counters.setdefault(key, Counter())

    def gauge(self, name: str, **labels) -> Gauge:
        key = render_key(name, labels)
        with self._lock:
            return self._gauges.setdefault(key, Gauge())

    def histogram(self, name: str) -> LatencyHistogram:
        key = sanitize(name)
        with self._lock:
            return self._hists.setdefault(key, LatencyHistogram(key))

    def inc(self, name: str, n=1, **labels) -> None:
        self.counter(name, **labels).inc(n)

    def set_gauge(self, name: str, v, **labels) -> None:
        self.gauge(name, **labels).set(v)

    # ---- events (JSONL) --------------------------------------------------
    def open_jsonl(self, path) -> None:
        """Stream every later ``emit`` to ``path``, one JSON line each,
        flushed per line (the log survives a crash)."""
        self._jsonl = open(path, "a", buffering=1)

    def emit(self, event: dict) -> None:
        """Append a structured event (a publish, a heal, a scrape...)."""
        evt = {"ts": time.time(), **event}
        with self._lock:
            self.events.append(evt)
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(evt) + "\n")

    def close_jsonl(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    # ---- mirrors ----------------------------------------------------------
    def observe_metrics_state(self, mstate, prefix: str = "stream") -> dict:
        """Mirror a (possibly tenant-stacked) ``MetricsState`` into the
        registry, the one read of the stream's lane: a scalar stream lands
        unlabelled, stacked lanes get a ``tenant`` label each.  Returns the
        host report."""
        from repro_torch.core import telemetry as tm

        report = tm.metrics_report(mstate)
        for field, value in report.items():
            if field.endswith("_total"):
                self.counter(f"{prefix}_{field}").set(value)
                continue
            counter = field in tm.COUNTERS
            arr = np.asarray(value)
            lanes = ([(None, float(arr))] if arr.ndim == 0
                     else list(enumerate(arr.tolist())))
            for tenant, v in lanes:
                labels = {} if tenant is None else {"tenant": tenant}
                if counter:
                    self.counter(f"{prefix}_{field}_total", **labels).set(v)
                else:
                    self.gauge(f"{prefix}_{field}", **labels).set(v)
        return report

    def observe_kernel_launches(self) -> None:
        """Mirror each CUDA kernel's launch count (kept by its wrapper)."""
        from repro_torch.kernels import cuda

        for name, n in cuda.LAUNCHES.items():
            self.counter("kernel_launches_total", kernel=name).set(n)

    # ---- read-out --------------------------------------------------------
    def scrape(self) -> dict:
        """The whole registry as a flat dict: counters and gauges by
        rendered key, histograms expanded through their summaries."""
        self.observe_kernel_launches()
        with self._lock:
            out: dict = {}
            for key, c in self._counters.items():
                out[key] = c.value
            for key, g in self._gauges.items():
                out[key] = g.value
            for key, h in self._hists.items():
                out.update(h.summary(key))
            return out

    def to_prometheus(self) -> str:
        from repro_torch.obs import export

        self.observe_kernel_launches()
        return export.to_prometheus(self)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self.events.clear()


_DEFAULT = TelemetryHub()


def get_hub() -> TelemetryHub:
    """The process-default hub."""
    return _DEFAULT


def fresh_hub() -> TelemetryHub:
    """Reset and return the default hub: a service entry point calls this,
    so one process can run several services without cross-talk (a metrics
    server started before keeps reading the same object)."""
    _DEFAULT.reset()
    return _DEFAULT
