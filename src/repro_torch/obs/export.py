"""Exporters: Prometheus text exposition, a JSONL event log, /metrics.

* ``to_prometheus(hub)`` renders counters, gauges and histograms (as
  summaries, with the warm-up split as ``*_compiles`` / ``*_compile_ms``);
  ``serve_metrics(hub, port)`` serves it on ``GET /metrics`` from a daemon
  thread (``serve --metrics-port P``).
* ``write_jsonl(path, hub)`` writes the buffered events plus one final
  ``scrape`` event; ``hub.open_jsonl(path)`` streams events live instead.
  ``read_jsonl`` and ``parse_prometheus`` close the round trip.
"""
from __future__ import annotations

import json
import re
import threading

from repro_torch.obs.hub import render_key

_LINE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?)\s+(\S+)$")


def _base_name(key: str) -> str:
    return key.partition("{")[0]


def _labeled(key: str, extra: dict) -> str:
    """Merge extra labels into an already rendered key."""
    base, _, rest = key.partition("{")
    labels = dict(extra)
    if rest:
        for part in rest.rstrip("}").split(","):
            k, _, v = part.partition("=")
            labels[k] = v.strip('"')
    return render_key(base, labels)


def to_prometheus(hub) -> str:
    """Text exposition: counters, gauges, and histograms as summaries
    (quantile-labelled series and _count/_sum, with the warm-up split as
    companion ``*_compiles`` / ``*_compile_ms`` series)."""
    lines: list[str] = []
    typed: set[str] = set()

    def header(key: str, kind: str):
        base = _base_name(key)
        if base not in typed:
            typed.add(base)
            lines.append(f"# TYPE {base} {kind}")

    with hub._lock:
        for key, c in sorted(hub._counters.items()):
            header(key, "counter")
            lines.append(f"{key} {c.value:g}")
        for key, g in sorted(hub._gauges.items()):
            header(key, "gauge")
            lines.append(f"{key} {g.value:g}")
        for key, h in sorted(hub._hists.items()):
            s = h.summary(key)
            header(key, "summary")
            for q, field in (("0.5", "p50"), ("0.9", "p90"),
                             ("0.99", "p99")):
                lines.append(f'{_labeled(key, {"quantile": q})} '
                             f'{s[f"{key}_{field}"]:g}')
            lines.append(f"{key}_count {len(h.ms):g}")
            lines.append(f"{key}_sum {sum(h.ms):g}")
            header(f"{key}_compiles", "counter")
            lines.append(f"{key}_compiles {len(h.compile_ms):g}")
            header(f"{key}_compile_ms", "counter")
            lines.append(f"{key}_compile_ms {sum(h.compile_ms):g}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Inverse of ``to_prometheus``: rendered key → float value (comment
    and TYPE lines skipped)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        mt = _LINE_RE.match(line)
        if mt:
            out[mt.group(1)] = float(mt.group(2))
    return out


def write_jsonl(path, hub) -> None:
    """The hub's buffered events plus one final ``scrape`` event (the full
    registry, latency summaries included), one JSON object per line."""
    with open(path, "w") as f:
        for evt in hub.events:
            f.write(json.dumps(evt) + "\n")
        f.write(json.dumps({"event": "scrape", **hub.scrape()}) + "\n")


def read_jsonl(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def serve_metrics(hub, port: int = 0, host: str = "0.0.0.0"):
    """Serve ``GET /metrics`` (Prometheus text) from a daemon thread.

    Returns the running ``ThreadingHTTPServer``: its bound port is
    ``server.server_address[1]`` (``port=0`` picks a free one); stop it
    with ``server.shutdown()`` and ``server.server_close()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/metrics", "/metric"):
                self.send_error(404)
                return
            body = hub.to_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                     # quiet scrapes
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
