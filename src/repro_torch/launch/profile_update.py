"""Where one streamed point's update spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_update \\
        --capacity 1024 --warm 600 --steps 20 [--matmul pallas2]

Builds the service's stream (the same data and plan as ``serve.py
--mode kpca``; ``--health`` guards it), folds ``--warm`` points in, times
``--steps`` updates on the host clock, ``--steps`` more with each stage
of the update timed on the host clock, runs ``--steps`` more under
torch's sync debug mode, then profiles ``--steps`` more with
``torch.profiler`` (CPU and CUDA activity).  Prints one JSON object: wall
ms per update, the host ms per update spent issuing each stage (slice,
gate, ingest, scatter, select, probe: no stage waits for the device, so
while the device idles the host clock reads the host's own cost; the
rest is the glue between them), device-busy ms per update (the sum of
the device events' time), the device's idle share (1 - busy / wall),
host operators and device launches per update, the operators with the
most host time of their own, the host's time blocked in reads of device
values per update (``.item()``, ``bool()``: the fused pair reads whether
a cluster merge fires, once per pair), the synchronizing calls per
update and the source lines that made them (reads, and copies from
pageable host memory), and the kernels that take the most device time.
Run the file with another tree's ``src`` on ``PYTHONPATH`` to profile
that tree.
"""
from __future__ import annotations

import argparse
import collections
import json
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.core import engine as eng, health as hl
from repro_torch.launch import serve

# (module, function) of each stage of an update; none calls another.
STAGES = ((eng, "slice_state"), (hl, "_gate"), (eng, "_ingest"),
          (eng, "scatter_state"), (hl, "_select"), (hl, "probe"))


def stage_ms(stream, xs) -> dict:
    """Host ms per update spent in each stage of ``STAGES`` while
    ``stream`` folds in ``xs``, and the rest (``glue``)."""
    spent = collections.Counter()
    saved = [(mod, name, getattr(mod, name)) for mod, name in STAGES]

    def timed(fn, name):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            spent[name] += time.perf_counter() - t
            return out
        return run

    for mod, name, fn in saved:
        setattr(mod, name, timed(fn, name))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in xs:
            stream.update(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    out = {name: spent[name] * 1e3 / len(xs) for _, name in STAGES}
    out["glue"] = wall * 1e3 / len(xs) - sum(out.values())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--warm", type=int, default=600)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dtype", choices=tuple(serve.DTYPES), default="float32")
    ap.add_argument("--matmul", default="pallas",
                    choices=("pallas", "pallas2"))
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--health", action="store_true",
                    help="guard the stream (the default health policy)")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    dtype = serve.DTYPES[args.dtype]

    sargs = serve.parse_args(["--capacity", str(args.capacity), "--points",
                              str(args.warm), "--dtype", args.dtype,
                              "--matmul", args.matmul,
                              "--transform-every", str(args.warm + 1),
                              *(["--health"] if args.health else [])])
    _, stream = serve.kpca_service(sargs)
    rng = np.random.default_rng(1)
    xs = torch.as_tensor(rng.normal(size=(4 * args.steps, sargs.dim)),
                         dtype=dtype, device=device)
    # Wall time without the profiler (which adds host cost per operator),
    # then the same number of updates under it.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in xs[:args.steps]:
        stream.update(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    stages = stage_ms(stream, xs[3 * args.steps:])
    # Each synchronizing call warns once under the debug mode; the warning
    # names the Python line that made it.
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for x in xs[args.steps:2 * args.steps]:
                stream.update(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{w.filename.rsplit('/src/', 1)[-1]}:{w.lineno}" for w in seen
        if "synchroniz" in str(w.message))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in xs[2 * args.steps:3 * args.steps]:
            stream.update(x)
        torch.cuda.synchronize()

    # Device-side events (kernels, copies, sets): their own time ranges,
    # not the host operators that launched them.
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    busy_ms = sum(map(sum, by_name.values())) / 1e3 / args.steps
    # A read of a device value waits for the device (aten::item ends in
    # aten::_local_scalar_dense, which copies and synchronizes).
    reads = [e for e in prof.events() if e.device_type == DeviceType.CPU
             and e.name == "aten::_local_scalar_dense"]
    read_ms = sum(e.time_range.elapsed_us() for e in reads) / 1e3 / args.steps
    launches = sum(map(len, by_name.values())) / args.steps
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    rows = sorted(by_name.items(), key=lambda kv: sum(kv[1]), reverse=True)
    result = {
        "device": torch.cuda.get_device_name(device),
        "capacity": args.capacity, "m_start": args.warm + 4,
        "steps": args.steps, "dtype": args.dtype, "matmul": args.matmul,
        "health": args.health,
        "wall_ms_per_update": wall_ms,
        "host_stage_ms_per_update": stages,
        "device_busy_ms_per_update": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches_per_update": launches,
        "host_ops_per_update": sum(e.count for e in host) / args.steps,
        "host_top": [{"name": e.key, "calls_per_update": e.count / args.steps,
                      "self_ms_per_update":
                      e.self_cpu_time_total / 1e3 / args.steps}
                     for e in host[:args.top]],
        "host_reads_per_update": len(reads) / args.steps,
        "host_read_ms_per_update": read_ms,
        "syncs_per_update": sum(sites.values()) / args.steps,
        "sync_sites": {k: v / args.steps for k, v in sites.most_common()},
        "top": [{"name": name[:80],
                 "ms_per_update": sum(ts) / 1e3 / args.steps,
                 "launches_per_update": len(ts) / args.steps}
                for name, ts in rows[:args.top]],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
