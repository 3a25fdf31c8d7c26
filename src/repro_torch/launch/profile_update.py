"""Where one streamed point's update spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_update \\
        --capacity 1024 --warm 600 --steps 20 [--matmul pallas2]

Builds the service's stream (the same data and plan as ``serve.py
--mode kpca``), folds ``--warm`` points in, times ``--steps`` updates on
the host clock, then profiles ``--steps`` more with ``torch.profiler``
(CPU and CUDA activity).  Prints one JSON object: wall ms per update,
device-busy ms per update (the sum of the device events' time), the
device's idle share (1 - busy / wall), device launches per update, the
host's time blocked in reads of device values per update (``.item()``,
``bool()``: the fused pair reads whether a cluster merge fires, once per
pair), and the kernels that take the most device time.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.launch import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--warm", type=int, default=600)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dtype", choices=tuple(serve.DTYPES), default="float32")
    ap.add_argument("--matmul", default="pallas",
                    choices=("pallas", "pallas2"))
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    dtype = serve.DTYPES[args.dtype]

    sargs = serve.parse_args(["--capacity", str(args.capacity), "--points",
                              str(args.warm), "--dtype", args.dtype,
                              "--matmul", args.matmul,
                              "--transform-every", str(args.warm + 1)])
    _, stream = serve.kpca_service(sargs)
    rng = np.random.default_rng(1)
    xs = torch.as_tensor(rng.normal(size=(2 * args.steps, sargs.dim)),
                         dtype=dtype, device=device)
    # Wall time without the profiler (which adds host cost per operator),
    # then the same number of updates under it.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in xs[:args.steps]:
        stream.update(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in xs[args.steps:]:
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
    rows = sorted(by_name.items(), key=lambda kv: sum(kv[1]), reverse=True)
    result = {
        "device": torch.cuda.get_device_name(device),
        "capacity": args.capacity, "m_start": args.warm + 4,
        "steps": args.steps, "dtype": args.dtype, "matmul": args.matmul,
        "wall_ms_per_update": wall_ms,
        "device_busy_ms_per_update": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches_per_update": launches,
        "host_reads_per_update": len(reads) / args.steps,
        "host_read_ms_per_update": read_ms,
        "top": [{"name": name[:80],
                 "ms_per_update": sum(ts) / 1e3 / args.steps,
                 "launches_per_update": len(ts) / args.steps}
                for name, ts in rows[:args.top]],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
