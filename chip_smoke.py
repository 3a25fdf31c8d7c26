#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``   — compile the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` with nvcc (one process per source, all at once) into ``build/``.
2. ``kernels`` — each kernel against its plain PyTorch version on the same
   CUDA inputs (capacity bucket 1024 with m = 1000 and m = 300, f32 and
   f64), each output entry within its own bound as
   ``repro_torch.kernels.checks`` states it.
3. ``service`` — the port's main path, ``repro_torch.launch.serve`` in
   ``--mode kpca`` (Algorithm 2, rotation kernel, fused k-row prologue,
   bucketed dispatch): capacity 1024, d = 16, 4 seed + 1000 streamed
   points in f32, a batch of 64 queries every 16 points; then capacity
   256 with 200 points in f64.  Every kernel's launch count is reset just
   before and read just after, and must match the reckoning (4 rotations,
   1 k-row pass and 1 projection per point, 1 transform per query batch).
   The final state is held against ``batch_kpca`` (eigh on the card, f64).
4. ``timing`` — at the kernel phase's shapes, each kernel's device time
   (profiler records) beside the plain version's, one library call's and
   its bound, and each call's event-timed time, host work included.  It
   runs last so that the profiler is never attached to the service.

Then the card's name and power limit, the kernels' summary line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_N, MAIN_M = 1024, 1000
# Final-state bars against the eigh oracle (top-8 eigenvalues' largest
# relative error, smallest cosine of the principal angles between the
# top-8 subspaces).  On this data the port's stream, run on a CPU, is
# 3.4e-6 / 1 - 2.8e-6 off in f32 at 250 points and 1.3e-8 / 1 - 1e-12 in
# f64; the bars leave room for the drift of a 4x longer stream and a
# top-8 gap of 1.4 % (f32), and sit far below a wrong rotation (errors of
# order 1).  The reference's f32 stream is 2.2e-2 off at 250 points: its
# displacement deflation uses the state type's eps (ROADMAP.md, "Faults
# found"); the port uses the solve type's.
BARS = {"float32": (1e-3, 0.999), "float64": (1e-6, 1.0 - 1e-8)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_summary(reports: dict) -> dict:
    """Registers and spill bytes per compiled entry, from ``ptxas -v``."""
    out = {}
    for src, text in reports.items():
        entry = None
        for line in text.splitlines():
            hit = re.search(r"Compiling entry function '(\w+)'", line)
            if hit:
                entry = hit.group(1)
            hit = re.search(r"Used (\d+) registers", line)
            if hit and entry:
                out.setdefault(src, []).append(int(hit.group(1)))
            hit = re.search(r"(\d+) bytes spill stores", line)
            if hit and entry and int(hit.group(1)):
                out.setdefault(src + ":spills", []).append(int(hit.group(1)))
    return out


def kernel_phase(torch, checks, cuda) -> dict:
    """Each kernel against its plain version, per entry within its own
    bound; returns the rows by (kernel name, dtype, m).  ``launches``
    counts this phase's launches of the kernel; the service's counts start
    from zero after it."""
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for m in (MAIN_M, 300):
            for case in checks.cases(MAIN_N, m, dtype, "cuda"):
                before = cuda.LAUNCHES[case.name]
                res = checks.compare(case)
                row = {"phase": "kernels", "name": case.name,
                       "dtype": str(dtype).removeprefix("torch."),
                       "n": MAIN_N, "m": m, **res,
                       "launches": cuda.LAUNCHES[case.name] - before}
                emit(row)
                rows[case.name, row["dtype"], m] = row
    return rows


def timing_phase(torch, checks) -> dict:
    """Each kernel's time beside its plain version's, one library call's
    and its bound, at the shapes of the kernel phase.  Runs after the
    service, so the profiler (CUPTI) is never attached while the main path
    is timed.  ``ms``, ``plain_ms`` and ``library_ms`` are device time per
    call (the profiler's CUDA activity records); the ``*call_ms`` twins
    time whole calls between CUDA events, the wrapper's host work
    included."""
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for m in (MAIN_M, 300):
            for case in checks.cases(MAIN_N, m, dtype, "cuda"):
                ms, per_call = checks.device_ms(case.kernel)
                plain_ms, plain_per_call = checks.device_ms(case.plain)
                bound_ms, bound_by = case.bound(dtype)
                row = {"phase": "timing", "name": case.name,
                       "dtype": str(dtype).removeprefix("torch."),
                       "n": MAIN_N, "m": m, "ms": ms,
                       "device_launches_per_call": per_call,
                       "call_ms": checks.call_ms(case.kernel),
                       "plain_ms": plain_ms,
                       "plain_device_launches_per_call": plain_per_call,
                       "plain_call_ms": checks.call_ms(case.plain),
                       "library_ms": (checks.device_ms(case.library)[0]
                                      if case.library else None),
                       "library_call_ms": (checks.call_ms(case.library)
                                           if case.library else None),
                       "bound_ms": bound_ms, "bound_by": bound_by}
                emit(row)
                rows[case.name, row["dtype"], m] = row
    return rows


def oracle_check(torch, stream, dtype_name: str) -> dict:
    """Top-8 eigenpairs of the stream against eigh of the batch gram."""
    from repro_torch.core import batch, kernels_fn as kf

    top = 8
    m = stream.m
    X = stream.state.X[:m].double()
    K = kf.gram_block(X, X, spec=stream.spec)
    lam_ref, vec_ref = batch.batch_kpca(K, adjusted=True)
    lam_ref, vec_ref = lam_ref.flip(0)[:top], vec_ref.flip(1)[:, :top]
    lam, vec = stream.eigpairs()
    lam, vec = lam[:top].double(), vec[:m, :top].double()
    rel = float(((lam - lam_ref).abs() / lam_ref.abs()).max())
    cos = float(torch.linalg.svdvals(vec_ref.T @ vec).min())
    bar_rel, bar_cos = BARS[dtype_name]
    if not (rel <= bar_rel and cos >= bar_cos):
        raise AssertionError(f"{dtype_name} final state off the eigh oracle: "
                             f"eigenvalue rel err {rel:.3e} (bar {bar_rel}), "
                             f"subspace min cos {cos:.9f} (bar {bar_cos})")
    return {"top8_eig_rel_err": rel, "top8_subspace_min_cos": cos,
            "bar_rel_err": bar_rel, "bar_min_cos": bar_cos}


def service_phase(torch, cuda, serve, capacity: int, points: int,
                  dtype_name: str) -> dict:
    """The main path through its entry point, with the launch counts read
    around it and checked against the reckoning."""
    args = serve.parse_args([
        "--mode", "kpca", "--device", "cuda", "--dtype", dtype_name,
        "--capacity", str(capacity), "--points", str(points),
        "--dim", "16", "--batch", "64", "--transform-every", "16"])
    cuda.reset_launches()
    result, stream = serve.kpca_service(args)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    expect = {"eigvec_rotate": 4 * points, "krow_project": points,
              "eigvec_project": points,
              "transform_project": points // args.transform_every}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    if not (result["finite"] and torch.isfinite(stream.state.U).all()):
        raise AssertionError("non-finite state")
    if result["m_final"] != 4 + points:
        raise AssertionError(f"m_final {result['m_final']} != {4 + points}")
    keep = ("m_final", "finite", "update_ms_p50", "update_ms_p90",
            "update_ms_p99", "update_ms_max", "update_ms_compile_ms",
            "query_ms_p50", "query_ms_p90", "query_ms_p99", "query_ms_max",
            "transforms_served", "total_s")
    row = {"phase": "service", "dtype": dtype_name, "capacity": capacity,
           "points": points, **{k: result[k] for k in keep},
           "launches": launches,
           **oracle_check(torch, stream, dtype_name)}
    emit(row)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    from repro_torch.kernels import checks, cuda
    from repro_torch.launch import serve

    resolve_device("cuda")        # pins TF32 off for every product below
    t0 = time.perf_counter()
    info = cuda.build()
    cuda.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"], "cached": info["cached"],
          "ptxas_registers": ptxas_summary(info.get("ptxas", {}))})

    checked = kernel_phase(torch, checks, cuda)
    f32 = service_phase(torch, cuda, serve, 1024, 1000, "float32")
    service_phase(torch, cuda, serve, 256, 200, "float64")
    timed = timing_phase(torch, checks)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kernels = []
    for name, (source, replaces) in checks.SOURCES.items():
        key = (name, "float32", MAIN_M)
        r = timed[key]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": f32["launches"][name],
                        "max_abs_err": checked[key]["max_abs_err"],
                        "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
