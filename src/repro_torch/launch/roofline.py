"""Kernel roofline of the port: each CUDA kernel's achieved memory rate
beside a STREAM triad measured on the card, and the fused-against-unfused
times of one ingest and one query batch.

The counterpart of the reference's ``benchmarks/roofline.py``, at its
shapes (M = 1024, d = 64, Q = 512, C = 64, float32, all M points active)
and with its byte and operation models: each row counts the bytes the call
must move (operands in, results out, once) and its useful operations.
The peak is measured, not quoted: a triad a = b + 1.5·c over float32
arrays of 1 << 24 entries (64 MB each, beyond the 50 MB L2) gives the
card's reachable rate, and each row reports its rate as a fraction of it
and its operation rate as a fraction of the data sheet's peak for its
route (``peak_flops``): 67 TFLOP/s, or 495 TFLOP/s for
``nystrom_recon``, whose float32 runs on TF32 products on the tensor
cores (``rbf_gram``'s float32 runs on the CUDA cores).  The two grams
count their work as ``kernels/checks.py``'s cases do: one
triangle of the symmetric output, its operand read once.

Rows, by the reference driver's names: ``eigvec_rotate``,
``eigvec_rotate2``, ``rbf_gram``, ``krow_fused`` (``krow_project``),
``eigvec_project``, ``transform_batch`` (``transform_project``: C = 64 in
one launch) and ``nystrom_recon`` (``scaled_gram``).  The rotations take
their roots in offset form, so their operands are a solved factor as
``kernels/checks.py`` builds it for the main path.  On the card ``ms`` is device time (profiler records,
``checks.device_ms``) and ``call_ms`` a whole call's time between CUDA
events; with ``--device cpu`` the rows time the plain versions by the
wall clock, for the tests, and name no device rate.

The second part times one Algorithm-2 ingest and one 64-query transform at
m = 128 in a capacity-1024 stream, unfused at fixed capacity, unfused
bucketed and fused bucketed, by the wall clock around work that ends in a
synchronisation; it warns, as the reference does, where a speed-up is
below 1.5×.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--smoke]
        [--device cpu]

The CLI writes ``BENCH_torch_roofline.json`` at the repository root,
naming the card and its power limit.  ``--smoke`` runs toy sizes, writes
nothing, and exits non-zero on a non-finite output or a non-positive
rate.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine as eng, inkpca, kernels_fn as kf
from repro_torch.kernels import checks
from repro_torch.kernels.eigvec_update import ops as eops
from repro_torch.kernels.nystrom_recon import ops as nops
from repro_torch.kernels.rbf_gram import ops as kops

OUT_PATH = Path(__file__).resolve().parents[3] / "BENCH_torch_roofline.json"
F32 = 4
PEAK_FLOPS = checks.PEAK_FLOPS[torch.float32]


def _finite(out) -> bool:
    if isinstance(out, (tuple, list)):
        return all(_finite(o) for o in out)
    return bool(torch.isfinite(out).all())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _wall_ms(fn, reps: int, device: torch.device) -> float:
    """Mean wall-clock ms per call after one warm-up call, the device
    synchronised at both ends."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def _times(fn, reps: int, device: torch.device
           ) -> tuple[float, float | None, int]:
    """(ms, call_ms, calls): device time per call and the event-timed
    whole call on the card, the wall clock and None on the CPU; and how
    many times ``fn`` was called (the launch reckoning's count: the
    profiler may take its records more than once)."""
    calls = 0

    def counted():
        nonlocal calls
        calls += 1
        return fn()

    out = counted()
    _sync(device)
    if not _finite(out):
        raise SystemExit("[roofline] non-finite kernel output")
    if device.type == "cuda":
        return (checks.device_ms(counted, reps=reps)[0],
                checks.call_ms(counted, reps=reps), calls)
    return _wall_ms(counted, reps, device), None, calls


def peak_bandwidth(n: int, reps: int, device: torch.device
                   ) -> tuple[float, int]:
    """STREAM triad a = b + 1.5·c: (reachable GB/s, bytes per pass)."""
    b = torch.ones(n, dtype=torch.float32, device=device)
    c = torch.full((n,), 0.5, dtype=torch.float32, device=device)
    a = torch.empty_like(b)
    ms, _, _ = _times(lambda: torch.add(b, c, alpha=1.5, out=a), reps,
                      device)
    nbytes = 3 * n * F32                       # read b, read c, write a
    return nbytes / (ms * 1e-3) / 1e9, nbytes


def _row(name: str, ms: float, call_ms: float | None, calls: int,
         nbytes: float, flops: float, peak_gbps: float,
         peak_flops: float) -> dict:
    gbps = nbytes / (ms * 1e-3) / 1e9
    return {"kernel": name, "ms": ms, "call_ms": call_ms, "calls": calls,
            "bytes": nbytes, "flops": flops,
            "ai_flop_per_byte": flops / nbytes,
            "gbps": gbps, "peak_gbps": peak_gbps,
            "frac_of_peak": gbps / peak_gbps,
            "gflops": flops / (ms * 1e-3) / 1e9,
            "peak_flops": peak_flops,
            "frac_of_peak_flops": flops / (ms * 1e-3) / peak_flops}


def kernel_rows(M: int, d: int, Q: int, C: int, reps: int,
                peak_gbps: float, device: torch.device) -> list[dict]:
    """One row per port kernel at the reference driver's shapes (f32)."""
    rng = np.random.default_rng(0)
    f32 = torch.float32

    def normal(*shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale, dtype=f32,
                               device=device)

    spec = kf.KernelSpec(name="rbf", sigma=float(d))
    u = normal(M, M, scale=1 / np.sqrt(M))
    x = normal(M, d)
    xq = normal(Q, d)
    x_new = normal(d)
    s_cols = normal(M, C)
    s_diag = torch.as_tensor(rng.uniform(0.5, 1.5, size=M), dtype=f32,
                             device=device)
    b_rows = normal(Q, M)
    aux = torch.stack([torch.ones(M, dtype=f32, device=device),
                       normal(M)], dim=1)
    vpair = normal(M, 2)
    m_full = torch.tensor(M, dtype=torch.int32, device=device)
    solved = {c.name: c for c in checks.cases(M, M, f32, device)
              if not c.variant}
    # The two grams' work and peak as ``checks`` counts them: one triangle
    # (the operand read once), at the peak of each one's route.
    rbf = checks.rbf_gram_case(x, x, spec.sigma)
    recon = checks.scaled_gram_case(b_rows, s_diag)
    calls = [
        ("eigvec_rotate", solved["eigvec_rotate"].kernel,
         (2 * M * M + 4 * M) * F32, 2 * M**3 + 3 * M * M, PEAK_FLOPS),
        ("eigvec_rotate2", solved["eigvec_rotate2"].kernel,
         (2 * M * M + 12 * M) * F32, 4 * M**3 + 6 * M * M, PEAK_FLOPS),
        ("rbf_gram", rbf.kernel, rbf.bytes, rbf.flops,
         rbf.peak or PEAK_FLOPS),
        ("krow_fused", lambda: kops.krow_project(u, x, x_new, aux, m_full,
                                                 spec=spec),
         (M * M + M * d + 2 * M + M + 3 * M) * F32,
         2 * M * d + 3 * M + 6 * M * M, PEAK_FLOPS),
        ("eigvec_project", lambda: eops.project_vectors(u, vpair, m_full),
         (M * M + 2 * M + 2 * M) * F32, 4 * M * M, PEAK_FLOPS),
        ("transform_batch",
         lambda: nops.transform_project(xq, x, s_cols, m_full, spec=spec),
         (Q * d + M * d + M * C + Q * C + Q) * F32,
         2 * Q * M * (d + C) + 3 * Q * M, PEAK_FLOPS),
        ("nystrom_recon", recon.kernel, recon.bytes, recon.flops,
         recon.peak or PEAK_FLOPS),
    ]
    return [_row(name, *_times(fn, reps, device), nbytes, flops, peak_gbps,
                 peak_flops)
            for name, fn, nbytes, flops, peak_flops in calls]


# The wrapper (``cuda.LAUNCHES`` key) behind each row whose name, the
# reference's, differs from it.
ROW_KERNELS = {"krow_fused": "krow_project",
               "transform_batch": "transform_project",
               "nystrom_recon": "scaled_gram"}


def launch_reckoning(result: dict, names) -> dict:
    """The kernel launches a run of ``main`` makes, by wrapper (``names``:
    every counted wrapper): one per call of each row's function, and per
    fused ingest one ``krow_project`` and one ``eigvec_project``, per
    fused transform one ``transform_project`` (C = min(16, m) in one
    launch)."""
    expect = dict.fromkeys(names, 0)
    for r in result["kernels"]:
        expect[ROW_KERNELS.get(r["kernel"], r["kernel"])] += r["calls"]
    fused = result["fused"]["fused_calls"]
    for name in ("krow_project", "eigvec_project", "transform_project"):
        expect[name] += fused
    return expect


def _state_at(m: int, capacity: int, d: int, spec, device
              ) -> inkpca.KPCAState:
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32,
                        device=device)
    state = inkpca.init_state(X[:4], capacity, spec, adjusted=True,
                              dtype=torch.float32)
    return eng.Engine(spec, eng.DEFAULT_PLAN._replace(
        dispatch="bucketed")).update_block(state, X[4:])


def fused_comparison(capacity: int, m: int, d: int, q_batch: int,
                     reps: int, device: torch.device) -> dict:
    """Fused against unfused at m active points in a capacity-M stream
    (f32), by the wall clock.  The transform takes min(16, m) components,
    as the reference's does.  ``fused_calls`` is how many times each fused
    spelling ran (one ``krow_project`` and one ``eigvec_project`` launch
    an ingest, one ``transform_project`` launch a transform)."""
    rng = np.random.default_rng(2)
    spec = kf.KernelSpec(name="rbf", sigma=float(d))
    state = _state_at(m, capacity, d, spec, device)
    x_new = torch.as_tensor(rng.normal(size=d), dtype=torch.float32,
                            device=device)
    q = torch.as_tensor(rng.normal(size=(q_batch, d)), dtype=torch.float32,
                        device=device)
    plan_fused = eng.UpdatePlan(matmul="jnp2", dispatch="bucketed",
                                fuse_krow=True)
    engines = {name: eng.Engine(spec, plan, adjusted=True)
               for name, plan in (
                   ("unfused_fixed", eng.UpdatePlan(matmul="jnp",
                                                    dispatch="fixed")),
                   ("unfused_bucketed", eng.UpdatePlan(matmul="jnp",
                                                       dispatch="bucketed")),
                   ("fused_bucketed", plan_fused))}
    ingest = {name: _wall_ms(lambda e=e: e.update(state, x_new, m=m).L,
                             reps, device)
              for name, e in engines.items()}
    n_comp = min(16, m)
    Mb = eng.bucket_for(m, capacity, plan_fused.min_bucket)
    sub = eng.slice_state(state, Mb) if Mb < capacity else state
    transform = {
        "unfused_fixed": _wall_ms(lambda: eng.transform_state(
            state, q, spec=spec, adjusted=True, n_components=n_comp),
            reps, device),
        "fused_bucketed": _wall_ms(lambda: eng.transform_state(
            sub, q, spec=spec, adjusted=True, n_components=n_comp,
            plan=plan_fused), reps, device),
    }
    return {"capacity": capacity, "m": m, "dim": d, "q_batch": q_batch,
            "n_components": n_comp, "bucket": Mb, "fused_calls": 1 + reps,
            "ingest_ms": ingest, "transform_ms": transform,
            "ingest_speedup_fused":
                ingest["unfused_fixed"] / ingest["fused_bucketed"],
            "transform_speedup_fused":
                transform["unfused_fixed"] / transform["fused_bucketed"]}


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(smoke: bool = False, device=None, out: Path | None = OUT_PATH
         ) -> dict:
    """Run the roofline; write ``out`` unless it is None or ``smoke``."""
    device = resolve_device(device)
    M, d, Q, C, reps = 1024, 64, 512, 64, 25
    triad_n, cap, m_at, q_batch = 1 << 24, 1024, 128, 64
    if smoke:
        M, d, Q, C, reps, triad_n = 128, 16, 64, 16, 1, 1 << 20
        cap, m_at, q_batch = 128, 16, 8
    timer = ("device time (profiler records)" if device.type == "cuda"
             else "wall clock")

    peak_gbps, triad_bytes = peak_bandwidth(triad_n, max(reps, 3), device)
    card = card_name(device)
    print(f"[roofline] STREAM-triad peak: {peak_gbps:.1f} GB/s "
          f"({triad_bytes / 1e6:.0f} MB per pass) on {card}, {timer}")
    rows = kernel_rows(M, d, Q, C, reps, peak_gbps, device)
    print(f"[roofline] per kernel at M={M}, d={d}, Q={Q}, C={C} (f32)")
    print(f"{'kernel':>16s} {'ms':>9s} {'call ms':>9s} {'GB/s':>8s} "
          f"{'triad%':>7s} {'AI f/B':>7s} {'GFLOP/s':>9s} {'peak%':>6s}")
    for r in rows:
        call = "-" if r["call_ms"] is None else f"{r['call_ms']:9.4f}"
        print(f"{r['kernel']:>16s} {r['ms']:9.4f} {call:>9s} "
              f"{r['gbps']:8.1f} {100 * r['frac_of_peak']:6.1f}% "
              f"{r['ai_flop_per_byte']:7.1f} {r['gflops']:9.1f} "
              f"{100 * r['frac_of_peak_flops']:5.2f}%")
    fused = fused_comparison(cap, m_at, d, q_batch, max(reps // 5, 1),
                             device)
    print(f"[roofline] fused-vs-unfused at m={fused['m']}, "
          f"M={fused['capacity']} (bucket {fused['bucket']}): "
          f"ingest {fused['ingest_speedup_fused']:.2f}x, "
          f"transform {fused['transform_speedup_fused']:.2f}x")
    if min(fused["ingest_speedup_fused"],
           fused["transform_speedup_fused"]) < 1.5:
        print("[roofline] WARNING: fused speedup below the 1.5x gate")

    result = {"device": card, "timer": timer, "dtype": "float32",
              "reps": reps, "peak_gbps": peak_gbps,
              "triad_bytes": triad_bytes, "peak_flops": PEAK_FLOPS,
              "kernels": rows, "fused": fused,
              "ingest_speedup_fused": fused["ingest_speedup_fused"],
              "transform_speedup_fused": fused["transform_speedup_fused"]}
    if smoke:
        bad = [r["kernel"] for r in rows
               if not (np.isfinite(r["gbps"]) and r["gbps"] > 0)]
        if bad or not np.isfinite(peak_gbps) or peak_gbps <= 0:
            raise SystemExit(f"[roofline] smoke gate failed: "
                             f"{bad or 'triad'}")
        print("[roofline] smoke OK (finite, rate > 0), nothing written")
        return result
    if out is not None:
        Path(out).write_text(json.dumps(result, indent=2) + "\n")
        print(f"[roofline] wrote {out}")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="toy sizes, nothing written, non-zero exit on a "
                         "non-finite output or a non-positive rate")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions, "
                         "wall clock)")
    args = ap.parse_args()
    main(smoke=args.smoke, device=args.device)
