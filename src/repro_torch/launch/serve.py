"""Streaming services of the port.

* ``--mode kpca``: incremental-KPCA ingest + transform.  Points arrive one
  at a time; each is folded into the eigendecomposition (Algorithm 2) and
  every ``--transform-every`` points a batch of ``--batch`` queries is
  projected on the current principal components.
* ``--mode nystrom``: the incremental Nyström landmark service (paper §4,
  grow_rows): each point becomes an observed row and is offered as a
  landmark; ``--landmark-policy append`` admits every offer until the
  budget fills (Algorithm 1 per admission).  It reports the final
  ``trace_error`` and the admission counts.

The plan's defaults are the port's main path: the rotation kernel
(``--matmul pallas``; ``pallas2`` fuses each ±sigma pair into one
rotation), the fused kernel-row prologue and query transform
(``--fuse-krow``; ``--no-fuse-krow`` turns them off) and bucketed dispatch.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode kpca \\
        --capacity 1024 --points 1000 --batch 64 --matmul pallas2
    PYTHONPATH=src python -m repro_torch.launch.serve --mode kpca \\
        --device cpu --capacity 64 --points 40 --dim 8
    PYTHONPATH=src python -m repro_torch.launch.serve --mode nystrom \\
        --device cpu --capacity 64 --points 80 --dim 8 --matmul pallas2

Update and query latencies go into separate histograms; the first sample
per bucket rung (per component count for queries) is reported apart as
warm-up.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine as eng
from repro_torch.core import inkpca, kernels_fn as kf, nystrom
from repro_torch.obs import LatencyHistogram

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def make_plan(args) -> eng.UpdatePlan:
    return eng.UpdatePlan(matmul=args.matmul, dispatch=args.dispatch,
                          window=args.window, fuse_krow=args.fuse_krow,
                          landmark_policy=args.landmark_policy,
                          health=True if args.health else None,
                          metrics=args.metrics)


def kpca_service(args) -> tuple[dict, inkpca.KPCAStream]:
    """Run the service loop; returns the result dict and the stream."""
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    rng = np.random.default_rng(args.seed)
    d = args.dim
    x0 = torch.as_tensor(rng.normal(size=(4, d)), dtype=dtype, device=device)
    spec = kf.KernelSpec(name="rbf", sigma=float(d))
    plan = make_plan(args)
    stream = inkpca.KPCAStream(x0, args.capacity, spec, adjusted=True,
                               plan=plan, dtype=dtype, device=device)

    upd, qry = LatencyHistogram("update_ms"), LatencyHistogram("query_ms")
    n_served = 0
    t_total = time.perf_counter()
    for i in range(args.points):
        # Drawn point by point, interleaved with the queries, as the
        # reference driver draws them: one seed gives both the same data.
        x = torch.as_tensor(rng.normal(size=(d,)), dtype=dtype, device=device)
        rung = (eng.bucket_for(stream.m + 1, args.capacity, plan.min_bucket)
                if args.dispatch == "bucketed" else -1)
        with upd.timed(key=rung) as t:
            t.sync(stream.update(x).L)
        if (i + 1) % args.transform_every == 0:
            q = torch.as_tensor(rng.normal(size=(args.batch, d)),
                                dtype=dtype, device=device)
            n_comp = min(8, stream.m)
            with qry.timed(key=n_comp) as t:
                t.sync(stream.transform(q, n_components=n_comp))
            n_served += args.batch
    t_total = time.perf_counter() - t_total

    st = stream.state
    result = {
        "mode": "kpca", "dispatch": args.dispatch, "capacity": args.capacity,
        "window": args.window, "points": args.points,
        "m_final": int(st.m),
        **upd.summary("update_ms"),
        **qry.summary("query_ms"),
        "transforms_served": n_served,
        "total_s": t_total,
        "finite": bool(torch.isfinite(st.L).all()),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "dtype": args.dtype,
    }
    return result, stream


def kpca_main(args) -> dict:
    result, _ = kpca_service(args)
    print(f"[serve/kpca] {args.dispatch}: {args.points} updates to "
          f"m={result['m_final']} (capacity {args.capacity}) on "
          f"{result['device']}, update p50 {result['update_ms_p50']:.3f} ms, "
          f"query p50 {result['query_ms_p50']:.3f} ms  {result}")
    return result


def nystrom_service(args) -> tuple[dict, nystrom.NystromState]:
    """The landmark service loop (grow_rows, RBF with sigma = d,
    Algorithm 1 per admission); returns the result dict and the state.
    Counters are a plain dict."""
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    rng = np.random.default_rng(args.seed)
    d = args.dim
    spec = kf.KernelSpec(name="rbf", sigma=float(d))
    engine = eng.Engine(spec, make_plan(args), adjusted=False)
    x0 = torch.as_tensor(rng.normal(size=(4, d)), dtype=dtype, device=device)
    state = nystrom.init_nystrom(None, x0, args.capacity, spec, dtype=dtype,
                                 grow_rows=True)
    budget = args.landmark_budget or args.capacity - 1
    counts = {"admitted": 0, "rejected": 0}
    step = LatencyHistogram("step_ms")
    t_total = time.perf_counter()
    for _ in range(args.points):
        x = torch.as_tensor(rng.normal(size=(d,)), dtype=dtype, device=device)
        m = int(state.kpca.m)
        rung = (eng.bucket_for(min(m + 1, args.capacity), args.capacity,
                               engine.plan.min_bucket)
                if args.dispatch == "bucketed" else -1)
        with step.timed(key=rung) as t:
            state = nystrom.observe_rows(state, x, spec, plan=engine.plan)
            state, action = engine.offer_landmark(state, x, budget=budget)
            t.sync(state.Knm)
        counts[action] += 1
    t_total = time.perf_counter() - t_total

    err = float(nystrom.trace_error(state, spec))
    result = {
        "mode": "nystrom", "policy": args.landmark_policy,
        "capacity": args.capacity, "budget": budget, "points": args.points,
        "m_final": int(state.kpca.m), "rows": int(state.Knm.shape[0]),
        "trace_error": err, "total_s": t_total,
        "finite": bool(torch.isfinite(state.kpca.L).all()
                       and np.isfinite(err)),
        **step.summary("step_ms"), **counts,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "dtype": args.dtype,
    }
    return result, state


def nystrom_main(args) -> dict:
    result, _ = nystrom_service(args)
    print(f"[serve/nystrom] {args.landmark_policy}: {args.points} points, "
          f"{result['admitted']} admitted / {result['rejected']} rejected "
          f"-> m={result['m_final']} on {result['device']}, trace err "
          f"{result['trace_error']:.4f}  {result}")
    return result


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("kpca", "nystrom"), default="kpca")
    ap.add_argument("--batch", type=int, default=4,
                    help="queries per transform batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--points", type=int, default=100)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--dispatch", choices=("fixed", "bucketed"),
                    default="bucketed")
    ap.add_argument("--matmul", default="pallas",
                    choices=("jnp", "pallas", "jnp2", "pallas2"),
                    help="rotation route: 'pallas' is the CUDA kernel, "
                         "'jnp' the dense product; 'pallas2'/'jnp2' fuse "
                         "each ±sigma pair into one rotation")
    ap.add_argument("--transform-every", type=int, default=16)
    ap.add_argument("--fuse-krow", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fused kernel-row prologue and query transform")
    ap.add_argument("--window", type=int, default=None,
                    help="sliding window (not ported yet: raises)")
    ap.add_argument("--health", action="store_true",
                    help="health lane (not ported yet: raises)")
    ap.add_argument("--metrics", action="store_true",
                    help="metrics lane (not ported yet: raises)")
    ap.add_argument("--landmark-policy", choices=("append", "leverage"),
                    default="append",
                    help="nystrom mode admission policy ('leverage' is not "
                         "ported yet: raises)")
    ap.add_argument("--landmark-budget", type=int, default=None,
                    help="nystrom mode: most landmarks (default capacity - 1)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return nystrom_main(args) if args.mode == "nystrom" else kpca_main(args)


if __name__ == "__main__":
    main()
