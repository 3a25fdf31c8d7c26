"""Serving drivers of the port.

* ``--mode lm``: the LM decode loop with KV and recurrent caches, as the
  reference's ``serve --mode lm``: the prompt is fed through teacher-forced
  decode steps (cache warm-up), then ``--gen`` tokens are decoded greedily.
  Parameters are drawn from ``--seed`` on the device; ``--smoke`` takes
  the architecture's reduced config.

      PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
          --device cpu --arch jamba_1_5_large_398b --smoke

  The port runs an architecture with experts with ``moe=None``: every
  layer takes its dense FFN (``configs``; the experts are ROADMAP.md §1
  item 11).

* ``--mode kpca``: incremental-KPCA ingest + transform.  Points arrive one
  at a time; each is folded into the eigendecomposition (Algorithm 2) and
  every ``--transform-every`` points a batch of ``--batch`` queries is
  projected on the current principal components.
  ``--window W`` makes the stream a sliding window over the trailing W
  points: past a full window each point first evicts the oldest one
  through the decremental pipeline (``core/downdate.py``), so the service
  runs on an unbounded stream in bounded memory.
  ``--tenants B`` serves B independent streams as one ``StreamBatch``:
  each step folds a point into every tenant with each kernel launched once
  for the cohort; ``--cohorts bucket`` groups the tenants by their own
  bucket, ``bucket-padded`` pads each group to a power of two (the
  reference's geometries).  ``--decouple`` and ``--mesh`` are accepted and
  raise: they wait for ROADMAP.md items 6 and 10.
* ``--mode nystrom``: the incremental Nyström landmark service (paper §4,
  grow_rows): each point becomes an observed row and is offered as a
  landmark.  ``--landmark-policy append`` admits every offer until the
  budget fills (Algorithm 1 per admission); ``leverage`` admits a point
  whose projection residual is not yet spanned, swaps out the
  lowest-leverage landmark once the budget is full, and stops offering
  once the tracked trace error has improved by less than
  ``--stop-rel-tol`` for ``--stop-patience`` admissions in a row (the
  sufficient-subset rule).  It reports the final ``trace_error``, the
  admitted / replaced / rejected counts, ``stopped_at`` and, while the
  tracker ran, its drift from the recomputed trace error.

``--health`` attaches the default health policy: every point goes
through the quarantine gate (a non-finite point is rejected before the
rank-one pairs fire and leaves the state bit for bit) and a probe, and at
each transform interval an unhealthy stream walks the heal ladder
(``core/health.py``); the Nyström service drops non-finite rows.
``--metrics`` attaches the in-stream metric lane (``core/telemetry.py``),
mirrored into the telemetry hub at the end; ``--metrics-jsonl PATH``
writes the hub's events and a final scrape, ``--metrics-port P`` serves
``GET /metrics`` during the run (both imply ``--metrics``).
Faults are injected through the service functions' ``on_point`` seam
(``kpca_service``, ``nystrom_service``), not from the command line.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode kpca \\
        --device cpu --capacity 64 --points 40 --dim 8 --health --metrics

The plan's defaults are the port's main path: the rotation kernel
(``--matmul pallas``; ``pallas2`` fuses each ±sigma pair into one
rotation), the fused kernel-row prologue and query transform
(``--fuse-krow``; ``--no-fuse-krow`` turns them off) and bucketed dispatch.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode kpca \\
        --capacity 1024 --points 1000 --batch 64 --matmul pallas2
    PYTHONPATH=src python -m repro_torch.launch.serve --mode kpca \\
        --device cpu --capacity 64 --points 40 --dim 8
    PYTHONPATH=src python -m repro_torch.launch.serve --mode kpca \\
        --device cpu --capacity 64 --window 24 --points 60 --dim 8
    PYTHONPATH=src python -m repro_torch.launch.serve --mode kpca \\
        --device cpu --tenants 3 --cohorts bucket --capacity 32 \\
        --points 20 --dim 4
    PYTHONPATH=src python -m repro_torch.launch.serve --mode nystrom \\
        --device cpu --capacity 64 --points 80 --dim 8 --matmul pallas2
    PYTHONPATH=src python -m repro_torch.launch.serve --mode nystrom \\
        --device cpu --landmark-policy leverage --stop-rel-tol 1e-2 \\
        --stop-patience 3 --capacity 64 --landmark-budget 32 \\
        --points 200 --dim 8

Update and query latencies go into separate histograms; the first sample
per bucket rung (per component count for queries) is reported apart as
warm-up.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, obs, resolve_device
from repro_torch.core import engine as eng
from repro_torch.core import health as hl
from repro_torch.core import inkpca, kernels_fn as kf, nystrom
from repro_torch.core import telemetry as tm
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.obs import LatencyHistogram

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def make_plan(args) -> eng.UpdatePlan:
    # Any export surface implies the metric lane.
    metrics = bool(args.metrics or args.metrics_jsonl
                   or args.metrics_port is not None)
    return eng.UpdatePlan(matmul=args.matmul, dispatch=args.dispatch,
                          window=args.window, fuse_krow=args.fuse_krow,
                          landmark_policy=args.landmark_policy,
                          health=hl.DEFAULT_POLICY if args.health else None,
                          metrics=metrics)


def export_metrics(args, hub) -> None:
    """Write the hub out where ``--metrics-jsonl`` asks (the
    ``--metrics-port`` server runs from ``main`` for the whole run)."""
    if args.metrics_jsonl:
        hub.close_jsonl()
        obs.write_jsonl(args.metrics_jsonl, hub)


def kpca_draws(args):
    """(x0, draws): the service's numpy inputs from ``--seed``, in the
    reference driver's order — the 4 seed points, then for each streamed
    point the point and, every ``--transform-every`` points, the query
    batch drawn after it (else None)."""
    rng = np.random.default_rng(args.seed)
    x0 = rng.normal(size=(4, args.dim))

    def draws():
        for i in range(args.points):
            x = rng.normal(size=(args.dim,))
            q = (rng.normal(size=(args.batch, args.dim))
                 if (i + 1) % args.transform_every == 0 else None)
            yield x, q

    return x0, draws()


def kpca_service(args, on_point=None) -> tuple[dict, inkpca.KPCAStream]:
    """Run the service loop; returns the result dict and the stream.  With
    ``--window`` the update latencies are also split by phase: growth
    (m < W, append-only) and steady state (evict + ingest).

    Under ``--health`` the heal check rides the transform interval: one
    read of the last probe's verdict, and the heal ladder when it fails.
    The active count is tracked on the host as bounds (a guarded point
    may be rejected on the device), so the loop reads m back only where
    the bounds disagree.  ``on_point(i, stream, x)``, when given, is
    called before each update with the point about to be offered and
    returns the point to offer (a testing seam: it may also corrupt
    ``stream.state``)."""
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    d = args.dim
    x0, draws = kpca_draws(args)
    spec = kf.KernelSpec(name="rbf", sigma=float(d))
    plan = make_plan(args)
    stream = inkpca.KPCAStream(torch.as_tensor(x0, dtype=dtype,
                                               device=device),
                               args.capacity, spec, adjusted=True,
                               plan=plan, dtype=dtype, device=device)

    hub = obs.fresh_hub()
    upd, qry = hub.histogram("update_ms"), hub.histogram("query_ms")
    phases = {"growth": LatencyHistogram(), "steady": LatencyHistogram()}
    n_served = n_heals = 0
    t_total = time.perf_counter()
    for i, (x, q) in enumerate(draws):
        if on_point is not None:
            x = on_point(i, stream, x)
        x = torch.as_tensor(x, dtype=dtype, device=device)
        lo, hi = stream.m_bounds
        steady = args.window is not None and (
            lo >= args.window or (hi >= args.window
                                  and stream.m >= args.window))
        need = args.window if steady else min(hi + 1, args.capacity)
        rung = (eng.bucket_for(need, args.capacity, plan.min_bucket)
                if args.dispatch == "bucketed" else -1)
        with upd.timed(key=rung) as t:
            stream.update(x)
            t.sync(stream.kpca_state.L)
        phases["steady" if steady else "growth"].add(upd.last_ms, key=rung)
        if q is not None:
            if args.health and not stream.is_healthy():
                stream.heal()
                n_heals += 1
                hub.inc("heals_total")
            q = torch.as_tensor(q, dtype=dtype, device=device)
            n_comp = 8 if stream.m_bounds[0] >= 8 else min(8, stream.m)
            with qry.timed(key=n_comp) as t:
                t.sync(stream.transform(q, n_components=n_comp))
            n_served += args.batch
    t_total = time.perf_counter() - t_total

    st = stream.kpca_state
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
    if args.window is not None:
        for name, hist in phases.items():
            result.update(hist.summary(f"{name}_update_ms"))
            result[f"{name}_points"] = len(hist.ms) + len(hist.compile_ms)
    if args.health:
        result["heals"] = n_heals
        result["health"] = stream.health_report()
        result["quarantined"] = result["health"]["quarantined"]
    if stream.metrics is not None:
        result["metrics"] = hub.observe_metrics_state(stream.metrics)
    export_metrics(args, hub)
    return result, stream


def kpca_main(args) -> dict:
    result, _ = kpca_service(args)
    print(f"[serve/kpca] {args.dispatch}: {args.points} updates to "
          f"m={result['m_final']} (capacity {args.capacity}) on "
          f"{result['device']}, update p50 {result['update_ms_p50']:.3f} ms, "
          f"query p50 {result['query_ms_p50']:.3f} ms  {result}")
    return result


def multitenant_draws(args):
    """(x0, steps): the multi-tenant service's numpy inputs from
    ``--seed``, in the reference service's order — the (B, 4, d) seeds,
    then for each step the (B, d) points and, every ``--transform-every``
    steps, the (B, batch, d) queries drawn after them (else None)."""
    rng = np.random.default_rng(args.seed)
    B, d = args.tenants, args.dim
    x0 = rng.normal(size=(B, 4, d))
    steps = []
    for i in range(args.points):
        xs = rng.normal(size=(B, d))
        q = (rng.normal(size=(B, args.batch, d))
             if (i + 1) % args.transform_every == 0 else None)
        steps.append((xs, q))
    return x0, steps


def kpca_multitenant_service(args, on_step=None
                             ) -> tuple[dict, eng.StreamBatch]:
    """B independent tenant streams through one ``StreamBatch``: one
    batched step per point (per occupied bucket under grouped cohorts).
    The points move to the card in one copy before the loop, so a step
    reads nothing back but at a bucket crossing; under ``--health`` each
    step's points go as numpy to the quarantine gate's host check.
    ``on_step(i, batch, xs)``, when given, returns the (B, d) points to
    offer at step i (a testing seam).  Returns the result dict (the
    reference service's keys) and the cohort."""
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    B, d = args.tenants, args.dim
    spec = kf.KernelSpec(name="rbf", sigma=float(d))
    plan = make_plan(args)
    x0, steps = multitenant_draws(args)
    batch = eng.StreamBatch(torch.as_tensor(x0, dtype=dtype, device=device),
                            args.capacity, spec, plan=plan, adjusted=True,
                            dtype=dtype, cohorts=args.cohorts,
                            window=args.window, device=device)
    gated = plan.health is not None and plan.health.quarantine
    points = (None if gated or on_step is not None else torch.as_tensor(
        np.stack([xs for xs, _ in steps]), dtype=dtype, device=device))

    hub = obs.fresh_hub()
    upd, qry = hub.histogram("step_ms"), hub.histogram("query_ms")
    n_served = 0
    t_total = time.perf_counter()
    for i, (xs, q) in enumerate(steps):
        if on_step is not None:
            xs = on_step(i, batch, xs)
        rungs = tuple(sorted({
            batch._tenant_bucket(int(m)) if args.dispatch == "bucketed"
            else -1 for m in batch._m_host}))
        with upd.timed(key=rungs) as t:
            batch.update(xs if points is None else points[i])
            t.sync(batch.working_states()[-1].L)   # syncs the device
        if q is not None:
            n_comp = min(8, int(batch._m_host.min()))
            with qry.timed(key=n_comp) as t:
                t.sync(batch.transform(torch.as_tensor(q, device=device),
                                       n_components=n_comp))
            n_served += B * args.batch
    t_total = time.perf_counter() - t_total

    sts = batch.states
    m_final = [int(v) for v in sts.m.tolist()]
    steady = float(np.median(upd.ms)) if upd.ms else float("nan")
    result = {
        "mode": "kpca-multitenant", "tenants": B,
        "dispatch": args.dispatch, "cohorts": args.cohorts,
        "window": args.window, "capacity": args.capacity,
        "points": args.points, "m_final": m_final,
        **upd.summary("step_ms"), **qry.summary("query_ms"),
        "aggregate_updates_per_s": float(B / (steady / 1e3)),
        "transforms_served": n_served, "total_s": t_total,
        "finite": bool(torch.isfinite(sts.L).all()),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "dtype": args.dtype,
    }
    if args.health:
        result["quarantined"] = batch.health_summary()["quarantined"]
    if batch.metrics is not None:
        report = hub.observe_metrics_state(batch.metrics)
        result["metrics"] = {k: (v.tolist() if hasattr(v, "tolist") else v)
                             for k, v in report.items()}
    export_metrics(args, hub)
    return result, batch


def kpca_multitenant_main(args) -> dict:
    result, _ = kpca_multitenant_service(args)
    print(f"[serve/kpca] {args.tenants} tenants x {args.points} updates to "
          f"m={result['m_final'][0]} (capacity {args.capacity}) on "
          f"{result['device']}, step p50 {result['step_ms_p50']:.3f} ms = "
          f"{result['aggregate_updates_per_s']:.0f} updates/s aggregate, "
          f"query p50 {result['query_ms_p50']:.3f} ms  {result}")
    return result


def nystrom_service(args, on_point=None
                    ) -> tuple[dict, nystrom.NystromState]:
    """The landmark service loop (grow_rows, RBF with sigma = d,
    Algorithm 1 per admission); returns the result dict and the state.
    The points are drawn from ``--seed`` in the order the reference's
    ``nystrom_main`` draws them and moved to the device in one copy; the landmark count is tracked on
    the host.  Under ``leverage`` one residual read per point feeds both
    the tracker and the admission gate, and once the stopping rule holds
    the tracker freezes and every later point is only observed.
    Counters are a plain dict, mirrored into the hub.  Under ``--health``
    a non-finite point is quarantined before it is observed or offered
    (the finite flags of all points are read once); ``--metrics`` keeps
    the tracker's trace error in a ``MetricsState``.  ``on_point(i, x)``,
    when given, maps each drawn point to the point to stream (a testing
    seam, applied before the points move to the device)."""
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    rng = np.random.default_rng(args.seed)
    d = args.dim
    spec = kf.KernelSpec(name="rbf", sigma=float(d))
    engine = eng.Engine(spec, make_plan(args), adjusted=False)
    x0 = torch.as_tensor(rng.normal(size=(4, d)), dtype=dtype, device=device)
    draws = rng.normal(size=(args.points, d))
    if on_point is not None:
        draws = np.stack([on_point(i, x) for i, x in enumerate(draws)])
    xs = torch.as_tensor(draws, dtype=dtype, device=device)
    quarantine = (engine.plan.health is not None
                  and engine.plan.health.quarantine)
    # One read for the run; observe_rows then needs no gate of its own.
    finite = (torch.isfinite(xs).all(dim=1).tolist() if quarantine
              else [True] * args.points)
    observe_plan = engine.plan._replace(health=None)
    ms = tm.init_metrics(dtype, device) if engine.plan.metrics else None
    hub = obs.fresh_hub()
    n_quarantined = 0
    state = nystrom.init_nystrom(None, x0, args.capacity, spec, dtype=dtype,
                                 grow_rows=True)
    budget = args.landmark_budget or args.capacity - 1
    leverage = engine.plan.landmark_policy == "leverage"
    rule = nystrom.SufficientSubsetRule(rel_tol=args.stop_rel_tol,
                                        patience=args.stop_patience)
    tracker = nystrom.TraceErrorTracker(state, spec) if leverage else None
    counts = {"admitted": 0, "replaced": 0, "rejected": 0}
    stopped_at = None
    m = 4
    step = LatencyHistogram("step_ms")
    t_total = time.perf_counter()
    for i in range(args.points):
        x = xs[i]
        if not finite[i]:
            n_quarantined += 1
            hub.inc("quarantined_total")
            continue
        rung = (eng.bucket_for(min(m + 1, args.capacity), args.capacity,
                               engine.plan.min_bucket)
                if args.dispatch == "bucketed" else -1)
        with step.timed(key=rung) as t:
            res = None
            if leverage and not rule.sufficient:
                res = float(nystrom.admission_residual(state, x, spec))
                tracker.observe(state, x, residual=res)
            state = nystrom.observe_rows(state, x, spec, plan=observe_plan,
                                         m=m)
            if leverage and rule.sufficient:
                action = "rejected"
            else:
                prev, info = state, {}
                state, action = engine.offer_landmark(
                    state, x, budget=budget, residual=res, m=m, info=info)
                if action == "admitted":
                    m += 1
                if leverage and action != "rejected":
                    if action == "admitted":
                        tracker.admitted(prev, x)
                    else:
                        tracker.replaced(state, state_before=prev, x=x,
                                         j=info["victim"])
                    tracker.maybe_resync(state)
                    if ms is not None:
                        ms = tm.note_trace_error(ms, tracker.value)
                    if rule.observe(tracker.value):
                        stopped_at = i
            t.sync(state.Knm)
        counts[action] += 1
    t_total = time.perf_counter() - t_total

    err = float(nystrom.trace_error(state, spec))
    result = {
        "mode": "nystrom", "policy": args.landmark_policy,
        "capacity": args.capacity, "budget": budget, "points": args.points,
        "m_final": int(state.kpca.m), "rows": int(state.Knm.shape[0]),
        "trace_error": err, "stopped_at": stopped_at,
        # Only while the tracker ran: once the rule holds it freezes and
        # later rows arrive untracked.
        "tracker_drift": (abs(tracker.value - err)
                          if tracker and not rule.sufficient else None),
        "tracker_resyncs": tracker.resyncs if tracker else None,
        "total_s": t_total,
        "finite": bool(torch.isfinite(state.kpca.L).all()
                       and np.isfinite(err)),
        **step.summary("step_ms"), **counts,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "dtype": args.dtype,
    }
    for k, v in counts.items():
        hub.counter("landmark_total", action=k).set(v)
    hub.set_gauge("trace_error", err)
    hub.set_gauge("active_m", result["m_final"])
    if quarantine:
        result["quarantined"] = n_quarantined
    if ms is not None:
        result["metrics"] = hub.observe_metrics_state(ms, prefix="nystrom")
    export_metrics(args, hub)
    return result, state


def nystrom_main(args) -> dict:
    result, _ = nystrom_service(args)
    print(f"[serve/nystrom] {args.landmark_policy}: {args.points} points, "
          f"{result['admitted']} admitted / {result['replaced']} replaced / "
          f"{result['rejected']} rejected -> m={result['m_final']} on "
          f"{result['device']}, trace err {result['trace_error']:.4f}, "
          f"stopped_at={result['stopped_at']}  {result}")
    return result


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lm_main(cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 16,
            gen: int = 32, seed: int = 0, device=None,
            params: lm.LM | None = None) -> dict:
    """The LM decode service: ``batch`` prompts of ``prompt_len`` tokens
    from the synthetic stream, fed through teacher-forced decode steps,
    then ``gen`` greedy decode steps.  ``params`` defaults to the model
    drawn from ``seed`` on ``device``.  Times are host clock around work
    that ends in a device synchronize."""
    dev = resolve_device(device)
    if params is None:
        params = lm.init_params(cfg, seed, dev)
    serve_step = steps.make_serve_step(cfg)
    max_seq = prompt_len + gen
    stream = TokenStream(vocab=cfg.vocab, seq_len=prompt_len,
                         global_batch=batch, seed=seed)
    prompts = stream.batch_at(0, dev)["tokens"]
    caches = lm.init_caches(params, cfg, batch, max_seq)

    _sync(dev)
    t0 = time.perf_counter()
    for t in range(prompt_len):       # prefill: teacher-forced decode
        pos = torch.full((batch, 1), t, dtype=torch.int64, device=dev)
        nxt, logits, caches = serve_step(params, caches,
                                         prompts[:, t:t + 1], pos)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    generated = []
    tok = nxt
    t0 = time.perf_counter()
    for t in range(prompt_len, max_seq):      # greedy continuation
        pos = torch.full((batch, 1), t, dtype=torch.int64, device=dev)
        tok, logits, caches = serve_step(params, caches, tok, pos)
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    out = torch.cat(generated, dim=1)
    result = {"arch": cfg.name, "n_layers": cfg.n_layers, "device": dev.type,
              "prefill_s": t_prefill, "decode_s": t_decode,
              "tokens_per_s": batch * gen / max(t_decode, 1e-9),
              "generated_shape": tuple(out.shape),
              "finite": bool(torch.isfinite(logits).all()),
              "tokens_in_vocab": bool(((out >= 0) & (out < cfg.vocab)).all())}
    print(f"[serve/lm] {cfg.name}: served {batch}x{gen} tokens on "
          f"{dev.type}: {result['tokens_per_s']:.1f} tok/s  {result}")
    return result


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("lm", "kpca", "nystrom"),
                    default="kpca")
    ap.add_argument("--arch", default="qwen3_32b",
                    help="lm mode: architecture id (repro_torch.configs)")
    ap.add_argument("--smoke", action="store_true",
                    help="lm mode: the architecture's reduced config")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4,
                    help="queries per transform batch (kpca); sequences "
                         "(lm)")
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
                    help="sliding-window size W: evict the oldest point "
                         "before ingesting past a full window (kpca mode)")
    ap.add_argument("--health", action="store_true",
                    help="attach the default health policy: probes ride "
                         "the update, non-finite points are quarantined "
                         "before the rank-one pairs fire, and an "
                         "unhealthy stream is healed at the transform "
                         "interval")
    ap.add_argument("--metrics", action="store_true",
                    help="attach the in-stream metric lane (MetricsState); "
                         "implied by the export flags below")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve GET /metrics (Prometheus text) during the "
                         "run; 0 picks a free port")
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="append hub events during the run and write a "
                         "final full-registry scrape line to PATH")
    ap.add_argument("--landmark-policy", choices=("append", "leverage"),
                    default="append",
                    help="nystrom mode admission policy: 'append' admits "
                         "until the budget fills; 'leverage' gates on the "
                         "projection residual and swaps out the "
                         "lowest-leverage landmark at the budget")
    ap.add_argument("--landmark-budget", type=int, default=None,
                    help="nystrom mode: most landmarks (default capacity - 1)")
    ap.add_argument("--stop-rel-tol", type=float, default=1e-2,
                    help="sufficient-subset rule (leverage): relative "
                         "improvement of the trace error below which an "
                         "admission counts as flat")
    ap.add_argument("--stop-patience", type=int, default=3,
                    help="sufficient-subset rule (leverage): consecutive "
                         "flat admissions before offers stop")
    ap.add_argument("--tenants", type=int, default=1,
                    help="kpca mode: serve B independent tenant streams "
                         "as one StreamBatch (one batched step per point)")
    ap.add_argument("--cohorts", choices=("max", "bucket", "bucket-padded"),
                    default="max",
                    help="multi-tenant bucket geometry: 'max' runs the "
                         "cohort at its largest tenant's bucket; 'bucket' "
                         "groups tenants by their own bucket; "
                         "'bucket-padded' pads each group to a power of two")
    ap.add_argument("--decouple", action="store_true",
                    help="decoupled ingest/serve (not ported: ROADMAP.md "
                         "item 6)")
    ap.add_argument("--mesh", default=None, metavar="PtxPr",
                    help="tenant x data mesh of the decoupled queries (not "
                         "ported: ROADMAP.md item 10)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.mode == "lm":
        return lm_main(configs.get_config(args.arch, smoke=args.smoke),
                       batch=args.batch, prompt_len=args.prompt_len,
                       gen=args.gen, seed=args.seed, device=args.device)
    if args.decouple:
        raise NotImplementedError(
            "serve --decouple (IngestServeLoop) is not ported yet: "
            "ROADMAP.md item 6")
    if args.mesh is not None:
        raise NotImplementedError(
            "serve --mesh (the tenant mesh) is not ported yet: ROADMAP.md "
            "item 10")
    server = None
    if args.metrics_port is not None:
        # Started before the service, so the run is scrapeable live; the
        # service resets the same default hub object (fresh_hub).
        server = obs.serve_metrics(obs.get_hub(), args.metrics_port)
        print(f"[obs] /metrics on :{server.server_address[1]}")
    if args.metrics_jsonl:
        obs.get_hub().open_jsonl(args.metrics_jsonl)
    try:
        if args.mode == "nystrom":
            return nystrom_main(args)
        if args.tenants > 1:
            return kpca_multitenant_main(args)
        return kpca_main(args)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()


if __name__ == "__main__":
    main()
