"""Serving drivers of the port.

* ``--mode lm``: the LM decode loop with KV and recurrent caches, as the
  reference's ``serve --mode lm``: the prompt is fed through teacher-forced
  decode steps (cache warm-up), then ``--gen`` tokens are decoded greedily.
  Parameters are drawn from ``--seed`` on the device; ``--smoke`` takes
  the architecture's reduced config.

      PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
          --device cpu --arch jamba_1_5_large_398b --smoke

  ``--arch`` takes every id of ``repro_torch.configs.ARCH_IDS`` (the
  reference's ten): attention, Mamba, mLSTM and sLSTM blocks, dense and
  expert FFNs.  An MoE layer's count cache is built at ``prompt_len +
  gen`` positions, so prompt and continuation share one capacity.

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
  reference's geometries).
  ``--decouple`` serves through ``IngestServeLoop``: each step first
  answers ``--query-rate`` query batches against the last published
  immutable snapshot, then folds a point into every tenant's working
  state, and republishes every ``--serve-every`` steps (or, with
  ``--publish-on-drift``, when a tenant's top spectrum drifts; the probe
  every ``--drift-probe-every`` steps).  Under ``--health`` a publication
  is gated on the probes: heal once, else refuse and keep serving the
  last healthy snapshot.  ``--mesh PtxPr`` runs it over P_t·P_r ranks of
  ``torch.distributed`` (``torchrun``): each tenant slice of P_r ranks
  owns B/P_t tenants, ingests, publishes and answers them with no
  collective on the query path, and rank 0 gathers the report.
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
    PYTHONPATH=src python -m repro_torch.launch.serve --mode kpca \\
        --device cpu --decouple --tenants 4 --capacity 32 --points 20 \\
        --dim 4 --query-rate 2 --serve-every 4 --health
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mode kpca \\
        --device cpu --decouple --mesh 2x1 --tenants 4 --capacity 32 \\
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
                          serve_every=args.serve_every,
                          serve_components=args.serve_components,
                          health=hl.DEFAULT_POLICY if args.health else None,
                          metrics=metrics)


def parse_mesh(text):
    """'PtxPr' -> (P_t, P_r), e.g. '2x1'; None passes through."""
    if not text:
        return None
    pt, _, pr = text.lower().partition("x")
    return int(pt), int(pr or 1)


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


class IngestServeLoop:
    """Decoupled ingest/serve over a ``StreamBatch`` (the reference's
    loop): ingest folds points into the working state while query batches
    read the last PUBLISHED immutable snapshot (``core/serving``).

    A service step issues its queries before its ingest: they read only
    the published snapshot, so they never wait on the update.  Every
    ``plan.serve_every`` ingests the working state is republished (the
    projection S and the affine fields, never the (M, M) eigenvectors) and
    the snapshot reference is swapped on the host.  ``query_fn`` replaces
    the query executor (``distributed.make_tenant_query`` on a tenant
    mesh).

    **Graceful degradation** (``plan.health``): each publication is gated
    on a probe of every tenant's working state.  An unhealthy cohort gets
    one walk down the heal ladder (``StreamBatch.heal``) — unless an
    unhealthy tenant's stored points are corrupt, where the ladder would
    raise ``health.HealthError`` (restore from a checkpoint belongs to
    whoever owns it): that is decided beforehand on the state
    (``StreamBatch.stored_finite``), as the reference decides it by
    catching the error.  If the cohort is still unhealthy the publication
    is refused (``skipped``) and queries keep reading the last healthy
    snapshot.

    **Staleness-aware publication** (``publish_on_drift``): republish when
    a tenant's working top-C spectrum has drifted (relative L2) past the
    threshold from the one frozen at the last publication; ``serve_every``
    is then the longest staleness, and ``drift_probe_every`` rate-limits
    the probe (``drift_probes`` counts the probes that ran).

    Publish, heal and drift decisions are mirrored into a ``TelemetryHub``
    (``hub=``, default the process hub) and, with the plan's metric lane,
    into the cohort's ``MetricsState``.
    """

    def __init__(self, batch: eng.StreamBatch, spec: kf.KernelSpec, *,
                 plan: eng.UpdatePlan | None = None,
                 n_components: int | None = None, query_fn=None,
                 publish_on_drift: float | None = None,
                 drift_probe_every: int = 1, hub=None):
        self.batch = batch
        self.spec = spec
        self.plan = plan if plan is not None else batch.plan
        self.serve_every = max(1, int(self.plan.serve_every))
        self.n_components = n_components
        self._query_fn = query_fn
        self.policy = self.plan.health
        self.publish_on_drift = publish_on_drift
        self.drift_probe_every = max(1, int(drift_probe_every))
        self.hub = hub if hub is not None else obs.get_hub()
        self.skipped = 0           # publications refused on health
        self.heals = 0             # tenants sent down the heal ladder
        self.drift_publishes = 0   # publications the drift triggered
        self.drift_probes = 0      # drift probes that ran
        self.ref_lam = None        # (B, C) top spectrum at the last publish
        self._last_drift = 0.0     # the last probed largest drift
        self._since_probe = 0
        self.snaps = batch.publish(n_components)
        self.generation = 0        # host mirror of the snapshots' generation
        self._since = 0
        self._record_ref()

    def _record_ref(self) -> None:
        """Freeze the published top-C spectrum as the drift reference."""
        if self.policy is None and self.publish_on_drift is None:
            return
        nc = int(self.n_components if self.n_components is not None
                 else self.plan.serve_components)
        self.ref_lam = self.batch.top_spectra(nc)
        self._last_drift = 0.0
        self._since_probe = 0

    def query(self, q):
        """(B, nq, d) queries against the published snapshot; safe at any
        point relative to ingest (snapshots are immutable)."""
        if self._query_fn is not None:
            return self._query_fn(self.snaps, self.batch._points(q))
        from repro_torch.core import serving

        return serving.query_batch(self.snaps, self.batch._points(q),
                                   spec=self.spec, plan=self.plan)

    def publish(self):
        """Republish the working state and swap the snapshot.  With a
        health policy the publication is gated on the probe verdicts (heal
        once, then refuse: the previous snapshot keeps serving and
        ``skipped`` counts the refusal).  Returns the current snapshot
        either way."""
        if self.policy is not None:
            healthy, _ = self.batch.probe_all()
            if not healthy.all():
                if self.batch.stored_finite()[~healthy].all():
                    n = self.batch.heal()
                    self.heals += n
                    self.hub.inc("heals_total", n)
                healthy, _ = self.batch.probe_all()
            if not healthy.all():
                self.skipped += 1
                self.hub.inc("skipped_publishes_total")
                self.hub.emit({"event": "skipped_publish",
                               "generation": self.generation})
                self.batch.note_skipped_publish()
                return self.snaps
        self.snaps = self.batch.publish(self.n_components)
        self.generation += 1
        self.hub.inc("publishes_total")
        self.hub.set_gauge("generation", self.generation)
        self.hub.emit({"event": "publish", "generation": self.generation,
                       "drift": self._last_drift})
        self._since = 0
        self._record_ref()
        return self.snaps

    def _drift_due(self) -> bool:
        """True when a tenant's spectrum has left the published one.  The
        probe runs every ``drift_probe_every``-th call; between probes the
        decision rides the last probed drift (a publish resets it)."""
        if self.publish_on_drift is None or self.ref_lam is None:
            return False
        self._since_probe += 1
        if self._since_probe < self.drift_probe_every:
            return self._last_drift > self.publish_on_drift
        self._since_probe = 0
        self.drift_probes += 1
        self.hub.inc("drift_probes_total")
        _, drift = self.batch.probe_all(ref_lam=self.ref_lam)
        self._last_drift = float(np.max(drift))
        self.hub.set_gauge("spectral_drift", self._last_drift)
        self.batch.note_drift(drift)
        return self._last_drift > self.publish_on_drift

    def _publish_due(self) -> bool:
        """The publish decision: the ``serve_every`` cadence first, else
        the rate-limited drift trigger."""
        cadence = self._since >= self.serve_every
        drifted = (not cadence) and self._drift_due()
        if drifted:
            self.drift_publishes += 1
            self.hub.inc("drift_publishes_total")
        return cadence or drifted

    def ingest(self, xs) -> bool:
        """Fold one (B, d) block into the working state and republish when
        the cadence (or the drift trigger) says so.  True iff a publication
        happened."""
        self.batch.update(xs)
        self._since += 1
        if not self._publish_due():
            return False
        gen0 = self.generation
        self.publish()
        return self.generation != gen0

    def step(self, xs, queries=None):
        """One service step: queries first (against the snapshot), then
        ingest.  Returns (answers or None, published)."""
        y = self.query(queries) if queries is not None else None
        return y, self.ingest(xs)


def decoupled_draws(args):
    """(x0, steps): the decoupled service's numpy inputs from ``--seed``,
    in the reference service's order — the (B, 4, d) seeds, then for each
    step the (B, d) points and the ``--query-rate`` (B, batch, d) query
    batches drawn after them."""
    rng = np.random.default_rng(args.seed)
    B, d = args.tenants, args.dim
    x0 = rng.normal(size=(B, 4, d))
    steps = []
    for _ in range(args.points):
        xs = rng.normal(size=(B, d))
        steps.append((xs, [rng.normal(size=(B, args.batch, d))
                           for _ in range(args.query_rate)]))
    return x0, steps


def _rank_device(mesh: str, device: torch.device, env, cards: int
                 ) -> torch.device:
    """This rank's card when ``torchrun`` starts the ranks of ``--mesh``
    on CUDA: NCCL with one rank per card, so ``cuda`` (no index) becomes
    ``cuda:LOCAL_RANK``.  Raises when the host runs more ranks than it has
    visible cards, or when an index would put every rank on one card."""
    per_host = int(env.get("LOCAL_WORLD_SIZE", env.get("WORLD_SIZE", "1")))
    if per_host > cards:
        raise ValueError(f"--mesh {mesh} on CUDA runs NCCL with one rank "
                         f"per card: {per_host} ranks on this host, but "
                         f"{cards} visible card(s)")
    if device.index is not None:
        if per_host > 1:
            raise ValueError(f"--mesh {mesh}: --device {device} would put "
                             f"all {per_host} ranks of this host on one "
                             f"card; give --device cuda")
        return device
    return torch.device("cuda", int(env.get("LOCAL_RANK", "0")))


def _tenant_mesh(args, mesh_shape, device):
    """The tenant mesh of ``--mesh PtxPr`` and this rank's device.  Raises
    unless the world has exactly P_t·P_r ranks.  A caller that joined the
    world chose its backend and device; otherwise the service joins it
    from ``torchrun``'s environment: gloo on the CPU, NCCL with one rank
    per card on CUDA (``_rank_device``), the card bound before the
    group is made."""
    import os

    import torch.distributed as tdist

    from repro_torch.core import distributed as dist

    pt, pr = mesh_shape
    world = (tdist.get_world_size() if tdist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != pt * pr:
        raise ValueError(f"--mesh {args.mesh} needs WORLD_SIZE == P_t·P_r "
                         f"== {pt * pr}, but WORLD_SIZE is {world}")
    if not tdist.is_initialized():
        if "RANK" not in os.environ:
            raise ValueError(f"--mesh {args.mesh} runs under torchrun (or "
                             f"in a process group its caller made)")
        if device.type == "cuda":
            device = _rank_device(args.mesh, device, os.environ,
                                  torch.cuda.device_count())
            torch.cuda.set_device(device)
        dist.init_world(backend="nccl" if device.type == "cuda" else "gloo")
    elif device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return dist.make_tenant_mesh(pt, pr, device=device), device


def kpca_decoupled_service(args, on_step=None
                           ) -> tuple[dict, IngestServeLoop]:
    """``--decouple``: B tenant streams ingest into the working state while
    ``--query-rate`` query batches a step read the published snapshot
    (``IngestServeLoop``).  Query latencies are taken under the
    concurrent ingest; publication is timed apart.  ``on_step(i, batch,
    xs)``, when given, returns the (B, d) points to fold at step i (the
    testing seam of ``kpca_multitenant_service``).

    With ``--mesh PtxPr`` this rank's tenant slice serves its B/P_t
    tenants (the draws are the whole cohort's, so tenant b sees the same
    inputs at any mesh); the queries run ``distributed.make_tenant_query``
    (no collective), and the report is gathered from every slice (rank 0
    prints it).  Returns the result dict (the reference's keys) and the
    loop."""
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    B, d = args.tenants, args.dim
    spec = kf.KernelSpec(name="rbf", sigma=float(d))
    plan = make_plan(args)
    mesh_shape = parse_mesh(args.mesh)
    mesh = None
    if mesh_shape is not None:
        mesh, device = _tenant_mesh(args, mesh_shape, device)
    own = range(B) if mesh is None else mesh.tenants(B)
    lo, hi = own.start, own.stop
    x0, steps = decoupled_draws(args)
    batch = eng.StreamBatch(torch.as_tensor(x0[lo:hi], dtype=dtype,
                                            device=device),
                            args.capacity, spec, plan=plan, adjusted=True,
                            dtype=dtype, cohorts=args.cohorts,
                            window=args.window, device=device)
    query_fn = None
    if mesh is not None:
        from repro_torch.core import distributed as dist
        query_fn = dist.make_tenant_query(mesh, spec, plan=plan)
    gated = plan.health is not None and plan.health.quarantine
    # One copy of the run's points and queries to the card before the loop
    # (numpy points for the quarantine gate's host check).
    points = (None if gated or on_step is not None else torch.as_tensor(
        np.stack([xs[lo:hi] for xs, _ in steps]), dtype=dtype,
        device=device))
    queries = torch.as_tensor(np.stack([np.stack(qs)[:, lo:hi]
                                        for _, qs in steps]),
                              dtype=dtype, device=device)

    hub = obs.fresh_hub()
    loop = IngestServeLoop(batch, spec, plan=plan, query_fn=query_fn,
                           publish_on_drift=args.publish_on_drift,
                           drift_probe_every=args.drift_probe_every, hub=hub)
    ing, qry, pub = (hub.histogram("ingest_ms"), hub.histogram("query_ms"),
                     hub.histogram("publish_ms"))
    n_served = 0
    t_total = time.perf_counter()
    for i, (xs, _) in enumerate(steps):
        xs = xs[lo:hi]
        if on_step is not None:
            xs = on_step(i, batch, xs)
        # Queries first: they read only the published snapshot.
        for q in queries[i]:
            with qry.timed(key=loop.generation == 0) as t:
                t.sync(loop.query(q))
            n_served += (hi - lo) * args.batch
        rungs = tuple(sorted({
            batch._tenant_bucket(int(m)) if args.dispatch == "bucketed"
            else -1 for m in batch._m_host}))
        with ing.timed(key=rungs) as t:
            batch.update(xs if points is None else points[i])
            t.sync(batch.working_states()[-1].L)   # syncs the device
        loop._since += 1
        if loop._publish_due():
            with pub.timed(key=rungs) as t:
                t.sync(loop.publish().S)
    t_total = time.perf_counter() - t_total

    sts = batch.states
    result = {
        "mode": "kpca-decoupled", "tenants": B,
        "dispatch": args.dispatch, "cohorts": args.cohorts,
        "capacity": args.capacity, "window": args.window,
        "mesh": args.mesh, "tenant_sharded_queries": query_fn is not None,
        "staging": None if mesh is None else mesh.rows.staging,
        "serve_every": args.serve_every, "query_rate": args.query_rate,
        "publish_on_drift": args.publish_on_drift,
        "points": args.points, "m_final": [int(v) for v in sts.m.tolist()],
        "generations": loop.generation,
        "drift_publishes": loop.drift_publishes,
        "drift_probes": loop.drift_probes,
        "skipped_publishes": loop.skipped, "heals": loop.heals,
        "quarantined": int(batch.quarantined.sum()),
        **ing.summary("ingest_ms"), **qry.summary("query_ms"),
        **pub.summary("publish_ms"),
        "queries_served": n_served, "total_s": t_total,
        "finite": bool(torch.isfinite(sts.L).all()),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "dtype": args.dtype,
    }
    if batch.metrics is not None:
        report = hub.observe_metrics_state(batch.metrics)
        result["metrics"] = {k: (v.tolist() if hasattr(v, "tolist") else v)
                             for k, v in report.items()}
    if mesh is not None:
        result = _gather_report(result, mesh)
    export_metrics(args, hub)
    return result, loop


def _gather_report(local: dict, mesh) -> dict:
    """Every rank's report, joined: the per-tenant lists concatenated over
    the tenant slices (each slice's first rank), the counts of slice 0
    with each slice's beside them, the latencies of this rank."""
    import torch.distributed as tdist

    parts = [None] * tdist.get_world_size()
    tdist.all_gather_object(parts, local)
    slices = parts[::mesh.p_rows]
    out = dict(local)
    out["m_final"] = [m for p in slices for m in p["m_final"]]
    out["quarantined"] = sum(p["quarantined"] for p in slices)
    out["queries_served"] = sum(p["queries_served"] for p in slices)
    out["finite"] = all(p["finite"] for p in parts)
    for key in ("generations", "skipped_publishes", "heals", "drift_probes",
                "drift_publishes"):
        out[f"{key}_per_slice"] = [p[key] for p in slices]
    out["world_size"] = len(parts)
    return out


def kpca_decoupled_main(args) -> dict:
    import torch.distributed as tdist

    joined = tdist.is_initialized()
    result, _ = kpca_decoupled_service(args)
    rank = tdist.get_rank() if tdist.is_initialized() else 0
    if tdist.is_initialized() and not joined:   # the service joined it
        tdist.destroy_process_group()
    if rank == 0:
        print(f"[serve/kpca-decoupled] {args.tenants} tenants x "
              f"{args.points} steps (publish every {args.serve_every}) on "
              f"{result['device']}, ingest p50 "
              f"{result['ingest_ms_p50']:.3f} ms, query p50 "
              f"{result['query_ms_p50']:.3f} / p99 "
              f"{result['query_ms_p99']:.3f} ms under ingest, publish p50 "
              f"{result['publish_ms_p50']:.3f} ms  {result}")
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
                    help="decoupled ingest/serve: queries read the last "
                         "published snapshot, not the working state")
    ap.add_argument("--query-rate", type=int, default=1,
                    help="decoupled mode: query batches (of --batch points a "
                         "tenant) a step, against the published snapshot")
    ap.add_argument("--serve-every", type=int, default=1,
                    help="decoupled mode: republish every N steps")
    ap.add_argument("--serve-components", type=int, default=8,
                    help="components C frozen into published snapshots")
    ap.add_argument("--drift-probe-every", type=int, default=4, metavar="K",
                    help="decoupled mode: run the spectral-drift probe every "
                         "K-th step that does not publish")
    ap.add_argument("--publish-on-drift", type=float, default=None,
                    metavar="THRESH",
                    help="decoupled mode: republish when a tenant's top-C "
                         "spectrum drifts (relative L2) past THRESH from the "
                         "last published one; --serve-every is then the "
                         "longest staleness")
    ap.add_argument("--mesh", default=None, metavar="PtxPr",
                    help="decoupled mode: a (tenant, data) mesh of P_t x P_r "
                         "torch.distributed ranks (torchrun); each tenant "
                         "slice serves B/P_t tenants")
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
    if args.mesh is not None and not args.decouple:
        raise ValueError("--mesh shards the decoupled service: pass "
                         "--decouple")
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
        if args.decouple:
            return kpca_decoupled_main(args)
        if args.tenants > 1:
            return kpca_multitenant_main(args)
        return kpca_main(args)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()


if __name__ == "__main__":
    main()
