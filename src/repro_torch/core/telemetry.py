"""Stream metrics on the device: the in-stream half of the observability
layer.

A ``MetricsState`` rides the stream next to the ``HealthState``: counters
and gauges as 0-d tensors on the stream's device, advanced by the
``note_*`` functions and read back only by ``metrics_report`` (the
caller's one synchronizing read, as ``obs.TelemetryHub`` scrapes it).

* **Equal states.**  The eigensystem never goes through a metered path:
  a note runs after the update, from values the update already produced
  (``state.m``, the window clock, the quarantine counter) and host-known
  block sizes.  So a metered stream's states equal an unmetered one's
  bit for bit.
* **Exact counters without reads.**  ``accepted = clock_after −
  clock_before`` on a window (a guarded window step advances the clock
  only for an accepted point), ``accepted = offered − Δquarantined`` on a
  guarded stream, and ``evictions = accepted − (m_after − m_before)``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

# Gauge value meaning "not applicable / never observed".
GAUGE_UNSET = -1.0

COUNTERS = ("ingests", "rejections", "evictions", "downdates", "publishes",
            "skipped_publishes", "heals_polish", "heals_resync")


class MetricsState(NamedTuple):
    """Counters (int32, monotone) and gauges (the state's type) of one
    stream; ``init_metrics_stacked`` gives every leaf a leading tenant
    axis, over which every note broadcasts."""

    # -- counters ----------------------------------------------------------
    ingests: Tensor            # points folded into the eigensystem
    rejections: Tensor         # points quarantined
    evictions: Tensor          # window evictions (implicit downdates)
    downdates: Tensor          # explicit downdates / landmark removals
    publishes: Tensor          # serving snapshots published
    skipped_publishes: Tensor  # publications refused on health
    heals_polish: Tensor       # heal-ladder rungs taken, by rung
    heals_resync: Tensor
    # -- gauges ------------------------------------------------------------
    m: Tensor                  # active count after the last noted step
    window_fill: Tensor        # m / window (GAUGE_UNSET when unwindowed)
    generation: Tensor         # last published snapshot generation
    spec_drift: Tensor         # mirror of HealthState.spec_drift
    orth_err: Tensor           # mirror of HealthState.orth_err
    neg_frac: Tensor           # mirror of HealthState.neg_frac
    trace_err: Tensor          # Nyström trace-error estimate (GAUGE_UNSET
    #                            until a tracker reports one)


def init_metrics(dtype=torch.float32, device=None) -> MetricsState:
    def full(v, dt):
        return torch.full((), v, dtype=dt, device=device)

    z = full(0, torch.int32)
    return MetricsState(
        ingests=z, rejections=z.clone(), evictions=z.clone(),
        downdates=z.clone(), publishes=z.clone(),
        skipped_publishes=z.clone(), heals_polish=z.clone(),
        heals_resync=z.clone(), m=full(0.0, dtype),
        window_fill=full(GAUGE_UNSET, dtype),
        generation=full(-1, torch.int32), spec_drift=full(GAUGE_UNSET, dtype),
        orth_err=full(0.0, dtype), neg_frac=full(0.0, dtype),
        trace_err=full(GAUGE_UNSET, dtype))


def init_metrics_stacked(n: int, dtype=torch.float32,
                         device=None) -> MetricsState:
    """(n,)-leaf MetricsState: one metric lane per tenant."""
    one = init_metrics(dtype, device)
    return MetricsState(*(leaf.expand(n).clone() for leaf in one))


def _gauge(g: Tensor, value) -> Tensor:
    """``value`` (a number or a tensor) as gauge ``g``'s type, shape and
    device."""
    return torch.as_tensor(value).to(device=g.device, dtype=g.dtype
                                     ).expand_as(g).clone()


def _i32(x) -> Tensor | int:
    return x.to(torch.int32) if torch.is_tensor(x) else int(x)


def note_block(ms: MetricsState, m_before, m_after, offered, accepted,
               hstate=None, *, window: int | None = None) -> MetricsState:
    """Account one update, block or window step.  ``accepted`` is the
    exact folded count (the identities in the module docstring);
    evictions are ``accepted − (m_after − m_before)``: zero on append-only
    paths, one per evict + ingest pair at a full window.  With ``hstate``
    the probe gauges are mirrored; ``window`` sets the fill gauge."""
    acc = _i32(accepted)
    grown = _i32(m_after) - _i32(m_before)
    mf = _gauge(ms.m, m_after)
    fill = (mf / window if window is not None
            else torch.full_like(ms.window_fill, GAUGE_UNSET))
    ms = ms._replace(ingests=(ms.ingests + acc).to(torch.int32),
                     rejections=(ms.rejections + (_i32(offered) - acc)
                                 ).to(torch.int32),
                     evictions=(ms.evictions + (acc - grown)
                                ).to(torch.int32),
                     m=mf, window_fill=fill)
    if hstate is not None:
        ms = ms._replace(spec_drift=hstate.spec_drift.to(ms.spec_drift.dtype),
                         orth_err=hstate.orth_err.to(ms.orth_err.dtype),
                         neg_frac=hstate.neg_frac.to(ms.neg_frac.dtype))
    return ms


def note_lanes(ms: MetricsState, ingests, rejections, evictions, m,
               window_fill) -> MetricsState:
    """Stacked-lane account: per-tenant host-exact deltas."""
    def add(c, v):
        return (c + _gauge(c, v)).to(torch.int32)

    return ms._replace(ingests=add(ms.ingests, ingests),
                       rejections=add(ms.rejections, rejections),
                       evictions=add(ms.evictions, evictions),
                       m=_gauge(ms.m, m),
                       window_fill=_gauge(ms.window_fill, window_fill))


# -------------------------------------------------- host-triggered notes --
# These fire on host-decided events (publish, heal, explicit downdate).
def note_downdate(ms: MetricsState, m_after=None, n: int = 1) -> MetricsState:
    ms = ms._replace(downdates=(ms.downdates + n).to(torch.int32))
    if m_after is not None:
        ms = ms._replace(m=_gauge(ms.m, m_after))
    return ms


def note_publish(ms: MetricsState, generation) -> MetricsState:
    return ms._replace(publishes=(ms.publishes + 1).to(torch.int32),
                       generation=_gauge(ms.generation, generation))


def note_skipped_publish(ms: MetricsState) -> MetricsState:
    return ms._replace(
        skipped_publishes=(ms.skipped_publishes + 1).to(torch.int32))


def note_heal(ms: MetricsState, rung: str, n=1) -> MetricsState:
    """``rung``: "polish" | "resync" ("noop" is not counted)."""
    if rung == "polish":
        return ms._replace(heals_polish=(ms.heals_polish + n).to(torch.int32))
    if rung == "resync":
        return ms._replace(heals_resync=(ms.heals_resync + n).to(torch.int32))
    return ms


def note_drift(ms: MetricsState, drift) -> MetricsState:
    return ms._replace(spec_drift=_gauge(ms.spec_drift, drift))


def note_trace_error(ms: MetricsState, value) -> MetricsState:
    return ms._replace(trace_err=_gauge(ms.trace_err, value))


# ------------------------------------------------------------- read-out --
def metrics_report(ms: MetricsState) -> dict:
    """Host snapshot, the one synchronizing read: counters and the
    generation as Python ints, gauges as floats; stacked lanes come back
    as numpy arrays per field plus a summed ``*_total`` per counter."""
    # One copy to the host: every leaf as f64 (int32 counters are exact).
    shape = ms.m.shape
    flat = torch.cat([leaf.detach().reshape(-1).to(torch.float64)
                      for leaf in ms]).cpu().numpy()
    out: dict = {}
    for i, k in enumerate(MetricsState._fields):
        n = max(1, ms.m.numel())
        arr = flat[i * n:(i + 1) * n].reshape(shape)
        if k in COUNTERS or k == "generation":
            arr = arr.astype(np.int64)
        if arr.ndim == 0:
            out[k] = (int(arr) if k in COUNTERS or k == "generation"
                      else float(arr))
        else:
            out[k] = arr
            if k in COUNTERS:
                out[f"{k}_total"] = int(arr.sum())
    return out
