"""Sliding-window incremental KPCA: bounded memory on an unbounded stream.

``KPCAStream(window=W)`` tracks the exact mean-adjusted (or raw) kernel
eigensystem of the trailing W points: once the window is full, every new
point first evicts the oldest one through the decremental pipeline
(``core/downdate.py``) and then folds in as usual, so each step costs the
window's bucket and memory never grows.

The FIFO order lives in the state as an arrival-index ring (``ages`` and
``clock``, int64 on the state's device), so a windowed state carried
across (``convert.window_from_numpy``) continues exactly, and the victim of
a steady-state step, argmin(ages), is picked on the card with no host
read.  The eviction permutation (``downdate.boundary_perm``) keeps the
survivors' arrival order, so physically the oldest point is row 0 of a
pure FIFO stream; the ring stays authoritative all the same.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import downdate as dd
from repro_torch.core import kernels_fn as kf
from repro_torch.core.rankone import index_set

Tensor = torch.Tensor

AGE_DTYPE = torch.int64


def age_sentinel(dtype=AGE_DTYPE) -> int:
    """Inactive-slot marker, far above any real arrival index."""
    return int(torch.iinfo(dtype).max // 2)


class WindowState(NamedTuple):
    """A ``KPCAState`` plus the FIFO arrival ring.

    kpca:  the fixed-capacity eigensystem state (``inkpca.KPCAState``)
    ages:  (M,) int64 arrival index of the point in each physical row;
           ``age_sentinel()`` marks inactive rows
    clock: ()   int64 arrival index of the next ingested point
    """

    kpca: object
    ages: Tensor
    clock: Tensor


def init_window(x0: Tensor, capacity: int, spec: kf.KernelSpec, *,
                adjusted: bool = True, dtype=torch.float32) -> WindowState:
    from repro_torch.core import inkpca

    kpca = inkpca.init_state(x0, capacity, spec, adjusted=adjusted,
                             dtype=dtype)
    m0 = x0.shape[0]
    ages = torch.full((capacity,), age_sentinel(), dtype=AGE_DTYPE,
                      device=x0.device)
    ages[:m0] = torch.arange(m0, dtype=AGE_DTYPE, device=x0.device)
    return WindowState(kpca=kpca, ages=ages,
                       clock=torch.tensor(m0, dtype=AGE_DTYPE,
                                          device=x0.device))


def oldest_row(wstate: WindowState) -> int:
    """Physical row of the oldest active point (a host read)."""
    return int(torch.argmin(wstate.ages))


def evict(engine, wstate: WindowState, row, *, m: int | None = None
          ) -> WindowState:
    """Remove the point in physical ``row`` (an int, or a 0-d device
    tensor) and carry the ages ring through the same survivor-order
    permutation the downdate applied.  ``m`` is the host's active count
    (None reads it)."""
    kpca = engine.downdate(wstate.kpca, row, m=m)
    row = torch.as_tensor(row, dtype=torch.int32, device=wstate.ages.device)
    order = dd.boundary_perm(row, wstate.kpca.m, wstate.ages.shape[0])
    ages = index_set(wstate.ages[order], wstate.kpca.m - 1, age_sentinel())
    return wstate._replace(kpca=kpca, ages=ages)


def rebase_ages(wstate: WindowState) -> WindowState:
    """Shift the active stamps and the clock down so the clock restarts at
    the capacity.  Active ages lie in [clock − m, clock), so the shift
    keeps their order and keeps them non-negative; sentinels stay."""
    sent = age_sentinel()
    base = wstate.clock - wstate.ages.shape[0]
    ages = torch.where(wstate.ages == sent, sent, wstate.ages - base)
    return wstate._replace(ages=ages, clock=wstate.clock - base)


def maybe_rebase(wstate: WindowState) -> WindowState:
    """Rebase when the clock nears the sentinel, selected on the device so
    the check reads nothing back."""
    reb = rebase_ages(wstate)
    need = wstate.clock >= age_sentinel() - 1
    return wstate._replace(ages=torch.where(need, reb.ages, wstate.ages),
                           clock=torch.where(need, reb.clock, wstate.clock))


def ingest(engine, wstate: WindowState, x_new: Tensor, *, window: int
           ) -> WindowState:
    """One sliding-window step: evict the oldest point if the window is
    full, fold the new point in and stamp its arrival index (a spelling of
    ``engine.Engine.step`` on a windowed bundle)."""
    from repro_torch.core import engine as eng

    s = engine.step(eng.make_stream(wstate), x_new, window=window)
    return WindowState(kpca=s.kpca, ages=s.ages, clock=s.clock)
