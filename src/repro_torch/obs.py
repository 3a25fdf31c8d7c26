"""Latency histogram for the port's service loops.

A phase is timed on the host clock around work that ends in
``torch.cuda.synchronize()`` (the handle's ``sync``), so the sample holds
the device's execution and not just the enqueue.  The first sample of
each key (a bucket rung, a component count) is kept apart as warm-up: it
pays the kernel build and the library's first-call set-up.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


class _TimedHandle:
    """Yielded by ``LatencyHistogram.timed``: ``sync(x)`` marks the tensor
    the phase produced; the clock stops after its device has finished."""

    def __init__(self):
        self._sync = None

    def sync(self, x: torch.Tensor) -> None:
        self._sync = x


class LatencyHistogram:
    """Steady-state vs warm-up latency split for one service phase."""

    def __init__(self, name: str = "phase"):
        self.name = name
        self.ms: list[float] = []
        self.compile_ms: list[float] = []
        self._seen: set = set()
        self.last_ms: float | None = None

    def add(self, sample_ms: float, key=None) -> None:
        self.last_ms = sample_ms
        if key not in self._seen:
            self._seen.add(key)
            self.compile_ms.append(sample_ms)
        else:
            self.ms.append(sample_ms)

    @contextlib.contextmanager
    def timed(self, key=None):
        handle = _TimedHandle()
        t0 = time.perf_counter()
        yield handle
        if handle._sync is not None and handle._sync.is_cuda:
            torch.cuda.synchronize(handle._sync.device)
        self.add((time.perf_counter() - t0) * 1e3, key=key)

    def summary(self, name: str | None = None) -> dict:
        """p50/p90/p99/max of the steady samples, plus the warm-up count
        and total (keys ``{name}_compiles`` / ``{name}_compile_ms``, as the
        reference's driver prints them)."""
        name = name if name is not None else self.name
        arr = np.asarray(self.ms, float) if self.ms else np.zeros((1,))
        out = {f"{name}_p50": float(np.percentile(arr, 50)),
               f"{name}_p90": float(np.percentile(arr, 90)),
               f"{name}_p99": float(np.percentile(arr, 99)),
               f"{name}_max": float(arr.max())}
        out[f"{name}_compiles"] = len(self.compile_ms)
        out[f"{name}_compile_ms"] = float(sum(self.compile_ms))
        return out
