"""Straggler and failure detection for the training loop, the counterpart
of the reference's ``distributed/straggler.py`` (plain host code).

* ``HeartbeatMonitor``: each worker beats (worker, step, t); the monitor
  flags workers whose last beat is older than ``timeout_s`` or more than
  ``max_step_lag`` steps behind the median.  The launcher's policy for a
  flagged worker is to drop it and restart from the latest atomic
  checkpoint; here the decision is what is exercised.
* ``StepTimer``: an EWMA of the step's wall time with spike counting, the
  in-process signal that this host is the slow one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class HeartbeatMonitor:
    n_workers: int
    timeout_s: float = 60.0
    max_step_lag: int = 10
    _last: dict = field(default_factory=dict)   # worker -> (step, t)

    def beat(self, worker: int, step: int, t: float | None = None) -> None:
        self._last[worker] = (step, time.time() if t is None else t)

    def flagged(self, now: float | None = None) -> list[dict]:
        now = time.time() if now is None else now
        if not self._last:
            return []
        steps = sorted(s for s, _ in self._last.values())
        median = steps[len(steps) // 2]
        out = []
        for w in range(self.n_workers):
            if w not in self._last:
                out.append({"worker": w, "reason": "never-beat"})
                continue
            step, t = self._last[w]
            if now - t > self.timeout_s:
                out.append({"worker": w, "reason": "timeout",
                            "stale_s": now - t})
            elif median - step > self.max_step_lag:
                out.append({"worker": w, "reason": "lagging",
                            "lag": median - step})
        return out

    def healthy(self, now: float | None = None) -> bool:
        return not self.flagged(now)

    def report(self) -> dict:
        return {"workers": self.n_workers, "flagged": self.flagged()}


@dataclass
class StepTimer:
    alpha: float = 0.1
    spike_factor: float = 3.0
    ewma: float | None = None
    spikes: int = 0
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.time()

    def stop(self) -> float:
        dt = time.time() - self._t0
        if self.ewma is None:
            self.ewma = dt
        else:
            if dt > self.spike_factor * self.ewma:
                self.spikes += 1
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return dt
