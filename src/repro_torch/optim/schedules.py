"""Learning-rate schedules, the counterpart of the reference's
``optim/schedules.py``: each a plain function of the step (an int, or a
0-d tensor read on the host) returning the rate as a Python float.

WSD (warmup–stable–decay) is the MiniCPM schedule (arXiv:2404.06395): the
rate warms up, holds at its peak for most of training, then decays
exponentially to a floor in the last ``decay_frac`` of the steps.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

Schedule = Callable[[object], float]


def _step(step) -> float:
    return float(step)


def constant(lr: float) -> Schedule:
    return lambda step: float(lr)


def linear_warmup(lr: float, warmup: int) -> Schedule:
    def fn(step) -> float:
        return lr * min(_step(step) / max(warmup, 1), 1.0)
    return fn


def cosine(lr: float, warmup: int, total: int, floor: float = 0.1
           ) -> Schedule:
    def fn(step) -> float:
        s = _step(step)
        wf = min(s / max(warmup, 1), 1.0)
        prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog))
        return lr * wf * cos
    return fn


def wsd(lr: float, warmup: int, total: int, decay_frac: float = 0.1,
        floor: float = 0.01) -> Schedule:
    """Warmup–Stable–Decay: stable at the peak, exponential decay to
    ``floor`` times the peak over the last ``decay_frac`` of ``total``."""
    decay_start = int(total * (1.0 - decay_frac))

    def fn(step) -> float:
        s = _step(step)
        wf = min(s / max(warmup, 1), 1.0)
        prog = min(max((s - decay_start) / max(total - decay_start, 1), 0.0),
                   1.0)
        return lr * wf * math.exp(math.log(floor) * prog)
    return fn


@dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "cosine"          # constant | cosine | wsd
    lr: float = 3e-4
    warmup: int = 100
    total: int = 10_000
    decay_frac: float = 0.1
    floor: float = 0.1


def make_schedule(cfg: ScheduleConfig) -> Schedule:
    if cfg.kind == "constant":
        return constant(cfg.lr)
    if cfg.kind == "cosine":
        return cosine(cfg.lr, cfg.warmup, cfg.total, cfg.floor)
    if cfg.kind == "wsd":
        return wsd(cfg.lr, cfg.warmup, cfg.total, cfg.decay_frac,
                   floor=min(cfg.floor, 0.05))
    raise ValueError(cfg.kind)
