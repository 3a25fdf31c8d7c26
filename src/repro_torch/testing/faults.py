"""Fault injection: named crash points and controlled corruption.

**Killpoints.**  Code that can die mid-way (the checkpoint store between
its writes and renames) calls ``trip(point)`` at each such instant.
``trip`` does nothing unless a test ``arm``-ed that point; then it raises
``FaultInjected``, as a kill -9 at that line would end the process.  The
registry is process-local: with nothing armed ``trip`` costs one dict
check.

**Corruptors.**  Functions that damage an eigensystem state in controlled
ways (a non-finite input point, noisy eigenvectors, one flipped bit, a
negative eigenvalue, a poisoned stored row), out of place, for torch
states on any device, so that detection and repair (``core/health``) can
be checked end to end.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

__all__ = ["FaultInjected", "arm", "disarm", "armed", "trip", "injected",
           "nan_point", "nonfinite_every", "corrupt_eigvecs", "bitflip_eigvec",
           "corrupt_eigenvalue", "poison_stored_row"]


class FaultInjected(BaseException):
    """Raised at an armed killpoint.  A ``BaseException``, so a handler for
    ``Exception`` does not swallow it: a killed process runs no handler
    either."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point!r}")
        self.point = point


_armed: dict[str, int] = {}
_hits: dict[str, int] = {}


def arm(point: str, *, after: int = 0) -> None:
    """Arm ``point``: its (after+1)-th ``trip`` raises."""
    _armed[point] = int(after)
    _hits[point] = 0


def disarm(point: str | None = None) -> None:
    """Disarm one point, or every point when called with no argument."""
    if point is None:
        _armed.clear()
        _hits.clear()
    else:
        _armed.pop(point, None)
        _hits.pop(point, None)


def armed(point: str) -> bool:
    return point in _armed


def trip(point: str) -> None:
    """Killpoint: nothing unless armed."""
    if not _armed or point not in _armed:
        return
    _hits[point] = _hits.get(point, 0) + 1
    if _hits[point] > _armed[point]:
        disarm(point)
        raise FaultInjected(point)


@contextmanager
def injected(point: str, *, after: int = 0):
    """Arm ``point`` for the scope; always disarms on exit."""
    arm(point, after=after)
    try:
        yield
    finally:
        disarm(point)


# ------------------------------------------------------------ corruptors --
def nan_point(d: int, *, kind: str = "nan", index: int = 0,
              base=None) -> np.ndarray:
    """A d-dimensional float32 input point with one non-finite entry, the
    arrival the quarantine gate must reject."""
    x = (np.zeros(d, np.float32) if base is None
         else np.array(base, np.float32, copy=True))
    x[index] = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf}[kind]
    return x


def nonfinite_every(k: int, i: int, x) -> np.ndarray:
    """Point ``i`` of a stream, or for every k-th point (i + 1 a multiple
    of k) a non-finite stand-in, NaN and inf in turn: the services'
    ``on_point`` seam takes it to poison a run."""
    if (i + 1) % k:
        return x
    return nan_point(len(x), kind=("nan", "inf")[(i // k) % 2], base=x)


def corrupt_eigvecs(state, *, magnitude: float = 0.1, seed: int = 0):
    """Add Gaussian noise (numpy's generator from ``seed``, the reference's
    draws) to the active m×m block of U: a drift of orthogonality the
    probe must detect and ``heal`` repair.  Rows and columns past m are
    untouched, so the padding invariants hold."""
    m = int(state.m)
    noise = np.random.default_rng(seed).normal(scale=magnitude, size=(m, m))
    U = state.U.clone()
    U[:m, :m] += torch.as_tensor(noise, dtype=U.dtype, device=U.device)
    return state._replace(U=U)


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def bitflip_eigvec(state, i: int = 0, j: int = 0, *, bit: int = 31):
    """Flip one bit of U[i, j] on the tensor's bits, a silent data
    corruption (bit 31 of an f32 is its sign; bit 30 its exponent's top
    bit, a huge entry the probes catch)."""
    if state.U.dtype not in _BITS:
        raise TypeError(f"bitflip_eigvec supports f32/f64, got "
                        f"{state.U.dtype}")
    U = state.U.clone()
    word = U.view(_BITS[U.dtype])
    # Bit 31 of an int32 (63 of an int64) is its sign: form the mask in
    # the unsigned range and wrap it into the signed type.
    width = 8 * U.element_size()
    mask = (1 << bit) - (1 << width if bit == width - 1 else 0)
    word[i, j] ^= mask
    return state._replace(U=U)


def corrupt_eigenvalue(state, j: int = 0, *, value: float = -1.0):
    """Overwrite eigenvalue ``j``: a violation of positive
    semi-definiteness the negativity probe flags."""
    L = state.L.clone()
    L[j] = value
    return state._replace(L=L)


def poison_stored_row(state, row: int = 0):
    """Fill a stored point's row with NaN: resync in place is impossible,
    so the heal ladder ends in ``health.HealthError`` (restore from a
    checkpoint)."""
    X = state.X.clone()
    X[row] = float("nan")
    return state._replace(X=X)
