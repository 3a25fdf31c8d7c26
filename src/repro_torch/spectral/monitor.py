"""Streaming spectral monitor: the paper's incremental KPCA applied to
training observability.

Blocks of layer activations are fed into an incremental kernel-PCA
stream (Algorithm 2) and the kernel eigenspectrum is tracked over
training: a collapse of effective rank, feature drift or saturation shows
as a change of the spectrum's shape without ever forming an n×n gram over
the run (memory stays O(capacity²)).

The monitor rides the sliding-window stream (``core/window.py``): once the
window is full each new activation evicts the oldest one, so the tracked
spectrum is always that of the trailing ``window`` examples.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import health as hl, inkpca, kernels_fn as kf


@dataclass
class SpectralMonitor:
    """``window`` defaults to ``capacity``.  Every ``observe`` also
    publishes its stats as gauges on a ``TelemetryHub`` (``hub``, default
    the process hub, under ``{prefix}_*``), ``drift`` among them: the
    relative L2 motion of the top spectrum since the previous observe
    (``health.spectral_drift`` against the spectrum then).  The stream
    lives on ``device`` (``cuda`` unless given)."""

    capacity: int = 128
    kernel: str = "rbf"
    adjusted: bool = True
    dtype: object = torch.float32
    window: int | None = None
    prefix: str = "spectral"
    device: object = None
    hub: object = field(default=None, repr=False)
    _stream: inkpca.KPCAStream | None = field(default=None, repr=False)
    _ref_lam: object = field(default=None, repr=False)
    history: list = field(default_factory=list)

    def observe(self, activations) -> dict:
        """activations: (n, d) block (e.g. pooled per-example features)."""
        if self._stream is None:
            from repro_torch import resolve_device

            x = torch.as_tensor(activations, dtype=self.dtype,
                                device=resolve_device(self.device))
            W = self.window or self.capacity
            seed = x[: max(2, min(4, W, x.shape[0]),
                           min(16, W, x.shape[0] // 2))]
            sigma = float(kf.median_heuristic(x))
            spec = kf.KernelSpec(name=self.kernel, sigma=max(sigma, 1e-6))
            self._stream = inkpca.KPCAStream(
                seed, capacity=self.capacity, spec=spec,
                adjusted=self.adjusted, dtype=self.dtype, window=W,
                device=x.device)
            rest = x[seed.shape[0]:]
        else:
            rest = torch.as_tensor(activations, dtype=self.dtype,
                                   device=self._stream.device)
        if rest.shape[0] > 0:
            self._stream.update_block(rest)
        stats = self.stats()
        st = self._stream.kpca_state
        stats["drift"] = (float(hl.spectral_drift(st, self._ref_lam))
                          if self._ref_lam is not None else 0.0)
        self._ref_lam = hl.top_spectrum(st, min(8, self.capacity))
        hub = self.hub if self.hub is not None else obs.get_hub()
        for k, v in stats.items():
            hub.set_gauge(f"{self.prefix}_{k}", v)
        self.history.append(stats)
        return stats

    def stats(self) -> dict:
        st = self._stream.kpca_state
        m = self._stream.m
        lam = np.sort(st.L[:m].detach().cpu().numpy())[::-1]
        lam = np.maximum(lam, 0.0)
        total = lam.sum() + 1e-30
        p = lam / total
        entropy = float(-np.sum(p * np.log(p + 1e-30)))
        return {
            "m": m,
            "seen": int(self._stream.state.clock),
            "top_eig": float(lam[0]) if m else 0.0,
            "trace": float(total),
            "effective_rank": float(np.exp(entropy)),
            "explained_90": int(np.searchsorted(np.cumsum(p), 0.90) + 1),
        }

    def eigenvalues(self) -> np.ndarray:
        st = self._stream.kpca_state
        return np.sort(st.L[: self._stream.m].detach().cpu().numpy())[::-1]
