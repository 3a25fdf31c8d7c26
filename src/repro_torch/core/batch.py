"""Batch oracles for the streaming algorithms (paper §2.3).

* ``batch_kpca``  — eigh of the (optionally centered) gram matrix; the
  exactness oracle of the tests and of ``chip_smoke.py``.
* ``refit_state`` — a padded ``KPCAState`` rebuilt by batch KPCA of the
  stored active points.
"""
from __future__ import annotations

import torch

from repro_torch.core import kernels_fn as kf

Tensor = torch.Tensor


def batch_kpca(K: Tensor, *, adjusted: bool) -> tuple[Tensor, Tensor]:
    """Oracle: eigendecomposition (ascending) of K or the centered K'."""
    Keff = kf.center_gram(K) if adjusted else K
    return torch.linalg.eigh(Keff)


def refit_state(state, spec: kf.KernelSpec, *, adjusted: bool):
    """From-scratch re-fit oracle: a state of the same capacity, padding
    sentinels and running sums as a fresh ``inkpca.init_state`` of the
    active points X[:m] (reads m on the host)."""
    from repro_torch.core import inkpca

    m = int(state.m)
    return inkpca.init_state(state.X[:m], state.L.shape[0], spec,
                             adjusted=adjusted, dtype=state.L.dtype)
