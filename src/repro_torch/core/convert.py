"""Carry a ``KPCAState``, a ``WindowState`` or a ``NystromState`` across
packages as numpy arrays.

``state_from_numpy`` turns the fields of the reference's ``KPCAState``
(``L, U, m, S, K1, X``, each as a numpy array or scalar) into the port's
state on ``device``, so a stream started in JAX continues here;
``state_to_numpy`` is the reverse.  ``nystrom_from_numpy`` and
``nystrom_to_numpy`` do the same for a ``NystromState``: the KPCA fields
plus ``Knm`` and, for a grow_rows state, ``Xrows``;
``window_from_numpy`` and ``window_to_numpy`` for a ``WindowState``: the
KPCA fields plus the arrival ring ``ages`` and ``clock``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.inkpca import KPCAState
from repro_torch.core.nystrom import NystromState
from repro_torch.core.window import AGE_DTYPE, WindowState, age_sentinel

FIELDS = ("L", "U", "m", "S", "K1", "X")


def state_from_numpy(fields: dict, device=None) -> KPCAState:
    """Port state from a dict of numpy fields.  The float fields keep L's
    type; ``m`` becomes the 0-d int32 device tensor the kernels read."""
    missing = [k for k in FIELDS if k not in fields]
    if missing:
        raise ValueError(f"state fields missing: {missing}")
    dev = resolve_device(device)
    dtype = torch.from_numpy(np.array(fields["L"])).dtype
    M = np.asarray(fields["L"]).shape[0]
    m = int(np.asarray(fields["m"]))
    if not 0 <= m <= M or np.asarray(fields["U"]).shape != (M, M):
        raise ValueError(f"inconsistent state: m={m}, L {M}, "
                         f"U {np.asarray(fields['U']).shape}")

    def conv(k):
        return torch.as_tensor(np.array(fields[k]), dtype=dtype, device=dev)

    return KPCAState(L=conv("L"), U=conv("U"),
                     m=torch.tensor(m, dtype=torch.int32, device=dev),
                     S=conv("S"), K1=conv("K1"), X=conv("X"))


def state_to_numpy(state: KPCAState) -> dict:
    """The state's fields as numpy arrays (``m`` as int32)."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in FIELDS}


def nystrom_from_numpy(fields: dict, device=None) -> NystromState:
    """Port Nyström state from the KPCA fields plus ``Knm`` and ``Xrows``
    (None or absent for a fixed-row state), all in L's type."""
    kpca = state_from_numpy(fields, device)
    if "Knm" not in fields:
        raise ValueError("state fields missing: ['Knm']")
    M = kpca.L.shape[0]
    Knm = torch.as_tensor(np.array(fields["Knm"]), dtype=kpca.L.dtype,
                          device=kpca.L.device)
    xrows = fields.get("Xrows")
    if xrows is not None:
        xrows = torch.as_tensor(np.array(xrows), dtype=kpca.L.dtype,
                                device=kpca.L.device)
    if Knm.dim() != 2 or Knm.shape[1] != M or (
            xrows is not None and xrows.shape[0] != Knm.shape[0]):
        raise ValueError(f"inconsistent state: Knm {tuple(Knm.shape)}, "
                         f"capacity {M}, Xrows "
                         f"{None if xrows is None else tuple(xrows.shape)}")
    return NystromState(kpca=kpca, Knm=Knm, Xrows=xrows)


def nystrom_to_numpy(state: NystromState) -> dict:
    """The Nyström state's fields as numpy arrays (``Xrows`` None for a
    fixed-row state)."""
    out = state_to_numpy(state.kpca)
    out["Knm"] = state.Knm.detach().cpu().numpy()
    out["Xrows"] = (None if state.Xrows is None
                    else state.Xrows.detach().cpu().numpy())
    return out


def window_from_numpy(fields: dict, device=None) -> WindowState:
    """Port window state from the KPCA fields plus ``ages`` and ``clock``.
    The rows at and beyond m are inactive and take the port's int64
    sentinel, whatever integer type and sentinel the ring came in."""
    missing = [k for k in ("ages", "clock") if k not in fields]
    if missing:
        raise ValueError(f"state fields missing: {missing}")
    kpca = state_from_numpy(fields, device)
    M, m = kpca.L.shape[0], int(kpca.m)
    ages = np.array(fields["ages"]).astype(np.int64)
    clock = int(np.asarray(fields["clock"]))
    live = ages[:m]
    if ages.shape != (M,) or (m and not (0 <= live.min()
                                         and live.max() < clock)):
        raise ValueError(f"inconsistent window: ages {ages.shape} for "
                         f"capacity {M}, clock {clock}")
    ages[m:] = age_sentinel()
    dev = kpca.L.device
    return WindowState(kpca=kpca,
                       ages=torch.as_tensor(ages, device=dev),
                       clock=torch.tensor(clock, dtype=AGE_DTYPE,
                                          device=dev))


def window_to_numpy(state: WindowState) -> dict:
    """The window state's fields as numpy arrays (``ages``/``clock``
    int64)."""
    out = state_to_numpy(state.kpca)
    out["ages"] = state.ages.detach().cpu().numpy()
    out["clock"] = state.clock.detach().cpu().numpy()
    return out
