"""Carry a ``KPCAState``, a ``WindowState`` or a ``NystromState`` across
packages as numpy arrays.

``state_from_numpy`` turns the fields of the reference's ``KPCAState``
(``L, U, m, S, K1, X``, each as a numpy array or scalar) into the port's
state on ``device``, so a stream started in JAX continues here;
``state_to_numpy`` is the reverse.  ``nystrom_from_numpy`` and
``nystrom_to_numpy`` do the same for a ``NystromState``: the KPCA fields
plus ``Knm`` and, for a grow_rows state, ``Xrows``;
``window_from_numpy`` and ``window_to_numpy`` for a ``WindowState``: the
KPCA fields plus the arrival ring ``ages`` and ``clock``;
``krr_from_numpy`` and ``krr_to_numpy`` for a ``KRRState``: the KPCA
fields plus the targets ``y``; ``snapshot_from_numpy`` and
``snapshot_to_numpy`` for a ``ServingSnapshot``: ``S``, ``X``, ``m``,
``generation`` and, for a mean-adjusted head, the affine fields ``mf``,
``colsum``, ``colproj`` and ``grand``.
``stacked_state_from_numpy`` carries a tenant-stacked ``KPCAState`` (every
field with a leading tenant axis B: the reference's ``StreamBatch.states``),
which ``engine.StreamBatch.from_states`` continues;
``stacked_window_from_numpy`` a stacked ``WindowState`` (``ages`` (B, M),
``clock`` (B,)), whose ring a windowed cohort's lockstep FIFO defines where
the reference keeps none.  ``state_to_numpy`` and ``window_to_numpy`` take
stacked states as they are.
``lm_params_from_numpy`` turns the reference's LM parameter tree (as
numpy arrays) into the port's ``models.lm.LM``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.inkpca import KPCAState
from repro_torch.core.krr import KRRState
from repro_torch.core.nystrom import NystromState
from repro_torch.core.serving import AffineCorrection, ServingSnapshot
from repro_torch.core.window import AGE_DTYPE, WindowState, age_sentinel
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig

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


def stacked_state_from_numpy(fields: dict, device=None) -> KPCAState:
    """Tenant-stacked port state from numpy fields with a leading tenant
    axis (L (B, M), U (B, M, M), m (B,), S (B,), K1 (B, M), X (B, M, d)),
    each tenant checked as ``state_from_numpy`` checks one state."""
    missing = [k for k in FIELDS if k not in fields]
    if missing:
        raise ValueError(f"state fields missing: {missing}")
    arrs = {k: np.array(fields[k]) for k in FIELDS}
    B = arrs["L"].shape[0] if arrs["L"].ndim == 2 else -1
    if B < 1 or any(arrs[k].shape[:1] != (B,) for k in FIELDS):
        raise ValueError(f"stacked state needs a leading tenant axis on "
                         f"every field, got "
                         f"{ {k: arrs[k].shape for k in FIELDS} }")
    tenants = [state_from_numpy({k: arrs[k][b] for k in FIELDS}, device)
               for b in range(B)]
    return KPCAState(*(torch.stack(leaves) for leaves in zip(*tenants)))


def stacked_window_from_numpy(fields: dict, device=None) -> WindowState:
    """Tenant-stacked window state: the stacked KPCA fields plus ``ages``
    (B, M) and ``clock`` (B,), each tenant checked as
    ``window_from_numpy`` checks one.  Without ``ages``/``clock`` (a
    reference cohort's ``states``: its windows keep no ring) each tenant's
    ring is the lockstep FIFO's: row i holds arrival i, the clock is m."""
    kpca = stacked_state_from_numpy(fields, device)
    B, M = kpca.L.shape
    m = kpca.m.cpu().numpy()
    if "ages" in fields or "clock" in fields:
        ages = np.array(fields["ages"])
        clock = np.array(fields["clock"])
    else:
        ages = np.tile(np.arange(M, dtype=np.int64), (B, 1))
        clock = m.astype(np.int64)
    if ages.shape != (B, M) or clock.shape != (B,):
        raise ValueError(f"inconsistent stacked window: ages {ages.shape}, "
                         f"clock {clock.shape} for {B} tenants of "
                         f"capacity {M}")
    wins = [window_from_numpy({**state_to_numpy(KPCAState(
        *(leaf[b] for leaf in kpca))), "ages": ages[b], "clock": clock[b]},
        kpca.L.device) for b in range(B)]
    return WindowState(kpca=kpca,
                       ages=torch.stack([w.ages for w in wins]),
                       clock=torch.stack([w.clock for w in wins]))


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


def krr_from_numpy(fields: dict, device=None) -> KRRState:
    """Port KRR state from the KPCA fields plus the targets ``y``."""
    kpca = state_from_numpy(fields, device)
    if "y" not in fields:
        raise ValueError("state fields missing: ['y']")
    y = torch.as_tensor(np.array(fields["y"]), dtype=kpca.L.dtype,
                        device=kpca.L.device)
    if y.shape != kpca.L.shape:
        raise ValueError(f"inconsistent state: y {tuple(y.shape)} for "
                         f"capacity {kpca.L.shape[0]}")
    return KRRState(kpca=kpca, y=y)


def krr_to_numpy(state: KRRState) -> dict:
    """The KRR state's fields as numpy arrays."""
    return {**state_to_numpy(state.kpca), "y": state.y.detach().cpu().numpy()}


SNAPSHOT_FIELDS = ("S", "X", "m", "generation")


def snapshot_from_numpy(fields: dict, device=None) -> ServingSnapshot:
    """Port snapshot from numpy fields: S and X keep their type, ``m``
    becomes a 0-d int32 device tensor and ``generation`` a 0-d int32 host
    tensor; the affine fields, where ``mf`` is present and not None, take
    S's type."""
    missing = [k for k in SNAPSHOT_FIELDS if k not in fields]
    if missing:
        raise ValueError(f"snapshot fields missing: {missing}")
    dev = resolve_device(device)
    S = torch.as_tensor(np.array(fields["S"]), device=dev)
    X = torch.as_tensor(np.array(fields["X"]), device=dev)
    if S.dim() != 2 or X.dim() != 2 or S.shape[0] != X.shape[0]:
        raise ValueError(f"inconsistent snapshot: S {tuple(S.shape)}, X "
                         f"{tuple(X.shape)}")
    affine = None
    if fields.get("mf") is not None:
        affine = AffineCorrection(*(
            torch.as_tensor(np.array(fields[k]), dtype=S.dtype, device=dev)
            for k in AffineCorrection._fields))
    return ServingSnapshot(
        S=S, X=X,
        m=torch.tensor(int(np.asarray(fields["m"])), dtype=torch.int32,
                       device=dev),
        affine=affine,
        generation=torch.tensor(int(np.asarray(fields["generation"])),
                                dtype=torch.int32))


def snapshot_to_numpy(snap: ServingSnapshot) -> dict:
    """The snapshot's fields as numpy arrays (the affine fields None for a
    linear head)."""
    out = {k: getattr(snap, k).detach().cpu().numpy()
           for k in SNAPSHOT_FIELDS}
    for k in AffineCorrection._fields:
        out[k] = (None if snap.affine is None
                  else getattr(snap.affine, k).detach().cpu().numpy())
    return out


def _leaves(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _tensor(arr) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of its own type; bfloat16 (which numpy
    holds as the ``ml_dtypes`` extension type) goes through float32,
    exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def load_numpy_(module: torch.nn.Module, tree: dict, device=None
                ) -> torch.nn.Module:
    """Replace every parameter of ``module`` by the leaf of the same dotted
    path in the nested dict ``tree`` (the reference's parameter tree of
    the same layer, as numpy arrays), on ``device``, each leaf keeping its
    type; returns the module.  A leaf the module lacks, a parameter no
    leaf fills, or a shape that differs raises."""
    dev = resolve_device(device)
    flat = dict(_leaves(tree))
    names = dict(module.named_parameters())
    if set(names) != set(flat):
        raise ValueError(f"parameter trees differ: module only "
                         f"{sorted(set(names) - set(flat))[:5]}, reference "
                         f"only {sorted(set(flat) - set(names))[:5]}")
    for name, arr in flat.items():
        t = _tensor(arr)
        if t.shape != names[name].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(names[name].shape)}")
        mod_name, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(mod_name), leaf,
                torch.nn.Parameter(t.to(dev), requires_grad=False))
    return module


def lm_params_from_numpy(params: dict, cfg: ArchConfig, device=None
                         ) -> lm.LM:
    """The port's ``LM`` from the reference's ``lm.init_params`` tree as
    numpy arrays: ``{'embed', 'slots': {'slot{j}': leaves stacked over
    periods}, 'final_norm'}``.  Layer i takes period i // period of slot
    i % period: its mixer (attention, Mamba, mLSTM or sLSTM), and its FFN
    (dense, or the experts' ``router``, ``w_up``/``w_gate``/``w_down``
    banks and ``shared`` experts).  Every leaf keeps its type
    (``dt_bias``, ``a_log``, ``d_skip``, the router and the xLSTM gates
    are float32 in a bfloat16 model)."""
    tree = {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": {}}
    for i in range(cfg.n_layers):
        period, slot = divmod(i, cfg.period)
        tree["layers"][str(i)] = {
            k: np.asarray(v)[period]
            for k, v in _leaves(params["slots"][f"slot{slot}"])}
    model = lm.LM(cfg, torch.device("meta"))
    return load_numpy_(model, tree, device)
