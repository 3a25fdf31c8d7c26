"""Optimizers, the counterpart of the reference's ``optim/optimizers.py``.

* ``adamw``: float32 moments, decoupled weight decay on matrices only
  (``ndim >= 2``), the update cast to the parameter's type.
* ``adafactor``: the factored second moment (row and column statistics)
  for ``ndim >= 2``; O(r + c) state per matrix.
* ``sgdm``: momentum SGD, the baseline.

Each exposes ``init(params) -> OptState`` and ``update(grads, state,
params, lr) -> (params, state)``, over a dict of named tensors (the
port's ``dict(model.named_parameters())``).  The state keeps the
reference's names: ``step`` and ``inner`` (``{'mu', 'nu'}`` for adamw,
per leaf ``{'vr', 'vc'}`` or ``{'v'}`` for adafactor, the momentum for
sgdm), so ``core/convert.train_state_to_numpy`` lays it out as the
reference's tree and a checkpoint loads in either package.  ``step`` is
a 0-d int32 tensor on the host, so a schedule reads it without a device
sync.

Unlike the reference, which returns new arrays, ``update`` writes the new
parameters and moments in place (leaf by leaf, under ``no_grad``): a
full-width model keeps one copy of each.  ``torch.optim.AdamW`` is not
used: it keeps its moments in the parameter's type (bfloat16 here) and
decays vectors too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor


class OptState(NamedTuple):
    step: Tensor     # 0-d int32, on the host
    inner: dict


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], OptState]
    update: Callable[..., tuple[dict, OptState]]
    name: str = "opt"


def _zero_step() -> Tensor:
    return torch.zeros((), dtype=torch.int32)


def _zeros32(p: Tensor) -> Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def global_norm(tree: dict) -> Tensor:
    """The float32 2-norm over every leaf (a 0-d tensor on the leaves'
    device: no host read)."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in tree.values()]
    return torch.sqrt(sum(n * n for n in norms))


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float
                        ) -> tuple[dict, Tensor]:
    """Scale every gradient by min(1, max_norm / norm), in float32, cast
    back to each gradient's type (in place); returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    for g in grads.values():
        g.copy_(g.float() * scale)
    return grads, norm


# ------------------------------------------------------------------ AdamW --
def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params: dict) -> OptState:
        return OptState(step=_zero_step(),
                        inner={"mu": {k: _zeros32(p) for k, p in
                                      params.items()},
                               "nu": {k: _zeros32(p) for k, p in
                                      params.items()}})

    @torch.no_grad()
    def update(grads: dict, state: OptState, params: dict, lr: float):
        step = state.step + 1
        t = float(step)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        mus, nus = state.inner["mu"], state.inner["nu"]
        for k, p in params.items():
            g = grads[k].float()
            mu, nu = mus[k], nus[k]
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g * g)
            u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
            del g
            pf = p.float()
            if p.dim() >= 2:                 # decoupled decay, matrices only
                u.add_(weight_decay * pf)
            p.copy_(pf - lr * u)
        return params, OptState(step=step, inner=state.inner)

    return Optimizer(init=init, update=update, name="adamw")


# --------------------------------------------------------------- Adafactor --
def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_pow: float = 0.8, weight_decay: float = 0.0
              ) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018)."""

    def _factored(p: Tensor) -> bool:
        return p.dim() >= 2 and p.shape[-1] >= 2 and p.shape[-2] >= 2

    def init(params: dict) -> OptState:
        def st(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros32(p)}
        return OptState(step=_zero_step(),
                        inner={k: st(p) for k, p in params.items()})

    @torch.no_grad()
    def update(grads: dict, state: OptState, params: dict, lr: float):
        step = state.step + 1
        beta = 1.0 - float(step) ** (-decay_pow)
        for k, p in params.items():
            g = grads[k].float()
            v = state.inner[k]
            g2 = g * g + eps
            if _factored(p):
                v["vr"].mul_(beta).add_((1 - beta) * g2.mean(-1))
                v["vc"].mul_(beta).add_((1 - beta) * g2.mean(-2))
                denom = torch.clamp_min(v["vr"].mean(-1, keepdim=True),
                                        eps)[..., None]          # (..., 1, 1)
                u = (g * torch.rsqrt(v["vr"][..., None] / denom)
                     * torch.rsqrt(v["vc"][..., None, :]))
            else:
                v["v"].mul_(beta).add_((1 - beta) * g2)
                u = g * torch.rsqrt(v["v"])
            del g, g2
            # Update clipping (RMS <= clip_threshold).
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            pf = p.float()
            if weight_decay and p.dim() >= 2:
                u = u + weight_decay * pf
            p.copy_(pf - lr * u)
        return params, OptState(step=step, inner=state.inner)

    return Optimizer(init=init, update=update, name="adafactor")


# -------------------------------------------------------------------- SGDm --
def sgdm(momentum: float = 0.9) -> Optimizer:
    def init(params: dict) -> OptState:
        return OptState(step=_zero_step(),
                        inner={k: _zeros32(p) for k, p in params.items()})

    @torch.no_grad()
    def update(grads: dict, state: OptState, params: dict, lr: float):
        step = state.step + 1
        for k, p in params.items():
            m = state.inner[k]
            m.mul_(momentum).add_(grads[k].float())
            p.copy_(p.float() - lr * m)
        return params, OptState(step=step, inner=state.inner)

    return Optimizer(init=init, update=update, name="sgdm")


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    if name == "sgdm":
        return sgdm(**kw)
    raise ValueError(name)
