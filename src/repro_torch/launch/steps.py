"""Train, serve and prefill step builders — the counterpart of the
reference's ``launch/steps.py`` (its sharding derivations have no
counterpart on one device).

``TrainState`` carries the step, the model (an ``LM``, whose parameters
are the leaves) and the optimizer state over the model's named
parameters; ``make_train_step`` returns ``train_step(state, batch) ->
(state, metrics)``, which updates the model in place.  The serve and
prefill steps keep no autograd graph (``torch.inference_mode``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.optim import OptState, make_optimizer
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.optim.schedules import Schedule, ScheduleConfig, make_schedule

Tensor = torch.Tensor


class TrainState(NamedTuple):
    step: Tensor      # 0-d int32 on the host
    params: lm.LM
    opt: OptState


def param_dict(model: lm.LM) -> dict:
    """The model's parameters by dotted name: the optimizer's tree."""
    return dict(model.named_parameters())


def init_train_state(cfg: ArchConfig, optimizer: Optimizer, seed: int = 0,
                     device=None) -> TrainState:
    """The model drawn from ``seed`` on ``device`` (``lm.init_params``) and
    a fresh optimizer state over its parameters."""
    params = lm.init_params(cfg, seed, device)
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=params,
                      opt=optimizer.init(param_dict(params)))


def _microbatches(batch: dict, accum: int) -> list[dict]:
    B = batch["tokens"].shape[0]
    if B % accum:
        raise ValueError(f"batch {B} is not a multiple of accum {accum}")
    mb = B // accum
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(accum)]


def make_train_step(cfg: ArchConfig, optimizer: Optimizer,
                    schedule: Schedule, *, accum: int = 1,
                    clip: float = 1.0):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss
    and its gradients (``lm.loss_fn``, remat per period), clipping to the
    global norm ``clip``, the rate of the optimizer's step and one
    optimizer update, in place.

    ``accum`` > 1 splits the batch into that many microbatches, run one
    after another (activation memory / accum); their gradients and losses
    add up in float32 and are divided by ``accum``; the metrics are the
    last microbatch's with the mean loss, as the reference's scan gives
    them.  Metrics stay on the device (no host read)."""

    def grads_of(params: lm.LM, batch: dict):
        loss, metrics = lm.loss_fn(params, cfg, batch)
        leaves = param_dict(params)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), metrics, dict(zip(leaves, grads))

    def train_step(state: TrainState, batch: dict):
        if accum == 1:
            loss, metrics, grads = grads_of(state.params, batch)
        else:
            loss = None
            grads = None
            for mb in _microbatches(batch, accum):
                l, metrics, g = grads_of(state.params, mb)
                if grads is None:
                    loss = l.float()
                    grads = {k: v.float() for k, v in g.items()}
                else:
                    loss = loss + l
                    for k, v in g.items():
                        grads[k].add_(v.float())
                del g
            loss = loss / accum
            for v in grads.values():
                v.div_(accum)
            metrics = dict(metrics, loss=loss)
        grads, gnorm = clip_by_global_norm(grads, clip)
        lr = schedule(state.opt.step)
        _, opt = optimizer.update(grads, state.opt, param_dict(state.params),
                                  lr)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(step=state.step + 1, params=state.params,
                          opt=opt), metrics

    return train_step


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, caches, token (B, 1), pos (B, 1)) ->
    (next_token (B, 1), logits, caches) — one greedy decode iteration."""

    @torch.inference_mode()
    def serve_step(params: lm.LM, caches, token: Tensor, pos: Tensor):
        logits, caches = lm.decode_step(params, cfg, caches, token, pos)
        nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(token.dtype)
        return nxt, logits, caches

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """prefill(params, batch) -> logits — the full-sequence forward (no
    cache, no graph; the prefill and perplexity path)."""

    @torch.inference_mode()
    def prefill(params: lm.LM, batch: dict) -> Tensor:
        return lm.forward(params, cfg, batch["tokens"],
                          batch.get("embeddings"))

    return prefill


def optimizer_for(arch_name: str) -> Optimizer:
    if "kimi" in arch_name:
        return make_optimizer("adafactor")
    return make_optimizer("adamw")


def schedule_for(arch_name: str, total: int = 10_000) -> Schedule:
    kind = "wsd" if "minicpm" in arch_name else "cosine"
    return make_schedule(ScheduleConfig(kind=kind, total=total))
