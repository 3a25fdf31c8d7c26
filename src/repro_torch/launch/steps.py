"""Serve and prefill step builders — the counterpart of the reference's
``launch/steps.py`` (``make_prefill_step`` and ``make_serve_step``; the
train step, the optimizers and the sharding derivations are not ported
yet: ROADMAP.md §1 item 11)."""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig

Tensor = torch.Tensor


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, caches, token (B, 1), pos (B, 1)) ->
    (next_token (B, 1), logits, caches) — one greedy decode iteration."""

    def serve_step(params: lm.LM, caches, token: Tensor, pos: Tensor):
        logits, caches = lm.decode_step(params, cfg, caches, token, pos)
        nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(token.dtype)
        return nxt, logits, caches

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """prefill(params, batch) -> logits — the full-sequence forward (no
    cache; the prefill and perplexity path)."""

    def prefill(params: lm.LM, batch: dict) -> Tensor:
        return lm.forward(params, cfg, batch["tokens"],
                          batch.get("embeddings"))

    return prefill
