"""Deterministic synthetic token stream (step-indexed generator) — the
counterpart of the reference's ``data/synthetic.py``.

Every batch is a function of (seed, step) alone: a Zipf-distributed stream
in which, with probability 1/2, token t is a fixed permutation of token
t - 1 (a Markov chain a model can learn), else a fresh Zipf draw.  The
draws come from a ``torch.Generator``, so the tokens are not the
reference's bits (the tests hand both packages the same numpy tokens).

``frontend_embeddings`` attaches the modality frontends' stub embeddings.
The reference's ``make_batch_specs`` builds the dry run's shape stand-ins
and is not ported (the dry run parses XLA HLO; ROADMAP.md §1).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ArchConfig

Tensor = torch.Tensor


def _generator(seed: int) -> torch.Generator:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


@dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.1

    def _zipf_probs(self) -> Tensor:
        ranks = torch.arange(1, self.vocab + 1, dtype=torch.float64)
        w = ranks ** -self.zipf_a
        return w / w.sum()

    def batch_at(self, step: int, device=None) -> dict:
        """{'tokens', 'labels'} (B, T) int64 for ``step``; labels are the
        next tokens, -1 at the last position."""
        B, T = self.global_batch, self.seq_len
        gen = _generator(self.seed * 1_000_003 + int(step))
        base = torch.multinomial(self._zipf_probs(), B * T, replacement=True,
                                 generator=gen).reshape(B, T)
        gate = torch.rand((B, T - 1), generator=gen) < 0.5
        perm = torch.randperm(self.vocab, generator=_generator(self.seed + 1))
        tokens = base.clone()
        for t in range(1, T):
            tokens[:, t] = torch.where(gate[:, t - 1], perm[tokens[:, t - 1]],
                                       base[:, t])
        labels = torch.cat([tokens[:, 1:], torch.full((B, 1), -1,
                                                      dtype=tokens.dtype)], 1)
        return {"tokens": tokens.to(device), "labels": labels.to(device)}


def frontend_embeddings(cfg: ArchConfig, batch: dict, seed: int = 7) -> dict:
    """Attach stub modality embeddings (precomputed frame or patch
    features): for a config with ``frontend == 'embeddings'``, ``batch``
    gains ``embeddings`` (B, frontend_len, d_model) of N(0, 0.02²) draws
    from a ``torch.Generator`` seeded with ``seed`` (on the tokens'
    device, in the model's type) and its labels over those positions
    become -1; any other batch is returned as it is."""
    if cfg.frontend != "embeddings":
        return batch
    tokens = batch["tokens"]
    gen = torch.Generator(device=tokens.device)
    gen.manual_seed(seed)
    emb = torch.randn((tokens.shape[0], cfg.frontend_len, cfg.d_model),
                      generator=gen, device=tokens.device) * 0.02
    labels = batch["labels"].clone()
    labels[:, :cfg.frontend_len] = -1
    return {**batch, "embeddings": emb.to(getattr(torch, cfg.dtype)),
            "labels": labels}
