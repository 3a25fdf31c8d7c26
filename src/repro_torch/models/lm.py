"""Full LM assembly over heterogeneous block patterns — the counterpart of
the reference's ``models/lm.py``.

A config's ``block_pattern`` defines one period of layers (Jamba's 7 mamba
+ 1 attention); the network repeats it ``n_layers // period`` times.  The
reference stacks each slot's parameters over periods and scans over
periods; here the layers are an ``nn.ModuleList`` over ``n_layers`` and
the scan is a loop (layer i is slot i % period of period i // period).

The port runs block kinds ``attn`` (full or Nyström attention),
``mamba``, ``mlstm`` and ``slstm`` with FFN kinds ``dense``, ``moe`` and
``none``.  ``forward`` is differentiable (``loss_fn`` trains through it,
with ``remat`` per period as the reference's ``jax.checkpoint``); the
serving entry points ask for no graph (``decode_step`` runs under
``torch.inference_mode``, as do ``launch/steps``'s prefill and serve
steps).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import moe as moe_mod
from repro_torch.models import nystrom_attention as nys
from repro_torch.models import ssm, xlstm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (MLP, Attention, Embed, RMSNorm,
                                       attention_apply, attention_cache_init,
                                       attention_decode, embed_apply,
                                       logits_apply, mlp_apply, model_dtype,
                                       rmsnorm_apply)

Tensor = torch.Tensor

MIXERS = {"attn": Attention, "mamba": ssm.Mamba, "mlstm": xlstm.MLSTM,
          "slstm": xlstm.SLSTM}


def check_config(cfg: ArchConfig) -> None:
    """Raise for a config the port cannot build."""
    if cfg.attention not in ("full", "nystrom"):
        raise ValueError(f"{cfg.name}: unknown attention "
                         f"{cfg.attention!r}")
    bad = sorted(set(cfg.block_pattern) - set(MIXERS))
    if bad:
        raise ValueError(f"{cfg.name}: unknown block kinds {bad}")
    if cfg.n_layers % cfg.period:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of the period {cfg.period}")


class Block(nn.Module):
    """One layer: norm1 and the mixer, then norm2 and the FFN (or both on
    the same normed input for a parallel block)."""

    def __init__(self, cfg: ArchConfig, i: int, device=None):
        super().__init__()
        self.kind, self.ffn_kind = cfg.block_kind(i), cfg.ffn_kind(i)
        dt = model_dtype(cfg)
        self.norm1 = RMSNorm(cfg.d_model, dt, device)
        mixer = MIXERS[self.kind]
        if self.kind == "attn" and cfg.attention == "nystrom":
            mixer = nys.NystromAttention
        self.mixer = mixer(cfg, device)
        if self.ffn_kind != "none" and not cfg.parallel_block:
            self.norm2 = RMSNorm(cfg.d_model, dt, device)
        if self.ffn_kind == "dense":
            self.ffn = MLP(cfg, device=device)
        elif self.ffn_kind == "moe":
            self.ffn = moe_mod.MoE(cfg, device)


class LM(nn.Module):
    """``embed`` (table, head), ``layers`` and ``final_norm``, with the
    config it was built for; ``forward`` and ``decode_step`` below run
    it."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        self.layers = nn.ModuleList(Block(cfg, i, device)
                                    for i in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, model_dtype(cfg), device)


# ------------------------------------------------------------- init ---------
@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> LM:
    """The model with parameters drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (on the card for a card model: no host
    draw, no copy), by the reference's ``init_params`` distributions."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    model = LM(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(gen)
    return model


# ------------------------------------------------------------ forward -------
def _mixer_apply(p, cfg: ArchConfig, kind: str, h: Tensor,
                 positions: Tensor) -> Tensor:
    if kind == "attn":
        if cfg.attention == "nystrom":
            return nys.nystrom_attention_apply(p, cfg, h, positions)
        return attention_apply(p, cfg, h, positions)
    if kind == "mamba":
        return ssm.mamba_apply(p, cfg, h)
    if kind == "mlstm":
        return xlstm.mlstm_apply(p, cfg, h)
    return xlstm.slstm_apply(p, cfg, h)


def _ffn_apply(p: Block, cfg: ArchConfig, h: Tensor) -> Tensor:
    if p.ffn_kind == "moe":
        return moe_mod.moe_apply(p.ffn, cfg, h)
    return mlp_apply(p.ffn, cfg, h)


def _block(p: Block, cfg: ArchConfig, h: Tensor, positions: Tensor
           ) -> Tensor:
    rs = cfg.residual_scale
    hn = rmsnorm_apply(p.norm1, h)
    if cfg.parallel_block and p.ffn_kind != "none":
        # command-r style: attention and FFN read the same normed input.
        return h + rs * (_mixer_apply(p.mixer, cfg, p.kind, hn, positions)
                         + _ffn_apply(p, cfg, hn))
    h = h + rs * _mixer_apply(p.mixer, cfg, p.kind, hn, positions)
    if p.ffn_kind != "none":
        h = h + rs * _ffn_apply(p, cfg, rmsnorm_apply(p.norm2, h))
    return h


def embed_tokens(params: LM, cfg: ArchConfig, tokens: Tensor,
                 embeddings: Tensor | None = None) -> Tensor:
    """Token embedding; modality frontends supply the first
    ``frontend_len`` positions as precomputed embeddings."""
    h = embed_apply(params.embed, tokens)
    if cfg.frontend == "embeddings" and embeddings is not None:
        F_ = cfg.frontend_len
        h = torch.cat([embeddings.to(h.dtype), h[:, F_:]], dim=1)
    return h


def _period(layers, cfg: ArchConfig, h: Tensor, positions: Tensor
            ) -> Tensor:
    for layer in layers:
        h = _block(layer, cfg, h, positions)
    return h


def forward(params: LM, cfg: ArchConfig, tokens: Tensor,
            embeddings: Tensor | None = None, *, remat: bool = True
            ) -> Tensor:
    """tokens: (B, T) -> logits (B, T, vocab).  Differentiable.  With
    ``remat`` and grad mode on, each period of layers runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are not
    kept but computed again in the backward, as the reference's
    ``jax.checkpoint`` per period does (the same function, the same
    numbers).  Without grad mode ``remat`` changes nothing."""
    B, T = tokens.shape
    h = embed_tokens(params, cfg, tokens, embeddings)
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    remat = remat and torch.is_grad_enabled()
    for i in range(0, cfg.n_layers, cfg.period):
        period = params.layers[i:i + cfg.period]
        if remat:
            h = checkpoint(_period, period, cfg, h, positions,
                           use_reentrant=False)
        else:
            h = _period(period, cfg, h, positions)
    h = rmsnorm_apply(params.final_norm, h)
    return logits_apply(params.embed, cfg, h)


def loss_fn(params: LM, cfg: ArchConfig, batch: dict, *, remat: bool = True
            ) -> tuple[Tensor, dict]:
    """Next-token cross entropy in float32, the reference's ``loss_fn``:
    labels < 0 are masked (frontend positions, padding).  Returns (loss,
    {'loss', 'accuracy', 'tokens'}).  The label's logit is gathered (the
    reference's one-hot reduction keeps its vocab axis sharded; here there
    is one device), the normaliser is the float32 log-sum-exp.  ``remat``
    as ``forward``'s."""
    logits = forward(params, cfg, batch["tokens"], batch.get("embeddings"),
                     remat=remat)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    l32 = logits.float()
    lse = torch.logsumexp(l32, dim=-1)                         # (B, T)
    label_logit = torch.gather(l32, -1, labels.clamp_min(0)[..., None]
                               )[..., 0]
    ll = label_logit - lse
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = -(ll * mask).sum() / denom
    with torch.no_grad():
        hit = (torch.argmax(logits, dim=-1) == labels).float()
        acc = (hit * mask).sum() / denom
    return loss, {"loss": loss.detach(), "accuracy": acc,
                  "tokens": mask.sum()}


# ------------------------------------------------------------- decode -------
def _mixer_cache_init(p, cfg: ArchConfig, kind: str, batch: int,
                      max_seq: int, device):
    if kind == "attn":
        if cfg.attention == "nystrom":
            return nys.nystrom_cache_init(p, cfg, batch)
        return attention_cache_init(cfg, batch, max_seq, device)
    if kind == "mamba":
        return ssm.mamba_cache_init(cfg, batch, device)
    if kind == "mlstm":
        return xlstm.mlstm_cache_init(cfg, batch, device)
    return xlstm.slstm_cache_init(cfg, batch, device)


@torch.no_grad()
def init_caches(params: LM, cfg: ArchConfig, batch: int, max_seq: int
                ) -> list[dict]:
    """One decode cache per layer, ``{'mixer': ...}``: the KV cache of an
    attention layer (a ``NystromCache`` for Nyström attention), the chunk
    state and conv window of a Mamba layer, the
    recurrent state of an xLSTM layer; an MoE layer adds ``'ffn'``, its
    per-expert counts and the capacity of a ``max_seq``-token prefill
    (``moe.moe_cache_init``)."""
    dev = params.final_norm.scale.device
    caches = []
    for layer in params.layers:
        cache = {"mixer": _mixer_cache_init(layer.mixer, cfg, layer.kind,
                                            batch, max_seq, dev)}
        if layer.ffn_kind == "moe":
            cache["ffn"] = moe_mod.moe_cache_init(cfg, batch, max_seq, dev)
        caches.append(cache)
    return caches


def _mixer_decode(p, cfg: ArchConfig, kind: str, h: Tensor, cache: dict,
                  pos: Tensor) -> tuple[Tensor, dict]:
    if kind == "attn":
        if cfg.attention == "nystrom":
            return nys.nystrom_decode(p, cfg, h, cache, pos)
        return attention_decode(p, cfg, h, cache, pos)
    if kind == "mamba":
        return ssm.mamba_decode(p, cfg, h, cache)
    if kind == "mlstm":
        return xlstm.mlstm_decode(p, cfg, h, cache)
    return xlstm.slstm_decode(p, cfg, h, cache)


@torch.inference_mode()
def decode_step(params: LM, cfg: ArchConfig, caches: list[dict],
                token: Tensor, pos: Tensor) -> tuple[Tensor, list[dict]]:
    """One decode step.  token: (B, 1) integers; pos: (B, 1) positions.
    Returns (logits (B, 1, vocab), the updated caches).  Serving: runs
    under ``torch.inference_mode`` (no graph, caches updated in place)."""
    h = embed_apply(params.embed, token)
    rs = cfg.residual_scale
    new_caches = []
    for layer, cache in zip(params.layers, caches):
        hn = rmsnorm_apply(layer.norm1, h)
        y, mixer_cache = _mixer_decode(layer.mixer, cfg, layer.kind, hn,
                                       cache["mixer"], pos)
        new_cache = {"mixer": mixer_cache}

        def ffn_decode(x):
            # An MoE layer threads its count cache, so decode replays the
            # prefill's capacity drops.
            if layer.ffn_kind == "moe":
                out, new_cache["ffn"] = moe_mod.moe_decode(
                    layer.ffn, cfg, x, cache["ffn"])
                return out
            return mlp_apply(layer.ffn, cfg, x)

        if cfg.parallel_block and layer.ffn_kind != "none":
            h = h + rs * (y + ffn_decode(hn))
        else:
            h = h + rs * y
            if layer.ffn_kind != "none":
                h = h + rs * ffn_decode(rmsnorm_apply(layer.norm2, h))
        new_caches.append(new_cache)
    h = rmsnorm_apply(params.final_norm, h)
    return logits_apply(params.embed, cfg, h), new_caches
