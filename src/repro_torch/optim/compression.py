"""Int8 gradient compression with error feedback, the counterpart of the
reference's ``optim/compression.py``:

    e_t      <- the residual of the previous step
    q_t      =  Q(g_t + e_t)                 (blockwise symmetric int8)
    e_{t+1}  =  (g_t + e_t) - DQ(q_t)

The int8 payload and its float32 per-block scales are all-gathered over a
``torch.distributed`` group (the reference's ``all_gather`` over the pod
axis inside ``shard_map``), dequantised and averaged locally: one byte an
entry on the wire (plus 4/256 of scales) against the float32 all-reduce's
four.  Without an initialised process group, or on a group of one rank,
it is the reference's ``npods=1`` case.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor

BLOCK = 256


class CompressionState(NamedTuple):
    error: dict     # error-feedback residual per gradient, float32


def init_state(grads_like: dict) -> CompressionState:
    return CompressionState(error={
        k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for k, g in grads_like.items()})


def _pad_to_block(x: Tensor) -> tuple[Tensor, int]:
    n = x.numel()
    np_ = -(-n // BLOCK) * BLOCK
    flat = torch.nn.functional.pad(x.reshape(-1), (0, np_ - n))
    return flat.reshape(-1, BLOCK), n


def compress_int8(g: Tensor) -> tuple[Tensor, Tensor]:
    """Blockwise symmetric int8 quantisation: (q (nblocks, 256) int8,
    scales (nblocks,) float32), round half to even as the reference's."""
    blocks, _ = _pad_to_block(g.float())
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def decompress_int8(q: Tensor, scale: Tensor, shape: tuple, n: int
                    ) -> Tensor:
    deq = q.float() * scale[:, None]
    return deq.reshape(-1)[:n].reshape(shape)


def _world(group) -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _all_gather(x: Tensor, group, world: int) -> Tensor:
    """(world, *x.shape): every rank's x in rank order."""
    if world == 1:
        return x[None]
    out = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


def compressed_psum(grads: dict, state: CompressionState, group=None
                    ) -> tuple[dict, CompressionState]:
    """The error-feedback int8 mean of ``grads`` over ``group`` (every rank
    calls it with its own gradients): quantise locally, all-gather the int8
    payload and the scales, dequantise, sum the ranks in rank order and
    divide by their count.  Returns (mean gradients in each gradient's
    type, the new state)."""
    world = _world(group)
    means, errors = {}, {}
    for k, g in grads.items():
        target = g.float() + state.error[k]
        q, scale = compress_int8(target)
        q_all = _all_gather(q, group, world)            # (P, nblocks, BLOCK)
        s_all = _all_gather(scale, group, world)        # (P, nblocks)
        deq = torch.sum(q_all.float() * s_all[..., None], dim=0)
        means[k] = (deq.reshape(-1)[:g.numel()].reshape(g.shape)
                    / world).to(g.dtype)
        errors[k] = target - decompress_int8(q, scale, g.shape, g.numel())
    return means, CompressionState(error=errors)
