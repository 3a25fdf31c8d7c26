"""Wrapper for the SSD intra-chunk kernel: a CPU tensor runs
``ref.ssd_intra_chunk_ref``, a CUDA tensor launches
``csrc/ssd_intra_chunk.cu`` or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

Tensor = torch.Tensor

MAX_CHUNK = 256           # a block keeps its rows' scores for all s <= t
MAX_HEAD_DIM = 64         # a thread row holds 4 of a head's P columns


def intra_chunk(c: Tensor, b: Tensor, x: Tensor, cum: Tensor) -> Tensor:
    """The intra-chunk term of every chunk in one launch: c, b (G, Q, N)
    and x (G, Q, H, P) of one type (float32 or bfloat16), cum (G, Q, H)
    float32; returns (G, Q, H, P) in x's type."""
    if x.device.type == "cpu":
        return ssd_intra_chunk_ref(c, b, x, cum)
    dtype = cuda.check_operands("ssd_intra_chunk", x, c, b)
    cuda.check_operands("ssd_intra_chunk", cum)
    G, Q, H, P = x.shape
    N = c.shape[2]
    if (c.shape != (G, Q, N) or b.shape != c.shape
            or cum.shape != (G, Q, H) or cum.dtype != torch.float32):
        raise ValueError(f"ssd_intra_chunk: c {tuple(c.shape)}, b "
                         f"{tuple(b.shape)}, x {tuple(x.shape)}, cum "
                         f"{tuple(cum.shape)} {cum.dtype} (cum is float32)")
    if Q > MAX_CHUNK or P > MAX_HEAD_DIM:
        raise ValueError(f"ssd_intra_chunk: chunk {Q} > {MAX_CHUNK} or "
                         f"head dim {P} > {MAX_HEAD_DIM}")
    y = torch.empty_like(x)
    cuda.launch("ssd_intra_chunk", dtype, c, b, x, cum, y, G, Q, N, H, P)
    return y
