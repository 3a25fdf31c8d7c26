"""Wrapper for the SSD intra-chunk kernel: a CPU tensor runs
``ref.ssd_intra_chunk_ref``, a CUDA tensor launches
``csrc/ssd_intra_chunk.cu`` or raises.  By x's type: bfloat16 launches the
tensor-core kernel (wgmma, TMA), float32 the SIMT kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

Tensor = torch.Tensor

MAX_CHUNK = 256           # a block keeps its rows' scores for all s <= t
MAX_HEAD_DIM = 64         # one 64-wide tile of a head's P columns
MAX_STATE_BF16 = 128      # bfloat16: c and b rows of at most two TMA boxes
TMA_BOX = 64              # bfloat16 per 128-byte TMA box row


def tma_state_dim(N: int) -> int:
    """The state width the bfloat16 kernel's tensor maps read for c and b:
    64 for N <= 64, 128 for N <= 128 (TMA boxes of 64 bf16, 16-byte
    strides); larger N raises."""
    if not 1 <= N <= MAX_STATE_BF16:
        raise ValueError(f"ssd_intra_chunk: bfloat16 state {N} not in "
                         f"1..{MAX_STATE_BF16}")
    return -(-N // TMA_BOX) * TMA_BOX


def pad_last(x: Tensor, width: int) -> Tensor:
    """``x`` zero-padded to ``width`` in its last dim and 16-byte aligned
    (a tensor map's base): the zeros add nothing to a score or to y.  No
    copy where it already is both."""
    if x.shape[-1] != width:
        x = F.pad(x, (0, width - x.shape[-1]))
    return x.clone() if x.data_ptr() % 16 else x


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
    if dtype == torch.bfloat16:
        # TMA boxes of 64 bf16: N padded to 64 or 128, P to 64; y keeps P.
        N = tma_state_dim(N)
        c, b, x = pad_last(c, N), pad_last(b, N), pad_last(x, TMA_BOX)
    cuda.launch("ssd_intra_chunk", dtype, c, b, x, cum, y, G, Q, N, H, P)
    return y
