"""Wrapper for the SSD intra-chunk kernel: a CPU tensor runs
``ref.ssd_intra_chunk_ref`` (differentiated by autograd), a CUDA tensor
launches ``csrc/ssd_intra_chunk.cu`` or raises.  By x's type: bfloat16
launches the tensor-core kernel (wgmma, TMA), float32 the SIMT kernel.  On
CUDA the call is a ``torch.autograd.Function`` whose backward launches
``csrc/ssd_intra_chunk_bwd.cu`` (``ref.ssd_intra_chunk_bwd_ref`` is its
plain version)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda
from repro_torch.kernels.ssd_chunk.ref import (ssd_intra_chunk_bwd_ref,
                                               ssd_intra_chunk_ref)

Tensor = torch.Tensor

MAX_CHUNK = 256           # a block keeps its rows' scores for all s <= t
MAX_HEAD_DIM = 64         # one 64-wide tile of a head's P columns
MAX_STATE_BF16 = 128      # bfloat16: c and b rows of at most two TMA boxes
TMA_BOX = 64              # bfloat16 per 128-byte TMA box row
TILE = 64                 # the backward's rows t (or columns s) per tile


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
    float32; returns (G, Q, H, P) in x's type.  Differentiable in all four
    operands: on CUDA the gradient is the backward kernel's."""
    if x.device.type == "cpu":
        return ssd_intra_chunk_ref(c, b, x, cum)
    return _IntraChunk.apply(c, b, x, cum)


class _IntraChunk(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient.  The
    operands are saved as they were passed (the bfloat16 forward pads
    copies of them for its tensor maps), so the gradients are those of the
    unpadded c, b, x and cum.  Under ``torch.utils.checkpoint`` the
    recomputation calls ``forward`` again: a second launch of the forward
    kernel."""

    @staticmethod
    def forward(ctx, c: Tensor, b: Tensor, x: Tensor, cum: Tensor) -> Tensor:
        ctx.save_for_backward(c, b, x, cum)
        return _forward(c, b, x, cum)

    @staticmethod
    def backward(ctx, dy: Tensor):
        return intra_chunk_backward(*ctx.saved_tensors, dy)


def _shapes(name: str, c: Tensor, b: Tensor, x: Tensor, cum: Tensor
            ) -> tuple[int, int, int, int, int]:
    """(G, Q, N, H, P) of the operands, checked against each other and
    the kernels' limits."""
    G, Q, H, P = x.shape
    N = c.shape[2]
    if (c.shape != (G, Q, N) or b.shape != c.shape
            or cum.shape != (G, Q, H) or cum.dtype != torch.float32):
        raise ValueError(f"{name}: c {tuple(c.shape)}, b "
                         f"{tuple(b.shape)}, x {tuple(x.shape)}, cum "
                         f"{tuple(cum.shape)} {cum.dtype} (cum is float32)")
    if Q > MAX_CHUNK or P > MAX_HEAD_DIM:
        raise ValueError(f"{name}: chunk {Q} > {MAX_CHUNK} or "
                         f"head dim {P} > {MAX_HEAD_DIM}")
    return G, Q, N, H, P


def _forward(c: Tensor, b: Tensor, x: Tensor, cum: Tensor) -> Tensor:
    """One launch of the forward kernel on CUDA operands."""
    dtype = cuda.check_operands("ssd_intra_chunk", x, c, b)
    cuda.check_operands("ssd_intra_chunk", cum)
    G, Q, N, H, P = _shapes("ssd_intra_chunk", c, b, x, cum)
    y = torch.empty_like(x)
    if dtype == torch.bfloat16:
        # TMA boxes of 64 bf16: N padded to 64 or 128, P to 64; y keeps P.
        N = tma_state_dim(N)
        c, b, x = pad_last(c, N), pad_last(b, N), pad_last(x, TMA_BOX)
    cuda.launch("ssd_intra_chunk", dtype, c, b, x, cum, y, G, Q, N, H, P)
    return y


def intra_chunk_backward(c: Tensor, b: Tensor, x: Tensor, cum: Tensor,
                         dy: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(dc, db, dx, dcum) of the intra-chunk term from its operands and
    the output's gradient dy (G, Q, H, P), in the operands' types (dcum
    float32): one launch of the backward kernel (three device kernels in
    order, float32 scratch for dS and Z's row and column sums), or on the
    CPU the plain version.  The same limits as the forward's: Q <= 256,
    P <= 64, bfloat16 N <= 128."""
    dy = dy.to(x.dtype).contiguous()
    if x.device.type == "cpu":
        return ssd_intra_chunk_bwd_ref(c, b, x, cum, dy)
    dtype = cuda.check_operands("ssd_intra_chunk_bwd", x, c, b, dy)
    cuda.check_operands("ssd_intra_chunk_bwd", cum)
    G, Q, N, H, P = _shapes("ssd_intra_chunk_bwd", c, b, x, cum)
    if dy.shape != x.shape:
        raise ValueError(f"ssd_intra_chunk_bwd: dy {tuple(dy.shape)} is not "
                         f"x's {tuple(x.shape)}")
    if dtype == torch.bfloat16:
        tma_state_dim(N)                    # the forward's limit on N
    nt = -(-Q // TILE)
    f32 = dict(dtype=torch.float32, device=x.device)
    dS = torch.empty((G, Q, Q), **f32)
    rowpart = torch.empty((G, nt, H, Q), **f32)
    colpart = torch.empty_like(rowpart)
    dc, db, dx = torch.empty_like(c), torch.empty_like(b), torch.empty_like(x)
    dcum = torch.empty_like(cum)
    cuda.launch("ssd_intra_chunk_bwd", dtype, c, b, x, cum, dy, dc, db, dx,
                dcum, dS, rowpart, colpart, G, Q, N, H, P)
    return dc, db, dx, dcum
