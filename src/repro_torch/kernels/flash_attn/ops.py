"""Wrapper for the causal flash-attention kernels: a CPU tensor runs
``ref.flash_attention_ref`` (differentiated by autograd), a CUDA tensor
launches ``csrc/flash_attention.cu`` or raises.  By the operands' type:
bfloat16 launches the tensor-core kernel (wgmma, TMA), float32 the SIMT
kernel.  On CUDA the call is a ``torch.autograd.Function`` whose backward
launches ``csrc/flash_attention_bwd.cu`` (``ref.flash_attention_bwd_ref``
is its plain version)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda
from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                flash_attention_ref)

Tensor = torch.Tensor

MAX_HEAD_DIM = 128        # the largest head dim either kernel takes


def tma_head_dim(hd: int) -> int:
    """The head dim the bfloat16 kernel's tensor maps read: 64 for
    hd <= 64, else 128 (TMA boxes of 64 bf16, 16-byte strides)."""
    return 64 if hd <= 64 else 128


def pad_head_dim(x: Tensor, hdp: int) -> Tensor:
    """``x`` (B, T, heads, hd) zero-padded to hdp columns: the zeros add
    nothing to a dot product, so attention over the padded operands,
    scaled by 1/sqrt(hd) of the true hd, is attention over ``x``.  No copy
    where hd is already hdp."""
    return x if x.shape[-1] == hdp else F.pad(x, (0, hdp - x.shape[-1]))


def causal_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal softmax attention in the model's layout: q (B, T, H, hd),
    k and v (B, T, Hkv, hd), H a multiple of Hkv (q head h reads kv head
    h // (H / Hkv), no copy of k and v to H heads); returns (B, T, H, hd)
    in q's type.  float32 or bfloat16, scores and sums in float32.
    Differentiable: on CUDA the gradient is the backward kernel's."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    return _FlashAttention.apply(q, k, v)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient.  The
    operands are saved as they were passed (hd unpadded), so the gradients
    are those of the unpadded q, k and v.  Under
    ``torch.utils.checkpoint`` the recomputation calls ``forward`` again,
    a second launch of the forward kernel."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        out = _forward(q, k, v)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout: Tensor):
        q, k, v, out = ctx.saved_tensors
        return attention_backward(q, k, v, out, dout)


def attention_backward(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                       dout: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of causal attention from its operands, its output and
    the output's gradient, in the operands' type: one launch of the
    backward kernel (its two passes: dq with each row's log-sum-exp and
    rowsum(dout * out), then dk and dv), or on the CPU the plain
    version."""
    dout = dout.to(q.dtype).contiguous()
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, dout)
    dtype = cuda.check_operands("flash_attention_bwd", q, k, v, out, dout)
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    if (k.shape != (B, T, Hkv, hd) or v.shape != k.shape
            or out.shape != q.shape or H % Hkv or hd > MAX_HEAD_DIM):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse)
    cuda.launch("flash_attention_bwd", dtype, q, k, v, out, dout, dq, dk, dv,
                lse, dsum, B, T, H, Hkv, hd, 1.0 / hd ** 0.5)
    return dq, dk, dv


def _forward(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """One launch of the forward kernel on CUDA operands."""
    dtype = cuda.check_operands("flash_attention", q, k, v)
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    if (q.dim() != 4 or k.shape != (B, T, Hkv, hd) or v.shape != k.shape
            or H % Hkv):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} > "
                         f"{MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if dtype == torch.bfloat16:
        hdp = tma_head_dim(hd)
        q, k, v = (pad_head_dim(x, hdp) for x in (q, k, v))
        # A tensor map's base must be 16-byte aligned.
        q, k, v = (x.clone() if x.data_ptr() % 16 else x for x in (q, k, v))
    cuda.launch("flash_attention", dtype, q, k, v, out, B, T, H, Hkv, hd,
                1.0 / hd ** 0.5)
    return out
