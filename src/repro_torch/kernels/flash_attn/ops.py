"""Wrapper for the causal flash-attention kernels: a CPU tensor runs
``ref.flash_attention_ref`` (differentiated by autograd), a CUDA tensor
launches ``csrc/flash_attention.cu`` or raises.  By the operands' type:
bfloat16 launches the tensor-core kernel (wgmma, TMA), float32 the SIMT
kernel.  On CUDA the call is a ``torch.autograd.Function`` whose backward
launches ``csrc/flash_attention_bwd.cu`` (``ref.flash_attention_bwd_ref``
is its plain version).  When a gradient will be taken, the bfloat16
forward also writes each row's log-sum-exp, which the bfloat16 backward
reads (``ref.flash_attention_lse_ref`` is its plain version)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda
from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                flash_attention_lse_ref,
                                                flash_attention_ref)

Tensor = torch.Tensor

MAX_HEAD_DIM = 128        # the largest head dim either kernel takes
LSE_ROWS = 64             # csrc/common.cuh kLseRows


def lse_len(T: int) -> int:
    """Row stride of the bfloat16 kernels' float32 (B, H, T) log-sum-exp
    and rowsum(dout * out) arrays: T rounded up to the backward's 64-row
    query tile (``csrc/common.cuh`` ``lse_stride``)."""
    return -(-T // LSE_ROWS) * LSE_ROWS


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
    # Decided here: grad mode is off inside a Function's forward.
    want_lse = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    return _FlashAttention.apply(q, k, v, want_lse)


def attention_with_lse(q: Tensor, k: Tensor, v: Tensor
                       ) -> tuple[Tensor, Tensor]:
    """``causal_attention``'s output and each row's log-sum-exp, float32
    (B, H, T) in the bfloat16 kernel's base-2 units, as the forward
    computes them when a gradient will be taken: on CUDA one launch of the
    bfloat16 kernel that writes both (no autograd graph), on the CPU the
    plain versions."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v), flash_attention_lse_ref(q, k)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: the log-sum-exp output is the "
                        f"bfloat16 kernel's, got {q.dtype}")
    out, lse = _forward(q, k, v, want_lse=True)
    return out, lse[..., :q.shape[1]]


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient.  The
    operands are saved as they were passed (hd unpadded), so the gradients
    are those of the unpadded q, k and v; in bfloat16 the forward's
    log-sum-exp is saved beside them.  Under ``torch.utils.checkpoint``
    the recomputation calls ``forward`` again (with grad on, so it writes
    the log-sum-exp the backward reads), a second launch of the forward
    kernel."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor,
                want_lse: bool) -> Tensor:
        out, lse = _forward(q, k, v, want_lse)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout: Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        return (*attention_backward(q, k, v, out, dout, lse), None)


def attention_backward(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                       dout: Tensor, lse: Tensor | None = None
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of causal attention from its operands, its output and
    the output's gradient, in the operands' type: one launch of the
    backward kernel, or on the CPU the plain version.

    ``lse`` is each row's log-sum-exp in the kernel's base-2 units
    (``ref.flash_attention_lse_ref``): float32 (B, H, T), or the bfloat16
    forward's (B, H, ``lse_len(T)``) buffer.  The bfloat16 kernel needs it
    (rowsum(dout * out), then dk and dv, then dq); the float32 kernel
    computes its own (dq with each row's log-sum-exp and rowsum(dout *
    out), then dk and dv) and ignores it; the plain version recomputes it
    where it is None."""
    dout = dout.to(q.dtype).contiguous()
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, dout, lse)
    dtype = cuda.check_operands("flash_attention_bwd", q, k, v, out, dout)
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    if (k.shape != (B, T, Hkv, hd) or v.shape != k.shape
            or out.shape != q.shape or H % Hkv or hd > MAX_HEAD_DIM):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dtype == torch.float32:
        lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        dsum = torch.empty_like(lse)
    else:
        Tp = lse_len(T)
        if (lse is None or lse.dtype != torch.float32
                or lse.device != q.device or lse.shape[:2] != (B, H)
                or lse.shape[2] not in (T, Tp)):
            raise ValueError(
                f"flash_attention_bwd: bfloat16 needs the forward's float32 "
                f"log-sum-exp of shape ({B}, {H}, {T} or {Tp}), got "
                f"{None if lse is None else tuple(lse.shape)}")
        if lse.shape[2] != Tp:
            lse = F.pad(lse, (0, Tp - T))
        lse = lse.contiguous()
        dsum = torch.empty_like(lse)
        q, k, v, out, dout = _tma_operands(hd, q, k, v, out, dout)
    cuda.launch("flash_attention_bwd", dtype, q, k, v, out, dout, dq, dk, dv,
                lse, dsum, B, T, H, Hkv, hd, 1.0 / hd ** 0.5)
    return dq, dk, dv


def _tma_operands(hd: int, *xs: Tensor) -> tuple[Tensor, ...]:
    """The bfloat16 kernels' operands as their tensor maps read them: the
    head dim zero-padded to ``tma_head_dim(hd)``, the base 16-byte
    aligned."""
    hdp = tma_head_dim(hd)
    xs = (pad_head_dim(x, hdp) for x in xs)
    return tuple(x.clone() if x.data_ptr() % 16 else x for x in xs)


def _forward(q: Tensor, k: Tensor, v: Tensor, want_lse: bool = False
             ) -> tuple[Tensor, Tensor | None]:
    """One launch of the forward kernel on CUDA operands; in bfloat16 with
    ``want_lse`` it also returns each row's log-sum-exp, float32 (B, H,
    ``lse_len(T)``) in the kernel's base-2 units (rows past T unwritten),
    else None."""
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
    out, lse = torch.empty_like(q), None
    if dtype == torch.bfloat16:
        q, k, v = _tma_operands(hd, q, k, v)
        if want_lse:
            lse = torch.empty((B, H, lse_len(T)), dtype=torch.float32,
                              device=q.device)
    cuda.launch("flash_attention", dtype, q, k, v, out, lse, B, T, H, Hkv,
                hd, 1.0 / hd ** 0.5)
    return out, lse
