"""Wrapper for the causal flash-attention kernel: a CPU tensor runs
``ref.flash_attention_ref``, a CUDA tensor launches
``csrc/flash_attention.cu`` or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

Tensor = torch.Tensor

MAX_HEAD_DIM = 128        # the kernel holds a row of q, k, v per thread row


def causal_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal softmax attention in the model's layout: q (B, T, H, hd),
    k and v (B, T, Hkv, hd), H a multiple of Hkv (q head h reads kv head
    h // (H / Hkv), no copy of k and v to H heads); returns (B, T, H, hd)
    in q's type.  float32 or bfloat16, scores and sums in float32."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
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
    cuda.launch("flash_attention", dtype, q, k, v, out, B, T, H, Hkv, hd,
                1.0 / hd ** 0.5)
    return out
