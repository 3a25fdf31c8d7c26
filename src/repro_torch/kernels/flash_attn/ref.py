"""Plain PyTorch version of the causal flash-attention kernel."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal softmax attention in the model's layout: q (B, T, H, hd),
    k and v (B, T, Hkv, hd) with H a multiple of Hkv; q head h reads kv
    head h // (H / Hkv).  Returns (B, T, H, hd) in q's type.

    Numerics of the kernel it stands beside: scores summed in float32 and
    scaled by 1/sqrt(hd), the softmax in float32 with the causal mask
    selected before the exponential, the probabilities cast to v's type,
    the product summed in float32.  It goes one kv head (its group of q
    heads) at a time, so the float32 scores of the whole call never exist
    at once."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    if H % Hkv or k.shape != (B, T, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    groups = H // Hkv
    scale = 1.0 / hd ** 0.5
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for j in range(Hkv):
        qj = q[:, :, j * groups:(j + 1) * groups].float()   # (B, T, g, hd)
        kj, vj = k[:, :, j].float(), v[:, :, j]
        s = torch.einsum("btgd,bsd->bgts", qj, kj) * scale
        s = torch.where(causal, s, -torch.inf)
        p = torch.softmax(s, dim=-1).to(v.dtype).float()
        o = torch.einsum("bgts,bsd->btgd", p, vj.float())
        out[:, :, j * groups:(j + 1) * groups] = o.to(q.dtype)
    return out
