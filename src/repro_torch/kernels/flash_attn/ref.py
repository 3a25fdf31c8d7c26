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


def flash_attention_bwd_ref(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                            dout: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) of
    causal attention from q (B, T, H, hd), k and v (B, T, Hkv, hd), the
    forward's output ``out`` and its gradient ``dout`` (B, T, H, hd).

    The kernel's formula, every operand read into float32 and every
    product and sum in float32: with S = q kᵀ/sqrt(hd) masked to s <= t,
    P = exp(S - lse) (lse the row's log-sum-exp, the mask selected before
    the exponential), D = rowsum(dout ∘ out), dv = Pᵀ dout, dS = P ∘
    (dout vᵀ - D), dq = dS k/sqrt(hd), dk = dSᵀ q/sqrt(hd); dk and dv of
    kv head j sum over its group of q heads.  Outputs in the operands'
    types.  One kv head at a time, as the forward's plain version."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    if (H % Hkv or k.shape != (B, T, Hkv, hd) or v.shape != k.shape
            or out.shape != q.shape or dout.shape != q.shape):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}")
    groups = H // Hkv
    scale = 1.0 / hd ** 0.5
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for j in range(Hkv):
        heads = slice(j * groups, (j + 1) * groups)
        qj, oj, doj = (x[:, :, heads].float() for x in (q, out, dout))
        kj, vj = k[:, :, j].float(), v[:, :, j].float()
        s = torch.einsum("btgd,bsd->bgts", qj, kj) * scale
        s = torch.where(causal, s, -torch.inf)
        p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
        p = torch.where(causal, p, 0.0)
        del s
        dsum = (doj * oj).sum(-1).permute(0, 2, 1)[..., None]   # (B, g, T, 1)
        dp = torch.einsum("btgd,bsd->bgts", doj, vj)
        ds = p * (dp - dsum)
        del dp
        dv[:, :, j] = torch.einsum("bgts,btgd->bsd", p, doj).to(v.dtype)
        del p
        dq[:, :, heads] = (torch.einsum("bgts,bsd->btgd", ds, kj)
                           * scale).to(q.dtype)
        dk[:, :, j] = (torch.einsum("bgts,btgd->bsd", ds, qj)
                       * scale).to(k.dtype)
    return dq, dk, dv
