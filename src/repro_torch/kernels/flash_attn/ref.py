"""Plain PyTorch version of the causal flash-attention kernel."""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

LOG2E = 1.0 / math.log(2.0)


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


def flash_attention_lse_ref(q: Tensor, k: Tensor) -> Tensor:
    """Plain version of the log-sum-exp the bfloat16 forward kernel writes
    when a gradient will be taken: float32 (B, H, T), row t of head h the
    log-sum-exp of its causal scores q_t·k_s/sqrt(hd) (s <= t), in the
    kernel's base-2 units: times log2(e), so that P = exp2(S·log2(e) /
    sqrt(hd) - lse).  Scores and the log-sum-exp in float32, one kv head
    (its group of q heads) at a time."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    if H % Hkv or k.shape != (B, T, Hkv, hd):
        raise ValueError(f"flash_attention_lse: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    groups = H // Hkv
    scale = 1.0 / hd ** 0.5
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    for j in range(Hkv):
        qj = q[:, :, j * groups:(j + 1) * groups].float()
        s = torch.einsum("btgd,bsd->bgts", qj, k[:, :, j].float()) * scale
        s = torch.where(causal, s, -torch.inf)
        lse[:, j * groups:(j + 1) * groups] = torch.logsumexp(s, -1) * LOG2E
    return lse


def flash_attention_bwd_ref(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                            dout: Tensor, lse: Tensor | None = None
                            ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) of
    causal attention from q (B, T, H, hd), k and v (B, T, Hkv, hd), the
    forward's output ``out`` and its gradient ``dout`` (B, T, H, hd), and
    optionally each row's log-sum-exp ``lse`` (B, H, >= T) in the kernel's
    base-2 units (``flash_attention_lse_ref``; columns past T unread),
    which it then uses instead of recomputing it.

    The kernel's formula, every operand read into float32 and every
    product and sum in float32: with S = q kᵀ/sqrt(hd) masked to s <= t,
    P = exp(S - lse) (lse the row's log-sum-exp, the mask selected before
    the exponential), D = rowsum(dout ∘ out), dv = Pᵀ dout, dS = P ∘
    (dout vᵀ - D), dq = dS k/sqrt(hd), dk = dSᵀ q/sqrt(hd); dk and dv of
    kv head j sum over its group of q heads.  As the kernel's A operands,
    P and dS are rounded to the operands' type before the products that
    form dv, dq and dk (exact in float32).  Outputs in the operands'
    types.  One kv head at a time, as the forward's plain version."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    if (H % Hkv or k.shape != (B, T, Hkv, hd) or v.shape != k.shape
            or out.shape != q.shape or dout.shape != q.shape
            or (lse is not None and (lse.shape[:2] != (B, H)
                                     or lse.shape[2] < T))):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, "
                         f"lse {None if lse is None else tuple(lse.shape)}")
    groups = H // Hkv
    scale = 1.0 / hd ** 0.5
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def rounded(x: Tensor) -> Tensor:
        return x.to(q.dtype).float()

    for j in range(Hkv):
        heads = slice(j * groups, (j + 1) * groups)
        qj, oj, doj = (x[:, :, heads].float() for x in (q, out, dout))
        kj, vj = k[:, :, j].float(), v[:, :, j].float()
        s = torch.einsum("btgd,bsd->bgts", qj, kj) * scale
        s = torch.where(causal, s, -torch.inf)
        if lse is None:
            lse_j = torch.logsumexp(s, dim=-1, keepdim=True)
        else:                                   # base 2 -> natural units
            lse_j = lse[:, heads, :T, None].float() / LOG2E
        p = torch.where(causal, torch.exp(s - lse_j), 0.0)
        del s
        dsum = (doj * oj).sum(-1).permute(0, 2, 1)[..., None]   # (B, g, T, 1)
        dp = torch.einsum("btgd,bsd->bgts", doj, vj)
        ds = rounded(p * (dp - dsum))
        del dp
        dv[:, :, j] = torch.einsum("bgts,btgd->bsd", rounded(p),
                                   doj).to(v.dtype)
        del p
        dq[:, :, heads] = (torch.einsum("bgts,bsd->btgd", ds, kj)
                           * scale).to(q.dtype)
        dk[:, :, j] = (torch.einsum("bgts,btgd->bsd", ds, qj)
                       * scale).to(k.dtype)
    return dq, dk, dv
