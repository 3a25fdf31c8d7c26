"""Nyström attention — the paper's technique inside the LM, the
counterpart of the reference's ``models/nystrom_attention.py``.

The softmax-attention kernel factors through the paper's RBF kernel:

    exp(q·k/√hd) = c(q) · g(q, k) · c(k),
    g(x, y) = exp(-‖x-y‖²/σ),  σ = 2√hd,   c(x) = exp(‖x‖²/σ),

so a Nyström approximation of the attention gram over m landmark keys L
(paper §4) gives

    Σ_s exp(q·k_s/√hd) v_s ≈ c(q) · g(q,L) · G_LL⁻¹ · Ψ,
        Ψ = Σ_s g(L, k_s) c(k_s) v_sᵀ            (m × dv running statistic)
        ζ = Σ_s g(L, k_s) c(k_s)                 (m   running normalizer)

with G_LL = g(L, L) the landmark gram, the K_{m,m} whose eigensystem the
paper maintains incrementally (Algorithm 1; ``grow_landmark``).

Every k-side weight carries c̃(k) = exp(‖k‖²/σ − β) with a running shift β
(the running max of ‖k‖²/σ), so each factor is at most 1; c̃(q) cancels in
the ratio.  Prefill is exact within a chunk and Nyström-approximate across
chunks; the chunks run as a Python loop (the reference's ``lax.scan``).
Decode state is O(m·(hd + 2)) per kv head, independent of the context.
The reference's sharding constraint has no counterpart and is dropped.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import Attention, _param, _qkv

Tensor = torch.Tensor

_JITTER = 1e-4


class NystromAttention(Attention):
    """The GQA projections of ``layers.Attention`` and learned landmark keys
    (inducing points): ``landmarks`` (Hkv, m, hd), float32 in any model
    type, drawn as the reference's ``dense_init(...) · sqrt(hd)``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__(cfg, device)
        self.landmarks = _param((cfg.n_kv_heads, cfg.nystrom_landmarks,
                                 cfg.hd), torch.float32, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        super().reset_parameters(gen)
        z = torch.randn(self.landmarks.shape, generator=gen,
                        device=self.landmarks.device)
        hd = self.landmarks.shape[-1]
        self.landmarks.copy_(z / math.sqrt(self.landmarks.shape[0])
                             * math.sqrt(hd))


def _sigma(hd: int) -> float:
    return 2.0 * float(hd) ** 0.5


def _rbf(x: Tensor, y: Tensor, sigma: float) -> Tensor:
    """g(x, y) over the trailing feature dim, broadcasting the leading
    ones: x (..., q, d), y (..., s, d) -> (..., q, s)."""
    d2 = (torch.sum(x * x, -1)[..., :, None]
          + torch.sum(y * y, -1)[..., None, :] - 2.0 * (x @ y.mT))
    return torch.exp(-torch.clamp_min(d2, 0.0) / sigma)


def _ginv(landmarks: Tensor, sigma: float) -> Tensor:
    """(H, m, m) inverse of the jittered landmark gram (``torch.linalg.inv``,
    differentiable).  At serve time this matrix can instead be maintained
    by Algorithm 1 (``grow_landmark``, ``ginv_from_eig``)."""
    G = _rbf(landmarks, landmarks, sigma)
    G = G + _JITTER * torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    return torch.linalg.inv(G)


class NystromChunkCarry(NamedTuple):
    psi: Tensor    # (B, Hkv, m, dv)
    zeta: Tensor   # (B, Hkv, m)
    beta: Tensor   # (B, Hkv) running shift (max ‖k‖²/σ)


def nystrom_attention_apply(p: NystromAttention, cfg: ArchConfig, x: Tensor,
                            positions: Tensor, *, chunk: int = 0) -> Tensor:
    """Chunk-causal Nyström attention (train and prefill): exact softmax
    attention within each chunk, Nyström-approximate over all previous
    chunks through the (Ψ, ζ) running statistics.  ``chunk=0`` picks
    max(landmarks, 128), cut to T."""
    B, T, _ = x.shape
    hd = cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    groups = Hq // Hkv
    sigma = _sigma(hd)
    Q = min(chunk or max(cfg.nystrom_landmarks, 128), T)
    if T % Q:
        raise ValueError(f"nystrom attention: T {T} is not a multiple of "
                         f"the chunk {Q}")
    nc = T // Q

    q, k, v = _qkv(p, cfg, x, positions)
    lm = p.landmarks.float()                           # (Hkv, m, hd)
    m = lm.shape[1]
    Ginv = _ginv(lm, sigma)                            # (Hkv, m, m)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()

    carry = NystromChunkCarry(
        psi=torch.zeros((B, Hkv, m, hd), device=x.device),
        zeta=torch.zeros((B, Hkv, m), device=x.device),
        # beta starts at 0 (knorm >= 0): exp(beta - beta_new) stays
        # differentiable, and psi, zeta start at zero.
        beta=torch.zeros((B, Hkv), device=x.device))
    outs = []
    for c in range(nc):
        rows = slice(c * Q, (c + 1) * Q)
        qb, kb, vb = (t[:, rows].float() for t in (q, k, v))   # (B,Q,H*,hd)
        knorm = torch.sum(kb * kb, -1) / sigma         # (B,Q,Hkv)
        beta_new = torch.maximum(carry.beta, knorm.amax(dim=1))
        scale = torch.exp(carry.beta - beta_new)       # <= 1
        psi = carry.psi * scale[..., None, None]
        zeta = carry.zeta * scale[..., None]

        ck = torch.exp(knorm - beta_new[:, None, :])   # c̃(k) <= 1
        qg = qb.reshape(B, Q, Hkv, groups, hd).permute(0, 2, 3, 1, 4)
        # Nyström inter-chunk read-out for this chunk's queries.
        phiq = _rbf(qg, lm[None, :, None], sigma)      # (B,Hkv,g,Q,m)
        r = torch.einsum("bhgqm,hmn->bhgqn", phiq, Ginv)
        num_nys = torch.einsum("bhgqn,bhnv->bhgqv", r, psi)
        den_nys = torch.einsum("bhgqn,bhn->bhgq", r, zeta)

        # Exact intra-chunk attention in the same c̃-scaled space.
        kh = kb.permute(0, 2, 1, 3)                    # (B,Hkv,Q,hd)
        g_qk = _rbf(qg, kh[:, :, None], sigma)         # (B,Hkv,g,Q,S)
        w_intra = g_qk * ck.permute(0, 2, 1)[:, :, None, None, :]
        w_intra = torch.where(causal, w_intra, 0.0)
        num_intra = torch.einsum("bhgqs,bshv->bhgqv", w_intra, vb)
        den_intra = torch.sum(w_intra, -1)

        num = num_intra + num_nys                      # c̃(q) cancels
        den = den_intra + den_nys
        out = num / torch.clamp_min(den, 1e-9)[..., None]    # (B,Hkv,g,Q,hd)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, Q, Hq, hd))

        # Fold this chunk's keys into the running statistics.
        phik = _rbf(lm[None], kh, sigma)               # (B,Hkv,m,Q)
        wk = phik * ck.permute(0, 2, 1)[:, :, None, :]
        psi = psi + torch.einsum("bhms,bshv->bhmv", wk, vb)
        zeta = zeta + torch.sum(wk, -1)
        carry = NystromChunkCarry(psi, zeta, beta_new)
    out = torch.cat(outs, dim=1).reshape(B, T, Hq * hd).to(x.dtype)
    return out @ p.wo


# ------------------------------------------------------------------ decode --
class NystromCache(NamedTuple):
    """O(m) per-head decode state, independent of the context length."""
    psi: Tensor     # (B, Hkv, m, hd)
    zeta: Tensor    # (B, Hkv, m)
    beta: Tensor    # (B, Hkv)
    ginv: Tensor    # (Hkv, m, m), maintainable by Algorithm 1 at serve time


def nystrom_cache_init(p: NystromAttention, cfg: ArchConfig, batch: int
                       ) -> NystromCache:
    m, hd = cfg.nystrom_landmarks, cfg.hd
    dev = p.landmarks.device
    return NystromCache(
        psi=torch.zeros((batch, cfg.n_kv_heads, m, hd), device=dev),
        zeta=torch.zeros((batch, cfg.n_kv_heads, m), device=dev),
        beta=torch.zeros((batch, cfg.n_kv_heads), device=dev),
        ginv=_ginv(p.landmarks.float(), _sigma(hd)))


def nystrom_decode(p: NystromAttention, cfg: ArchConfig, x: Tensor,
                   cache: NystromCache, pos: Tensor
                   ) -> tuple[Tensor, NystromCache]:
    """One-token decode: O(m·hd) flops and state.  x: (B, 1, d); pos: (B, 1)
    positions (or a 0-d one for the batch)."""
    B = x.shape[0]
    hd = cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    groups = Hq // Hkv
    sigma = _sigma(hd)
    positions = pos.reshape(1, 1).expand(B, 1) if pos.dim() == 0 else pos

    q, k, v = _qkv(p, cfg, x, positions)
    q, k, v = q.float()[:, 0], k.float()[:, 0], v.float()[:, 0]   # (B,H*,hd)
    lm = p.landmarks.float()

    # Fold the new key and value into (Ψ, ζ) with the shift update.
    knorm = torch.sum(k * k, -1) / sigma               # (B,Hkv)
    beta = torch.maximum(cache.beta, knorm)
    scale = torch.exp(cache.beta - beta)
    ck = torch.exp(knorm - beta)
    phik = _rbf(lm[None], k[:, :, None, :], sigma)[..., 0]    # (B,Hkv,m)
    wk = phik * ck[..., None]
    psi = cache.psi * scale[..., None, None] + wk[..., None] * v[:, :, None, :]
    zeta = cache.zeta * scale[..., None] + wk

    # Read out through the cache's G⁻¹ (c̃(q) cancels).
    qg = q.reshape(B, Hkv, groups, hd)
    phiq = _rbf(qg, lm[None], sigma)                   # (B,Hkv,g,m)
    r = torch.einsum("bhgm,hmn->bhgn", phiq, cache.ginv)
    num = torch.einsum("bhgn,bhnv->bhgv", r, psi)
    den = torch.einsum("bhgn,bhn->bhg", r, zeta)
    out = (num / torch.clamp_min(den, 1e-9)[..., None]).reshape(B, 1,
                                                                Hq * hd)
    return (out.to(x.dtype) @ p.wo,
            NystromCache(psi=psi, zeta=zeta, beta=beta, ginv=cache.ginv))


# ----------------------------------------------- serve-time landmark growth --
def grow_landmark(landmarks: Tensor, L: Tensor, U: Tensor, m_active,
                  new_lm: Tensor, sigma: float, *, plan=None
                  ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Add one landmark with the paper's Algorithm 1 (the incremental
    eigendecomposition of the landmark gram K_{m,m}): the incremental
    Nyström loop of §4 applied to attention.  Returns the updated
    (landmarks, L, U, m_active).

    landmarks: (M, hd), a fixed-capacity buffer for one head; (L, U): the
    maintained eigendecomposition of g(landmarks, landmarks) over the
    first ``m_active`` rows.  ``plan`` defaults to the rotation kernel's
    route (``matmul="pallas"``): on CUDA one update launches
    ``eigvec_rotate`` twice, on the CPU its plain version runs."""
    from repro_torch.core import engine as eng, inkpca, kernels_fn as kf

    plan = plan if plan is not None else eng.UpdatePlan(matmul="pallas")
    M = landmarks.shape[0]
    dev = landmarks.device
    m_active = torch.as_tensor(m_active, dtype=torch.int32, device=dev)
    spec = kf.KernelSpec(name="rbf", sigma=float(sigma))
    mask = torch.arange(M, device=dev) < m_active
    a = torch.where(mask, kf.kernel_row(new_lm, landmarks, spec=spec), 0.0)
    k_new = torch.ones((), dtype=L.dtype, device=dev)      # RBF diagonal
    state = inkpca.KPCAState(L=L, U=U, m=m_active,
                             S=torch.zeros((), dtype=L.dtype, device=dev),
                             K1=torch.zeros((M,), dtype=L.dtype, device=dev),
                             X=landmarks)
    state = inkpca.update_unadjusted(state, a, k_new, new_lm, plan=plan)
    return state.X, state.L, state.U, state.m


def ginv_from_eig(L: Tensor, U: Tensor, m_active,
                  jitter: float = _JITTER) -> Tensor:
    """G⁻¹ from the maintained eigenpairs, over the active ones with
    eigenvalues above ``jitter`` (the paper's eq. 7 rescaling)."""
    M = L.shape[0]
    mask = torch.arange(M, device=L.device) < torch.as_tensor(
        m_active, device=L.device)
    keep = mask & (L > jitter)
    inv = torch.where(keep, 1.0 / torch.where(L > jitter, L, 1.0), 0.0)
    return (U * inv[None, :]) @ U.T
