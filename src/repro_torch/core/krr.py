"""Incremental kernel ridge regression from the maintained eigensystem
(paper §3: an incremental eigendecomposition of the kernel matrix serves
wherever its inverse is needed, as in kernel regression).

With K = U Λ Uᵀ maintained by Algorithm 1, the coefficients
α = (K + λI)⁻¹ y are a diagonal rescale,

    α = U (Λ + λI)⁻¹ Uᵀ y,

so a new point costs the rank-one updates plus an O(m²) re-solve, and a λ
path costs one rescale per λ.  The default type is float64, on the card
too (its rotations run on the f64 kernels).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import engine as eng
from repro_torch.core import inkpca, kernels_fn as kf, rankone

Tensor = torch.Tensor


class KRRState(NamedTuple):
    kpca: inkpca.KPCAState       # eigendecomposition of K_{m,m} (Alg. 1)
    y: Tensor                    # (M,) targets, zero-padded


def init_krr(x0: Tensor, y0: Tensor, capacity: int, spec: kf.KernelSpec,
             *, dtype=torch.float64) -> KRRState:
    """Seed points ``x0`` with targets ``y0``, on x0's device."""
    kpca = inkpca.init_state(x0, capacity, spec, adjusted=False, dtype=dtype)
    y = torch.zeros((capacity,), dtype=dtype, device=x0.device)
    y[:y0.shape[0]] = torch.as_tensor(y0, device=x0.device).to(dtype)
    return KRRState(kpca=kpca, y=y)


def add_point(state: KRRState, x_new: Tensor, y_new, spec: kf.KernelSpec, *,
              plan: eng.UpdatePlan = eng.DEFAULT_PLAN) -> KRRState:
    """Fold one point and its target in (Algorithm 1 under ``plan``)."""
    x_new = x_new.to(state.kpca.X.dtype)
    a, k_new = eng.masked_row(state.kpca, x_new, spec)
    m = state.kpca.m
    kpca = inkpca.update_unadjusted(state.kpca, a, k_new, x_new, plan=plan)
    return KRRState(kpca=kpca, y=rankone.index_set(state.y, m, y_new))


def coefficients(state: KRRState, lam: float) -> Tensor:
    """α = U (Λ + λ)⁻¹ Uᵀ y, O(m²) from the maintained eigenpairs."""
    st = state.kpca
    mask = rankone.active_mask(st.L.shape[0], st.m)
    z = st.U.T @ torch.where(mask, state.y, 0.0)
    inv = torch.where(mask, 1.0 / (st.L + lam), 0.0)
    return st.U @ (inv * z)


def predict(state: KRRState, x: Tensor, lam: float,
            spec: kf.KernelSpec) -> Tensor:
    """f(x) = k(x, X) α at new points x: (n, d) -> (n,)."""
    st = state.kpca
    alpha = coefficients(state, lam)
    K_x = kf.gram_block(x.to(st.X.dtype), st.X, spec=spec)
    mask = rankone.active_mask(st.X.shape[0], st.m)
    return torch.where(mask[None, :], K_x, 0.0) @ alpha


def publish_predict(state: KRRState, lam: float, *, generation: int = 0):
    """Freeze the predict head into a ``serving.ServingSnapshot``:
    S = α[:, None], solved once at publication, so a prediction is a
    snapshot query f(x) = k(x, X_masked) @ α."""
    from repro_torch.core import serving

    st = state.kpca
    alpha = coefficients(state, lam)
    return serving.ServingSnapshot(
        S=alpha[:, None].to(st.X.dtype).contiguous(), X=st.X, m=st.m,
        affine=None, generation=torch.tensor(generation, dtype=torch.int32))


def snapshot_predict(snap, x: Tensor, spec: kf.KernelSpec, *,
                     plan: eng.UpdatePlan | None = None) -> Tensor:
    """f(x) from a published KRR snapshot: (n, d) -> (n,)."""
    from repro_torch.core import serving

    return serving.query(snap, x, spec=spec, plan=plan)[:, 0]


def loocv_residuals(state: KRRState, lam: float) -> Tensor:
    """Leave-one-out residuals in closed form, e_i = (y − Kα)_i/(1 − H_ii),
    with the hat diagonal H_ii = Σ_j U_ij² λ_j/(λ_j + λ) from the
    maintained eigenpairs."""
    st = state.kpca
    mask = rankone.active_mask(st.L.shape[0], st.m)
    lam_safe = torch.where(mask, st.L, 0.0)
    w = lam_safe / (lam_safe + lam)
    H_diag = torch.sum((st.U * st.U) * w[None, :], dim=1)
    alpha = coefficients(state, lam)
    resid = torch.where(mask, state.y, 0.0) - lam_safe_dot(state, alpha)
    denom = torch.clamp_min(1.0 - H_diag, 1e-12)
    return torch.where(mask, resid / denom, 0.0)


def lam_safe_dot(state: KRRState, alpha: Tensor) -> Tensor:
    """K α from the maintained eigenpairs (K is never stored)."""
    st = state.kpca
    mask = rankone.active_mask(st.L.shape[0], st.m)
    lam_active = torch.where(mask, st.L, 0.0)
    return st.U @ (lam_active * (st.U.T @ alpha))
