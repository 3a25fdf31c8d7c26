"""Decremental updates: remove a point from the maintained eigensystem.

The exact inverse of the paper's Algorithms 1 and 2.  Algorithm 1 folds a
point in by expanding with the eigenpair (k/4, e_m) and applying the ±sigma
pair (v1, +4/k), (v2, −4/k); the inverse applies (v2, +4/k), (v1, −4/k) and
then contracts the decoupled (k/4, e_q) eigenpair.  Algorithm 2 inverts its
expansion pair first, then its mean-adjustment pair with the sigmas
negated and the order swapped.

``downdate(state, i)``:

1. Permute point i to the active boundary q = m−1 (a cyclic shift that
   keeps the survivors' arrival order).  K → P K Pᵀ maps the eigensystem to
   (L, P U): a row permutation of U, X and K1 inside the active prefix, so
   every padding invariant, and with them the kernels' pruning, holds.
2. The inverse pair(s) through ``engine.apply_pair`` (fused or sequential,
   per the plan): row q is then decoupled.
3. Contract: one Householder reflector on U's columns, built from row q of
   U, turns the decoupled eigenpair into the exact identity pair
   (sentinel, e_q); then m shrinks by one.

The point to remove is a 0-d device tensor, so a caller that picks it on
the card (the window's argmin of the arrival ring) reads nothing back.
Every function takes the optional leading tenant axis of ``rankone``: a
stacked state and points (B,) remove one point from each tenant at once
(``engine.StreamBatch``'s lockstep FIFO removes row 0 of each).
"""
from __future__ import annotations

import torch

from repro_torch.core import engine as eng
from repro_torch.core import kernels_fn as kf, rankone
from repro_torch.core.rankone import (index_get, index_set, matvec, take,
                                      take_cols, take_rows)

Tensor = torch.Tensor


def _move_to(idx: Tensor, i: Tensor, q: Tensor) -> Tensor:
    """The order that moves entry ``i`` of ``idx`` to just after ``q``,
    keeping every other entry in place relative to the rest: a stable
    argsort of the float64 key (as the reference's ``jnp.argsort``)."""
    key = torch.where(idx == i[..., None], q.to(torch.float64)[..., None]
                      + 0.5, idx.to(torch.float64))
    return torch.argsort(key, dim=-1, stable=True)


def boundary_perm(i: Tensor, m: Tensor, M: int) -> Tensor:
    """Row order moving index ``i`` to the active boundary q = m−1:
    new = old[order] = [0..i−1, i+1..q, i, q+1..M−1].  Inactive rows never
    move; callers with side arrays (the ages ring) apply the same order."""
    idx = torch.arange(M, device=m.device)
    return _move_to(idx, i, m - 1)


def permute_to_boundary(state, i: Tensor):
    """Apply ``boundary_perm`` to the state's row-indexed arrays."""
    order = boundary_perm(i, state.m, state.L.shape[-1])
    return state._replace(U=take_rows(state.U, order),
                          K1=take(state.K1, order),
                          X=take_rows(state.X, order))


def contract_rows(L: Tensor, U: Tensor, w: Tensor, m: Tensor, *,
                  row_ids: Tensor | None = None
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """Remove the decoupled eigenpair at row q = m−1.

    The reflector and the permutation act on U's columns, so ``U`` may be
    a row block: ``row_ids`` then names its rows' global indices (the
    row-sharded downdate of ``core/distributed.py``; None is the square
    state).

    ``w`` is row q of U on the active columns: a unit vector, ±e_{j*} in
    exact arithmetic.  A Householder H concentrates it into column
    j* = argmax |w|, which then is ±e_q by orthogonality; that column moves
    to position q and the identity row and column are forced exactly.
    Where w is not ±e_{j*} (eigenvalues near the contracted one), H mixes
    only the columns where w has mass, erring by the cluster width, as
    the cluster merge does.  The LAPACK sign choice (reflect onto
    −sign(w_{j*})·e_{j*}, ‖u‖² ≈ 4) avoids the cancellation of the
    same-sign target; the target's sign does not matter since the identity
    pair is forced."""
    M = L.shape[-1]
    dtype = L.dtype
    q = m - 1
    idx = torch.arange(M, device=L.device)
    j_star = torch.argmax(torch.abs(w), dim=-1)
    sgn = torch.where(index_get(w, j_star) < 0, -1.0, 1.0).to(dtype)
    u = w + sgn[..., None] * (idx == j_star[..., None]).to(dtype)
    unorm2 = torch.sum(u * u, dim=-1)
    coef = torch.where(unorm2 > torch.finfo(dtype).tiny, 2.0 / unorm2,
                       torch.zeros((), dtype=dtype, device=L.device))
    # U @ H, a rank-one apply.
    U = U - coef[..., None, None] * (matvec(U, u)[..., :, None]
                                     * u[..., None, :])

    # Column j* -> position q; the columns between shift left by one.
    order = _move_to(idx, j_star, q)
    U = take_cols(U, order)
    L = take(L, order)

    # Force the exact identity pair at position q.
    at_q = idx == q[..., None]
    e_q = at_q.to(dtype)
    row_q = at_q if row_ids is None else row_ids == q[..., None]
    U = torch.where(at_q[..., None, :], row_q.to(dtype)[..., :, None], U)
    U = torch.where(row_q[..., :, None], e_q[..., None, :], U)
    m_new = m - 1
    L = rankone.sentinelize(L, m_new, L.new_zeros(()))
    return L, U, m_new


def contract_last(L: Tensor, U: Tensor, m: Tensor
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """Remove the decoupled boundary eigenpair and shrink m by one."""
    mask = rankone.active_mask(L.shape[-1], m)
    w = torch.where(mask, index_get(U, m - 1), 0.0)
    return contract_rows(L, U, w, m)


def _boundary_row(state, spec: kf.KernelSpec
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """(a, k_new, sum a): the kernel row of the boundary point against the
    survivors, zero at and beyond q = m−1 — the masked row the forward
    update consumed when this point streamed in."""
    M = state.L.shape[-1]
    q = state.m - 1
    x_ev = index_get(state.X, q)
    k_full = kf.kernel_row(x_ev, state.X, spec=spec)
    k_full = torch.where(rankone.active_mask(M, state.m), k_full, 0.0)
    a = torch.where(rankone.active_mask(M, q), k_full, 0.0)
    return a, index_get(k_full, q), torch.sum(a, dim=-1)


def downdate_unadjusted(state, spec: kf.KernelSpec, *,
                        plan: eng.UpdatePlan = eng.DEFAULT_PLAN):
    """Inverse of Algorithm 1 for the boundary point (row m−1)."""
    M = state.L.shape[-1]
    q = state.m - 1
    a, k_new, sum_a = _boundary_row(state, spec)
    kn = torch.clamp_min(k_new, torch.finfo(state.L.dtype).tiny)

    v1 = index_set(a, q, kn / 2.0)
    v2 = index_set(a, q, kn / 4.0)
    sigma = 4.0 / kn
    L, U = eng.apply_pair(state.L, state.U, v2, sigma, v1, -sigma, state.m,
                          plan=plan)
    L, U, m_new = contract_last(L, U, state.m)

    K1 = torch.where(rankone.active_mask(M, q), state.K1 - a, 0.0)
    S = state.S - 2.0 * sum_a - k_new
    X = index_set(state.X, q, torch.zeros_like(state.X[..., 0, :]))
    return state._replace(L=L, U=U, m=m_new, S=S, K1=K1, X=X)


def downdate_adjusted(state, spec: kf.KernelSpec, *,
                      plan: eng.UpdatePlan = eng.DEFAULT_PLAN):
    """Inverse of Algorithm 2 for the boundary point (row m−1).

    The forward order was: mean-adjustment pair at m, expansion, new-row
    pair at m+1.  The inverse runs the new-row pair first (sigmas negated,
    order swapped), contracts the expansion eigenpair, then inverts the
    mean-adjustment pair, whose u is rebuilt from the pre-add sums (S, K1)
    recovered from the maintained ones."""
    M = state.L.shape[-1]
    dtype = state.L.dtype
    q = state.m - 1
    mask_m = rankone.active_mask(M, state.m)
    mf_post = state.m.to(dtype)[..., None]

    a, k_new, sum_a = _boundary_row(state, spec)

    # --- Invert step 4: the expansion pair (paper eq. (3)). ---
    k_vec = index_set(a, q, k_new)
    v = k_vec - (torch.sum(k_vec, dim=-1)[..., None] + state.K1
                 - state.S[..., None] / mf_post) / mf_post
    v = torch.where(mask_m, v, 0.0)
    v0 = index_get(v, q)
    eps = torch.finfo(dtype).eps
    v0 = torch.where(v0.abs() < eps, eps, v0)
    v1 = index_set(v, q, v0 / 2.0)
    v2 = index_set(v, q, v0 / 4.0)
    sigma = 4.0 / v0
    L, U = eng.apply_pair(state.L, state.U, v2, sigma, v1, -sigma, state.m,
                          plan=plan)
    L, U, m_new = contract_last(L, U, state.m)

    # --- Invert step 1: the mean-adjustment pair, at m_new actives. ---
    S_pre = state.S - 2.0 * sum_a - k_new
    mask_q = rankone.active_mask(M, m_new)
    K1_pre = torch.where(mask_q, state.K1 - a, 0.0)
    mf = m_new.to(dtype)
    C = (-S_pre / mf**2 + state.S / (mf + 1.0) ** 2)[..., None]
    mf = mf[..., None]
    u = K1_pre / (mf * (mf + 1.0)) - a / (mf + 1.0) + 0.5 * C
    u = torch.where(mask_q, u, 0.0)
    ones_u_p = torch.where(mask_q, 1.0 + u, 0.0)
    ones_u_m = torch.where(mask_q, 1.0 - u, 0.0)
    half = a.new_full((), 0.5)
    L, U = eng.apply_pair(L, U, ones_u_m, half, ones_u_p, -half, m_new,
                          plan=plan)

    X = index_set(state.X, q, torch.zeros_like(state.X[..., 0, :]))
    return state._replace(L=L, U=U, m=m_new, S=S_pre, K1=K1_pre, X=X)


def downdate(state, i: Tensor, spec: kf.KernelSpec, *, adjusted: bool,
             plan: eng.UpdatePlan = eng.DEFAULT_PLAN):
    """Remove point ``i`` (0 ≤ i < m, a 0-d device tensor) from the
    maintained eigensystem.  Needs m ≥ 2; callers check on the host."""
    state = permute_to_boundary(state, i)
    fn = downdate_adjusted if adjusted else downdate_unadjusted
    return fn(state, spec, plan=plan)
