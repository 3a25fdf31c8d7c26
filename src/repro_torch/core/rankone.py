"""Rank-one updates to the symmetric eigendecomposition (paper §3.2).

Given A = U diag(d) Uᵀ and a perturbation A + sigma·v vᵀ, the updated
eigenvalues are the roots of the secular equation (Golub 1973)

    w(t) = 1 + sigma · sum_i z_i² / (d_i - t),        z = Uᵀ v

and the updated eigenvectors are U @ W with W[:, j] ∝ z / (d - t_j)
(Bunch, Nielsen & Sorensen 1978).  ``method="gu"`` recomputes ẑ from the
roots (Gu & Eisenstat 1994) for orthogonality; ``method="bns"`` uses z.

The state is padded to a fixed capacity M with an active count m:
inactive eigenpairs are identity pairs (U[:, j] = e_j) whose sentinel
eigenvalues sit strictly above the active spectrum.  ``m`` is a 0-d int32
tensor on the state's device, so no step reads it back to the host.

The O(m³) rotation U @ W runs on the card in the hand-written kernel
``kernels/csrc/eigvec_rotate.cu`` (``matmul="pallas"``, the reference's
spelling) or as a dense product of the materialized factor
(``matmul="jnp"``, the oracle route).  sigma < 0 is reduced to sigma > 0
by the flip identity eig(D + s zzᵀ) = -rev(eig(-rev(D) + |s| rev(z)rev(z)ᵀ)).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.eigvec_update import ops as eigvec_ops
from repro_torch.kernels.eigvec_update.ref import cauchy_factor_ref

Tensor = torch.Tensor

# Margin multiplier used when regenerating sentinel eigenvalues.
_SENTINEL_GAP = 1.0


def _eps_for(dtype) -> float:
    return torch.finfo(dtype).eps


def _solve_dtype(dtype, precise: bool):
    """The secular solve's type: float64 under ``precise``, else the
    state's.  Its eps also sets the displacement-deflation thresholds."""
    return torch.float64 if precise else dtype


def index_set(vec: Tensor, i: Tensor, value) -> Tensor:
    """``vec`` with entry (or row) ``i`` replaced — out of place, and with
    ``i`` a device tensor, so no host read."""
    value = torch.as_tensor(value, dtype=vec.dtype, device=vec.device)
    return vec.index_put((i.reshape(1).long(),),
                         value.reshape((1,) + vec.shape[1:]))


def index_get(vec: Tensor, i: Tensor) -> Tensor:
    """``vec[i]`` for a 0-d device tensor ``i``, without a host read."""
    return vec.index_select(0, i.reshape(1).long())[0]


def active_mask(M: int, m: Tensor) -> Tensor:
    return torch.arange(M, device=m.device) < m


def sentinelize(d: Tensor, m: Tensor, room: Tensor) -> Tensor:
    """Place inactive eigenvalues strictly above the active spectrum.

    ``room`` bounds how far the top active root can travel (sigma·||z||²
    for sigma > 0, else 0).  Sentinels are spaced by 1 so bisection
    intervals in the inactive region are well conditioned.
    """
    M = d.shape[0]
    mask = active_mask(M, m)
    top = torch.max(torch.where(mask, d, -torch.inf))
    top = torch.where(torch.isfinite(top), top, 0.0)   # m == 0 corner
    base = top + torch.abs(room) + _SENTINEL_GAP
    idx = torch.arange(M, dtype=d.dtype, device=d.device)
    sent = base + _SENTINEL_GAP * (idx - m.to(d.dtype))
    return torch.where(mask, d, sent)


def _secular_bisect(d: Tensor, z2: Tensor, sigma: Tensor, iters: int,
                    defl: Tensor | None = None) -> Tensor:
    """All roots of 1 + sigma·sum_i z2_i/(d_i - t), sigma > 0, d ascending.

    Root j lives in (d_j, next pole) and the top root in (d_{M-1},
    d_{M-1} + sigma·sum(z2)) (paper eq. 5); fixed-iteration bisection of
    all M roots at once.  Deflated poles (``defl``) keep their eigenvalue
    at the pole and are skipped in every other root's bracket.
    """
    eps = _eps_for(d.dtype)
    znorm2 = torch.sum(z2)
    top = d[-1] + sigma * znorm2 + eps
    lo = d
    if defl is None:
        hi = torch.cat([d[1:], top[None]])
    else:
        d_nd = torch.where(defl, torch.inf, d)
        # Next non-deflated pole above each entry: a reversed cumulative
        # minimum (jax.lax.cummin over the flipped vector).
        nxt = torch.cat([torch.cummin(d_nd.flip(0), 0).values.flip(0)[1:],
                         d.new_full((1,), torch.inf)])
        hi = torch.where(torch.isinf(nxt), top, nxt)

    def w_at(t: Tensor) -> Tensor:
        den = d[:, None] - t[None, :]
        safe = torch.where(den == 0.0, eps, den)
        return 1.0 + sigma * torch.sum(z2[:, None] / safe, dim=0)

    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = w_at(mid) > 0.0     # w increasing between poles: root < mid
        lo, hi = torch.where(pos, lo, mid), torch.where(pos, mid, hi)
    roots = 0.5 * (lo + hi)
    if defl is not None:
        roots = torch.where(defl, d, roots)
    return roots


def _cluster_merge(d: Tensor, z: Tensor, tol: Tensor):
    """LAPACK dlaed2-style cluster deflation.

    For each run of poles closer than ``tol``, a Householder reflector H
    (block-diagonal over runs) rotates the run's z-mass into its LAST
    element; the others become exactly zero and deflate.  Returns
    (z_new, apply, fired) with apply(X) = H @ X in O(M²) by segment sums.
    """
    M = d.shape[0]
    gap = torch.diff(d)
    new_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=d.device),
                         gap > tol])
    seg = torch.cumsum(new_seg.to(torch.int64), 0) - 1

    def segsum(x: Tensor) -> Tensor:        # per-run sum, gathered back
        out = torch.zeros((M,) + x.shape[1:], dtype=x.dtype, device=x.device)
        return out.index_add_(0, seg, x)[seg]

    seg_size = segsum(torch.ones_like(z))
    znorm_seg = torch.sqrt(segsum(z * z))
    is_last = torch.cat([new_seg[1:],
                         torch.ones(1, dtype=torch.bool, device=d.device)])
    z_last = segsum(torch.where(is_last, z, 0.0))
    sl = torch.where(z_last >= 0, 1.0, -1.0).to(z.dtype)
    target = -sl * znorm_seg                  # H z_run = target · e_last
    w = z - torch.where(is_last, target, 0.0)
    wnorm2 = segsum(w * w)
    tiny = torch.finfo(d.dtype).tiny
    active = (seg_size > 1.5) & (wnorm2 > tiny)
    coef = torch.where(active, 2.0 / torch.where(active, wnorm2, 1.0), 0.0)

    def apply(X: Tensor) -> Tensor:           # H @ X, rows mixed per run
        s = segsum(w[:, None] * X)
        return X - (coef * w)[:, None] * s

    wz = segsum(w * z)
    z_new = z - coef * w * wz
    # exact zeros on merged (non-last) members so deflation catches them
    z_new = torch.where(active & ~is_last, 0.0, z_new)
    return z_new, apply, torch.any(active)


def _gu_zhat(d: Tensor, roots: Tensor, sigma: Tensor, z: Tensor) -> Tensor:
    """Gu–Eisenstat recomputation of |z| from the computed roots:
    sigma·ẑ_i² = prod_j (roots_j - d_i) / prod_{j != i} (d_j - d_i),
    in log space.  Deflated and inactive entries come out exactly 0."""
    num = roots[None, :] - d[:, None]                      # (i, j)
    den = d[None, :] - d[:, None]
    den.fill_diagonal_(1.0)
    tiny = torch.finfo(d.dtype).tiny
    log_z2 = (torch.sum(torch.log(num.abs() + tiny), dim=1)
              - torch.sum(torch.log(den.abs() + tiny), dim=1)
              - torch.log(sigma.abs()))
    zhat = torch.sign(z) * torch.sqrt(torch.exp(log_z2))
    # Guard: if the identity degenerates numerically, fall back to z.
    return torch.where(torch.isfinite(zhat), zhat, z)


def _cauchy_inv(d: Tensor, roots: Tensor, zhat: Tensor) -> Tensor:
    """Inverse column norms of W[i, j] = zhat_i / (d_i - roots_j)."""
    den = d[:, None] - roots[None, :]
    eps = _eps_for(d.dtype)
    safe = torch.where(den.abs() < eps, torch.where(den < 0, -eps, eps), den)
    W = zhat[:, None] / safe
    norms = torch.sqrt(torch.sum(W * W, dim=0))
    return torch.where(norms > 0, 1.0 / norms, 1.0)


class _Factor(NamedTuple):
    """One solved rank-one update as an original-domain Cauchy factor:
    W[k, j] = z_k·inv_j/(d_k-lam_j), deflated columns identity; ``L_new``
    is the updated (pre-sort) spectrum.  The sigma<0 flip's sign is folded
    into z, so the active region is a prefix for either sign."""

    z: Tensor
    d: Tensor
    lam: Tensor
    inv: Tensor
    defl: Tensor
    L_new: Tensor


def _solve_factor(d_sent: Tensor, z: Tensor, sigma: Tensor, m: Tensor,
                  scale: Tensor, *, iters: int, method: str,
                  precise: bool) -> _Factor:
    """Displacement deflation + secular solve + un-flip, as a ``_Factor``.

    A direction deflates when it is inactive, when |z_i| is negligible, or
    when it would move by less than the spectrum's resolution
    (sigma·z_i² ≲ eps·‖A‖).  With ``precise`` the secular equations are
    solved in float64 for any state type (the reference does so under x64,
    which its tests enable); the factor's vectors stay in the solve type.

    eps is the solve type's.  The reference takes the state type's, so an
    f32 state under ``precise`` drops every component with sigma·z² below
    ~1e-5·‖A‖, though the f64 solve resolves it.  Over a stream the
    spectrum then drifts by 1e-2 relative within 250 points, against 3e-6
    with the solve type's eps (ROADMAP.md, "Faults found").  For an f64
    state the two are the same.
    """
    M = d_sent.shape[0]
    dtype = d_sent.dtype
    solve_dtype = _solve_dtype(dtype, precise)
    eps = _eps_for(solve_dtype)
    mask = active_mask(M, m)
    sig_abs = torch.abs(sigma)
    neg = sigma < 0
    znorm = torch.sqrt(torch.sum(z * z))
    floor = 32.0 * eps * torch.clamp_min(znorm, eps)
    defl = (~mask | (z.abs() < floor)
            | (sig_abs * z * z < 64.0 * eps * scale))
    z = torch.where(defl, 0.0, z)

    d_eff = torch.where(neg, -d_sent.flip(0), d_sent)
    z_eff = torch.where(neg, z.flip(0), z)
    defl_eff = torch.where(neg, defl.flip(0), defl)
    d_s = d_eff.to(solve_dtype)
    z_s = z_eff.to(solve_dtype)
    sig_s = sig_abs.to(solve_dtype)
    roots_eff = _secular_bisect(d_s, z_s * z_s, sig_s, iters, defl=defl_eff)
    if method == "gu":
        zhat_eff = _gu_zhat(d_s, roots_eff, sig_s, z_s)
        zhat_eff = torch.where(defl_eff, 0.0, zhat_eff)
    else:
        zhat_eff = z_s
    inv_eff = _cauchy_inv(d_s, roots_eff, zhat_eff)
    inv_eff = torch.where(defl_eff, 1.0, inv_eff)

    z_o = torch.where(neg, -zhat_eff.flip(0), zhat_eff)
    lam_o = torch.where(neg, -roots_eff.flip(0), roots_eff)
    inv_o = torch.where(neg, inv_eff.flip(0), inv_eff)
    L_new = torch.where(mask, lam_o.to(dtype), d_sent)
    return _Factor(z=torch.where(mask, z_o, 0.0), d=d_sent.to(solve_dtype),
                   lam=lam_o, inv=inv_o, defl=defl, L_new=L_new)


def _apply_factor(U: Tensor, f: _Factor, mask: Tensor, m: Tensor, *,
                  matmul: str) -> Tensor:
    """U @ Ŵn for one factor, keeping the padding invariants.

    ``"pallas"``: the rotation kernel generates the factor from four O(M)
    vectors (padded entries d = 2e30, lam = 1e30, z = inv = 0, so padded
    factor entries are exactly 0) and prunes everything beyond m; deflated
    columns, which include every inactive one, keep U's own column.
    ``"jnp"``: the dense factor with identity columns, then a product.
    """
    if matmul == "pallas":
        C = eigvec_ops.rotate_vectors(U, *kernel_operands(f, mask, U.dtype),
                                      m)
        return torch.where(f.defl[None, :], U, C)
    Wn = cauchy_factor_ref(f.z, f.d, f.lam, f.inv,
                           f.defl.to(f.z.dtype)).to(dtype=U.dtype)
    return U @ Wn


def kernel_operands(f: _Factor, mask: Tensor, dtype
                    ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(z, d, lam, inv) of a factor as the rotation kernel takes them, with
    padded entries d = 2e30, lam = 1e30 and z = inv = 0 so that every
    padded factor entry is exactly 0.  z and inv are in the state's type;
    d and lam stay in the solve's type, so a root closer to its pole than
    the state's rounding does not collide with it.  (The reference casts
    them to the state's type, and an f32 state can then divide by 0.)"""
    return (torch.where(mask, f.z.to(dtype), 0.0),
            torch.where(mask, f.d, 2e30),
            torch.where(mask, f.lam, 1e30),
            torch.where(mask, f.inv.to(dtype), 0.0))


def _update_body(L: Tensor, U: Tensor, v: Tensor, sigma: Tensor, m: Tensor,
                 *, iters: int, method: str, matmul: str, precise: bool,
                 z: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """One rank-one update; ``z`` = Uᵀv may come precomputed (the fused
    ingest kernel produces it), else it is the dense product here."""
    M = L.shape[0]
    dtype = L.dtype
    mask = active_mask(M, m)
    if z is None:
        v = torch.where(mask, v, 0.0)
        z = U.T @ v
    else:
        z = torch.where(mask, z, 0.0)
    sig_abs = torch.abs(sigma)

    # Re-sentinelize with head-room for the top root's travel; under the
    # flip the sentinels land (negated) at the bottom, still sorted.
    room = sig_abs * torch.sum(z * z)
    d_sent = sentinelize(L, m, room)

    # Cluster-merge deflation; U absorbs the block reflector at O(M²).  Its
    # tolerance is the state type's: it protects the rotation of U, which
    # rounds in that type.
    scale = torch.max(torch.abs(torch.where(mask, L, 0.0))) + room + 1e-30
    tol = 64.0 * _eps_for(dtype) * scale
    z, applyH, _ = _cluster_merge(d_sent, z, tol)
    U = applyH(U.T).T                            # U @ H, no matmul

    f = _solve_factor(d_sent, z, sigma, m, scale, iters=iters, method=method,
                      precise=precise)
    U_new = _apply_factor(U, f, mask, m, matmul=matmul)
    # Deflation can locally reorder roots; the next update's interlacing
    # needs ascending order.  Stable, as jnp.argsort is, so ties among
    # deflated roots and sentinels keep their column order.
    perm = torch.argsort(f.L_new, stable=True)
    return f.L_new[perm], U_new[:, perm]


def rank_one_update(L: Tensor, U: Tensor, v: Tensor, sigma, m, *,
                    iters: int = 62, method: str = "gu",
                    matmul: str = "jnp", precise: bool = True,
                    z: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """One symmetric rank-one update of the eigendecomposition.

    L: (M,) ascending eigenvalues (sentinels above the active spectrum),
    U: (M, M) eigenvectors in columns (identity on inactive columns),
    v: (M,) update vector, sigma: scalar of either sign, m: active count.
    ``z`` is an optional precomputed Uᵀv in the current basis.
    Returns the updated (L, U), sorted ascending, same padding invariants.
    """
    if matmul not in ("jnp", "pallas"):
        raise ValueError(f"unknown rotation route {matmul!r}")
    sigma = torch.as_tensor(sigma, dtype=L.dtype, device=L.device)
    m = torch.as_tensor(m, dtype=torch.int32, device=L.device)
    return _update_body(L, U, v, sigma, m, iters=iters, method=method,
                        matmul=matmul, precise=precise, z=z)


def expand_eigensystem_perm(L: Tensor, lam_new: Tensor, m: Tensor
                            ) -> tuple[Tensor, Tensor, Tensor]:
    """Eigenvalue half of ``expand_eigensystem``: the sorted spectrum plus
    the column permutation to apply to U (or to a precomputed Uᵀv)."""
    m_new = m + 1
    L = index_set(L, m, lam_new)
    L = sentinelize(L, m_new, L.new_zeros(()))
    perm = torch.argsort(L, stable=True)
    return L[perm], perm, m_new


def expand_eigensystem(L: Tensor, U: Tensor, lam_new: Tensor, m: Tensor
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """Append eigenpair (lam_new, e_m) and restore ascending order.
    (Paper Alg. 1 line 2 writes k/4 into the U corner — an erratum; the new
    unit eigenvector must be e_{m+1}.)"""
    L_new, perm, m_new = expand_eigensystem_perm(L, lam_new, m)
    return L_new, U[:, perm], m_new


def reconstruct(L: Tensor, U: Tensor, m: Tensor) -> Tensor:
    """K̃ = U diag(L) Uᵀ restricted to the active block (testing utility)."""
    M = L.shape[0]
    mask = active_mask(M, m)
    Lm = torch.where(mask, L, 0.0)
    K = (U * Lm[None, :]) @ U.T
    blk = mask[:, None] & mask[None, :]
    return torch.where(blk, K, 0.0)
