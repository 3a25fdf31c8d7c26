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
(``matmul="jnp"``, the oracle route).  ``rank_one_update_pair`` fuses a
±sigma pair's two rotations into one (``kernels/csrc/eigvec_rotate2.cu``).
The secular roots are kept as (origin pole, offset) pairs (``_Roots``).
sigma < 0 is reduced to sigma > 0 by the flip identity
eig(D + s zzᵀ) = -rev(eig(-rev(D) + |s| rev(z)rev(z)ᵀ)).

Every function takes an optional leading tenant axis: L (B, M), U
(B, M, M), v (B, M), m (B,) and sigma (B,) or a scalar advance B
independent eigensystems at once (``engine.StreamBatch``), the kernels
launched once for the B tenants.  The single stream is the same code with
no leading axis; each tenant's arithmetic is the single stream's.  A
batched index (``index_set``/``index_get``) is clamped into range: a lane
that a masked cohort step discards may sit at m = M.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.eigvec_update import ops as eigvec_ops
from repro_torch.kernels.eigvec_update.ref import (cauchy_factor_ref,
                                                   guard_zero)

Tensor = torch.Tensor

# Margin multiplier used when regenerating sentinel eigenvalues.
_SENTINEL_GAP = 1.0


def _eps_for(dtype) -> float:
    return torch.finfo(dtype).eps


def _solve_dtype(dtype, precise: bool):
    """The secular solve's type: float64 under ``precise``, else the
    state's.  Its eps also sets the displacement-deflation thresholds."""
    return torch.float64 if precise else dtype


def _batched_index(vec: Tensor, i: Tensor) -> Tensor:
    """Per-tenant entry (or row) indices ``i`` (B,) as a gather index into
    ``vec`` (B, M, ...), clamped into range."""
    M = vec.shape[1]
    idx = i.long().clamp(0, M - 1)
    return idx.reshape((-1, 1) + (1,) * (vec.dim() - 2)).expand(
        (vec.shape[0], 1) + vec.shape[2:])


def index_set(vec: Tensor, i: Tensor, value) -> Tensor:
    """``vec`` with entry (or row) ``i`` replaced — out of place, and with
    ``i`` a device tensor, so no host read.  A Python ``value`` becomes a
    fill on vec's device, not a copy from the host (which synchronizes).
    With a tenant axis, ``vec`` is (B, M, ...), ``i`` (B,) and ``value``
    (B, ...) or a scalar."""
    value = (value.to(dtype=vec.dtype, device=vec.device)
             if torch.is_tensor(value) else vec.new_full((), value))
    if i.dim() == 0:
        return vec.index_put((i.reshape(1).long(),),
                             value.reshape((1,) + vec.shape[1:]))
    idx = _batched_index(vec, i)
    return vec.scatter(1, idx, value.reshape(
        value.shape[:1] + (1,) + value.shape[1:]).expand(idx.shape))


def index_get(vec: Tensor, i: Tensor) -> Tensor:
    """``vec[i]`` for a 0-d device tensor ``i``, without a host read; with a
    tenant axis, tenant b's entry (or row) i[b]."""
    if i.dim() == 0:
        return vec.index_select(0, i.reshape(1).long())[0]
    return torch.gather(vec, 1, _batched_index(vec, i))[:, 0]


def take(vec: Tensor, perm: Tensor) -> Tensor:
    """``vec[perm]`` along the last axis, per tenant."""
    if vec.dim() == 1:
        return vec[perm]
    return torch.take_along_dim(vec, perm, dim=-1)


def take_cols(U: Tensor, perm: Tensor) -> Tensor:
    """``U[:, perm]``, per tenant."""
    if U.dim() == 2:
        return U[:, perm]
    return torch.take_along_dim(U, perm[..., None, :], dim=-1)


def take_rows(U: Tensor, perm: Tensor) -> Tensor:
    """``U[perm]`` (rows), per tenant."""
    if perm.dim() == 1:
        return U[perm]
    return torch.take_along_dim(U, perm.reshape(
        perm.shape + (1,) * (U.dim() - 2)), dim=1)


def tmatvec(U: Tensor, v: Tensor) -> Tensor:
    """Uᵀ v per tenant (v (M,) or (M, k), with U's tenant axis)."""
    if U.dim() == 2:
        return U.T @ v
    if v.dim() == U.dim():
        return U.mT @ v
    return (U.mT @ v[..., None])[..., 0]


def matvec(U: Tensor, v: Tensor) -> Tensor:
    """U v per tenant."""
    if U.dim() == 2:
        return U @ v
    return (U @ v[..., None])[..., 0]


def active_mask(M: int, m: Tensor) -> Tensor:
    return torch.arange(M, device=m.device) < m[..., None]


def sentinelize(d: Tensor, m: Tensor, room: Tensor) -> Tensor:
    """Place inactive eigenvalues strictly above the active spectrum.

    ``room`` bounds how far the top active root can travel (sigma·||z||²
    for sigma > 0, else 0).  Sentinels are spaced by 1 so bisection
    intervals in the inactive region are well conditioned.
    """
    M = d.shape[-1]
    mask = active_mask(M, m)
    top = torch.amax(torch.where(mask, d, -torch.inf), dim=-1)
    top = torch.where(torch.isfinite(top), top, 0.0)   # m == 0 corner
    base = top + torch.abs(room) + _SENTINEL_GAP
    idx = torch.arange(M, dtype=d.dtype, device=d.device)
    sent = base[..., None] + _SENTINEL_GAP * (idx - m.to(d.dtype)[..., None])
    return torch.where(mask, d, sent)


class _Roots(NamedTuple):
    """Secular roots in offset form: root j = org[j] + tau[j], with org[j]
    the pole the root is closer to (the top root: its lower pole).  Every
    difference d_i - root_j is then formed as (d_i - org_j) - tau_j, which
    is exact for close poles (Sterbenz) and keeps the root's distance to
    them to full relative accuracy, as LAPACK's dlaed4 does."""

    org: Tensor
    tau: Tensor

    @property
    def value(self) -> Tensor:
        return self.org + self.tau


def _pole_gaps(d: Tensor, org: Tensor, tau: Tensor) -> Tensor:
    """(i, j) matrix of d_i - root_j in offset form."""
    return (d[..., :, None] - org[..., None, :]) - tau[..., None, :]


def _secular_roots(d: Tensor, z2: Tensor, sigma: Tensor, iters: int,
                   defl: Tensor | None = None) -> _Roots:
    """All roots of 1 + sigma·sum_i z2_i/(d_i - t), sigma > 0, d ascending.

    Root j lives in (d_j, next pole) and the top root in (d_{M-1},
    d_{M-1} + sigma·sum(z2)) (paper eq. 5).  Deflated poles (``defl``)
    keep their eigenvalue at the pole and are skipped in every other
    root's bracket.  One evaluation at each bracket's midpoint picks the
    root's origin (the nearer pole); then fixed-iteration bisection of
    every offset at once, each secular term formed from (d_i - org_j)
    - tau_j.  Bisecting the absolute root instead resolves it only to an
    ulp of its magnitude: between two poles 2e-13 apart near 2.0 that
    keeps 3 digits of the root's position, and the eigenvectors built on
    it lose orthogonality (ROADMAP.md, "Faults found").
    """
    eps = _eps_for(d.dtype)
    znorm2 = torch.sum(z2, dim=-1)
    top = d[..., -1] + sigma * znorm2 + eps
    inf = d.new_full(d.shape[:-1] + (1,), torch.inf)
    if defl is None:
        nxt = torch.cat([d[..., 1:], inf], dim=-1)
    else:
        d_nd = torch.where(defl, torch.inf, d)
        # Next non-deflated pole above each entry: a reversed cumulative
        # minimum (jax.lax.cummin over the flipped vector).
        nxt = torch.cat([torch.cummin(d_nd.flip(-1), -1).values.flip(-1)
                         [..., 1:], inf], dim=-1)
    hi_is_pole = ~torch.isinf(nxt)
    hi = torch.where(hi_is_pole, nxt, top[..., None])
    half = 0.5 * (hi - d)
    sig = sigma[..., None]

    def w_of(den: Tensor) -> Tensor:     # den[i, j] = d_i - t_j
        return 1.0 + sig * torch.sum(z2[..., :, None] / den, dim=-2)

    # Root j sits below its bracket's midpoint (w increasing between
    # poles): origin d_j; above it and below a pole: origin that pole;
    # above it and below ``top`` (the top root): origin d_j, offset in the
    # upper half.  The offset's magnitude is then bisected geometrically
    # from eps² of the half-width up, so it converges to relative accuracy
    # however close the root is to its origin: an arithmetic bisection
    # resolves only 2^-iters of the half-width, which for a root 1e-15
    # from its pole in a bracket 1e-3 wide leaves 1e-7 of its distance.
    den = _pole_gaps(d, d, half)
    in_lower = w_of(torch.where(den == 0.0, eps, den)) > 0.0
    upper = ~in_lower & hi_is_pole
    org = torch.where(upper, hi, d)
    sign = torch.where(upper, -1.0, 1.0).to(d.dtype)
    near = in_lower | upper
    tiny = torch.finfo(d.dtype).tiny
    lo = torch.clamp_min(torch.where(near, half * eps * eps, half), tiny)
    # A zero-width bracket (coincident poles the merge did not join) keeps
    # a bracket of one tiny, so the offset stays finite.
    hi_t = torch.maximum(torch.where(near, half, 2.0 * half), lo)
    # Fixed origins: d_i - org_j once.  The offsets stay strictly inside
    # their brackets (|tau| >= tiny), so no denominator is 0 in the loop.
    delta = d[..., :, None] - org[..., None, :]
    for _ in range(iters):
        mid = lo * torch.sqrt(hi_t / lo)
        # |tau| above mid iff w(org + sign·mid) is on the root's far side.
        grow = (w_of(delta - (sign * mid)[..., None, :]) > 0.0) == upper
        lo, hi_t = torch.where(grow, mid, lo), torch.where(grow, hi_t, mid)
    tau = sign * lo * torch.sqrt(hi_t / lo)
    if defl is not None:
        org = torch.where(defl, d, org)
        tau = torch.where(defl, 0.0, tau)
    return _Roots(org=org, tau=tau)


def _secular_bisect(d: Tensor, z2: Tensor, sigma: Tensor, iters: int,
                    defl: Tensor | None = None) -> Tensor:
    """The roots of ``_secular_roots`` as absolute values."""
    return _secular_roots(d, z2, sigma, iters, defl).value


def _cluster_merge(d: Tensor, z: Tensor, tol: Tensor):
    """LAPACK dlaed2-style cluster deflation.

    For each run of poles closer than ``tol``, a Householder reflector H
    (block-diagonal over runs) rotates the run's z-mass into its LAST
    element; the others become exactly zero and deflate.  Returns
    (z_new, apply, fired) with apply(X) = H @ X in O(M²) by segment sums.

    With a tenant axis the B·M entries are one flattened sequence with a
    run boundary forced at each tenant's first entry, so one segmented
    reduction serves the cohort and no run crosses two tenants.
    """
    lead = d.shape[:-1]
    M = d.shape[-1]
    N = d.numel()
    gap = torch.diff(d, dim=-1)
    first = torch.ones(lead + (1,), dtype=torch.bool, device=d.device)
    new_seg = torch.cat([first, gap > tol[..., None]], dim=-1)
    seg = torch.cumsum(new_seg.reshape(N).to(torch.int64), 0) - 1
    # Run r spans entries offsets[r]:offsets[r + 1]; runs past the last are
    # empty.  A segmented reduction adds each run in a fixed order (on the
    # CPU left to right, as index_add_ did), so two runs of one stream on
    # the card agree bit for bit; index_add_ adds with atomics there.
    offsets = torch.searchsorted(
        seg, torch.arange(N + 1, dtype=seg.dtype, device=d.device))

    def segsum(x: Tensor) -> Tensor:        # per-run sum, gathered back
        flat = x.reshape((N,) + x.shape[len(lead) + 1:])
        return torch.segment_reduce(flat, "sum", offsets=offsets, axis=0,
                                    unsafe=True)[seg].reshape(x.shape)

    seg_size = segsum(torch.ones_like(z))
    znorm_seg = torch.sqrt(segsum(z * z))
    is_last = torch.cat([new_seg[..., 1:], first], dim=-1)
    z_last = segsum(torch.where(is_last, z, 0.0))
    sl = torch.where(z_last >= 0, 1.0, -1.0).to(z.dtype)
    target = -sl * znorm_seg                  # H z_run = target · e_last
    w = z - torch.where(is_last, target, 0.0)
    wnorm2 = segsum(w * w)
    tiny = torch.finfo(d.dtype).tiny
    active = (seg_size > 1.5) & (wnorm2 > tiny)
    coef = torch.where(active, 2.0 / torch.where(active, wnorm2, 1.0), 0.0)

    def apply(X: Tensor) -> Tensor:           # H @ X, rows mixed per run
        s = segsum(w[..., :, None] * X)
        return X - (coef * w)[..., :, None] * s

    wz = segsum(w * z)
    z_new = z - coef * w * wz
    # exact zeros on merged (non-last) members so deflation catches them
    z_new = torch.where(active & ~is_last, 0.0, z_new)
    return z_new, apply, torch.any(active, dim=-1)


def _gu_zhat(d: Tensor, roots: _Roots, sigma: Tensor, z: Tensor) -> Tensor:
    """Gu–Eisenstat recomputation of |z| from the computed roots:
    sigma·ẑ_i² = prod_j (roots_j - d_i) / prod_{j != i} (d_j - d_i),
    in log space, each roots_j - d_i in offset form.  Deflated and
    inactive entries come out exactly 0."""
    num = _pole_gaps(d, roots.org, roots.tau)               # -(root_j - d_i)
    den = d[..., None, :] - d[..., :, None]
    den.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    tiny = torch.finfo(d.dtype).tiny
    log_z2 = (torch.sum(torch.log(num.abs() + tiny), dim=-1)
              - torch.sum(torch.log(den.abs() + tiny), dim=-1)
              - torch.log(sigma.abs())[..., None])
    zhat = torch.sign(z) * torch.sqrt(torch.exp(log_z2))
    # Guard: if the identity degenerates numerically, fall back to z.
    return torch.where(torch.isfinite(zhat), zhat, z)


def _guarded(den: Tensor) -> Tensor:
    """Offset-form denominators with an exact zero (a deflated column's
    own pole) replaced by ±``offset_guard``.  The reference guards
    absolute roots at ±eps; in offset form a root's distance to its pole
    is exact however small, and a guard at eps would overwrite it
    (``eigvec_update.ref._denominators``)."""
    return guard_zero(den, den.dtype)


def _cauchy_inv(d: Tensor, roots: _Roots, zhat: Tensor) -> Tensor:
    """Inverse column norms of W[i, j] = zhat_i / (d_i - roots_j)."""
    W = zhat[..., :, None] / _guarded(_pole_gaps(d, roots.org, roots.tau))
    norms = torch.sqrt(torch.sum(W * W, dim=-2))
    return torch.where(norms > 0, 1.0 / norms, 1.0)


class _Factor(NamedTuple):
    """One solved rank-one update as an original-domain Cauchy factor:
    W[k, j] = z_k·inv_j/((d_k - org_j) - tau_j), deflated columns
    identity; the roots are org + tau (``_Roots``).  ``L_new`` is the
    updated (pre-sort) spectrum.  The sigma<0 flip's sign is folded into
    z, so the active region is a prefix for either sign."""

    z: Tensor
    d: Tensor
    org: Tensor
    tau: Tensor
    inv: Tensor
    defl: Tensor
    L_new: Tensor


def _solve_factor(d_sent: Tensor, z: Tensor, sigma: Tensor, m: Tensor,
                  scale: Tensor, *, iters: int, method: str,
                  precise: bool) -> _Factor:
    """Displacement deflation + secular solve + un-flip, as a ``_Factor``.

    A direction deflates when it is inactive, when |z_i| is negligible, or
    when zeroing it perturbs the matrix by less than the spectrum's
    resolution: |sigma|·|z_i|·‖z‖ ≲ eps·‖A‖, LAPACK's dlaed2 criterion
    (the largest entry of sigma·z zᵀ it drops).  The reference deflates on
    sigma·z_i² instead, which drops off-diagonal terms of up to
    sqrt(eps·‖A‖·sigma)·‖z‖; it needs that to keep an absolute root from
    rounding onto its pole, which the offset form (``_Roots``) never
    does.

    With ``precise`` the secular equations are solved in float64 for any
    state type (the reference does so under x64, which its tests enable);
    the factor's vectors stay in the solve type.

    eps is the solve type's.  The reference takes the state type's, so an
    f32 state under ``precise`` drops every component with sigma·z² below
    ~1e-5·‖A‖, though the f64 solve resolves it.  Over a stream the
    spectrum then drifts by 1e-2 relative within 250 points, against 3e-6
    with the solve type's eps (ROADMAP.md, "Faults found").  For an f64
    state the two are the same.
    """
    M = d_sent.shape[-1]
    dtype = d_sent.dtype
    solve_dtype = _solve_dtype(dtype, precise)
    eps = _eps_for(solve_dtype)
    mask = active_mask(M, m)
    sig_abs = torch.abs(sigma)
    neg = (sigma < 0)[..., None]
    znorm = torch.sqrt(torch.sum(z * z, dim=-1))[..., None]
    floor = 32.0 * eps * torch.clamp_min(znorm, eps)
    defl = (~mask | (z.abs() < floor)
            | (sig_abs[..., None] * z.abs() * znorm
               < 64.0 * eps * scale[..., None]))
    z = torch.where(defl, 0.0, z)

    d_eff = torch.where(neg, -d_sent.flip(-1), d_sent)
    z_eff = torch.where(neg, z.flip(-1), z)
    defl_eff = torch.where(neg, defl.flip(-1), defl)
    d_s = d_eff.to(solve_dtype)
    z_s = z_eff.to(solve_dtype)
    sig_s = sig_abs.to(solve_dtype)
    roots_eff = _secular_roots(d_s, z_s * z_s, sig_s, iters, defl=defl_eff)
    if method == "gu":
        zhat_eff = _gu_zhat(d_s, roots_eff, sig_s, z_s)
        zhat_eff = torch.where(defl_eff, 0.0, zhat_eff)
    else:
        zhat_eff = z_s
    inv_eff = _cauchy_inv(d_s, roots_eff, zhat_eff)
    inv_eff = torch.where(defl_eff, 1.0, inv_eff)

    # Un-flip; negation is exact, so (d - org) - tau keeps its accuracy.
    z_o = torch.where(neg, -zhat_eff.flip(-1), zhat_eff)
    org_o = torch.where(neg, -roots_eff.org.flip(-1), roots_eff.org)
    tau_o = torch.where(neg, -roots_eff.tau.flip(-1), roots_eff.tau)
    inv_o = torch.where(neg, inv_eff.flip(-1), inv_eff)
    L_new = torch.where(mask, (org_o + tau_o).to(dtype), d_sent)
    return _Factor(z=torch.where(mask, z_o, 0.0), d=d_sent.to(solve_dtype),
                   org=org_o, tau=tau_o, inv=inv_o, defl=defl, L_new=L_new)


def _apply_factor(U: Tensor, f: _Factor, mask: Tensor, m: Tensor, *,
                  matmul: str, row_offset: int | None = None) -> Tensor:
    """U @ Ŵn for one factor, keeping the padding invariants.  ``U`` may
    be a row block whose first row is the state's row ``row_offset`` (a
    host int; the row-sharded update of ``core/distributed.py``).

    ``"pallas"``: the rotation kernel generates the factor from five O(M)
    vectors (``kernel_operands``: padded factor entries are exactly 0) and
    prunes everything beyond m; deflated columns, which include every
    inactive one, keep U's own column.
    ``"jnp"``: the dense factor with identity columns, then a product.
    """
    if matmul == "pallas":
        z, d, org, inv, tau = kernel_operands(f, mask, U.dtype)
        C = eigvec_ops.rotate_vectors(U, z, d, org, inv, m, tau=tau,
                                      row_offset=row_offset)
        return torch.where(f.defl[..., None, :], U, C)
    Wn = cauchy_factor_ref(f.z, f.d, f.org, f.inv, f.defl.to(f.z.dtype),
                           tau=f.tau).to(dtype=U.dtype)
    return U @ Wn


def kernel_operands(f: _Factor, mask: Tensor, dtype
                    ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(z, d, org, inv, tau) of a factor as the rotation kernel takes
    them, with padded entries d = 2e30, org = 1e30 and z = inv = tau = 0
    so that every padded factor entry is exactly 0.  z and inv are in the
    state's type; d, org and tau stay in the solve's type and the kernel
    forms each denominator as (d - org) - tau in float64, so a root close
    to its pole keeps its distance from it.  (The reference passes the
    absolute roots, cast to the state's type: an f32 state can then
    divide by 0, and an f64 one keeps 3 digits of a root between two
    poles 1e-13 apart.)"""
    return (torch.where(mask, f.z.to(dtype), 0.0),
            torch.where(mask, f.d, 2e30),
            torch.where(mask, f.org, 1e30),
            torch.where(mask, f.inv.to(dtype), 0.0),
            torch.where(mask, f.tau, 0.0))


def _update_body(L: Tensor, U: Tensor, v: Tensor, sigma: Tensor, m: Tensor,
                 *, iters: int, method: str, matmul: str, precise: bool,
                 z: Tensor | None = None, row_offset: int | None = None
                 ) -> tuple[Tensor, Tensor]:
    """One rank-one update; ``z`` = Uᵀv may come precomputed (the fused
    ingest kernel produces it, or a row-sharded update all-reduces it),
    else it is the dense product here.  With ``row_offset`` U is a row
    block of the state (``_apply_factor``) and ``z`` must be given."""
    M = L.shape[-1]
    dtype = L.dtype
    mask = active_mask(M, m)
    if z is None:
        v = torch.where(mask, v, 0.0)
        z = tmatvec(U, v)
    else:
        z = torch.where(mask, z, 0.0)
    sig_abs = torch.abs(sigma)

    # Re-sentinelize with head-room for the top root's travel; under the
    # flip the sentinels land (negated) at the bottom, still sorted.
    room = sig_abs * torch.sum(z * z, dim=-1)
    d_sent = sentinelize(L, m, room)

    # Cluster-merge deflation; U absorbs the block reflector at O(M²).  Its
    # tolerance is the state type's: it protects the rotation of U, which
    # rounds in that type.
    scale = _scale(L, mask, room)
    tol = 64.0 * _eps_for(dtype) * scale
    z, applyH, _ = _cluster_merge(d_sent, z, tol)
    U = applyH(U.mT).mT                          # U @ H, no matmul

    f = _solve_factor(d_sent, z, sigma, m, scale, iters=iters, method=method,
                      precise=precise)
    U_new = _apply_factor(U, f, mask, m, matmul=matmul,
                          row_offset=row_offset)
    # Deflation can locally reorder roots; the next update's interlacing
    # needs ascending order.  Stable, as jnp.argsort is, so ties among
    # deflated roots and sentinels keep their column order.
    perm = torch.argsort(f.L_new, dim=-1, stable=True)
    return take(f.L_new, perm), take_cols(U_new, perm)


def _scale(L: Tensor, mask: Tensor, room: Tensor) -> Tensor:
    """‖A‖'s stand-in of the deflation tests: max |L| over the active
    spectrum plus the update's room."""
    return (torch.amax(torch.abs(torch.where(mask, L, 0.0)), dim=-1) + room
            + 1e-30)


def _as_sigma(sigma, L: Tensor) -> Tensor:
    """sigma as a tensor of L's type and device, one per tenant."""
    return torch.as_tensor(sigma, dtype=L.dtype, device=L.device).expand(
        L.shape[:-1])


def rank_one_update(L: Tensor, U: Tensor, v: Tensor, sigma, m, *,
                    iters: int = 62, method: str = "gu",
                    matmul: str = "jnp", precise: bool = True,
                    z: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """One symmetric rank-one update of the eigendecomposition.

    L: (M,) ascending eigenvalues (sentinels above the active spectrum),
    U: (M, M) eigenvectors in columns (identity on inactive columns),
    v: (M,) update vector, sigma: scalar of either sign, m: active count;
    or each with a leading tenant axis (module docstring).
    ``z`` is an optional precomputed Uᵀv in the current basis.
    Returns the updated (L, U), sorted ascending, same padding invariants.
    """
    if matmul not in ("jnp", "pallas"):
        raise ValueError(f"unknown rotation route {matmul!r}")
    sigma = _as_sigma(sigma, L)
    m = torch.as_tensor(m, dtype=torch.int32, device=L.device)
    return _update_body(L, U, v, sigma, m, iters=iters, method=method,
                        matmul=matmul, precise=precise, z=z)


# ------------------------------------------------------ fused ±sigma pair --
def _pair_factor(L: Tensor, z: Tensor, sigma: Tensor, m: Tensor, *,
                 iters: int, method: str, precise: bool) -> _Factor:
    """Sentinelize + solve one update into a Cauchy factor (no rotation):
    ``rank_one_update``'s pipeline minus the dlaed2 cluster merge, whose
    block reflector is not a Cauchy factor and so cannot sit between the
    two fused rotations (``_merge_fires`` sends such pairs down the
    sequential path)."""
    mask = active_mask(L.shape[-1], m)
    room = torch.abs(sigma) * torch.sum(z * z, dim=-1)
    d_sent = sentinelize(L, m, room)
    return _solve_factor(d_sent, z, sigma, m, _scale(L, mask, room),
                         iters=iters, method=method, precise=precise)


def _factor_tmatvec(f: _Factor, y: Tensor) -> Tensor:
    """(Ŵn)ᵀ y in O(M²) from the factor's vectors: the second secular
    solve's z without the first rotation of U."""
    den = _guarded(_pole_gaps(f.d, f.org, f.tau))
    s = torch.sum((f.z * y)[..., :, None] / den, dim=-2) * f.inv
    return torch.where(f.defl, y, s)


class _PairFactors(NamedTuple):
    """Both solved factors of a fused ±sigma pair.

    Factor 1's columns carry the inter-update sort (org1/tau1/inv1/defl1
    are permuted; cid1 records the permutation, so a deflated column is
    e_{cid1[j]}).  ``L_new`` is the post-update-2 spectrum before the
    final ``perm2`` sort; ``merge_fired`` says a dlaed2 cluster merge
    would fire on either update, where the fused rotation is unsafe."""

    z1: Tensor
    d1: Tensor
    org1: Tensor
    tau1: Tensor
    inv1: Tensor
    defl1: Tensor
    cid1: Tensor
    z2: Tensor
    d2: Tensor
    org2: Tensor
    tau2: Tensor
    inv2: Tensor
    defl2: Tensor
    cid2: Tensor
    L_new: Tensor
    perm2: Tensor
    merge_fired: Tensor


def _merge_fires(L: Tensor, z: Tensor, sigma: Tensor, m: Tensor) -> Tensor:
    """Would ``rank_one_update``'s cluster merge rotate z-mass for this
    (spectrum, z, sigma)?  Same sentinels and tolerance as the sequential
    path, detection only."""
    M = L.shape[-1]
    mask = active_mask(M, m)
    room = torch.abs(sigma) * torch.sum(z * z, dim=-1)
    d_sent = sentinelize(L, m, room)
    tol = 64.0 * _eps_for(L.dtype) * _scale(L, mask, room)
    return _cluster_merge(d_sent, z, tol)[2]


def _pair_solve(L: Tensor, z1: Tensor, sigma1: Tensor, z2_raw: Tensor,
                sigma2: Tensor, m: Tensor, *, iters: int, method: str,
                precise: bool) -> _PairFactors:
    """Solve both secular systems of a fused pair, no rotation of U.

    ``z2_raw`` is Uᵀv₂ in the pre-update basis; the second update's
    z₂ = U₁ᵀv₂ comes from the Cauchy transpose-matvec (O(M²))."""
    M = L.shape[-1]
    dtype = L.dtype
    f1 = _pair_factor(L, z1, sigma1, m, iters=iters, method=method,
                      precise=precise)
    perm1 = torch.argsort(f1.L_new, dim=-1, stable=True)
    L1 = take(f1.L_new, perm1)
    y = _factor_tmatvec(f1, z2_raw.to(f1.z.dtype))
    z2 = take(y, perm1).to(dtype)
    f2 = _pair_factor(L1, z2, sigma2, m, iters=iters, method=method,
                      precise=precise)
    perm2 = torch.argsort(f2.L_new, dim=-1, stable=True)
    fired = _merge_fires(L, z1, sigma1, m) | _merge_fires(L1, z2, sigma2, m)
    # Sentinels sort to themselves, so inactive cid stays the column index.
    cid2 = torch.arange(M, dtype=torch.int32, device=L.device)
    return _PairFactors(
        z1=f1.z, d1=f1.d, org1=take(f1.org, perm1), tau1=take(f1.tau, perm1),
        inv1=take(f1.inv, perm1), defl1=take(f1.defl, perm1),
        cid1=perm1.to(torch.int32),
        z2=f2.z, d2=f2.d, org2=f2.org, tau2=f2.tau, inv2=f2.inv,
        defl2=f2.defl, cid2=cid2.expand(L.shape),
        L_new=f2.L_new, perm2=perm2, merge_fired=fired)


def _pair_rotate_block(U: Tensor, pf: _PairFactors, m: Tensor, *,
                       matmul: str, row_offset: int | None = None) -> Tensor:
    """Fused double rotation (U @ W1n @ W2n)[:, perm2].  ``U`` may be a
    row block whose first row is the state's row ``row_offset``.

    ``"pallas"``: the ``eigvec_rotate2`` kernel generates both factors from
    their vectors (z, inv in the state's type; d, org, tau in the solve's,
    as for ``eigvec_rotate``: the reference casts them to the state's type
    and an f32 state can divide by 0); inactive columns are U's own.
    ``"jnp"``: both dense factors, then two products."""
    dtype = U.dtype
    if matmul == "pallas":
        mask = active_mask(U.shape[-1], m)
        C = eigvec_ops.rotate_vectors2(
            U, pf.z1.to(dtype), pf.d1, pf.org1, pf.inv1.to(dtype),
            pf.defl1.to(dtype), pf.cid1,
            pf.z2.to(dtype), pf.d2, pf.org2, pf.inv2.to(dtype),
            pf.defl2.to(dtype), pf.cid2, m, tau1=pf.tau1, tau2=pf.tau2,
            row_offset=row_offset)
        C = torch.where(mask[..., None, :], C, U)
    else:
        W1 = cauchy_factor_ref(pf.z1, pf.d1, pf.org1, pf.inv1,
                               pf.defl1.to(pf.z1.dtype), pf.cid1,
                               tau=pf.tau1).to(dtype)
        W2 = cauchy_factor_ref(pf.z2, pf.d2, pf.org2, pf.inv2,
                               pf.defl2.to(pf.z2.dtype), pf.cid2,
                               tau=pf.tau2).to(dtype)
        C = (U @ W1) @ W2
    return take_cols(C, pf.perm2)


def rank_one_update_pair(L: Tensor, U: Tensor, v1: Tensor, sigma1,
                         v2: Tensor, sigma2, m, *, iters: int = 62,
                         method: str = "gu", matmul: str = "jnp",
                         precise: bool = True, merge_fallback: bool = True,
                         z1: Tensor | None = None, z2: Tensor | None = None
                         ) -> tuple[Tensor, Tensor]:
    """Two back-to-back rank-one updates with ONE fused double rotation.

    Semantically ``rank_one_update(·, v2, sigma2) ∘ rank_one_update(·, v1,
    sigma1)``, the ±sigma pairs of Algorithms 1 and 2, except that U is
    rotated once: C = U @ W1n @ W2n.  The second update's z₂ = U₁ᵀv₂
    comes from the Cauchy transpose-matvec, so U is read and written once
    per pair.

    The cluster merge cannot sit between the two fused rotations; with
    ``merge_fallback`` (default) a pair on which a merge would fire runs
    as two sequential updates instead.  The reference decides that on the
    device (``lax.cond``); here ``merge_fired`` is read on the host, one
    synchronisation per pair, and the branch not taken launches nothing.
    With a tenant axis the read is ``merge_fired.any()``, still one per
    pair: where no tenant fired only the fused rotation runs, else both
    branches run for the cohort and each tenant takes its own branch's
    result (the select ``lax.cond`` becomes under ``jax.vmap``).

    ``matmul``: "jnp" (dense factors) or "pallas" (the ``eigvec_rotate2``
    kernel on the card, its plain version on the CPU).  ``z1``/``z2``
    (both or neither) are precomputed Uᵀv₁ / Uᵀv₂ in the current basis;
    the fallback reuses z1 and recomputes z2 from the rotated U₁.
    """
    if matmul not in ("jnp", "pallas"):
        raise ValueError(f"unknown rotation route {matmul!r}")
    if (z1 is None) != (z2 is None):
        raise ValueError("pass both precomputed projections or neither")
    M = L.shape[-1]
    sigma1 = _as_sigma(sigma1, L)
    sigma2 = _as_sigma(sigma2, L)
    m = torch.as_tensor(m, dtype=torch.int32, device=L.device)
    mask = active_mask(M, m)
    v1 = torch.where(mask, v1, 0.0)
    v2 = torch.where(mask, v2, 0.0)
    if z1 is None:
        # One pass over U for both.
        Z = tmatvec(U, torch.stack([v1, v2], dim=-1))
        z1, z2 = Z[..., 0], Z[..., 1]
    else:
        z1 = torch.where(mask, z1, 0.0)
        z2 = torch.where(mask, z2, 0.0)
    kw = dict(iters=iters, method=method, precise=precise)
    pf = _pair_solve(L, z1, sigma1, z2, sigma2, m, **kw)
    mf = pf.merge_fired
    fired = merge_fallback and bool(mf if mf.dim() == 0 else mf.any())
    if fired:
        L1, U1 = _update_body(L, U, v1, sigma1, m, matmul=matmul, z=z1,
                              **kw)
        Ls, Us = _update_body(L1, U1, v2, sigma2, m, matmul=matmul, **kw)
        if L.dim() == 1:
            return Ls, Us
    Lf = take(pf.L_new, pf.perm2)
    Uf = _pair_rotate_block(U, pf, m, matmul=matmul)
    if not fired:
        return Lf, Uf
    sel = pf.merge_fired[..., None]
    return torch.where(sel, Ls, Lf), torch.where(sel[..., None], Us, Uf)


def expand_eigensystem_perm(L: Tensor, lam_new: Tensor, m: Tensor
                            ) -> tuple[Tensor, Tensor, Tensor]:
    """Eigenvalue half of ``expand_eigensystem``: the sorted spectrum plus
    the column permutation to apply to U (or to a precomputed Uᵀv)."""
    m_new = m + 1
    L = index_set(L, m, lam_new)
    L = sentinelize(L, m_new, L.new_zeros(()))
    perm = torch.argsort(L, dim=-1, stable=True)
    return take(L, perm), perm, m_new


def expand_eigensystem(L: Tensor, U: Tensor, lam_new: Tensor, m: Tensor
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """Append eigenpair (lam_new, e_m) and restore ascending order.
    (Paper Alg. 1 line 2 writes k/4 into the U corner — an erratum; the new
    unit eigenvector must be e_{m+1}.)"""
    L_new, perm, m_new = expand_eigensystem_perm(L, lam_new, m)
    return L_new, take_cols(U, perm), m_new


def reconstruct(L: Tensor, U: Tensor, m: Tensor) -> Tensor:
    """K̃ = U diag(L) Uᵀ restricted to the active block (testing utility)."""
    M = L.shape[-1]
    mask = active_mask(M, m)
    Lm = torch.where(mask, L, 0.0)
    K = (U * Lm[..., None, :]) @ U.mT
    blk = mask[..., :, None] & mask[..., None, :]
    return torch.where(blk, K, 0.0)
