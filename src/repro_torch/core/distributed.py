"""Row-sharded incremental KPCA over ``torch.distributed`` (SPMD over
processes).

Scheme (the reference's, with processes for devices):

* Each rank of a row group holds its own row block U_p of the
  eigenvectors: M/P rows (data points), the rows of global index
  ``rank·M/P`` on.  L, the stored points X, the ages ring and every O(M)
  vector are replicated: each rank holds the same values.
* One update needs one collective: z = Σ_p U_pᵀ v_p (M numbers), the
  all-reduce of each row block's partial projection (the ``eigvec_project``
  kernel on the block on the ``pallas`` routes).  The secular solve and
  the Cauchy factor are computed on every rank from replicated O(M)
  vectors; each rank rotates only its row block (the rotation kernels at
  the block's ``row_offset``).
* ``plan.dispatch == "bucketed"`` slices every local operand to the
  active power-of-two bucket — a row block becomes a (min(M/P, M_b), M_b)
  rectangle — with the bucket read on the host once per call, as
  ``engine.rank_one`` does; the global row offset stays ``rank·M/P``
  (``rows_full``).  Rows past a bucket are inactive identity rows whose
  unit entry lies outside the sliced columns: they add nothing to z and
  are not changed by the update.

**Every collective is unconditional.**  A rank never branches on a value
another rank could compute differently: the replicated solve runs the same
operations on the same bits on every rank, so the fused pair's merge
predicate (read on the host, ``rankone._pair_solve``) is the same on every
rank, and the pair issues its second all-reduce whether or not the merge
fired (the fallback is collective-balanced).  A guarded window step runs
its collectives on a stand-in point and discards the result by a select.
Every process group is made with a ``timeout``, so a mismatched schedule
fails instead of hanging.

Collectives go through ``Comm``, on an explicit process group: NCCL with
one rank per card, gloo on the CPU, or gloo for several ranks on one card
(NCCL refuses two ranks on one GPU), whose CUDA path copies through host
memory — ``Comm.staging`` says so.  Only all-reduce is used: an all-gather
and the boundary permute are all-reduces of zero-padded buffers, each
entry with exactly one nonzero contributor, so they are exact.

A tenant mesh (``make_tenant_mesh``) splits P_t·P_r ranks into P_t tenant
slices of P_r ranks, each slice a row group of its own: a slice owns B/P_t
tenants' stacked eigensystems, row-sharded over its P_r ranks.  The tenant
axis needs no collective.

Torch has no ``lax.scan``: a window block is a Python loop over its
steps.  The builders return plain callables; nothing is compiled.
"""
from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import torch

from repro_torch.core import downdate as dd
from repro_torch.core import engine as eng
from repro_torch.core import kernels_fn as kf, rankone
from repro_torch.core.rankone import index_get, index_set, take, take_cols

Tensor = torch.Tensor

DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


# ---------------------------------------------------------------- groups --
class Comm:
    """The collectives of one row group: rank, size, device, backend and
    its process group (one process is a one-rank group)."""

    def __init__(self, group, *, rank: int, size: int, device=None,
                 backend: str):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = torch.device(device or "cpu")
        self.backend = backend
        self.collectives = 0          # all-reduces issued by this rank
        self.row_offsets: set[int] = set()   # row offsets this rank ran at

    def offset(self, rows: int) -> int:
        """This rank's first global row when each rank holds ``rows``
        rows (recorded in ``row_offsets``)."""
        r0 = self.rank * rows
        self.row_offsets.add(r0)
        return r0

    @property
    def staging(self) -> str:
        """How a collective moves a tensor of this group's device."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "host (gloo copies CUDA tensors through host memory)"
        return f"device ({self.backend})"

    def all_reduce(self, x: Tensor) -> Tensor:
        """Σ over the group's ranks (out of place)."""
        self.collectives += 1
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, x: Tensor) -> Tensor:
        """(size,) + x.shape: rank p's x at [p], exactly (a zero-padded
        all-reduce)."""
        buf = x.new_zeros((self.size,) + x.shape)
        buf[self.rank] = x
        return self.all_reduce(buf)

    def from_next(self, x: Tensor) -> Tensor:
        """The x of rank (rank + 1) mod size: the boundary permute."""
        return self.all_gather(x)[(self.rank + 1) % self.size]


def _timeout(seconds) -> datetime.timedelta:
    return (seconds if isinstance(seconds, datetime.timedelta)
            else datetime.timedelta(seconds=float(seconds)))


def init_world(*, rank: int | None = None, world_size: int | None = None,
               backend: str | None = None, store=None,
               init_method: str | None = None,
               timeout=DEFAULT_TIMEOUT) -> tuple[int, int]:
    """Join the default process group: rank and world size from the
    arguments or from ``torchrun``'s environment (RANK, WORLD_SIZE and
    MASTER_ADDR/MASTER_PORT, ``env://``); a ``store`` (e.g. a
    ``FileStore``) or an ``init_method`` (``tcp://localhost:<port>``)
    overrides the rendezvous.  Returns (rank, world size)."""
    import torch.distributed as dist

    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=_timeout(timeout))
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(**kw)
    return rank, world_size


def row_group(*, device=None, ranks: list[int] | None = None,
              timeout=DEFAULT_TIMEOUT) -> Comm:
    """A ``Comm`` over ``ranks`` (default: the whole world) of the
    initialised default group; every rank of the world must call it with
    the same ``ranks`` (``dist.new_group`` is collective)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    backend = dist.get_backend()
    group = (dist.group.WORLD if len(ranks) == world
             else dist.new_group(ranks, timeout=_timeout(timeout),
                                 backend=backend))
    me = dist.get_rank()
    return Comm(group, rank=ranks.index(me) if me in ranks else -1,
                size=len(ranks), device=device, backend=backend)


class TenantMesh(NamedTuple):
    """P_t tenant slices × P_r ranks: this rank's slice and its row
    group."""

    p_tenant: int
    p_rows: int
    tenant_index: int
    rows: Comm

    def tenants(self, n_tenants: int) -> range:
        """The tenants this rank's slice owns (B/P_t consecutive)."""
        if n_tenants % self.p_tenant:
            raise ValueError(f"{n_tenants} tenants do not split over "
                             f"{self.p_tenant} tenant slices")
        per = n_tenants // self.p_tenant
        return range(self.tenant_index * per, (self.tenant_index + 1) * per)


def make_tenant_mesh(p_tenant: int, p_rows: int, *, device=None,
                     timeout=DEFAULT_TIMEOUT) -> TenantMesh:
    """A (tenant, data) mesh of the initialised world's P_t·P_r ranks.
    The data axis varies fastest (rank = t·P_r + r), so each tenant slice
    is a contiguous group of P_r ranks, one ``dist.new_group`` each (every
    rank creates every group, in the same order).  Raises unless the world
    has exactly P_t·P_r ranks."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if world != p_tenant * p_rows:
        raise ValueError(f"mesh {p_tenant}x{p_rows} needs "
                         f"{p_tenant * p_rows} ranks, the world has {world}")
    me = dist.get_rank()
    mine = None
    for t in range(p_tenant):
        ranks = list(range(t * p_rows, (t + 1) * p_rows))
        comm = row_group(device=device, ranks=ranks, timeout=timeout)
        if me in ranks:
            mine = (t, comm)
    return TenantMesh(p_tenant, p_rows, mine[0], mine[1])


def local_rows(v: Tensor, r0: int, R: int) -> Tensor:
    """Entries [r0, r0 + R) of the last axis of ``v`` (replicated), zero
    past its end: this rank's slice of a replicated O(M) vector."""
    out = v[..., r0:r0 + R]
    short = R - out.shape[-1]
    if short:
        out = torch.cat([out, out.new_zeros(out.shape[:-1] + (short,))], -1)
    return out


def _row_ids(R: int, r0: int, device) -> Tensor:
    return torch.arange(R, device=device) + r0


# ------------------------------------------------------- update bodies --
def _solve_kwargs(plan: eng.UpdatePlan, dtype) -> dict:
    return dict(iters=eng.resolve_iters(plan.iters, dtype),
                method=plan.method, precise=plan.precise)


def _partial_project(U_loc: Tensor, V_loc: Tensor, m: Tensor, r0: int, *,
                     plan: eng.UpdatePlan) -> Tensor:
    """The row block's share of Uᵀ V (rows of global index ≥ m masked):
    ``eigvec_project`` on the block at its row offset on the ``pallas``
    routes, the dense product on ``jnp``."""
    if plan.inner_matmul == "pallas":
        from repro_torch.kernels.eigvec_update import ops as eops
        return eops.project_vectors(U_loc, V_loc, m, row_offset=r0)
    gids = _row_ids(U_loc.shape[-2], r0, U_loc.device)
    V_loc = torch.where((gids < m[..., None])[..., None], V_loc, 0.0)
    return U_loc.mT @ V_loc


def _update_sharded(L, U_loc, v_loc, sigma, m, *, comm: Comm,
                    plan: eng.UpdatePlan, rows_full: int | None = None):
    """One rank-one update of a row block: z from one all-reduce, then
    ``rankone._update_body`` (deflation, cluster merge, secular solve) on
    the replicated vectors, the rotation on the local rows only."""
    r0 = comm.offset(rows_full or U_loc.shape[-2])
    z = comm.all_reduce(_partial_project(U_loc, v_loc[..., None], m, r0,
                                         plan=plan)[..., 0])
    return rankone._update_body(L, U_loc, v_loc, sigma, m, z=z,
                                matmul=plan.inner_matmul, row_offset=r0,
                                **_solve_kwargs(plan, L.dtype))


def _pair_sharded(L, U_loc, v1_loc, sigma1, v2_loc, sigma2, m, *,
                  comm: Comm, plan: eng.UpdatePlan,
                  rows_full: int | None = None, Z: Tensor | None = None):
    """A ±sigma pair of a row block (optionally tenant-stacked) under
    ``plan``, as ``engine.apply_pair``: two sequential updates, or
    ("jnp2"/"pallas2") one fused double rotation with a
    collective-balanced merge fallback.  Two all-reduces either way.

    The first all-reduce carries z₁ (both z vectors on the fused routes);
    it is skipped when the caller holds the replicated projections ``Z``
    (the fused k-row ingest's).  Sequentially the second carries z₂ in the
    rotated basis.  Fused, z₂ comes from the Cauchy transpose-matvec, and
    where a cluster merge fires (the replicated predicate ``merge_fired``,
    read on the host, the same bits on every rank) the pair runs as two
    sequential updates; the second all-reduce is issued either way (on the
    unchanged block when no merge fired).  With a tenant axis both
    branches run where any tenant fired and each tenant takes its own
    branch's result, as ``rankone.rank_one_update_pair``."""
    r0 = comm.offset(rows_full or U_loc.shape[-2])
    kw = _solve_kwargs(plan, L.dtype)
    kw.update(matmul=plan.inner_matmul, row_offset=r0)
    if Z is None:
        V = (torch.stack([v1_loc, v2_loc], dim=-1) if plan.fused
             else v1_loc[..., None])
        Z = comm.all_reduce(_partial_project(U_loc, V, m, r0, plan=plan))
    mask = rankone.active_mask(L.shape[-1], m)
    z1 = torch.where(mask, Z[..., 0], 0.0)

    def second(L1, U1):
        z2 = comm.all_reduce(_partial_project(U1, v2_loc[..., None], m, r0,
                                              plan=plan)[..., 0])
        return L1, U1, z2

    if not plan.fused:
        L1, U1 = rankone._update_body(L, U_loc, v1_loc, sigma1, m, z=z1,
                                      **kw)
        L1, U1, z2 = second(L1, U1)
        return rankone._update_body(L1, U1, v2_loc, sigma2, m, z=z2, **kw)
    z2 = torch.where(mask, Z[..., 1], 0.0)
    pf = rankone._pair_solve(L, z1, sigma1, z2, sigma2, m,
                             **_solve_kwargs(plan, L.dtype))

    def fused():
        return take(pf.L_new, pf.perm2), rankone._pair_rotate_block(
            U_loc, pf, m, matmul=plan.inner_matmul, row_offset=r0)

    if not plan.merge_fallback:
        return fused()
    mf = pf.merge_fired
    fired = bool(mf if mf.dim() == 0 else mf.any())
    L1, U1 = (rankone._update_body(L, U_loc, v1_loc, sigma1, m, z=z1, **kw)
              if fired else (L, U_loc))
    L1, U1, z2s = second(L1, U1)      # unconditional
    if not fired:
        return fused()
    Ls, Us = rankone._update_body(L1, U1, v2_loc, sigma2, m, z=z2s, **kw)
    if L.dim() == 1:
        return Ls, Us
    Lf, Uf = fused()
    sel = mf[..., None]
    return torch.where(sel, Ls, Lf), torch.where(sel[..., None], Us, Uf)


# ------------------------------------------------------ bucket slicing --
def _bucket(plan: eng.UpdatePlan, M: int, m: int) -> int | None:
    """The bucket holding m (None: the capacity).  An update's caller
    passes the pre-update m and a downdate never grows it, so the bucket
    holds m itself."""
    if plan.dispatch != "bucketed":
        return None
    Mb = eng.bucket_for(max(int(m), 1), M, plan.min_bucket)
    return None if Mb >= M else Mb


def _bucketed_dispatch(body, plan: eng.UpdatePlan):
    """The dispatch shell of every builder: ``body(Mb, *args)`` runs at
    the capacity (Mb None) or at the bucket Mb.  Bucketed dispatch reads
    ``int(m)`` — by convention the last positional argument, with L first
    — on the host once per call."""
    def dispatch(*args):
        L, m = args[0], args[-1]
        M = L.shape[-1]
        Mb = _bucket(plan, M, int(m.max()) if torch.is_tensor(m)
                     and m.dim() else int(m))
        return body(Mb, *args)

    return dispatch


def _scatter(L, U_loc, Lb, Ub, m, Mb: int):
    """Write a bucket's (L, row block) back into the capacity arrays, with
    L's tail re-sentinelized."""
    Rb = Ub.shape[-2]
    L_new = L.clone()
    L_new[..., :Mb] = Lb
    L_new = rankone.sentinelize(L_new, m, L.new_zeros(()))
    U_new = U_loc.clone()
    U_new[..., :Rb, :Mb] = Ub
    return L_new, U_new


def make_sharded_update(comm: Comm, *,
                        plan: eng.UpdatePlan = eng.DEFAULT_PLAN):
    """A row-sharded rank-one update: f(L, U_loc, v_loc, sigma, m) ->
    (L, U_loc), U_loc and v_loc this rank's rows, the rest replicated."""

    def body(Mb, L, U_loc, v_loc, sigma, m):
        sigma = rankone._as_sigma(sigma, L)
        if Mb is None:
            return _update_sharded(L, U_loc, v_loc, sigma, m, comm=comm,
                                   plan=plan)
        R = U_loc.shape[-2]
        Rb = min(R, Mb)
        Lb, Ub = _update_sharded(
            L[..., :Mb].clone(), U_loc[..., :Rb, :Mb].contiguous(),
            v_loc[..., :Rb], sigma, m, comm=comm, plan=plan, rows_full=R)
        return _scatter(L, U_loc, Lb, Ub, m, Mb)

    return _bucketed_dispatch(body, plan)


def make_sharded_update_pair(comm: Comm, *,
                             plan: eng.UpdatePlan = eng.DEFAULT_PLAN):
    """A row-sharded ±sigma pair: f(L, U_loc, v1_loc, sigma1, v2_loc,
    sigma2, m) -> (L, U_loc); two all-reduces (``_pair_sharded``)."""

    def body(Mb, L, U_loc, v1, s1, v2, s2, m):
        s1, s2 = rankone._as_sigma(s1, L), rankone._as_sigma(s2, L)
        if Mb is None:
            return _pair_sharded(L, U_loc, v1, s1, v2, s2, m, comm=comm,
                                 plan=plan)
        R = U_loc.shape[-2]
        Rb = min(R, Mb)
        Lb, Ub = _pair_sharded(
            L[..., :Mb].clone(), U_loc[..., :Rb, :Mb].contiguous(),
            v1[..., :Rb], s1, v2[..., :Rb], s2, m, comm=comm, plan=plan,
            rows_full=R)
        return _scatter(L, U_loc, Lb, Ub, m, Mb)

    return _bucketed_dispatch(body, plan)


# ---------------------------------------------------------- downdates --
def _downdate_sharded(L, U_loc, a, k_new, m, *, comm: Comm,
                      plan: eng.UpdatePlan, rows_full: int | None = None):
    """Row-sharded inverse of Algorithm 1 for the boundary point q = m−1:
    the inverse ±sigma pair (``_pair_sharded``, two all-reduces), then
    one all-reduce broadcasting row q of U to every rank for the
    contraction, whose reflector and permutation act on U's columns
    (``downdate.contract_rows`` with the block's global row ids).  ``a``
    is the victim's kernel row, replicated."""
    M = L.shape[-1]
    dtype = L.dtype
    R = U_loc.shape[-2]
    q = m - 1
    r0 = comm.offset(rows_full or R)
    gids = _row_ids(R, r0, L.device)
    kn = torch.clamp_min(k_new, torch.finfo(dtype).tiny)
    a = torch.where(torch.arange(M, device=L.device) < q, a, 0.0)
    v1 = index_set(a, q, kn / 2.0)
    v2 = index_set(a, q, kn / 4.0)
    sigma = 4.0 / kn
    L, U_loc = _pair_sharded(L, U_loc, local_rows(v2, r0, R), sigma,
                             local_rows(v1, r0, R), -sigma, m, comm=comm,
                             plan=plan, rows_full=rows_full)
    own = (q >= r0) & (q < r0 + R)
    row = index_get(U_loc, (q - r0).clamp(0, R - 1))
    w = comm.all_reduce(torch.where(own, row, 0.0))   # global row q of U
    w = torch.where(rankone.active_mask(M, m), w, 0.0)
    return dd.contract_rows(L, U_loc, w, m, row_ids=gids)


def make_sharded_downdate(comm: Comm, *,
                          plan: eng.UpdatePlan = eng.DEFAULT_PLAN):
    """Row-sharded removal of the active boundary point (row m−1) of the
    unadjusted system: f(L, U_loc, a, k_new, m) -> (L, U_loc, m − 1), ``a``
    the victim's kernel row against the stored points, replicated.  Three
    all-reduces."""

    def body(Mb, L, U_loc, a, k_new, m):
        if Mb is None:
            return _downdate_sharded(L, U_loc, a, k_new, m, comm=comm,
                                     plan=plan)
        R = U_loc.shape[-2]
        Rb = min(R, Mb)
        Lb, Ub, m_new = _downdate_sharded(
            L[:Mb].clone(), U_loc[:Rb, :Mb].contiguous(), a[:Mb], k_new, m,
            comm=comm, plan=plan, rows_full=R)
        return _scatter(L, U_loc, Lb, Ub, m_new, Mb) + (m_new,)

    return _bucketed_dispatch(body, plan)


def _permute_rows_sharded(rows: Tensor, i: Tensor, m: Tensor, *,
                          comm: Comm, rows_full: int | None = None
                          ) -> Tensor:
    """Move global row ``i`` to the boundary q = m−1, the rows between
    shifting up (``downdate.boundary_perm`` on a row-sharded matrix), with
    ``i`` and ``m`` device tensors: the next rank's first row (the
    boundary permute) and global row i (one all-reduce) are all a rank
    needs.  Both collectives are unconditional."""
    R = rows.shape[0]
    r0 = comm.offset(rows_full or R)
    gids = _row_ids(R, r0, rows.device)
    nbr = comm.from_next(rows[0])
    shifted = torch.cat([rows[1:], nbr[None]], dim=0)
    own = (i >= r0) & (i < r0 + R)
    row_i = comm.all_reduce(torch.where(
        own, index_get(rows, (i - r0).clamp(0, R - 1)), 0.0))
    keep = (gids < i) | (gids >= m)
    last = gids == m - 1
    return torch.where(keep[:, None], rows,
                       torch.where(last[:, None], row_i[None, :], shifted))


def make_sharded_evict(comm: Comm, *,
                       plan: eng.UpdatePlan = eng.DEFAULT_PLAN):
    """Row-sharded removal of any active point: f(L, U_loc, a, k_new, i,
    m) -> (L, U_loc, m − 1), ``i`` a device tensor (e.g. the window's
    argmin of the ring), ``a`` the victim's kernel row against the stored
    points (self entry at i), replicated.  The boundary permutation runs
    on the ranks (``_permute_rows_sharded``): no host read decides the
    victim.  Five all-reduces."""

    def body(Mb, L, U_loc, a, k_new, i, m):
        i = torch.as_tensor(i, dtype=torch.int32, device=L.device)
        if Mb is None:
            U_p = _permute_rows_sharded(U_loc, i, m, comm=comm)
            order = dd.boundary_perm(i, m, L.shape[0])
            return _downdate_sharded(L, U_p, a[order], k_new, m, comm=comm,
                                     plan=plan)
        R = U_loc.shape[-2]
        Rb = min(R, Mb)
        U_p = _permute_rows_sharded(U_loc[:Rb, :Mb].contiguous(), i, m,
                                    comm=comm, rows_full=R)
        order = dd.boundary_perm(i, m, Mb)
        Lb, Ub, m_new = _downdate_sharded(
            L[:Mb].clone(), U_p, a[:Mb][order], k_new, m, comm=comm,
            plan=plan, rows_full=R)
        return _scatter(L, U_loc, Lb, Ub, m_new, Mb) + (m_new,)

    return _bucketed_dispatch(body, plan)


# -------------------------------------------------- the window engine --
class WindowBlockState(NamedTuple):
    """What a sharded window block carries: the replicated spectrum, this
    rank's row block, the replicated points and arrival ring."""

    L: Tensor
    U: Tensor
    X: Tensor
    ages: Tensor
    clock: Tensor


def _window_gate_sharded(x_new, X, m, *, spec, policy):
    """Quarantine verdict and stand-in (the stored row 0); ``x_new`` and
    ``X`` are replicated, so every rank reaches the same verdict and no
    collective is issued."""
    M = X.shape[0]
    x_new = x_new.to(X.dtype)
    ok = torch.isfinite(x_new).all()
    if policy.outlier_tol > 0.0:
        x_tmp = torch.where(ok, x_new, X[0])
        a_g = kf.kernel_row(x_tmp, X, spec=spec)
        a_g = torch.where(rankone.active_mask(M, m), a_g, 0.0)
        k_g = kf.gram_block(x_tmp[None], x_tmp[None], spec=spec)[0, 0]
        ok = ok & (torch.max(torch.abs(a_g)) >= policy.outlier_tol * k_g)
    return ok, torch.where(ok, x_new, X[0])


def _window_evict_sharded(L, U_loc, X, ages, m, *, comm, spec, plan,
                          rows_full=None):
    """Evict the FIFO-oldest point (argmin of the ring): the boundary
    permutation, the inverse pair and the contraction."""
    M = L.shape[0]
    victim = torch.argmin(ages).to(torch.int32)
    order = dd.boundary_perm(victim, m, M)
    U_p = _permute_rows_sharded(U_loc, victim, m, comm=comm,
                                rows_full=rows_full)
    X_p = X[order]
    q = m - 1
    a = kf.kernel_row(index_get(X_p, q), X_p, spec=spec)
    a = torch.where(rankone.active_mask(M, m), a, 0.0)
    L1, U1, m1 = _downdate_sharded(L, U_p, a, index_get(a, q), m, comm=comm,
                                   plan=plan, rows_full=rows_full)
    X1 = torch.where((torch.arange(M, device=L.device) == q)[:, None], 0.0,
                     X_p)
    return L1, U1, X1, ages[order], m1


def _window_ingest_sharded(L1, U1, X1, ages1, clock, x_new, m1, *, comm,
                           spec, plan, rows_full=None):
    """Expansion and the forward ±sigma pair (Algorithm 1).  Under
    ``plan.fuse_krow`` one ``krow_project`` pass over the row block (at
    its row offset) gives its slice of the masked kernel row and its
    partial projection Uᵀa, all-reduced in place of the pair's own first
    collective."""
    M = L1.shape[0]
    dtype = L1.dtype
    idx = torch.arange(M, device=L1.device)
    x_new = x_new.to(X1.dtype)
    k_new = kf.gram_block(x_new[None], x_new[None], spec=spec)[0, 0]
    kn = torch.clamp_min(k_new, torch.finfo(dtype).tiny)
    sigma = 4.0 / kn
    R = U1.shape[0]
    r0 = comm.offset(rows_full or R)
    if plan.fuse_krow:
        from repro_torch.kernels.rbf_gram import ops as kops

        X_loc = X1[r0:r0 + R]
        if X_loc.shape[0] < R:
            X_loc = torch.cat([X_loc, X_loc.new_zeros(
                (R - X_loc.shape[0], X_loc.shape[1]))])
        a_loc, Pp = kops.krow_project(U1, X_loc.contiguous(), x_new,
                                      U1.new_zeros((R, 0)), m1, spec=spec,
                                      row_offset=r0)
        p = comm.all_reduce(Pp[:, 0])
        L2, perm, m2 = rankone.expand_eigensystem_perm(L1, kn / 4.0, m1)
        U2 = take_cols(U1, perm)
        # Uᵀe_{m1} = e_{m1} before the expansion (an identity column).
        Z = torch.stack([take(index_set(p, m1, kn / 2.0), perm),
                         take(index_set(p, m1, kn / 4.0), perm)], dim=1)
        gids = _row_ids(R, r0, L1.device)
        v1_l = torch.where(gids == m1, kn / 2.0, a_loc)
        v2_l = torch.where(gids == m1, kn / 4.0, a_loc)
        L3, U3 = _pair_sharded(L2, U2, v1_l, sigma, v2_l, -sigma, m2,
                               comm=comm, plan=plan, rows_full=rows_full,
                               Z=Z)
    else:
        a_new = kf.kernel_row(x_new, X1, spec=spec)
        a_new = torch.where(rankone.active_mask(M, m1), a_new, 0.0)
        L2, U2, m2 = rankone.expand_eigensystem(L1, U1, kn / 4.0, m1)
        v1 = index_set(a_new, m1, kn / 2.0)
        v2 = index_set(a_new, m1, kn / 4.0)
        L3, U3 = _pair_sharded(L2, U2, local_rows(v1, r0, R), sigma,
                               local_rows(v2, r0, R), -sigma, m2, comm=comm,
                               plan=plan, rows_full=rows_full)
    X2 = torch.where((idx == m1)[:, None], x_new[None, :], X1)
    ages2 = index_set(ages1, m1, clock)
    return L3, U3, X2, ages2


def _window_step_sharded(st: WindowBlockState, x_new, m, *, comm, spec,
                         plan, rows_full=None) -> WindowBlockState:
    """One steady-state window step (m ≡ W, unadjusted): gate, evict the
    oldest point, ingest, advance the clock — a fixed schedule of
    all-reduces.  A rejected point runs the step on the stand-in and a
    replicated select keeps the old state bit for bit; the clock then
    does not advance."""
    policy = plan.health
    guard = policy is not None and policy.quarantine
    if guard:
        ok, x_new = _window_gate_sharded(x_new, st.X, m, spec=spec,
                                         policy=policy)
    L1, U1, X1, ages1, m1 = _window_evict_sharded(
        st.L, st.U, st.X, st.ages, m, comm=comm, spec=spec, plan=plan,
        rows_full=rows_full)
    L3, U3, X2, ages2 = _window_ingest_sharded(
        L1, U1, X1, ages1, st.clock, x_new, m1, comm=comm, spec=spec,
        plan=plan, rows_full=rows_full)
    new = WindowBlockState(L3, U3, X2, ages2, st.clock + 1)
    if not guard:
        return new
    return WindowBlockState(*(torch.where(ok, n, o)
                              for n, o in zip(new, st)))


def _rebase_ring(ages: Tensor, clock: Tensor, span: int):
    """``window.maybe_rebase`` hoisted per block: shift the stamps down
    when clock + span could reach the sentinel; a replicated select."""
    from repro_torch.core import window as wnd

    sent = wnd.age_sentinel(ages.dtype)
    base = clock - ages.shape[0]
    reb = torch.where(ages == sent, sent, ages - base)
    need = clock >= sent - 1 - span
    return torch.where(need, reb, ages), torch.where(need, clock - base,
                                                     clock)


def make_sharded_window_block(comm: Comm, spec: kf.KernelSpec, *,
                              plan: eng.UpdatePlan = eng.DEFAULT_PLAN):
    """The sharded steady-state window: f(L, U_loc, X, ages, clock, xs, m)
    -> (L, U_loc, X, ages, clock), folding a (T, d) block into a full
    window (m ≡ W, unadjusted).  Each step's victim is chosen on the
    device from the replicated ring; the ring is rebased at block entry.
    A loop over the block's steps; bucketed dispatch slices every local
    operand to the bucket holding W."""

    def run(L, U_loc, X, ages, clock, xs, m, rows_full=None):
        ages, clock = _rebase_ring(ages, clock, xs.shape[0])
        st = WindowBlockState(L, U_loc, X, ages, clock)
        for x_new in xs:
            st = _window_step_sharded(st, x_new, m, comm=comm, spec=spec,
                                      plan=plan, rows_full=rows_full)
        return st

    def body(Mb, L, U_loc, X, ages, clock, xs, m):
        if Mb is None:
            return tuple(run(L, U_loc, X, ages, clock, xs, m))
        R = U_loc.shape[0]
        Rb = min(R, Mb)
        st = run(L[:Mb].clone(), U_loc[:Rb, :Mb].contiguous(),
                 X[:Mb].clone(), ages[:Mb].clone(), clock, xs, m,
                 rows_full=R)
        L_new, U_new = _scatter(L, U_loc, st.L, st.U, m, Mb)
        X_new, ages_new = X.clone(), ages.clone()
        X_new[:Mb] = st.X
        ages_new[:Mb] = st.ages
        return L_new, U_new, X_new, ages_new, st.clock

    return _bucketed_dispatch(body, plan)


def make_sharded_window_block_metered(comm: Comm, spec: kf.KernelSpec, *,
                                      plan: eng.UpdatePlan = eng.DEFAULT_PLAN):
    """The sharded window block with a riding ``telemetry.MetricsState``:
    f(L, U_loc, X, ages, clock, xs, m, mstate) -> (..., mstate).  The
    block itself is ``make_sharded_window_block``'s; the note reads only
    replicated values (the accepted count is the clock's advance, m is
    the window), so it adds no collective."""
    from repro_torch.core import telemetry as tm

    inner = make_sharded_window_block(comm, spec, plan=plan)

    def fn(L, U_loc, X, ages, clock, xs, m, mstate):
        out = inner(L, U_loc, X, ages, clock, xs, m)
        mstate = tm.note_block(mstate, m, m, xs.shape[0], out[4] - clock)
        mstate = mstate._replace(window_fill=torch.ones_like(
            mstate.window_fill))
        return out + (mstate,)

    return fn


def make_sharded_expand(comm: Comm):
    """The expansion on a row block: f(L, U_loc, lam_new, m) -> (L, U_loc,
    m + 1); the permutation acts on columns, so each rank permutes its
    rows' columns, no collective."""

    def fn(L, U_loc, lam_new, m):
        return rankone.expand_eigensystem(L, U_loc, lam_new, m)

    return fn


def sharded_gram_row(comm: Comm, spec: kf.KernelSpec):
    """k(X_loc, x_new) for this rank's rows of the stored points (no
    collective)."""

    def fn(X_loc, x_new):
        return kf.kernel_row(x_new, X_loc, spec=spec)

    return fn


# --------------------------------------------------- tenant x row mesh --
def make_tenant_update_pair(mesh: TenantMesh, *,
                            plan: eng.UpdatePlan = eng.DEFAULT_PLAN):
    """The ±sigma pair over this slice's tenant-stacked bricks:
    f(L (b, M), U_loc (b, R, M), v1 (b, R), sigma1 (b,), v2, sigma2,
    m (b,)) with b = B/P_t, through ``rankone``'s tenant axis (one launch
    of each kernel for the slice's tenants).  The all-reduces run over the
    slice's row group only; the tenant axis needs none.  Bucketed
    dispatch takes the cohort's bucket, max(m), read on the host."""
    return make_sharded_update_pair(mesh.rows, plan=plan)


def make_tenant_query(mesh: TenantMesh, spec: kf.KernelSpec, *, plan=None):
    """Queries against this slice's tenant-stacked snapshots: f(snaps, xq
    (b, nq, d)) -> (b, nq, C), ``serving.query_batch`` on the local
    tenants, with no collective."""
    from repro_torch.core import serving

    def fn(snaps, xq):
        return serving.query_batch(snaps, xq, spec=spec, plan=plan)

    return fn


def make_rebalanced_update(comm: Comm, *,
                           plan: eng.UpdatePlan = eng.DEFAULT_PLAN):
    """A bucketed row-sharded update that spreads a small bucket over all
    ranks: f(L, U_loc, v, sigma, m), ``make_sharded_update``'s contract
    with ``v`` replicated.

    Below the crossover P_eff = ceil(M_b / (M/P)) < P only the ranks that
    own rows < M_b hold active data.  The (M_b, M_b) active block is then
    gathered (all-gather one), each rank takes a balanced M_b/P slice of
    its rows, the update runs on that layout, and the result is gathered
    (all-gather two) and written back into each rank's capacity rows.
    Fixed dispatch, one rank, buckets not divisible by P and buckets at or
    above the crossover run ``make_sharded_update``."""
    full_fn = make_sharded_update(comm, plan=plan)
    nP = comm.size

    def fn(L, U_loc, v, sigma, m):
        M = L.shape[0]
        R = M // nP
        p = comm.rank
        Mb = (eng.bucket_for(max(int(m), 1), M, plan.min_bucket)
              if plan.dispatch == "bucketed" else M)
        P_eff = max(1, -(-Mb // R))
        if nP == 1 or P_eff >= nP or Mb % nP:
            return full_fn(L, U_loc, local_rows(v, p * R, R), sigma, m)
        Rb = Mb // nP
        nloc = min(R, Mb)
        gathered = comm.all_gather(U_loc[:nloc, :Mb].contiguous())
        U_bkt = gathered.reshape(nP * nloc, Mb)[:Mb]
        U_b = U_bkt[p * Rb:(p + 1) * Rb].contiguous()
        sigma = rankone._as_sigma(sigma, L)
        Lb, U_b = _update_sharded(L[:Mb].clone(), U_b, v[p * Rb:(p + 1) * Rb],
                                  sigma, m, comm=comm, plan=plan)
        U_upd = comm.all_gather(U_b).reshape(Mb, Mb)
        gids = _row_ids(R, p * R, L.device)
        cand = U_upd[gids.clamp(0, Mb - 1)]
        cols = torch.where((gids < Mb)[:, None], cand, U_loc[:, :Mb])
        L_new = L.clone()
        L_new[:Mb] = Lb
        L_new = rankone.sentinelize(L_new, m, L.new_zeros(()))
        U_new = U_loc.clone()
        U_new[:, :Mb] = cols
        return L_new, U_new

    return fn
