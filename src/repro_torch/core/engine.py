"""Update engine: one code path from kernel row to scatter.

``UpdatePlan`` describes how updates run, with the reference's field names
and defaults, so one plan's values drive both packages.  ``Engine`` owns
bucket selection, slicing and scatter for one stream, append-only or
windowed: ``step``/``step_block`` advance a ``StreamState`` bundle, whose
arrival ring (present for a sliding window) selects the evict stage.

Bucket geometry (the reference's invariants): L is ascending with the
sentinels strictly above the active spectrum, inactive columns of U are
identity columns and active columns vanish on rows >= m, and K1 / X are
zero beyond m.  So the leading M_b×M_b block of a state with m < M_b
active pairs is itself a valid capacity-M_b state (``slice_state``), and
``scatter_state`` writes an updated bucket back.  Bucket choice uses the
host's count of active pairs, which the caller may pass (``KPCAStream``
mirrors it), so a step reads nothing back from the card.

Torch has no ``lax.scan``: a block is a Python loop over ``step``, with
the active count tracked on the host.  Not ported yet, each
raising ``NotImplementedError`` from ``check_plan`` or from the call: the
health and metrics lanes and the leverage landmark policy — see
ROADMAP.md, "Open items".
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import kernels_fn as kf, rankone

Tensor = torch.Tensor

DEFAULT_MIN_BUCKET = 128


class UpdatePlan(NamedTuple):
    """How updates run (field names and defaults as in the reference).

    method:     secular-solve eigenvector variant ("gu" | "bns")
    matmul:     rotation route — "jnp" (dense factor, the oracle) or
                "pallas" (the CUDA rotation kernel on the card, its plain
                version on the CPU); "jnp2"/"pallas2" fuse each ±sigma
                pair into one rotation (``eigvec_rotate2`` for "pallas2")
    merge_fallback: a fused pair on which a cluster merge would fire runs
                as two sequential updates
    iters:      fixed bisection iteration count; None resolves per state
                type (``resolve_iters``)
    dispatch:   "fixed" (capacity M every step) | "bucketed"
    min_bucket: smallest rung of the power-of-two bucket ladder
    precise:    solve the secular systems in float64
    fuse_krow:  produce each ingest's kernel row fused with its eigenbasis
                projection (``krow_project``), project Algorithm 2's
                second pair with ``eigvec_project`` and serve queries
                through ``transform_project``
    The other fields are carried for plan parity with the reference;
    ``check_plan`` rejects values whose paths are not ported.
    """

    method: str = "gu"
    matmul: str = "jnp"
    iters: int | None = None
    dispatch: str = "fixed"
    min_bucket: int = DEFAULT_MIN_BUCKET
    merge_fallback: bool = True
    compact_shrink: bool = False
    precise: bool = True
    window: int | None = None
    landmark_policy: str = "append"
    fuse_krow: bool = False
    serve_every: int = 1
    serve_components: int = 8
    health: object | None = None
    metrics: bool = False

    @property
    def fused(self) -> bool:
        return self.matmul in ("jnp2", "pallas2")

    @property
    def inner_matmul(self) -> str:
        """The single-rotation route behind a possibly fused spelling."""
        return {"jnp2": "jnp", "pallas2": "pallas"}.get(self.matmul,
                                                        self.matmul)


DEFAULT_PLAN = UpdatePlan()


def check_plan(plan: UpdatePlan) -> None:
    """Raise for plan values whose paths this port does not have yet,
    naming the ROADMAP.md item that ports each."""
    if plan.inner_matmul not in ("jnp", "pallas"):
        raise ValueError(f"unknown matmul route {plan.matmul!r}")
    if plan.window is not None and plan.window < 2:
        raise ValueError(f"window must be at least 2, got {plan.window}")
    if plan.health is not None or plan.metrics:
        raise NotImplementedError("health and metrics lanes are not ported "
                                  "yet: ROADMAP.md, Open items §1 item 7")
    if plan.dispatch not in ("fixed", "bucketed"):
        raise ValueError(f"unknown dispatch {plan.dispatch!r}")
    if plan.landmark_policy not in ("append", "leverage"):
        raise ValueError(f"unknown landmark_policy {plan.landmark_policy!r}")


def resolve_iters(iters: int | None, dtype) -> int:
    """Bisection iteration count: explicit value, or the dtype default
    (62 for f64, 32 for f32 — brackets shrink 2^-iters relative)."""
    if iters is not None:
        return iters
    return 62 if dtype.itemsize >= 8 else 32


# ------------------------------------------------------- bucket geometry --
def bucket_sizes(capacity: int, min_bucket: int = DEFAULT_MIN_BUCKET
                 ) -> tuple[int, ...]:
    """Power-of-two ladder min_bucket, 2·min_bucket, …, capped at capacity
    (the capacity itself is always the top rung)."""
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    sizes = []
    b = min(min_bucket, capacity)
    while b < capacity:
        sizes.append(b)
        b *= 2
    sizes.append(capacity)
    return tuple(sizes)


def bucket_for(m_needed: int, capacity: int,
               min_bucket: int = DEFAULT_MIN_BUCKET) -> int:
    """Smallest bucket that can hold ``m_needed`` active pairs."""
    if m_needed > capacity:
        raise ValueError(
            f"need room for {m_needed} active pairs but capacity is "
            f"{capacity} — grow the state before streaming more points")
    for b in bucket_sizes(capacity, min_bucket):
        if b >= m_needed:
            return b
    raise AssertionError("unreachable: capacity is always a bucket")


# ------------------------------------------------------- slice / scatter --
def slice_state(state, Mb: int):
    """The leading M_b×M_b block as a capacity-M_b state (a copy: the
    kernels take contiguous operands)."""
    return state._replace(L=state.L[:Mb].clone(),
                          U=state.U[:Mb, :Mb].contiguous(),
                          K1=state.K1[:Mb].clone(), X=state.X[:Mb].clone())


def scatter_state(full, sub):
    """Write an updated bucket back into a copy of the fixed-capacity state
    (out of place, as in the reference: a published snapshot that holds
    the old X never changes under it)."""
    Mb = sub.L.shape[0]
    L = full.L.clone()
    L[:Mb] = sub.L
    # The tail still holds sentinels for the pre-update spectrum.
    L = rankone.sentinelize(L, sub.m, L.new_zeros(()))
    U, K1, X = full.U.clone(), full.K1.clone(), full.X.clone()
    U[:Mb, :Mb] = sub.U
    K1[:Mb] = sub.K1
    X[:Mb] = sub.X
    return full._replace(L=L, U=U, m=sub.m, S=sub.S, K1=K1, X=X)


# ------------------------------------------------------ shared primitives --
def masked_row(state, x_new: Tensor, spec: kf.KernelSpec
               ) -> tuple[Tensor, Tensor]:
    """Kernel row against stored points, zeroed beyond the active count."""
    a_full = kf.kernel_row(x_new, state.X, spec=spec)
    mask = rankone.active_mask(state.X.shape[0], state.m)
    a = torch.where(mask, a_full, 0.0)
    k_new = kf.gram_block(x_new[None], x_new[None], spec=spec)[0, 0]
    return a, k_new


def apply_pair(L: Tensor, U: Tensor, v1: Tensor, sigma1: Tensor, v2: Tensor,
               sigma2: Tensor, m: Tensor, *, plan: UpdatePlan,
               z1: Tensor | None = None, z2: Tensor | None = None
               ) -> tuple[Tensor, Tensor]:
    """A ±sigma update pair under ``plan``: one fused double rotation
    (matmul "jnp2"/"pallas2", back to sequential where a cluster merge
    fires and ``plan.merge_fallback`` is set) or two sequential rank-one
    updates.

    ``z1``/``z2`` are optional precomputed Uᵀv₁/Uᵀv₂ in the CURRENT basis.
    The fused pair takes both; the sequential spelling reuses z1 only —
    z2 is stale after the first rotation, so the second update computes
    its own projection."""
    iters = resolve_iters(plan.iters, L.dtype)
    kw = dict(method=plan.method, matmul=plan.inner_matmul, iters=iters,
              precise=plan.precise)
    if plan.fused:
        return rankone.rank_one_update_pair(
            L, U, v1, sigma1, v2, sigma2, m,
            merge_fallback=plan.merge_fallback, z1=z1, z2=z2, **kw)
    L, U = rankone.rank_one_update(L, U, v1, sigma1, m, z=z1, **kw)
    return rankone.rank_one_update(L, U, v2, sigma2, m, **kw)


def rank_one(L: Tensor, U: Tensor, v: Tensor, sigma, m: Tensor, *,
             plan: UpdatePlan) -> tuple[Tensor, Tensor]:
    """One ``rankone.rank_one_update`` under ``plan``, run at the active
    bucket and scattered back (reads m on the host once)."""
    M = L.shape[0]
    m = torch.as_tensor(m, dtype=torch.int32, device=L.device)
    Mb = (M if plan.dispatch != "bucketed"
          else bucket_for(max(int(m), 1), M, plan.min_bucket))
    kw = dict(method=plan.method, matmul=plan.inner_matmul,
              iters=resolve_iters(plan.iters, L.dtype), precise=plan.precise)
    if Mb == M:
        return rankone.rank_one_update(L, U, v, sigma, m, **kw)
    Lb, Ub = rankone.rank_one_update(L[:Mb].clone(),
                                     U[:Mb, :Mb].contiguous(), v[:Mb],
                                     sigma, m, **kw)
    L_new = L.clone()
    L_new[:Mb] = Lb
    L_new = rankone.sentinelize(L_new, m, L.new_zeros(()))
    U_new = U.clone()
    U_new[:Mb, :Mb] = Ub
    return L_new, U_new


def eigpairs(state) -> tuple[Tensor, Tensor]:
    """Active (descending) eigenvalues and eigenvectors."""
    M = state.L.shape[0]
    mask = rankone.active_mask(M, state.m)
    order = torch.argsort(torch.where(mask, -state.L, torch.inf),
                          stable=True)
    return state.L[order], state.U[:, order]


def transform_state(state, x: Tensor, *, spec: kf.KernelSpec, adjusted: bool,
                    n_components: int, plan: UpdatePlan | None = None
                    ) -> Tensor:
    """Project points on the leading kernel principal components, as
    publish-then-query over ``core/serving`` (so a transform of a frozen
    state equals serving queries against a snapshot of it)."""
    from repro_torch.core import serving
    snap = serving.publish_transform(state, n_components=n_components,
                                     adjusted=adjusted)
    return serving.query(snap, x, spec=spec, plan=plan)


def _ingest(st, x_new: Tensor, spec: kf.KernelSpec, adjusted: bool,
            plan: UpdatePlan):
    """One Algorithm-1/2 ingest under ``plan``: the fused prologue
    (``inkpca.ingest_*``) with ``fuse_krow``, else the masked kernel row
    followed by the update's own Uᵀv products."""
    from repro_torch.core import inkpca
    if plan.fuse_krow:
        fn = inkpca.ingest_adjusted if adjusted else inkpca.ingest_unadjusted
        return fn(st, x_new, spec=spec, plan=plan)
    a, k_new = masked_row(st, x_new, spec)
    fn = inkpca.update_adjusted if adjusted else inkpca.update_unadjusted
    return fn(st, a, k_new, x_new, plan=plan)


# ------------------------------------------------------- stream bundle --
class StreamState(NamedTuple):
    """The bundle ``Engine.step``/``step_block`` advance: the eigensystem
    plus the optional members that select stages — ``ages``/``clock``, the
    sliding window's arrival ring (the evict stage), and ``health`` /
    ``metrics``, whose lanes are not ported yet (a bundle carrying either
    raises; ROADMAP.md, Open items §1 item 7)."""

    kpca: object
    ages: object = None
    clock: object = None
    health: object = None
    metrics: object = None

    @property
    def windowed(self) -> bool:
        return self.ages is not None


def make_stream(state, *, health=None, metrics=None) -> StreamState:
    """Wrap a ``KPCAState`` or a ``window.WindowState`` into a bundle."""
    if hasattr(state, "kpca"):                         # WindowState
        return StreamState(kpca=state.kpca, ages=state.ages,
                           clock=state.clock, health=health, metrics=metrics)
    return StreamState(kpca=state, health=health, metrics=metrics)


class Engine:
    """Bucket selection → slice → update → scatter for one stream, under an
    ``UpdatePlan``.  Stateless with respect to the stream (states go in and
    out).  Methods that take ``m`` accept the host's count of active pairs
    so that they read nothing back; None reads it from the card."""

    def __init__(self, spec: kf.KernelSpec, plan: UpdatePlan = DEFAULT_PLAN,
                 *, adjusted: bool = True):
        check_plan(plan)
        self.spec = spec
        self.plan = plan
        self.adjusted = adjusted

    def _bucket(self, capacity: int, need: int) -> int:
        if self.plan.dispatch != "bucketed":
            return capacity
        return bucket_for(need, capacity, self.plan.min_bucket)

    # ---- composed stream step ---------------------------------------------
    def _stream_window(self, stream: StreamState,
                       window: int | None) -> int | None:
        if stream.health is not None or stream.metrics is not None:
            raise NotImplementedError("health and metrics lanes are not "
                                      "ported yet: ROADMAP.md, Open items "
                                      "§1 item 7")
        if window is None:
            window = self.plan.window
        if stream.ages is not None and window is None:
            raise ValueError(
                "windowed StreamState needs a window size — pass window= "
                "or build the engine with UpdatePlan(window=W)")
        return window if stream.ages is not None else None

    def step(self, stream: StreamState, x_new: Tensor, *,
             window: int | None = None, m: int | None = None
             ) -> StreamState:
        """Advance the bundle by one point: evict the oldest point first if
        the bundle is windowed and its window is full, then ingest.  ``m``
        is the host's active count (None reads it)."""
        from repro_torch.core import window as wnd

        window = self._stream_window(stream, window)
        if stream.ages is None:
            return stream._replace(kpca=self._ingest_point(
                stream.kpca, x_new, m=m))
        w = self._window_point(wnd.WindowState(stream.kpca, stream.ages,
                                               stream.clock),
                               x_new, window=window, m=m)
        return stream._replace(kpca=w.kpca, ages=w.ages, clock=w.clock)

    def step_block(self, stream: StreamState, xs: Tensor, *,
                   window: int | None = None) -> StreamState:
        """Fold a (T, d) block, a loop over ``step``: the active count is
        read once and then tracked on the host, so the loop reads nothing
        back from the card."""
        window = self._stream_window(stream, window)
        m = int(stream.kpca.m)
        for x_new in xs:
            stream = self.step(stream, x_new, window=window, m=m)
            if window is None or m < window:
                m += 1
        return stream

    # ---- plain ingest -----------------------------------------------------
    def _ingest_point(self, state, x_new: Tensor, *, m: int | None = None):
        """Fold one point into ``state`` at the smallest bucket holding
        m + 1 active pairs.  Raises when the state is full, under either
        dispatch."""
        M = state.L.shape[0]
        if m is None:
            m = int(state.m)
        Mb = bucket_for(m + 1, M, self.plan.min_bucket)
        if self.plan.dispatch != "bucketed":
            Mb = M
        sub = slice_state(state, Mb) if Mb < M else state
        sub = _ingest(sub, x_new, self.spec, self.adjusted, self.plan)
        return scatter_state(state, sub) if Mb < M else sub

    def update(self, state, x_new: Tensor, *, m: int | None = None):
        """Fold one point into a bare eigensystem state (``step`` on an
        append-only bundle)."""
        return self.step(StreamState(kpca=state), x_new, m=m).kpca

    def update_block(self, state, xs: Tensor):
        """Fold a (T, d) block into a bare eigensystem state."""
        return self.step_block(StreamState(kpca=state), xs).kpca

    # ---- decremental path ---------------------------------------------------
    def downdate(self, state, i, *, m: int | None = None):
        """Remove point ``i`` (a physical row: an int, checked against the
        active range, or a 0-d device tensor) at the bucket holding the
        current m, the decremental mirror of ``update``; the next call
        re-buckets downward.  Requires m ≥ 2."""
        from repro_torch.core import downdate as dd

        M = state.L.shape[0]
        if m is None:
            m = int(state.m)
        if m < 2:
            raise ValueError(f"downdate needs at least 2 active points, "
                             f"got m={m}")
        if not torch.is_tensor(i) and not 0 <= i < m:
            raise ValueError(f"point index {i} outside active range "
                             f"[0, {m})")
        Mb = self._bucket(M, m)
        sub = slice_state(state, Mb) if Mb < M else state
        i = torch.as_tensor(i, dtype=torch.int32, device=state.L.device)
        sub = dd.downdate(sub, i, self.spec, adjusted=self.adjusted,
                          plan=self.plan)
        return scatter_state(state, sub) if Mb < M else sub

    def replace(self, state, i, x_new: Tensor, *, m: int | None = None):
        """Swap point ``i`` for ``x_new``: downdate, then update (works on
        a full state: the downdate frees the slot)."""
        if m is None:
            m = int(state.m)
        state = self.downdate(state, i, m=m)
        return self.update(state, x_new, m=m - 1)

    # ---- sliding window -----------------------------------------------------
    def _window_point(self, wstate, x_new: Tensor, *, window: int,
                      m: int | None = None):
        """Point-wise evict|ingest: append-only below a full window, else
        evict the oldest point (argmin of the ring, on the card) and
        ingest."""
        from repro_torch.core import window as wnd

        if m is None:
            m = int(wstate.kpca.m)
        wstate = wnd.maybe_rebase(wstate)
        if m >= window:
            wstate = wnd.evict(self, wstate, torch.argmin(wstate.ages), m=m)
            m -= 1
        kpca = self._ingest_point(wstate.kpca, x_new, m=m)
        ages = rankone.index_set(wstate.ages, wstate.kpca.m, wstate.clock)
        return wnd.WindowState(kpca=kpca, ages=ages, clock=wstate.clock + 1)

    def window_step(self, wstate, x_new: Tensor, *, window: int):
        """``step`` on a windowed bundle, unwrapped (``window.ingest``)."""
        from repro_torch.core import window as wnd

        return wnd.ingest(self, wstate, x_new, window=window)

    def window_block(self, wstate, xs: Tensor, *, window: int):
        """``step_block`` on a windowed bundle, unwrapped."""
        from repro_torch.core import window as wnd

        s = self.step_block(make_stream(wstate), xs, window=window)
        return wnd.WindowState(kpca=s.kpca, ages=s.ages, clock=s.clock)

    # ---- Nyström landmarks ------------------------------------------------
    def add_landmark(self, state, x_all, x_new: Tensor):
        """Bucketed ``nystrom.add_landmark``: the eigensystem update and the
        Knm column write both run at the bucket holding m + 1 landmarks.
        Reads m on the host once."""
        from repro_torch.core import nystrom

        M = state.kpca.L.shape[0]
        Mb = bucket_for(int(state.kpca.m) + 1, M, self.plan.min_bucket)
        if self.plan.dispatch != "bucketed":
            Mb = M
        if Mb == M:
            return nystrom.add_landmark(state, x_all, x_new, self.spec,
                                        plan=self.plan)
        sub = state._replace(kpca=slice_state(state.kpca, Mb),
                             Knm=state.Knm[:, :Mb])
        sub = nystrom.add_landmark(sub, x_all, x_new, self.spec,
                                   plan=self.plan)
        Knm = state.Knm.clone()
        Knm[:, :Mb] = sub.Knm
        return state._replace(kpca=scatter_state(state.kpca, sub.kpca),
                              Knm=Knm, Xrows=sub.Xrows)

    def offer_landmark(self, state, x: Tensor, *, x_all=None,
                       budget: int | None = None):
        """Offer one candidate landmark under ``plan.landmark_policy``:
        ``"append"``, the paper's §4 loop, admits every candidate until the
        budget (default M − 1) fills, then rejects.  Returns ``(state,
        action)`` with action "admitted" or "rejected"."""
        if self.plan.landmark_policy == "leverage":
            raise NotImplementedError(
                "landmark_policy='leverage' (residual-gated admission with "
                "lowest-leverage replacement) is not ported yet: ROADMAP.md, "
                "Open items §1 item 5")
        M = state.kpca.L.shape[0]
        budget = budget if budget is not None else M - 1
        if int(state.kpca.m) < budget:
            return self.add_landmark(state, x_all, x), "admitted"
        return state, "rejected"
