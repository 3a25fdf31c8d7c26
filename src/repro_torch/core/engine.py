"""Update engine: one code path from kernel row to scatter.

``UpdatePlan`` describes how updates run, with the reference's field names
and defaults, so one plan's values drive both packages.  ``Engine`` owns
bucket selection, slicing and scatter for one stream, append-only or
windowed: ``step``/``step_block`` advance a ``StreamState`` bundle, whose
arrival ring (present for a sliding window) selects the evict stage.
``StreamBatch`` advances B tenants' streams in lockstep through the
batched steps (``batched_update`` and its masked, downdate and scan
forms) over a tenant-stacked state.

Bucket geometry (the reference's invariants): L is ascending with the
sentinels strictly above the active spectrum, inactive columns of U are
identity columns and active columns vanish on rows >= m, and K1 / X are
zero beyond m.  So the leading M_b×M_b block of a state with m < M_b
active pairs is itself a valid capacity-M_b state (``slice_state``), and
``scatter_state`` writes an updated bucket back.  Bucket choice uses the
host's count of active pairs, which the caller may pass (``KPCAStream``
mirrors it), so a step reads nothing back from the card.

Torch has no ``lax.scan``: a block is a Python loop over ``step``, with
the active count tracked on the host.  ``min_rows`` is the row-support
floor every bucketed method takes: a truncated state that was not
compacted keeps eigenvector mass on rows past m, and a bucket below that
support would drop it (``truncate``).

A bundle carrying a ``health.HealthState`` runs the gate stage (input
quarantine and a probe after each point, ``core/health.py``), and one
carrying a ``telemetry.MetricsState`` the note stage.  A gated point may
be rejected on the device, so the host keeps bounds on the active count
(``HostCount``): a guarded point raises the upper bound only, and m is
read back only where the bounds disagree on a decision (the bucket, a
full window, the capacity).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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
    if plan.health is not None:
        from repro_torch.core import health as hl
        # Any object with the policy's fields (the reference's too: one
        # plan drives both packages).
        if not all(hasattr(plan.health, f) for f in hl.HealthPolicy._fields):
            raise TypeError(f"plan.health must be a health.HealthPolicy, "
                            f"got {type(plan.health).__name__}")
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
    kernels take contiguous operands).  A tenant-stacked state (a leading
    axis on every leaf, ``StreamBatch``) slices every tenant alike: the
    reference's ``_slice_stacked``."""
    return state._replace(L=state.L[..., :Mb].clone(),
                          U=state.U[..., :Mb, :Mb].contiguous(),
                          K1=state.K1[..., :Mb].clone(),
                          X=state.X[..., :Mb, :].clone())


def scatter_state(full, sub):
    """Write an updated bucket back into a copy of the fixed-capacity state
    (out of place, as in the reference: a published snapshot that holds
    the old X never changes under it); tenant-stacked states per tenant
    (the reference's ``_scatter_stacked``)."""
    Mb = sub.L.shape[-1]
    L = full.L.clone()
    L[..., :Mb] = sub.L
    # The tail still holds sentinels for the pre-update spectrum.
    L = rankone.sentinelize(L, sub.m, L.new_zeros(()))
    U, K1, X = full.U.clone(), full.K1.clone(), full.X.clone()
    U[..., :Mb, :Mb] = sub.U
    K1[..., :Mb] = sub.K1
    X[..., :Mb, :] = sub.X
    return full._replace(L=L, U=U, m=sub.m, S=sub.S, K1=K1, X=X)


# ------------------------------------------------------ shared primitives --
def masked_row(state, x_new: Tensor, spec: kf.KernelSpec
               ) -> tuple[Tensor, Tensor]:
    """Kernel row against stored points, zeroed beyond the active count
    (per tenant for a stacked state and points (B, d))."""
    a_full = kf.kernel_row(x_new, state.X, spec=spec)
    mask = rankone.active_mask(state.X.shape[-2], state.m)
    a = torch.where(mask, a_full, 0.0)
    xr = x_new[..., None, :]
    k_new = kf.gram_block(xr, xr, spec=spec)[..., 0, 0]
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
    """Active (descending) eigenvalues and eigenvectors (per tenant for a
    stacked state)."""
    M = state.L.shape[-1]
    mask = rankone.active_mask(M, state.m)
    order = torch.argsort(torch.where(mask, -state.L, torch.inf), dim=-1,
                          stable=True)
    return rankone.take(state.L, order), rankone.take_cols(state.U, order)


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
    sliding window's arrival ring (the evict stage), ``health`` (a
    ``health.HealthState``: the gate stage) and ``metrics`` (a
    ``telemetry.MetricsState``: the note stage)."""

    kpca: object
    ages: object = None
    clock: object = None
    health: object = None
    metrics: object = None

    @property
    def windowed(self) -> bool:
        return self.ages is not None


class HostCount:
    """Host bounds lo <= m <= hi on a stream's active count.  An unguarded
    step knows m exactly; a guarded step may reject its point on the
    device, so it raises ``hi`` only.  ``decide`` reads m back (one sync)
    only where the bounds disagree."""

    def __init__(self, m: int):
        self.lo = self.hi = int(m)

    def read(self, state) -> int:
        self.lo = self.hi = int(state.m)
        return self.lo

    def exact(self, state) -> int:
        """m itself: read back only if a rejection may have happened."""
        return self.lo if self.lo == self.hi else self.read(state)

    def decide(self, state, fn, limit: int | None = None):
        """``fn(m)`` when the bounds agree on it (and ``hi`` is at most
        ``limit``), else ``fn`` of m read back."""
        if self.lo != self.hi and ((limit is not None and self.hi > limit)
                                   or fn(self.lo) != fn(self.hi)):
            self.read(state)
        return fn(self.lo)

    def advanced(self, cap: int | None, *, certain: bool) -> None:
        """One point offered: accepted for sure (``certain``) or maybe;
        ``cap`` is the window's size (m stops there)."""
        self.hi = self.hi + 1 if cap is None else min(self.hi + 1, cap)
        if certain:
            self.lo = self.lo + 1 if cap is None else min(self.lo + 1, cap)


def _count(stream, m) -> HostCount:
    if isinstance(m, HostCount):
        return m
    return HostCount(int(stream.kpca.m) if m is None else m)


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

    def _bucket(self, capacity: int, need: int, min_rows: int = 0) -> int:
        """The bucket holding max(need, min_rows) rows: the capacity under
        fixed dispatch, where it still raises past the capacity."""
        Mb = bucket_for(max(need, min_rows, 1), capacity,
                        self.plan.min_bucket)
        return Mb if self.plan.dispatch == "bucketed" else capacity

    # ---- composed stream step ---------------------------------------------
    # A bundle advances through up to three stages, chosen by which of its
    # members are present:  gate (health) → evict|ingest (ages) → note
    # (metrics).  The note stage never touches the eigensystem, so metered
    # and unmetered states are equal bit for bit.

    def _stream_window(self, stream: StreamState,
                       window: int | None) -> int | None:
        if stream.health is not None:
            self._health_policy()
        if window is None:
            window = self.plan.window
        if stream.ages is not None and window is None:
            raise ValueError(
                "windowed StreamState needs a window size — pass window= "
                "or build the engine with UpdatePlan(window=W)")
        return window if stream.ages is not None else None

    def step(self, stream: StreamState, x_new: Tensor, *,
             window: int | None = None, m: int | HostCount | None = None,
             min_rows: int = 0) -> StreamState:
        """Advance the bundle by one point: gate it if the bundle carries a
        ``HealthState``, evict the oldest point first if it is windowed and
        its window is full, ingest, and note the step if it carries a
        ``MetricsState``.  ``m`` is the host's active count (an int, or a
        ``HostCount`` this call advances; None reads it); ``min_rows`` the
        row-support floor."""
        window = self._stream_window(stream, window)
        cnt = _count(stream, m)
        marks = self._marks(stream)
        stream = self._advance(stream, x_new, window, cnt, min_rows)
        return self._note_stage(stream, marks, offered=1, window=window)

    def step_block(self, stream: StreamState, xs: Tensor, *,
                   window: int | None = None, m: int | HostCount | None = None,
                   min_rows: int = 0) -> StreamState:
        """Fold a (T, d) block, a loop over the per-point stages; the active
        count is read once (or taken from ``m``) and then tracked on the
        host, and the note stage accounts the whole block once."""
        window = self._stream_window(stream, window)
        cnt = _count(stream, m)
        marks = self._marks(stream)
        for x_new in xs:
            stream = self._advance(stream, x_new, window, cnt, min_rows)
        return self._note_stage(stream, marks, offered=len(xs),
                                window=window)

    def _advance(self, stream: StreamState, x_new: Tensor,
                 window: int | None, cnt: HostCount,
                 min_rows: int) -> StreamState:
        """The gate and evict|ingest stages for one point; advances
        ``cnt``."""
        from repro_torch.core import health as hl
        from repro_torch.core import window as wnd

        if stream.health is None:
            m = cnt.exact(stream.kpca)
            if stream.ages is None:
                cnt.advanced(None, certain=True)
                return stream._replace(kpca=self._ingest_point(
                    stream.kpca, x_new, m=m, min_rows=min_rows))
            w = self._window_point(wnd.WindowState(stream.kpca, stream.ages,
                                                   stream.clock),
                                   x_new, window=window, m=m,
                                   min_rows=min_rows)
            cnt.advanced(window, certain=True)
            return stream._replace(kpca=w.kpca, ages=w.ages, clock=w.clock)
        certain = hl.always_accepts(self.plan.health)
        M = stream.kpca.L.shape[0]
        if stream.ages is None:
            Mb = cnt.decide(stream.kpca,
                            lambda m: self._bucket(M, m + 1, min_rows),
                            limit=M - 1)
            kpca, h = hl.guarded_update(self, stream.kpca, stream.health,
                                        x_new, Mb=Mb)
            cnt.advanced(None, certain=certain)
            return stream._replace(kpca=kpca, health=h)
        w = wnd.maybe_rebase(wnd.WindowState(stream.kpca, stream.ages,
                                             stream.clock))
        if cnt.decide(stream.kpca, lambda m: m >= window):
            w, h = hl.guarded_window_step(self, w, stream.health, x_new,
                                          window=window, min_rows=min_rows)
        else:
            Mb = cnt.decide(stream.kpca,
                            lambda m: self._bucket(M, m + 1, min_rows),
                            limit=M - 1)
            w, h = hl.guarded_grow_step(self, w, stream.health, x_new, Mb=Mb)
        cnt.advanced(window, certain=certain)
        return stream._replace(kpca=w.kpca, ages=w.ages, clock=w.clock,
                               health=h)

    @staticmethod
    def _marks(stream: StreamState):
        """What the note stage compares against: m, the clock and the
        quarantine counter before the step (None without metrics)."""
        if stream.metrics is None:
            return None
        return (stream.kpca.m, stream.clock,
                None if stream.health is None else stream.health.quarantined)

    @staticmethod
    def _note_stage(stream: StreamState, marks, *, offered: int,
                    window: int | None) -> StreamState:
        """Account the step into the riding ``MetricsState``, from device
        values the step produced.  Accepted count: the clock's advance on a
        window (a rejected point does not stamp), offered minus the
        quarantine counter's advance on a guarded stream, else offered."""
        if marks is None:
            return stream
        from repro_torch.core import telemetry as tm

        m0, c0, q0 = marks
        if c0 is not None:
            accepted = stream.clock - c0
        elif q0 is not None:
            accepted = offered - (stream.health.quarantined - q0)
        else:
            accepted = offered
        return stream._replace(metrics=tm.note_block(
            stream.metrics, m0, stream.kpca.m, offered, accepted,
            stream.health, window=window))

    def _health_policy(self):
        if self.plan.health is None:
            raise ValueError(
                "guarded dispatch needs a health policy — build the engine "
                "with UpdatePlan(health=health.HealthPolicy(...))")
        return self.plan.health

    # ---- plain ingest -----------------------------------------------------
    def _ingest_point(self, state, x_new: Tensor, *, m: int | None = None,
                      min_rows: int = 0):
        """Fold one point into ``state`` at the smallest bucket holding
        max(m + 1, min_rows) rows.  Raises when the state is full, under
        either dispatch."""
        M = state.L.shape[0]
        if m is None:
            m = int(state.m)
        Mb = self._bucket(M, m + 1, min_rows)
        sub = slice_state(state, Mb) if Mb < M else state
        sub = _ingest(sub, x_new, self.spec, self.adjusted, self.plan)
        return scatter_state(state, sub) if Mb < M else sub

    def update(self, state, x_new: Tensor, *, m: int | None = None,
               min_rows: int = 0):
        """Fold one point into a bare eigensystem state (``step`` on an
        append-only bundle)."""
        return self.step(StreamState(kpca=state), x_new, m=m,
                         min_rows=min_rows).kpca

    def update_block(self, state, xs: Tensor, *, min_rows: int = 0):
        """Fold a (T, d) block into a bare eigensystem state."""
        return self.step_block(StreamState(kpca=state), xs,
                               min_rows=min_rows).kpca

    # ---- decremental path ---------------------------------------------------
    def downdate(self, state, i, *, m: int | None = None,
                 min_rows: int = 0):
        """Remove point ``i`` (a physical row: an int, checked against the
        active range, or a 0-d device tensor) at the bucket holding the
        current m, the decremental mirror of ``update``; the next call
        re-buckets downward.  Requires m ≥ 2.  A ``NystromState`` routes
        to ``remove_landmark``."""
        from repro_torch.core import downdate as dd

        if hasattr(state, "kpca"):
            return self.remove_landmark(state, i, m=m, min_rows=min_rows)
        M = state.L.shape[0]
        if m is None:
            m = int(state.m)
        if m < 2:
            raise ValueError(f"downdate needs at least 2 active points, "
                             f"got m={m}")
        if not torch.is_tensor(i) and not 0 <= i < m:
            raise ValueError(f"point index {i} outside active range "
                             f"[0, {m})")
        Mb = self._bucket(M, m, min_rows)
        sub = slice_state(state, Mb) if Mb < M else state
        i = torch.as_tensor(i, dtype=torch.int32, device=state.L.device)
        sub = dd.downdate(sub, i, self.spec, adjusted=self.adjusted,
                          plan=self.plan)
        return scatter_state(state, sub) if Mb < M else sub

    def replace(self, state, i, x_new: Tensor, *, m: int | None = None,
                min_rows: int = 0):
        """Swap point ``i`` for ``x_new``: downdate, then update (works on
        a full state: the downdate frees the slot).  A ``NystromState``
        routes to ``replace_landmark`` (grow_rows)."""
        if hasattr(state, "kpca"):
            return self.replace_landmark(state, None, i, x_new, m=m,
                                         min_rows=min_rows)
        if m is None:
            m = int(state.m)
        state = self.downdate(state, i, m=m, min_rows=min_rows)
        return self.update(state, x_new, m=m - 1, min_rows=min_rows)

    # ---- sliding window -----------------------------------------------------
    def _window_point(self, wstate, x_new: Tensor, *, window: int,
                      m: int | None = None, min_rows: int = 0):
        """Point-wise evict|ingest: append-only below a full window, else
        evict the oldest point (argmin of the ring, on the card) and
        ingest."""
        from repro_torch.core import window as wnd

        if m is None:
            m = int(wstate.kpca.m)
        wstate = wnd.maybe_rebase(wstate)
        if m >= window:
            wstate = wnd.evict(self, wstate, torch.argmin(wstate.ages), m=m,
                               min_rows=min_rows)
            m -= 1
        kpca = self._ingest_point(wstate.kpca, x_new, m=m, min_rows=min_rows)
        ages = rankone.index_set(wstate.ages, wstate.kpca.m, wstate.clock)
        return wnd.WindowState(kpca=kpca, ages=ages, clock=wstate.clock + 1)

    def window_step(self, wstate, x_new: Tensor, *, window: int):
        """``step`` on a windowed bundle, unwrapped (``window.ingest``)."""
        from repro_torch.core import window as wnd

        return wnd.ingest(self, wstate, x_new, window=window)

    def window_block(self, wstate, xs: Tensor, *, window: int):
        """``step_block`` on a windowed bundle, unwrapped."""
        return self._unwindow(self.step_block(make_stream(wstate), xs,
                                              window=window))

    # ---- guarded and metered spellings --------------------------------------
    # The reference's per-combination methods, each a bundle through
    # ``step``/``step_block``.
    def _unwindow(self, s: StreamState):
        from repro_torch.core import window as wnd

        return wnd.WindowState(kpca=s.kpca, ages=s.ages, clock=s.clock)

    def update_guarded(self, state, hstate, x_new: Tensor, *, m=None,
                       min_rows: int = 0):
        """One gated point; returns ``(state, hstate)``.  A rejected point
        returns the input state bit for bit."""
        out = self.step(StreamState(kpca=state, health=hstate), x_new, m=m,
                        min_rows=min_rows)
        return out.kpca, out.health

    def update_block_guarded(self, state, hstate, xs: Tensor, *,
                             min_rows: int = 0):
        out = self.step_block(StreamState(kpca=state, health=hstate), xs,
                              min_rows=min_rows)
        return out.kpca, out.health

    def window_ingest_guarded(self, wstate, hstate, x_new: Tensor, *,
                              window: int, min_rows: int = 0):
        """One gated window point: a rejection leaves the eigensystem, the
        ring, the ages and the clock as they were."""
        out = self.step(make_stream(wstate, health=hstate), x_new,
                        window=window, min_rows=min_rows)
        return self._unwindow(out), out.health

    def window_block_guarded(self, wstate, hstate, xs: Tensor, *,
                             window: int, min_rows: int = 0):
        out = self.step_block(make_stream(wstate, health=hstate), xs,
                              window=window, min_rows=min_rows)
        return self._unwindow(out), out.health

    def update_metered(self, state, mstate, x_new: Tensor, *,
                       min_rows: int = 0):
        out = self.step(StreamState(kpca=state, metrics=mstate), x_new,
                        min_rows=min_rows)
        return out.kpca, out.metrics

    def update_block_metered(self, state, mstate, xs: Tensor, *,
                             min_rows: int = 0):
        out = self.step_block(StreamState(kpca=state, metrics=mstate), xs,
                              min_rows=min_rows)
        return out.kpca, out.metrics

    def window_block_metered(self, wstate, mstate, xs: Tensor, *,
                             window: int, min_rows: int = 0):
        out = self.step_block(make_stream(wstate, metrics=mstate), xs,
                              window=window, min_rows=min_rows)
        return self._unwindow(out), out.metrics

    def update_guarded_metered(self, state, hstate, mstate, x_new: Tensor, *,
                               min_rows: int = 0):
        out = self.step(StreamState(kpca=state, health=hstate,
                                    metrics=mstate), x_new, min_rows=min_rows)
        return out.kpca, out.health, out.metrics

    def update_block_guarded_metered(self, state, hstate, mstate,
                                     xs: Tensor, *, min_rows: int = 0):
        out = self.step_block(StreamState(kpca=state, health=hstate,
                                          metrics=mstate), xs,
                              min_rows=min_rows)
        return out.kpca, out.health, out.metrics

    def window_block_guarded_metered(self, wstate, hstate, mstate,
                                     xs: Tensor, *, window: int,
                                     min_rows: int = 0):
        out = self.step_block(make_stream(wstate, health=hstate,
                                          metrics=mstate), xs,
                              window=window, min_rows=min_rows)
        return self._unwindow(out), out.health, out.metrics

    def window_ingest_guarded_metered(self, wstate, hstate, mstate,
                                      x_new: Tensor, *, window: int,
                                      min_rows: int = 0):
        out = self.step(make_stream(wstate, health=hstate, metrics=mstate),
                        x_new, window=window, min_rows=min_rows)
        return self._unwindow(out), out.health, out.metrics

    def downdate_metered(self, state, mstate, i, *, m: int | None = None,
                         min_rows: int = 0):
        from repro_torch.core import telemetry as tm

        state = self.downdate(state, i, m=m, min_rows=min_rows)
        m_after = state.kpca.m if hasattr(state, "kpca") else state.m
        return state, tm.note_downdate(mstate, m_after)

    # ---- health probes and the heal ladder ----------------------------------
    def probe(self, state, hstate=None, *, ref_lam: Tensor | None = None):
        """A health probe of any state this engine serves (a window or
        Nyström state probes its ``.kpca``); ``ref_lam`` also measures the
        spectral drift.  Returns a fresh or updated ``HealthState``."""
        from repro_torch.core import health as hl

        policy = self.plan.health or hl.DEFAULT_POLICY
        kpca = getattr(state, "kpca", state)
        if hstate is None:
            hstate = hl.init_health(kpca.L.dtype, kpca.L.device)
        return hl.probe(kpca, hstate, policy, ref_lam)

    def heal(self, state, *, level: str = "auto",
             rung_out: list | None = None):
        """Walk the heal ladder (``health.heal_kpca``) on any state this
        engine serves: a window keeps its ring and clock; a Nyström state
        heals its landmark eigensystem (unadjusted: the K_mm block) and
        keeps ``Knm``/``Xrows`` (re-anchor a ``TraceErrorTracker`` after).
        Raises ``health.HealthError`` when the stored points are corrupt:
        the restore rung, for whoever owns the checkpoints."""
        from repro_torch.core import health as hl

        policy = self.plan.health or hl.DEFAULT_POLICY
        if hasattr(state, "Knm"):                      # NystromState
            return state._replace(kpca=hl.heal_kpca(
                state.kpca, self.spec, False, policy, level=level,
                rung_out=rung_out))
        if hasattr(state, "kpca"):                     # WindowState
            return state._replace(kpca=hl.heal_kpca(
                state.kpca, self.spec, self.adjusted, policy, level=level,
                rung_out=rung_out))
        return hl.heal_kpca(state, self.spec, self.adjusted, policy,
                            level=level, rung_out=rung_out)

    # ---- Nyström landmarks ------------------------------------------------
    def add_landmark(self, state, x_all, x_new: Tensor, *,
                     m: int | None = None, min_rows: int = 0):
        """Bucketed ``nystrom.add_landmark``: the eigensystem update and the
        Knm column write both run at the bucket holding max(m + 1,
        min_rows) rows.  ``min_rows`` is the row-support floor, as in
        ``update``: pass the pre-truncation landmark count to a state
        truncated without compaction.  ``m`` is the host's landmark count
        (None reads it)."""
        from repro_torch.core import nystrom

        M = state.kpca.L.shape[0]
        if m is None:
            m = int(state.kpca.m)
        Mb = self._bucket(M, m + 1, min_rows)
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

    @staticmethod
    def _check_landmark(what: str, state, j, m: int | None) -> int:
        """The host's landmark count (None reads it), checked to allow
        removing landmark ``j`` (an int, or a 0-d device tensor)."""
        if m is None:
            m = int(state.kpca.m)
        if m < 2:
            raise ValueError(f"{what} needs at least 2 landmarks, got m={m}")
        if not torch.is_tensor(j) and not 0 <= j < m:
            raise ValueError(f"landmark index {j} outside active range "
                             f"[0, {m})")
        return m

    def remove_landmark(self, state, j, *, m: int | None = None,
                        min_rows: int = 0):
        """Bucketed ``nystrom.remove_landmark``: the eigensystem downdate
        and the Knm column shuffle both run at the bucket holding the
        current landmark count (no growth: m rows, not m + 1)."""
        from repro_torch.core import nystrom

        M = state.kpca.L.shape[0]
        m = self._check_landmark("remove_landmark", state, j, m)
        Mb = self._bucket(M, m, min_rows)
        j = torch.as_tensor(j, dtype=torch.int32, device=state.Knm.device)
        if Mb == M:
            return nystrom.remove_landmark(state, j, self.spec,
                                           plan=self.plan)
        sub = state._replace(kpca=slice_state(state.kpca, Mb),
                             Knm=state.Knm[:, :Mb])
        sub = nystrom.remove_landmark(sub, j, self.spec, plan=self.plan)
        Knm = state.Knm.clone()
        Knm[:, :Mb] = sub.Knm
        return state._replace(kpca=scatter_state(state.kpca, sub.kpca),
                              Knm=Knm)

    def replace_landmark(self, state, x_all, j, x_new: Tensor, *,
                         m: int | None = None, min_rows: int = 0,
                         donate: bool = False):
        """Swap landmark ``j`` for ``x_new``: remove, then add, at the
        bucket holding the current m (the removal frees the slot the add
        writes).

        ``donate=True`` consumes the input state: its Knm, U, L, K1, X and
        S are overwritten in place with the result, which is returned
        on the same storage (only the bucket's block of Knm and U is
        written).  Pass it only where nothing reads the pre-swap state
        again: unlike a donated JAX buffer, a stale reference to it does
        not raise, it silently reads the new values.  The default copies.
        """
        from repro_torch.core import nystrom

        M = state.kpca.L.shape[0]
        m = self._check_landmark("replace_landmark", state, j, m)
        Mb = self._bucket(M, m, min_rows)
        j = torch.as_tensor(j, dtype=torch.int32, device=state.Knm.device)
        sub = state if Mb == M else state._replace(
            kpca=slice_state(state.kpca, Mb), Knm=state.Knm[:, :Mb])
        sub = nystrom.replace_landmark(sub, x_all, j, x_new, self.spec,
                                       plan=self.plan)
        if donate:
            return _write_bucket_(state, sub, Mb)
        if Mb == M:
            return sub
        Knm = state.Knm.clone()
        Knm[:, :Mb] = sub.Knm
        return state._replace(kpca=scatter_state(state.kpca, sub.kpca),
                              Knm=Knm, Xrows=sub.Xrows)

    def offer_landmark(self, state, x: Tensor, *, x_all=None,
                       budget: int | None = None, admit_tol: float = 1e-3,
                       reg: float = 1e-6, min_rows: int = 0,
                       residual: float | None = None, m: int | None = None,
                       info: dict | None = None):
        """Offer one candidate landmark under ``plan.landmark_policy``:

        * ``"append"``, the paper's §4 loop: admit every candidate until
          the budget (default M − 1) fills, then reject;
        * ``"leverage"``: residual-gated admission with lowest-leverage
          replacement at the budget (``nystrom.consider_landmark``;
          ``residual`` forwards a precomputed ``admission_residual``, and
          ``info`` receives the victim of a replacement).

        ``m`` is the host's landmark count (None reads it).  Returns
        ``(state, action)`` with action "admitted", "replaced" or
        "rejected"."""
        from repro_torch.core import nystrom

        if self.plan.landmark_policy == "leverage":
            return nystrom.consider_landmark(
                self, state, x, x_all=x_all, budget=budget,
                admit_tol=admit_tol, reg=reg, min_rows=min_rows,
                residual=residual, m=m, info=info)
        M = state.kpca.L.shape[0]
        budget = budget if budget is not None else M - 1
        if m is None:
            m = int(state.kpca.m)
        if m < budget:
            return self.add_landmark(state, x_all, x, m=m,
                                     min_rows=min_rows), "admitted"
        return state, "rejected"

    # ---- truncation / compaction ------------------------------------------
    def truncate(self, state, k: int, *, compact: bool | None = None,
                 capacity: int | None = None):
        """Keep only the k dominant eigenpairs (the paper's conclusion:
        "only maintain a subset").

        The kept columns keep their support on the pre-truncation rows.
        ``compact``:

        * True: re-express the state on its leading rows at ``capacity``
          (default: the bucket holding m + 1), freeing the old bucket;
        * False: the old rows keep eigenvector mass, so bucketed dispatch
          must keep slicing at the old active count: pass it as
          ``min_rows`` to every later call (``KPCAStream`` carries it);
        * None (default): ``plan.compact_shrink``, except that a bucketed
          engine compacts at unchanged capacity, so a bare
          ``truncate(state, k)`` streams on safely without a floor.

        A ``NystromState`` goes through ``_truncate_nystrom``."""
        if hasattr(state, "kpca"):
            return self._truncate_nystrom(state, k, compact=compact,
                                          capacity=capacity)
        keep_capacity = False
        if compact is None:
            compact = self.plan.compact_shrink
            if not compact and self.plan.dispatch == "bucketed":
                compact, keep_capacity = True, True
        M = state.L.shape[0]
        mask = rankone.active_mask(M, state.m)
        keep = torch.argsort(torch.where(mask, -state.L, torch.inf),
                             stable=True)[:k]
        L = torch.zeros_like(state.L)
        L[:k] = state.L[keep]
        U = torch.eye(M, dtype=state.U.dtype, device=state.U.device)
        U[:, :k] = state.U[:, keep]
        m = torch.clamp_max(state.m, k)
        L = rankone.sentinelize(L, m, L.new_zeros(()))
        out = state._replace(L=L, U=U, m=m)
        if compact:
            out = self.compact(out, capacity=M if keep_capacity else capacity)
        return out

    def _truncate_nystrom(self, state, k: int, *, compact: bool | None,
                          capacity: int | None):
        """Truncate a Nyström state's eigensystem without losing a
        landmark.  Its rows are observed landmarks with live Knm columns,
        and the reconstruction contracts over every row that carries
        eigenvector mass, so compaction is clamped to the row support
        r = m: the rank-k system is re-diagonalised on all r rows (the
        top k spectrum plus r − k zeros), m stays r and the capacity
        shrinks to the bucket holding r + 1.  Uncompacted, the caller
        passes ``min_rows=r`` to every later call until it compacts.  An
        explicit ``capacity`` of r or less raises."""
        kpca = state.kpca
        if compact is None:
            compact = (self.plan.compact_shrink
                       or self.plan.dispatch == "bucketed")
        r = int(kpca.m)
        trunc = self.truncate(kpca, k, compact=False)
        if not compact:
            return state._replace(kpca=trunc)
        M = kpca.L.shape[0]
        cap = (capacity if capacity is not None
               else bucket_for(r + 1, max(M, r + 1), self.plan.min_bucket))
        if cap <= r:
            raise ValueError(
                f"compaction capacity {cap} would drop observed landmark "
                f"rows (row support {r}): Nyström compaction is clamped "
                f"to the row-support floor")
        dtype = kpca.L.dtype
        mask = rankone.active_mask(M, trunc.m)
        Lm = torch.where(mask, trunc.L, 0.0)
        lam, vec = torch.linalg.eigh(((trunc.U * Lm[None, :])
                                      @ trunc.U.T)[:r, :r])
        # Rank <= k: the r - k numerically zero eigenvalues become exact
        # zeros, which the pseudo-inverse deflates.
        tol = r * torch.finfo(dtype).eps * lam.abs().max()
        lam = torch.where(lam.abs() <= tol, 0.0, lam)
        new = _reallocated(kpca, lam, vec, r, cap)
        ncopy = min(cap, M)
        Knm = state.Knm.new_zeros((state.Knm.shape[0], cap))
        Knm[:, :ncopy] = state.Knm[:, :ncopy]
        return state._replace(kpca=new, Knm=Knm)

    def compact(self, state, capacity: int | None = None):
        """Re-express the active eigensystem on its leading m rows and
        re-allocate it at ``capacity`` (default: the smallest bucket
        holding m + 1).  Every consumer reads only the leading m rows of
        the active columns, so re-diagonalising the m×m block of the
        reconstruction is exact for them; after ``truncate`` it also drops
        the mass outside the support, which frees the old bucket."""
        M = state.L.shape[0]
        m = int(state.m)
        cap = (capacity if capacity is not None
               else bucket_for(m + 1, max(M, m + 1), self.plan.min_bucket))
        if cap <= m:
            raise ValueError(f"compaction capacity {cap} cannot hold "
                             f"{m} active pairs plus one update")
        lam, vec = torch.linalg.eigh(
            rankone.reconstruct(state.L, state.U, state.m)[:m, :m])
        return _reallocated(state, lam, vec, m, cap)


def _reallocated(state, lam: Tensor, vec: Tensor, m: int, cap: int):
    """``state`` at capacity ``cap`` with the eigenpairs (lam, vec) of its
    leading m×m block; K1 and X keep their leading rows."""
    dtype, dev = state.L.dtype, state.L.device
    L = torch.zeros((cap,), dtype=dtype, device=dev)
    L[:m] = lam.to(dtype)
    U = torch.eye(cap, dtype=dtype, device=dev)
    U[:m, :m] = vec.to(dtype)
    mm = torch.tensor(m, dtype=state.m.dtype, device=state.m.device)
    L = rankone.sentinelize(L, mm, L.new_zeros(()))
    ncopy = min(cap, state.L.shape[0])
    K1 = state.K1.new_zeros((cap,))
    K1[:ncopy] = state.K1[:ncopy]
    X = state.X.new_zeros((cap,) + tuple(state.X.shape[1:]))
    X[:ncopy] = state.X[:ncopy]
    return state._replace(L=L, U=U, m=mm, K1=K1, X=X)


def _write_bucket_(state, sub, Mb: int):
    """Write an updated bucket ``sub`` of a Nyström state into ``state``'s
    own storage (the donating spelling): the Knm and U blocks, L (its
    sentinels re-placed past a bucket, as ``scatter_state``), K1, X and
    S; returns ``state`` with ``sub``'s m."""
    kp, new = state.kpca, sub.kpca
    state.Knm[:, :Mb].copy_(sub.Knm)
    kp.U[:Mb, :Mb].copy_(new.U)
    kp.L[:Mb].copy_(new.L)
    if Mb < kp.L.shape[0]:
        kp.L.copy_(rankone.sentinelize(kp.L, new.m, kp.L.new_zeros(())))
    kp.K1[:Mb].copy_(new.K1)
    kp.X[:Mb].copy_(new.X)
    kp.S.copy_(new.S)
    return state._replace(kpca=kp._replace(m=new.m))


# ------------------------------------------------ multi-tenant batched steps --
# The reference's vmapped steps (``engine._batched_*``): a tenant-stacked
# state (a leading axis B on every leaf) goes through the same functions as
# one stream, every kernel launched once for the cohort.  A masked step
# selects the whole state per lane, so an inactive (or pad) lane keeps its
# state bit for bit.  ``lax.scan`` becomes a Python loop.

def select_lanes(active: Tensor, new, old):
    """Leaf-wise ``torch.where(active[b], new, old)`` over the tenant axis:
    bit for bit ``old`` where ``active`` is false."""
    def sel(n, o):
        return torch.where(active.reshape(active.shape + (1,) * (o.dim() - 1)),
                           n, o)

    return type(old)(*(sel(n, o) for n, o in zip(new, old)))


def batched_update(states, xs: Tensor, spec: kf.KernelSpec, adjusted: bool,
                   plan: UpdatePlan):
    """Fold xs[b] into tenant b, every tenant active."""
    return _ingest(states, xs, spec, adjusted, plan)


def batched_update_masked(states, xs: Tensor, active: Tensor,
                          spec: kf.KernelSpec, adjusted: bool,
                          plan: UpdatePlan):
    """Fold xs[b] into tenant b where active[b]."""
    return select_lanes(active, _ingest(states, xs, spec, adjusted, plan),
                        states)


def batched_downdate_masked(states, rows: Tensor, active: Tensor,
                            spec: kf.KernelSpec, adjusted: bool,
                            plan: UpdatePlan):
    """Evict row rows[b] from tenant b where active[b] (the decremental
    mirror of ``batched_update_masked``)."""
    from repro_torch.core import downdate as dd

    new = dd.downdate(states, rows, spec, adjusted=adjusted, plan=plan)
    return select_lanes(active, new, states)


def batched_scan(states, xs: Tensor, spec: kf.KernelSpec, adjusted: bool,
                 plan: UpdatePlan):
    """A (T, B, d) block: T steps, B tenants per step."""
    for x_row in xs:
        states = batched_update(states, x_row, spec, adjusted, plan)
    return states


def batched_scan_masked(states, xs: Tensor, active: Tensor,
                        spec: kf.KernelSpec, adjusted: bool,
                        plan: UpdatePlan):
    """A (T, B, d) block under a T-constant tenant mask (padded cohorts,
    whose pad lanes never advance)."""
    for x_row in xs:
        states = batched_update_masked(states, x_row, active, spec, adjusted,
                                       plan)
    return states


def _window_pair(st, victim: Tensor, x_new: Tensor, spec: kf.KernelSpec,
                 adjusted: bool, plan: UpdatePlan):
    """The steady-state evict|ingest pair at m ≡ W: the downdate of the
    victim row, then one Algorithm-1/2 ingest."""
    from repro_torch.core import downdate as dd

    st = dd.downdate(st, victim, spec, adjusted=adjusted, plan=plan)
    return _ingest(st, x_new, spec, adjusted, plan)


def batched_window_scan_masked(states, xs: Tensor, active: Tensor,
                               spec: kf.KernelSpec, adjusted: bool,
                               plan: UpdatePlan):
    """A (T, B, d) block of steady-state window steps: every active tenant
    sits at m ≡ W, evicts its oldest point (physical row 0: the lockstep
    FIFO of ``StreamBatch``) and ingests; ``active`` is T-constant."""
    rows = torch.zeros(states.m.shape, dtype=torch.int32,
                       device=states.m.device)
    for x_row in xs:
        new = _window_pair(states, rows, x_row, spec, adjusted, plan)
        states = select_lanes(active, new, states)
    return states


# ---------------------------------------------------- multi-tenant batch --
class StreamBatch:
    """B independent KPCA streams advanced in lockstep (the reference's
    ``engine.StreamBatch``).

    One tenant-stacked ``KPCAState`` folds a point into every tenant's
    eigendecomposition per step, each of the path's kernels launched once
    for the cohort (the counterpart of the reference's ``jax.vmap``, which
    gives each ``pallas_call`` a batch grid axis), instead of B Python-loop
    dispatches.  Per-tenant active counts m_i may diverge (``active``
    masks).

    Cohort geometry (``cohorts=``):

    * ``"max"`` (default): bucketed dispatch runs the whole cohort at the
      bucket of max_i m_i + 1.
    * ``"bucket"``: tenants are grouped by their own active bucket, one
      batched step per group at that group's M_b; membership migrates at
      bucket crossings (``_regroup``).
    * ``"bucket-padded"``: as ``"bucket"``, with each group's tenant axis
      padded to the next power of two with inert copies of its first
      tenant, masked out of every step and never scattered back.  In JAX
      that bounds recompiles; torch compiles nothing, and the geometry is
      kept as the reference has it.

    Sliding windows (``window=W``): an active tenant at m = W first evicts
    its oldest point by a masked batched downdate of row 0 (lockstep FIFO:
    the eviction permutation keeps the survivors' order, so the oldest
    point is always physical row 0), then ingests.

    The working state is bucket resident: it lives at the cohort or group
    bucket between crossings, the active counts are tracked on the host
    (``_m_host``, exact: every folded point advances its tenant by one),
    and the capacity-M arrays are materialized only at crossings or when
    ``states`` is read.  ``_ceiling`` bounds max_i m_i on the host and is
    re-read from the card only at a crossing or an apparent exhaustion, so
    a step reads nothing back otherwise.

    With ``plan.health.quarantine`` a non-finite point is rejected on the
    host before any device step: its lane drops out of the active mask
    (before the evict mask is formed) and the point is zeroed, so it cannot
    poison the batched step the other lanes ride; ``quarantined`` counts
    them per tenant.  Pass the points as numpy arrays (or host tensors) to
    keep the gate free of reads from the card.  With ``plan.metrics`` a
    ``MetricsState`` of (B,) lanes is updated once per ``update`` /
    ``update_block`` from host-exact tallies.

    x0: (B, m0, d) seed points (one m0 for every tenant).
    """

    def __init__(self, x0, capacity: int, spec: kf.KernelSpec, *,
                 plan: UpdatePlan = DEFAULT_PLAN, adjusted: bool = True,
                 dtype=torch.float32, cohorts: str = "max",
                 window: int | None = None, device=None):
        from repro_torch import resolve_device
        from repro_torch.core import inkpca

        dev = resolve_device(device)
        x0 = torch.as_tensor(x0, device=dev)
        if x0.dim() != 3:
            raise ValueError(f"x0 must be (tenants, m0, d), got "
                             f"{tuple(x0.shape)}")
        state = inkpca.init_state_stacked(x0.to(dtype), capacity, spec,
                                          adjusted=adjusted, dtype=dtype)
        self._setup(state, spec, plan=plan, adjusted=adjusted,
                    cohorts=cohorts, window=window,
                    m0=np.full(x0.shape[0], x0.shape[1], dtype=np.int64))

    @classmethod
    def from_states(cls, states, spec: kf.KernelSpec, *,
                    plan: UpdatePlan = DEFAULT_PLAN, adjusted: bool = True,
                    cohorts: str = "max", window: int | None = None
                    ) -> "StreamBatch":
        """A cohort continuing from a tenant-stacked state (e.g. a
        reference cohort's ``states`` carried across by
        ``convert.stacked_state_from_numpy``); reads the counts once.
        Under a window every tenant's rows must be in arrival order (the
        lockstep FIFO)."""
        self = cls.__new__(cls)
        self._setup(states, spec, plan=plan, adjusted=adjusted,
                    cohorts=cohorts, window=window,
                    m0=states.m.cpu().numpy().astype(np.int64))
        return self

    def _setup(self, state, spec, *, plan, adjusted, cohorts, window, m0):
        check_plan(plan)
        if cohorts not in ("max", "bucket", "bucket-padded"):
            raise ValueError(f"cohorts must be 'max', 'bucket' or "
                             f"'bucket-padded', got {cohorts!r}")
        capacity = state.L.shape[-1]
        if window is None:
            window = plan.window
        if window is not None:
            if not 2 <= window <= capacity:
                raise ValueError(f"window must be in [2, capacity], got "
                                 f"{window} (capacity {capacity})")
            if int(m0.max()) > window:
                raise ValueError(f"seed size {int(m0.max())} exceeds "
                                 f"window {window}")
        self.spec = spec
        self.plan = plan
        self.adjusted = adjusted
        self.capacity = capacity
        self.cohorts = cohorts
        self.window = window
        self.n_tenants = int(state.L.shape[0])
        self.device = state.L.device
        self._full = state
        self._sub = None          # bucket-resident working state ("max")
        self._Mb = capacity
        # Host bound on max_i m_i (exact while every step is fully active;
        # re-read from the card at crossings).
        self._ceiling = int(m0.max())
        # Host-exact per-tenant active counts.
        self._m_host = m0.copy()
        self._groups: list[dict] | None = None
        # Per-tenant tallies: points rejected by the gate, folded, evicted.
        self.quarantined = np.zeros(self.n_tenants, dtype=np.int64)
        self._ingest_host = np.zeros(self.n_tenants, dtype=np.int64)
        self._evict_host = np.zeros(self.n_tenants, dtype=np.int64)
        self._serve_gen = -1
        self.metrics = None
        if plan.metrics:
            from repro_torch.core import telemetry as tm
            self.metrics = tm.init_metrics_stacked(
                self.n_tenants, state.L.dtype, self.device)

    # ---- host <-> device -----------------------------------------------------
    def _index(self, idx) -> Tensor:
        return torch.as_tensor(np.asarray(idx), dtype=torch.long,
                               device=self.device)

    def _mask(self, mask) -> Tensor:
        return torch.as_tensor(np.asarray(mask, bool), device=self.device)

    def _points(self, xs) -> Tensor:
        return torch.as_tensor(xs, device=self.device).to(
            self._full.X.dtype)

    # ---- bucket residency ----------------------------------------------------
    def _flush(self):
        """Scatter the working state back into the capacity-M arrays."""
        if self._sub is not None:
            self._full = (scatter_state(self._full, self._sub)
                          if self._Mb < self.capacity else self._sub)
            self._sub = None
        if self._groups is not None:
            for grp in self._groups:
                self._scatter_group(grp)
            self._groups = None

    @property
    def _grouped(self) -> bool:
        return self.cohorts in ("bucket", "bucket-padded")

    def _tenant_bucket(self, m: int) -> int:
        if self.plan.dispatch != "bucketed":
            return self.capacity
        return bucket_for(min(m + 1, self.capacity), self.capacity,
                          self.plan.min_bucket)

    def _gather_group(self, idx) -> dict:
        Mb = self._tenant_bucket(int(self._m_host[idx].max()))
        n_real = len(idx)
        if self.cohorts == "bucket-padded" and n_real > 0:
            # Pad the tenant axis to the next power of two with inert
            # copies of the first tenant.
            size = 1 << (n_real - 1).bit_length()
            idx_pad = np.concatenate([idx, np.repeat(idx[:1],
                                                     size - n_real)])
        else:
            idx_pad = idx
        at = self._index(idx_pad)
        rows = type(self._full)(*(leaf[at] for leaf in self._full))
        state = slice_state(rows, Mb) if Mb < self.capacity else rows
        return {"Mb": Mb, "idx": idx, "idx_pad": idx_pad, "n_real": n_real,
                "at": at, "at_real": self._index(idx), "state": state}

    def _scatter_group(self, grp) -> None:
        n = grp["n_real"]
        sub = type(self._full)(*(leaf[:n] for leaf in grp["state"]))
        at = grp["at_real"]
        if grp["Mb"] < self.capacity:
            rows = type(self._full)(*(leaf[at] for leaf in self._full))
            sub = scatter_state(rows, sub)
        self._full = type(self._full)(*(
            leaf.index_copy(0, at, r) for leaf, r in zip(self._full, sub)))

    def _group_mask(self, grp, host_mask) -> np.ndarray:
        """A per-tenant host mask on the group's (padded) lanes; pad lanes
        are always inert."""
        out = np.asarray(host_mask)[grp["idx_pad"]].copy()
        out[grp["n_real"]:] = False
        return out

    def _regroup(self):
        """(Re)partition the tenants into bucket-homogeneous groups, only
        when no grouping exists or some tenant's next update would cross
        its group's bucket."""
        if self._groups is not None:
            stale = any(
                self._tenant_bucket(int(self._m_host[g["idx"]].max()))
                != g["Mb"]
                or len({self._tenant_bucket(int(mi))
                        for mi in self._m_host[g["idx"]]}) > 1
                for g in self._groups)
            if not stale:
                return
            for grp in self._groups:
                self._scatter_group(grp)
            self._groups = None
        buckets = np.asarray([self._tenant_bucket(int(mi))
                              for mi in self._m_host])
        self._groups = [self._gather_group(np.nonzero(buckets == b)[0])
                        for b in sorted(set(buckets.tolist()))]

    @property
    def states(self):
        """The capacity-M stacked state (flushes the working bucket; use
        the return value of ``update`` for hot-path reads)."""
        self._flush()
        return self._full

    def _working(self, need: int):
        """The bucket-resident stacked state holding >= ``need`` pairs."""
        Mb = (self.capacity if self.plan.dispatch != "bucketed"
              else bucket_for(need, self.capacity, self.plan.min_bucket))
        if self._sub is None or Mb != self._Mb:
            self._flush()
            self._Mb = Mb
            self._sub = (slice_state(self._full, Mb)
                         if Mb < self.capacity else self._full)
        return self._sub

    def _need(self) -> int:
        """Rows the next update must fit, re-reading the ceiling from the
        card only at a crossing or an apparent exhaustion (idle tenants
        make the ceiling an overestimate)."""
        if self.window is not None:
            # Windows bound every tenant at m <= W <= capacity; an idle
            # tenant parked at m == capacity must not trip the raise.
            return min(self._ceiling + 1, self.capacity)
        resync = self._ceiling + 1 > self.capacity or (
            self.plan.dispatch == "bucketed" and self._sub is not None
            and bucket_for(min(self._ceiling + 1, self.capacity),
                           self.capacity, self.plan.min_bucket) > self._Mb)
        if resync:
            st = self._sub if self._sub is not None else self._full
            self._ceiling = int(st.m.max())
        if self._ceiling + 1 > self.capacity:
            raise ValueError(
                f"tenant at active count {self._ceiling} exhausted capacity "
                f"{self.capacity} — truncate/compact or re-shard the cohort")
        return self._ceiling + 1

    # ---- streaming -------------------------------------------------------------
    def _evict_mask(self, act_host) -> np.ndarray:
        """Tenants whose next active ingest must first evict."""
        if self.window is None:
            return np.zeros(self.n_tenants, bool)
        return act_host & (self._m_host >= self.window)

    def _evict_grouped(self, evict) -> None:
        """Masked batched downdates of row 0, one per group."""
        for grp in self._groups:
            ge = self._group_mask(grp, evict)
            if ge.any():
                rows = torch.zeros(len(grp["idx_pad"]), dtype=torch.int32,
                                   device=self.device)
                grp["state"] = batched_downdate_masked(
                    grp["state"], rows, self._mask(ge), self.spec,
                    self.adjusted, self.plan)
        self._m_host[evict] -= 1
        self._evict_host[evict] += 1
        self._ceiling = int(self._m_host.max())

    def _metrics_begin(self):
        if self.metrics is None:
            return None
        return (self._ingest_host.copy(), self._evict_host.copy(),
                self.quarantined.copy())

    def _metrics_commit(self, snap) -> None:
        from repro_torch.core import telemetry as tm

        if snap is None:
            return
        i0, e0, q0 = snap
        fill = (self._m_host / float(self.window) if self.window is not None
                else np.full(self.n_tenants, tm.GAUGE_UNSET))
        self.metrics = tm.note_lanes(
            self.metrics, self._ingest_host - i0, self.quarantined - q0,
            self._evict_host - e0, self._m_host, fill)

    def metrics_report(self) -> dict:
        """Host snapshot of the metric lanes (one read)."""
        from repro_torch.core import telemetry as tm

        return {} if self.metrics is None else tm.metrics_report(self.metrics)

    def note_skipped_publish(self) -> None:
        """Telemetry hook of the serving loop: a publication was refused on
        health grounds (counted on every lane: the verdict is the
        cohort's)."""
        if self.metrics is not None:
            from repro_torch.core import telemetry as tm
            self.metrics = tm.note_skipped_publish(self.metrics)

    def note_drift(self, drift) -> None:
        """Record the last probed per-tenant spectral drift as a gauge."""
        if self.metrics is not None:
            from repro_torch.core import telemetry as tm
            self.metrics = tm.note_drift(self.metrics,
                                         torch.as_tensor(np.asarray(drift)))

    def update(self, xs, active=None):
        """Fold xs[b] ((B, d)) into tenant b: one batched step per occupied
        bucket (one for ``cohorts="max"``), preceded under a window by one
        masked batched downdate per bucket for the tenants whose window is
        full.  Returns the bucket-resident stacked state (grouped cohorts:
        the largest group's; use ``states``/``state_of`` for full reads)."""
        snap = self._metrics_begin()
        out = self._update_impl(xs, active)
        self._metrics_commit(snap)
        return out

    def _gate(self, xs, act_host, checked: bool):
        """The quarantine gate: (points on the card, active lanes, whether
        any lane was dropped).  ``checked``: the caller already knows the
        points are finite."""
        policy = self.plan.health
        if checked or policy is None or not policy.quarantine:
            return self._points(xs), act_host, False
        host = (xs.detach().cpu().numpy() if torch.is_tensor(xs)
                else np.asarray(xs))
        ok = np.isfinite(host).all(axis=1)
        if ok.all():
            return self._points(xs), act_host, False
        self.quarantined[act_host & ~ok] += 1
        return (self._points(np.where(ok[:, None], host, 0.0)),
                act_host & ok, True)

    def _update_impl(self, xs, active=None, checked: bool = False):
        act_host = (np.ones(self.n_tenants, bool) if active is None
                    else np.asarray(active, bool).copy())
        xs, act_host, dropped = self._gate(xs, act_host, checked)
        masked = active is not None or dropped
        evict = self._evict_mask(act_host)
        if self._grouped:
            self._pending_check(act_host, evict)
            self._regroup()
            if evict.any():
                self._evict_grouped(evict)
            for grp in self._groups:
                at = grp["at"]
                if self.cohorts == "bucket-padded" or masked:
                    ga = self._group_mask(grp, act_host)
                    if ga.any():
                        grp["state"] = batched_update_masked(
                            grp["state"], xs[at], self._mask(ga), self.spec,
                            self.adjusted, self.plan)
                else:
                    grp["state"] = batched_update(
                        grp["state"], xs[at], self.spec, self.adjusted,
                        self.plan)
            self._m_host[act_host] += 1
            self._ingest_host[act_host] += 1
            self._ceiling = int(self._m_host.max())
            return self._groups[-1]["state"]
        if evict.any():
            # One bucket serves the evict and the following update.
            post_max = int((self._m_host - evict).max())
            need = max(int(self._m_host.max()),
                       min(post_max + 1, self.capacity))
            sub = self._working(need)
            rows = torch.zeros(self.n_tenants, dtype=torch.int32,
                               device=self.device)
            self._sub = batched_downdate_masked(
                sub, rows, self._mask(evict), self.spec, self.adjusted,
                self.plan)
            self._m_host[evict] -= 1
            self._evict_host[evict] += 1
            self._ceiling = int(self._m_host.max())
            sub = self._sub
        else:
            sub = self._working(self._need())
        if masked:
            self._sub = batched_update_masked(sub, xs, self._mask(act_host),
                                              self.spec, self.adjusted,
                                              self.plan)
        else:
            self._sub = batched_update(sub, xs, self.spec, self.adjusted,
                                       self.plan)
        self._m_host[act_host] += 1
        self._ingest_host[act_host] += 1
        self._ceiling += 1
        return self._sub

    def _pending_check(self, act_host, evict=None) -> None:
        """Raise on capacity exhaustion before any state changes; tenants
        that evict first grow by nothing."""
        after = self._m_host + act_host
        if evict is not None:
            after = after - evict
        if (after > self.capacity).any():
            raise ValueError(
                f"tenant at active count {int(self._m_host.max())} "
                f"exhausted capacity {self.capacity} — truncate/compact or "
                f"re-shard the cohort")

    def _steady_window_scan(self, xs: Tensor, mask_host):
        """A whole block of evict + ingest pairs for the lanes of
        ``mask_host`` (each at m ≡ W), one scan per cohort group; other
        lanes pass through untouched."""
        mk = np.asarray(mask_host, bool)
        self._ingest_host[mk] += int(xs.shape[0])
        self._evict_host[mk] += int(xs.shape[0])
        if self._grouped:
            self._regroup()
            out = None
            for grp in self._groups:
                ga = self._group_mask(grp, mk)
                if ga.any():
                    grp["state"] = batched_window_scan_masked(
                        grp["state"], xs[:, grp["at"]], self._mask(ga),
                        self.spec, self.adjusted, self.plan)
                    out = grp["state"]
            return out if out is not None else self._groups[-1]["state"]
        sub = self._working(max(int(self._m_host.max()), 1))
        self._sub = batched_window_scan_masked(
            sub, xs, self._mask(mk), self.spec, self.adjusted, self.plan)
        return self._sub

    def update_block(self, xs):
        """Fold a (T, B, d) block.  Chunks are cut at bucket crossings (any
        group's in grouped cohorts).  Under a window the lanes split: those
        already at m ≡ W fold the whole block as evict + ingest pairs in one
        scan per group, the growing lanes step point by point until they
        reach W and then scan too.  Under ``plan.health.quarantine`` the
        block is cut at the steps that carry a non-finite point, which go
        through ``update``'s gate."""
        snap = self._metrics_begin()
        out = self._update_block_impl(xs)
        self._metrics_commit(snap)
        return out

    def _update_block_impl(self, xs):
        policy = self.plan.health
        T = xs.shape[0]
        if policy is not None and policy.quarantine:
            host = (xs.detach().cpu().numpy() if torch.is_tensor(xs)
                    else np.asarray(xs))
            finite = np.isfinite(host).all(axis=(1, 2))
            if not finite.all():
                out, i = None, 0
                while i < T:
                    if finite[i]:
                        j = i + 1
                        while j < T and finite[j]:
                            j += 1
                        out = self._update_block_clean(
                            self._points(host[i:j]))
                        i = j
                    else:
                        out = self._update_impl(host[i])
                        i += 1
                return out
        return self._update_block_clean(self._points(xs))

    def _update_block_clean(self, xs: Tensor):
        """``update_block`` on an all-finite block on the card."""
        T = xs.shape[0]
        if self.window is not None:
            steady = self._m_host >= self.window
            grow = ~steady
            out = None
            if steady.any():
                out = self._steady_window_scan(xs, steady)
            if grow.any():
                act = None if not steady.any() else grow
                t = 0
                while t < T and int(self._m_host[grow].min()) < self.window:
                    out = self._update_impl(xs[t], active=act, checked=True)
                    t += 1
                if t < T:
                    out = self._steady_window_scan(xs[t:], grow)
            return out
        i = 0
        if self._grouped:
            ones = np.ones(self.n_tenants, bool)
            while i < T:
                self._pending_check(ones)
                self._regroup()
                take = min(min(g["Mb"] - int(self._m_host[g["idx"]].max())
                               for g in self._groups), T - i)
                for grp in self._groups:
                    blk = xs[i:i + take][:, grp["at"]]
                    if self.cohorts == "bucket-padded":
                        ga = self._mask(self._group_mask(grp, ones))
                        grp["state"] = batched_scan_masked(
                            grp["state"], blk, ga, self.spec, self.adjusted,
                            self.plan)
                    else:
                        grp["state"] = batched_scan(
                            grp["state"], blk, self.spec, self.adjusted,
                            self.plan)
                self._m_host += take
                self._ingest_host += take
                i += take
            self._ceiling = int(self._m_host.max())
            return self._groups[-1]["state"]
        while i < T:
            sub = self._working(self._need())
            # Chunk at the working bucket even at the capacity rung, so
            # _need() raises on exhaustion instead of writing past it.
            take = min(self._Mb - self._ceiling, T - i)
            self._sub = batched_scan(sub, xs[i:i + take], self.spec,
                                     self.adjusted, self.plan)
            self._ceiling += take
            self._m_host += take
            self._ingest_host += take
            i += take
        return self._sub

    # ---- reads -----------------------------------------------------------------
    def transform(self, q, n_components: int) -> Tensor:
        """Project per-tenant query batches q: (B, nq, d) -> (B, nq, k),
        one batched transform per occupied bucket: publish-then-query, as
        ``transform_state`` (under ``plan.fuse_krow`` one
        ``transform_project`` launch per group), so a transform equals
        ``serving.query_batch`` on ``publish``'s snapshots bit for bit."""
        from repro_torch.core import serving

        q = self._points(q)

        def fn(st, x):
            snap = serving.publish_transform(st, n_components=n_components,
                                             adjusted=self.adjusted)
            return serving.query_batch(snap, x, spec=self.spec,
                                       plan=self.plan)

        if self._grouped and self._groups is not None:
            out = None
            for grp in self._groups:
                yg = fn(grp["state"], q[grp["at"]])[:grp["n_real"]]
                if out is None:
                    out = yg.new_zeros((self.n_tenants,) + yg.shape[1:])
                out = out.index_copy(0, grp["at_real"], yg)
            return out
        return fn(self._sub if self._sub is not None else self._full, q)

    def working_states(self) -> list:
        """The bucket-resident working state(s), without a flush: one per
        occupied group (grouped cohorts), else the cohort's."""
        if self._grouped and self._groups is not None:
            return [g["state"] for g in self._groups]
        return [self._sub if self._sub is not None else self._full]

    def health_summary(self) -> dict:
        """The quarantine tally: total and per tenant."""
        return {"quarantined": int(self.quarantined.sum()),
                "quarantined_per_tenant": self.quarantined.copy()}

    def _parts(self) -> list:
        """(working state, tenant ids of its first lanes) per occupied
        group (grouped cohorts), else the cohort's, without a flush."""
        if self._grouped and self._groups is not None:
            return [(g["state"], g["idx"]) for g in self._groups]
        return [(self._sub if self._sub is not None else self._full,
                 np.arange(self.n_tenants))]

    def top_spectra(self, C: int) -> Tensor:
        """(B, C) each tenant's descending top-C active eigenvalues
        (``health.top_spectrum``), without a flush: the drift reference a
        serving loop freezes at a publication."""
        from repro_torch.core import health as hl
        from repro_torch.core.inkpca import unstack_state

        out = None
        for st, idx in self._parts():
            lam = torch.stack([hl.top_spectrum(unstack_state(st, j), C)
                               for j in range(len(idx))])
            if out is None:
                out = lam.new_zeros((self.n_tenants, C))
            out[torch.as_tensor(idx, device=self.device)] = lam
        return out

    def stored_finite(self) -> np.ndarray:
        """Host (B,) flags: tenant b's stored active points X[:m_b] are all
        finite.  Where one is not, the heal ladder raises
        ``health.HealthError`` for that tenant (``health._check_stored``):
        a caller that must not catch decides on this predicate first."""
        st = self.states
        finite = torch.isfinite(st.X).all(dim=-1)
        rows = torch.arange(st.X.shape[-2], device=self.device)
        return (finite | (rows >= st.m[:, None])).all(dim=-1).cpu().numpy()

    def probe_all(self, ref_lam=None):
        """A health probe of every tenant's working state, without a flush.
        Returns host arrays ``(healthy, drift)`` of shape (B,); ``drift``
        is None unless ``ref_lam`` ((B, C), the spectrum recorded at the
        last publication) is given.  The probe runs per tenant
        (``health.probe``, ROADMAP.md §1b), and the verdicts come back in
        one read."""
        from repro_torch.core import health as hl
        from repro_torch.core.inkpca import unstack_state

        policy = self.plan.health or hl.DEFAULT_POLICY
        healthy = np.zeros(self.n_tenants, bool)
        drift = None if ref_lam is None else np.zeros(self.n_tenants)
        ref = None if ref_lam is None else torch.as_tensor(
            ref_lam, device=self.device)
        for st, idx in self._parts():
            oks, drs = [], []
            for j, tenant in enumerate(idx):
                one = unstack_state(st, j)
                h = hl.probe(one, hl.init_health(one.L.dtype, self.device),
                             policy)
                oks.append(hl.verdict(h, policy))
                if ref is not None:
                    drs.append(hl.spectral_drift(one, ref[tenant].to(
                        one.L.dtype)))
            healthy[idx] = torch.stack(oks).cpu().numpy()
            if ref is not None:
                drift[idx] = torch.stack(drs).double().cpu().numpy()
        return healthy, drift

    def heal(self, *, level: str = "auto") -> int:
        """Walk the heal ladder (``health.heal_kpca``) over the cohort:
        probe every tenant, flush, and heal the unhealthy ones ("auto"; a
        forced ``level`` heals all).  Returns the number healed;
        ``health.HealthError`` propagates to the caller, who owns the
        checkpoints."""
        from repro_torch.core import health as hl
        from repro_torch.core.inkpca import unstack_state

        policy = self.plan.health or hl.DEFAULT_POLICY
        if level == "auto":
            healthy, _ = self.probe_all()
            todo = np.nonzero(~healthy)[0]
        else:
            todo = np.arange(self.n_tenants)
        if len(todo) == 0:
            return 0
        self._flush()
        full = self._full
        rungs = np.zeros((2, self.n_tenants), np.int64)   # polish / resync
        for i in todo:
            rung_out: list = []
            st = hl.heal_kpca(unstack_state(full, int(i)), self.spec,
                              self.adjusted, policy, level=level,
                              rung_out=rung_out)
            if rung_out and rung_out[-1] in ("polish", "resync"):
                rungs[0 if rung_out[-1] == "polish" else 1, int(i)] += 1
            at = self._index([int(i)])
            full = type(full)(*(leaf.index_copy(0, at, s[None])
                                for leaf, s in zip(full, st)))
        self._full = full
        if self.metrics is not None and rungs.any():
            dev = self.metrics.heals_polish.device
            self.metrics = self.metrics._replace(
                heals_polish=self.metrics.heals_polish + torch.as_tensor(
                    rungs[0], dtype=torch.int32, device=dev),
                heals_resync=self.metrics.heals_resync + torch.as_tensor(
                    rungs[1], dtype=torch.int32, device=dev))
        return len(todo)

    def publish(self, n_components: int | None = None):
        """Tenant-stacked ``serving.ServingSnapshot``s of the current
        working state (width ``plan.serve_components`` by default): "max"
        cohorts publish from the bucket-resident state, grouped cohorts
        flush first so one stacked snapshot covers every tenant."""
        from repro_torch.core import serving

        nc = int(self.plan.serve_components if n_components is None
                 else n_components)
        self._serve_gen += 1
        if self.metrics is not None:
            from repro_torch.core import telemetry as tm
            self.metrics = tm.note_publish(self.metrics, self._serve_gen)
        st = (self.states if self._grouped
              else self._sub if self._sub is not None else self._full)
        return serving.publish_transform(st, n_components=nc,
                                         adjusted=self.adjusted,
                                         generation=self._serve_gen)

    def state_of(self, i: int):
        """Tenant i's capacity-M state."""
        from repro_torch.core.inkpca import unstack_state

        return unstack_state(self.states, i)
