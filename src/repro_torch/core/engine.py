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
