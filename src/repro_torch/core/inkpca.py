"""Incremental kernel PCA (paper §3, Algorithms 1 & 2).

* ``update_unadjusted`` — Algorithm 1: expansion + 2 rank-one updates of
  the raw kernel matrix K.
* ``update_adjusted``   — Algorithm 2: 2 mean-adjustment updates of K',
  then expansion + 2 updates for the new row/column.
* ``ingest_*``          — the same with the fused prologue
  (``plan.fuse_krow``): one ``krow_project`` pass produces the kernel row
  and its projections, and Algorithm 2's second pair is projected by one
  ``eigvec_project`` pass.

``KPCAStream`` is the user-facing driver.  Its state lives on one device
(``cuda`` unless the caller passes ``device="cpu"``) and it keeps a host
mirror of the active count for bucket selection.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import engine as eng
from repro_torch.core import kernels_fn as kf
from repro_torch.core import rankone
from repro_torch.core.rankone import index_get, index_set

Tensor = torch.Tensor


class KPCAState(NamedTuple):
    """Fixed-capacity incremental KPCA state.

    L:  (M,)   eigenvalues (ascending; sentinels above the active spectrum)
    U:  (M,M)  eigenvectors in columns (identity on inactive columns)
    m:  ()     active count (int32, on the state's device)
    S:  ()     sum of all entries of the *unadjusted* K_mm          (Alg. 2)
    K1: (M,)   row sums K_mm @ 1_m, zero-padded                     (Alg. 2)
    X:  (M,d)  stored data points (needed to evaluate kernel rows)
    """

    L: Tensor
    U: Tensor
    m: Tensor
    S: Tensor
    K1: Tensor
    X: Tensor


def init_state(x0: Tensor, capacity: int, spec: kf.KernelSpec, *,
               adjusted: bool, dtype=torch.float32) -> KPCAState:
    """Batch-initialize from m0 >= 1 seed points (eigh of the small gram)
    on x0's device."""
    m0, d = x0.shape
    if not 1 <= m0 <= capacity:
        raise ValueError(f"need 1..{capacity} seed points, got {m0}")
    dev = x0.device
    x0 = x0.to(dtype)
    K0 = kf.gram_block(x0, x0, spec=spec)
    S = torch.sum(K0)
    K1 = torch.sum(K0, dim=1)
    Keff = kf.center_gram(K0) if adjusted else K0
    lam, vec = torch.linalg.eigh(Keff)

    M = capacity
    L = torch.zeros((M,), dtype=dtype, device=dev)
    U = torch.eye(M, dtype=dtype, device=dev)
    L[:m0] = lam
    U[:m0, :m0] = vec
    m = torch.tensor(m0, dtype=torch.int32, device=dev)
    L = rankone.sentinelize(L, m, L.new_zeros(()))
    X = torch.zeros((M, d), dtype=dtype, device=dev)
    X[:m0] = x0
    K1p = torch.zeros((M,), dtype=dtype, device=dev)
    K1p[:m0] = K1
    return KPCAState(L=L, U=U, m=m, S=S, K1=K1p, X=X)


def update_unadjusted(state: KPCAState, a: Tensor, k_new: Tensor,
                      x_new: Tensor, *,
                      plan: eng.UpdatePlan = eng.DEFAULT_PLAN) -> KPCAState:
    """Algorithm 1: K_{m,m} -> K_{m+1,m+1} via expansion + 2 rank-one
    updates."""
    M = state.L.shape[0]
    m = state.m
    kn = torch.clamp_min(k_new, torch.finfo(state.L.dtype).tiny)

    sum_a = torch.sum(a)
    S2 = state.S + 2.0 * sum_a + k_new
    K1 = torch.where(rankone.active_mask(M, m), state.K1 + a, 0.0)
    K1 = index_set(K1, m, sum_a + k_new)
    X = index_set(state.X, m, x_new)

    # Expansion: eigenpair (k/4, e_m), then the two updates of eq. (2).
    L, U, m1 = rankone.expand_eigensystem(state.L, state.U, kn / 4.0, m)
    v1 = index_set(a, m, kn / 2.0)
    v2 = index_set(a, m, kn / 4.0)
    sigma = 4.0 / kn
    L, U = eng.apply_pair(L, U, v1, sigma, v2, -sigma, m1, plan=plan)
    return KPCAState(L=L, U=U, m=m1, S=S2, K1=K1, X=X)


def _centered_column(a: Tensor, k_new: Tensor, K1: Tensor, S2: Tensor,
                     m: Tensor, mf: Tensor) -> tuple[Tensor, Tensor]:
    """Algorithm 2 step 3: the new centered row/column v (paper line 10)
    and its guarded corner v0."""
    M = a.shape[0]
    dtype = a.dtype
    k_vec = index_set(a, m, k_new)
    m_new_f = mf + 1.0
    v = k_vec - (torch.sum(k_vec) + K1 - S2 / m_new_f) / m_new_f
    v = torch.where(rankone.active_mask(M, m + 1), v, 0.0)
    v0 = index_get(v, m)
    eps = torch.finfo(dtype).eps
    v0 = torch.where(v0.abs() < eps, eps, v0)      # sigma = 4/v0 guard
    return v, v0


def update_adjusted(state: KPCAState, a: Tensor, k_new: Tensor,
                    x_new: Tensor, *,
                    plan: eng.UpdatePlan = eng.DEFAULT_PLAN) -> KPCAState:
    """Algorithm 2: K'_{m,m} -> K'_{m+1,m+1} via 4 rank-one updates.

    Follows the paper's derivation (§3.1.2); Alg. 2 line 4 contains an
    erratum (the square on m(m+1)) — the derived
    u = K1/(m(m+1)) - a/(m+1) + C/2 · 1_m is used.
    """
    M = state.L.shape[0]
    m = state.m
    dtype = state.L.dtype
    mf = m.to(dtype)
    mask_m = rankone.active_mask(M, m)

    # --- Step 1: mean-adjustment of the existing m×m block (2 updates). ---
    sum_a = torch.sum(a)
    S2 = state.S + 2.0 * sum_a + k_new
    C = -state.S / mf**2 + S2 / (mf + 1.0) ** 2
    u = state.K1 / (mf * (mf + 1.0)) - a / (mf + 1.0) + 0.5 * C
    u = torch.where(mask_m, u, 0.0)
    ones_u_p = torch.where(mask_m, 1.0 + u, 0.0)
    ones_u_m = torch.where(mask_m, 1.0 - u, 0.0)
    half = a.new_full((), 0.5)          # a fill, not a host copy
    L, U = eng.apply_pair(state.L, state.U, ones_u_p, half, ones_u_m, -half,
                          m, plan=plan)

    # --- Step 2: bookkeeping updates (paper lines 7-9). ---
    K1 = torch.where(mask_m, state.K1 + a, 0.0)
    K1 = index_set(K1, m, sum_a + k_new)

    # --- Steps 3-4: new centered column, expansion + 2 updates (eq. 3). ---
    v, v0 = _centered_column(a, k_new, K1, S2, m, mf)
    L, U, m1 = rankone.expand_eigensystem(L, U, v0 / 4.0, m)
    v1 = index_set(v, m, v0 / 2.0)
    v2 = index_set(v, m, v0 / 4.0)
    sigma = 4.0 / v0
    L, U = eng.apply_pair(L, U, v1, sigma, v2, -sigma, m1, plan=plan)

    X = index_set(state.X, m, x_new)
    return KPCAState(L=L, U=U, m=m1, S=S2, K1=K1, X=X)


# ------------------------------------------------------------ fused ingest --
# The ingest_* variants run the fused ``krow_project`` prologue: ONE pass
# over U produces the masked row a AND the projections of every update
# vector that lives in the pre-update basis.  The z vectors handed to
# ``eng.apply_pair`` are exact identities:
#
# * pre-expansion, Uᵀe_m = e_m (column m is an identity column and active
#   columns vanish on row m), so the expansion pair's projections are
#   z = (Uᵀa).at[m].set(kn/2 | kn/4) permuted by the expansion sort;
# * Algorithm 2's mean-adjustment vectors 1±u are affine in (a, 1_m, K1),
#   so their projections are the same affine combination of the three
#   projected columns.
#
# Algorithm 2's second (expansion) pair lives in the rotated basis U₁, so
# its projection is one pruned ``eigvec_project`` pass (Uᵀ[v₁|v₂]).


def ingest_unadjusted(state: KPCAState, x_new: Tensor, *,
                      spec: kf.KernelSpec,
                      plan: eng.UpdatePlan = eng.DEFAULT_PLAN) -> KPCAState:
    """Algorithm 1 with the fused kernel-row prologue (plan.fuse_krow)."""
    from repro_torch.kernels.rbf_gram import ops as kops

    M = state.L.shape[0]
    m = state.m
    dtype = state.L.dtype
    x_new = x_new.to(state.X.dtype)
    k_new = kf.kernel_diag(x_new[None], spec=spec)[0].to(dtype)
    kn = torch.clamp_min(k_new, torch.finfo(dtype).tiny)

    aux = state.U.new_zeros((M, 0))
    a, P = kops.krow_project(state.U, state.X, x_new, aux, m, spec=spec)
    p = P[:, 0]                                     # Uᵀa, pre-expansion

    sum_a = torch.sum(a)
    S2 = state.S + 2.0 * sum_a + k_new
    K1 = torch.where(rankone.active_mask(M, m), state.K1 + a, 0.0)
    K1 = index_set(K1, m, sum_a + k_new)
    X = index_set(state.X, m, x_new)

    L, perm, m1 = rankone.expand_eigensystem_perm(state.L, kn / 4.0, m)
    U = state.U[:, perm]
    v1 = index_set(a, m, kn / 2.0)
    v2 = index_set(a, m, kn / 4.0)
    z1 = index_set(p, m, kn / 2.0)[perm]
    z2 = index_set(p, m, kn / 4.0)[perm]
    sigma = 4.0 / kn
    L, U = eng.apply_pair(L, U, v1, sigma, v2, -sigma, m1, plan=plan,
                          z1=z1, z2=z2)
    return KPCAState(L=L, U=U, m=m1, S=S2, K1=K1, X=X)


def ingest_adjusted(state: KPCAState, x_new: Tensor, *,
                    spec: kf.KernelSpec,
                    plan: eng.UpdatePlan = eng.DEFAULT_PLAN) -> KPCAState:
    """Algorithm 2 with the fused kernel-row prologue (plan.fuse_krow)."""
    from repro_torch.kernels.eigvec_update import ops as eops
    from repro_torch.kernels.rbf_gram import ops as kops

    M = state.L.shape[0]
    m = state.m
    dtype = state.L.dtype
    mf = m.to(dtype)
    mask_m = rankone.active_mask(M, m)
    x_new = x_new.to(state.X.dtype)
    k_new = kf.kernel_diag(x_new[None], spec=spec)[0].to(dtype)

    # One fused pass: a plus Uᵀ[a | 1_m | K1] (the kernel masks rows >= m).
    aux = torch.stack([torch.ones_like(state.K1), state.K1], dim=1)
    a, P = kops.krow_project(state.U, state.X, x_new, aux, m, spec=spec)
    pa, p1, pk1 = P[:, 0], P[:, 1], P[:, 2]

    # --- Step 1: mean-adjustment of the existing m×m block (2 updates). ---
    sum_a = torch.sum(a)
    S2 = state.S + 2.0 * sum_a + k_new
    C = -state.S / mf**2 + S2 / (mf + 1.0) ** 2
    u = state.K1 / (mf * (mf + 1.0)) - a / (mf + 1.0) + 0.5 * C
    u = torch.where(mask_m, u, 0.0)
    ones_u_p = torch.where(mask_m, 1.0 + u, 0.0)
    ones_u_m = torch.where(mask_m, 1.0 - u, 0.0)
    zu = pk1 / (mf * (mf + 1.0)) - pa / (mf + 1.0) + 0.5 * C * p1
    half = a.new_full((), 0.5)          # a fill, not a host copy
    L, U = eng.apply_pair(state.L, state.U, ones_u_p, half, ones_u_m, -half,
                          m, plan=plan, z1=p1 + zu, z2=p1 - zu)

    # --- Steps 2-4: as ``update_adjusted``, the expansion pair projected
    # against the rotated U₁ by one pruned pass. ---
    K1 = torch.where(mask_m, state.K1 + a, 0.0)
    K1 = index_set(K1, m, sum_a + k_new)
    v, v0 = _centered_column(a, k_new, K1, S2, m, mf)
    L, U, m1 = rankone.expand_eigensystem(L, U, v0 / 4.0, m)
    v1 = index_set(v, m, v0 / 2.0)
    v2 = index_set(v, m, v0 / 4.0)
    sigma = 4.0 / v0
    Z = eops.project_vectors(U, torch.stack([v1, v2], dim=1), m1)
    L, U = eng.apply_pair(L, U, v1, sigma, v2, -sigma, m1, plan=plan,
                          z1=Z[:, 0], z2=Z[:, 1])

    X = index_set(state.X, m, x_new)
    return KPCAState(L=L, U=U, m=m1, S=S2, K1=K1, X=X)


class KPCAStream:
    """User-facing streaming driver — a thin shell over ``engine.Engine``.

    Dispatch decisions live in the ``UpdatePlan``; pass one via ``plan=``
    or use the keyword spellings (``method``/``matmul``/``iters``/
    ``dispatch``/``min_bucket``/``window``), folded into a plan here.  ``m``
    is the host mirror of the active count.  On CUDA a plan with
    ``fuse_krow`` needs a kernel the fused epilogues implement (RBF,
    Matern-3/2).

    ``window=W`` makes the stream a sliding window over the trailing W
    points: past a full window each new point first evicts the oldest one
    (``core/downdate.py``).  ``self.state`` is then a
    ``window.WindowState`` (the eigensystem plus the FIFO arrival ring);
    ``kpca_state`` is always the inner ``KPCAState``.
    """

    def __init__(self, x0, capacity: int, spec: kf.KernelSpec, *,
                 adjusted: bool = True, plan: eng.UpdatePlan | None = None,
                 method: str = "gu", matmul: str = "jnp",
                 iters: int | None = None, dtype=torch.float32,
                 dispatch: str = "fixed", min_bucket: int | None = None,
                 window: int | None = None, device=None):
        from repro_torch.core import window as wnd

        self.device = resolve_device(device)
        if plan is None:
            plan = eng.UpdatePlan(
                method=method, matmul=matmul, iters=iters, dispatch=dispatch,
                min_bucket=(min_bucket if min_bucket is not None
                            else eng.DEFAULT_MIN_BUCKET),
                window=window)
        if window is None:
            window = plan.window
        self.engine = eng.Engine(spec, plan, adjusted=adjusted)
        if self.device.type == "cuda" and plan.fuse_krow:
            from repro_torch.kernels.rbf_gram.ops import fused_kind
            fused_kind(spec, "KPCAStream(fuse_krow=True)")
        self.spec = spec
        self.adjusted = adjusted
        self.plan = plan
        self.window = window
        x0 = torch.as_tensor(x0, device=self.device)
        self.m = int(x0.shape[0])
        if window is not None:
            if not 2 <= window <= capacity:
                raise ValueError(f"window must be in [2, capacity], got "
                                 f"{window} (capacity {capacity})")
            if self.m > window:
                raise ValueError(f"seed size {self.m} exceeds window "
                                 f"{window}")
            self.state = wnd.init_window(x0, capacity, spec,
                                         adjusted=adjusted, dtype=dtype)
        else:
            self.state = init_state(x0, capacity, spec, adjusted=adjusted,
                                    dtype=dtype)

    @property
    def kpca_state(self) -> KPCAState:
        """The eigensystem state, windowed or not."""
        return self.state.kpca if self.window is not None else self.state

    def _bundle(self) -> eng.StreamState:
        return eng.make_stream(self.state)

    def _unbundle(self, s: eng.StreamState):
        """Write an advanced bundle back; returns ``self.state``."""
        if self.window is not None:
            from repro_torch.core import window as wnd
            self.state = wnd.WindowState(kpca=s.kpca, ages=s.ages,
                                         clock=s.clock)
        else:
            self.state = s.kpca
        return self.state

    def _grown(self, count: int) -> int:
        m = self.m + count
        return m if self.window is None else min(m, self.window)

    def update(self, x_new):
        """Fold one point into the stream (evicting the oldest first when a
        window is full)."""
        x_new = torch.as_tensor(x_new, dtype=self.kpca_state.X.dtype,
                                device=self.device)
        self._unbundle(self.engine.step(self._bundle(), x_new,
                                        window=self.window, m=self.m))
        self.m = self._grown(1)
        return self.state

    def downdate(self, i: int):
        """Remove the point in physical row ``i`` from the stream."""
        if self.window is not None:
            from repro_torch.core import window as wnd
            self.state = wnd.evict(self.engine, self.state, i, m=self.m)
        else:
            self.state = self.engine.downdate(self.state, i, m=self.m)
        self.m -= 1
        return self.state

    def update_block(self, xs):
        """Fold a (T, d) block: ``Engine.step_block``, a loop over the
        per-point step."""
        xs = torch.as_tensor(xs, dtype=self.kpca_state.X.dtype,
                             device=self.device)
        self._unbundle(self.engine.step_block(self._bundle(), xs,
                                              window=self.window))
        self.m = self._grown(xs.shape[0])
        return self.state

    partial_fit_block = update_block

    def truncate(self, k: int, *, compact: bool | None = None):
        """Keeping only the k dominant eigenpairs is not ported yet
        (ROADMAP.md, Open items §1 item 5); on a windowed stream it is
        refused outright, as in the reference: the window bounds the
        state."""
        if self.window is not None:
            raise ValueError("truncate is not supported on a windowed "
                             "stream — the window itself bounds the state")
        raise NotImplementedError("truncate is not ported yet: ROADMAP.md, "
                                  "Open items §1 item 5")

    def eigpairs(self) -> tuple[Tensor, Tensor]:
        """Active (descending) eigenvalues and eigenvectors."""
        return eng.eigpairs(self.kpca_state)

    def reconstruction(self) -> Tensor:
        st = self.kpca_state
        return rankone.reconstruct(st.L, st.U, st.m)

    def transform(self, x, n_components: int) -> Tensor:
        """Project new points on the leading kernel principal components.

        Under ``plan.fuse_krow`` with bucketed dispatch the state is first
        sliced to the smallest bucket holding the active set (lossless),
        so the fused transform costs O(Q·m_b·(d+k)), not O(Q·M·(d+k))."""
        st = self.kpca_state
        x = torch.as_tensor(x, dtype=st.X.dtype, device=self.device)
        if self.plan.fuse_krow and self.plan.dispatch == "bucketed":
            need = max(self.m, n_components, 1)
            Mb = eng.bucket_for(need, st.L.shape[0], self.plan.min_bucket)
            if Mb < st.L.shape[0]:
                st = eng.slice_state(st, Mb)
        return eng.transform_state(st, x, spec=self.spec,
                                   adjusted=self.adjusted,
                                   n_components=n_components, plan=self.plan)
