"""Each CUDA kernel against its plain version, on the card.

``cases(n, m, dtype, device)`` builds, for every kernel of the KPCA path,
the inputs the main path hands it at capacity-bucket ``n`` with ``m``
active pairs (a real solved rotation factor or fused pair with deflated
columns, an orthonormal active block of U, stored points and queries as
the service draws them), and ``gram_cases(n, k, dtype, device)`` those of
the Nyström reconstruction (B of n rows and width k), and
``rbf_gram_cases(n, m, dim, dtype, device)`` those of the dense RBF gram
(the roofline's k(X, X) where n = m); each returns a
``Case`` per kernel: the kernel call, its plain version, the one PyTorch
call that computes the same function where there is one, the tolerance
the comparison is held to and why, and the bound on its time.
``compare`` runs both versions and checks them.  Used by
``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.

Tolerances are per output entry, from the componentwise forward error
bound of a length-K dot product (Higham's gamma_K = K·eps per term
magnitude): two evaluations that each accumulate in the working type
differ at entry (i, j) by at most 2(K+2)·eps·(|A|·|B|)_ij, plus the
propagated error of a kernel epilogue where one is evaluated (its
Lipschitz constant in d2 times the rounding of the norm expansion, entry
by entry).  Each entry is held to its own bound, so a small column (the
k-row projection's Uᵀa beside Uᵀk1) is not judged by a large one.

Time bounds use the H100 SXM data sheet at 700 W: 3.35 TB/s of HBM,
67 TFLOP/s in float32 (CUDA cores; TF32 is not allowed) and 67 TFLOP/s in
float64 (the FP64 tensor cores, full IEEE float64; a bound takes the
card's peak for the type, whatever unit the kernel uses).  Bytes count
each input read once and each output written once; operations count what
these inputs need (the active m, not the capacity).

Times are device times: ``device_ms`` reads the kernels' own start and end
from the profiler's CUDA activity records (CUPTI), so the host's work in a
wrapper (operand checks, allocation, the ctypes call) is not counted.
``call_ms`` times whole calls between two CUDA events, host work and
launch latency included, as the main path pays them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import engine, kernels_fn as kf, rankone
from repro_torch.kernels.eigvec_update import ops as eops
from repro_torch.kernels.eigvec_update import ref as eref
from repro_torch.kernels.nystrom_recon import ops as nops
from repro_torch.kernels.nystrom_recon import ref as nref
from repro_torch.kernels.nystrom_recon.ref import transform_project_ref
from repro_torch.kernels.rbf_gram import ops as kops
from repro_torch.kernels.rbf_gram.ref import krow_project_ref, rbf_gram_ref

Tensor = torch.Tensor

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}

SOURCES = {
    "eigvec_rotate": ("src/repro_torch/kernels/csrc/eigvec_rotate.cu",
                      "src/repro/kernels/eigvec_update/eigvec_update.py:118"),
    "eigvec_rotate2": ("src/repro_torch/kernels/csrc/eigvec_rotate2.cu",
                       "src/repro/kernels/eigvec_update/eigvec_update.py:360"),
    "eigvec_project": ("src/repro_torch/kernels/csrc/eigvec_project.cu",
                       "src/repro/kernels/eigvec_update/eigvec_update.py:217"),
    "krow_project": ("src/repro_torch/kernels/csrc/krow_project.cu",
                     "src/repro/kernels/rbf_gram/krow_fused.py:110"),
    "transform_project": (
        "src/repro_torch/kernels/csrc/transform_project.cu",
        "src/repro/kernels/nystrom_recon/transform_batch.py:72"),
    "scaled_gram": ("src/repro_torch/kernels/csrc/scaled_gram.cu",
                    "src/repro/kernels/nystrom_recon/nystrom_recon.py:39"),
    "rbf_gram": ("src/repro_torch/kernels/csrc/rbf_gram.cu",
                 "src/repro/kernels/rbf_gram/rbf_gram.py:46"),
}

N_QUERIES, N_COMPONENTS, DIM = 64, 8, 16


@dataclass
class Case:
    name: str
    kernel: Callable[[], tuple]
    plain: Callable[[], tuple]
    library: Callable[[], object] | None
    tols: tuple[Tensor, ...]       # per entry, one per output
    tol_reason: str
    bytes: float
    flops: float
    exact_zero: Tensor | None = None   # mask of output 0 the kernel prunes
    keep: Tensor | None = None         # columns of output 0 the caller keeps

    def bound(self, dtype) -> tuple[float, str]:
        """(least time in ms, what bounds it) on an H100 SXM at 700 W."""
        t_bytes = self.bytes / HBM_BYTES_PER_S
        t_ops = self.flops / PEAK_FLOPS[dtype]
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")


def _gamma(K: int, dtype) -> float:
    return 2.0 * (K + 2) * torch.finfo(dtype).eps


def _state(n: int, m: int, dtype, device, seed: int):
    """An orthonormal active block of U (identity beyond m), a decaying
    spectrum L with sentinels above it, stored points X (zero beyond m)."""
    rng = np.random.default_rng(seed)
    U = torch.eye(n, dtype=torch.float64, device=device)
    if m:
        g = torch.as_tensor(rng.normal(size=(m, m)), device=device)
        U[:m, :m] = torch.linalg.qr(g)[0]
    L = torch.zeros(n, dtype=torch.float64, device=device)
    L[:m] = torch.sort(torch.as_tensor(
        np.exp(-np.arange(m) / 40.0) * 50.0, device=device)).values
    mt = torch.tensor(m, dtype=torch.int32, device=device)
    L = rankone.sentinelize(L, mt, L.new_zeros(()))
    X = torch.zeros((n, DIM), dtype=torch.float64, device=device)
    X[:m] = torch.as_tensor(rng.normal(size=(m, DIM)), device=device)
    return U.to(dtype), L.to(dtype), mt, X.to(dtype), rng


def _rotate_case(U, L, m, rng, dtype) -> Case:
    n = U.shape[0]
    mi = int(m)
    mask = rankone.active_mask(n, m)
    v = torch.where(mask, torch.as_tensor(rng.normal(size=n), dtype=dtype,
                                          device=U.device), 0.0)
    z = U.T @ v
    sigma = torch.tensor(0.5, dtype=dtype, device=U.device)
    room = sigma * torch.sum(z * z)
    d_sent = rankone.sentinelize(L, m, room)
    scale = torch.max(torch.abs(torch.where(mask, L, 0.0))) + room + 1e-30
    f = rankone._solve_factor(d_sent, z, sigma, m, scale,
                              iters=engine.resolve_iters(None, dtype),
                              method="gu", precise=True)
    zk, dk, orgk, invk, tauk = rankone.kernel_operands(f, mask, dtype)
    ops = (zk, dk, orgk, invk)
    Wn = eref.eigvec_rotate_ref(torch.eye(n, dtype=dtype, device=U.device),
                                *ops, tauk)             # W * inv, stored
    one = torch.ones(n, dtype=torch.float64, device=U.device)
    W64 = torch.where(~f.defl[None, :], eref.eigvec_rotate_ref(
        torch.diag(one), zk.double(), dk, orgk, one, tauk), 0.0)
    mag = (U.double().abs() @ W64.abs()) * invk.double().abs()
    rows, cols = eref.pruned_region_mask(n, n, mi, block=eops.ROTATE_TILE)
    outside = ~(rows[:, None] & cols[None, :]).to(U.device) & ~f.defl[None, :]
    item = U.element_size()
    return Case(
        name="eigvec_rotate",
        kernel=lambda: (eops.rotate_vectors(U, *ops, m, tau=tauk),),
        plain=lambda: (eref.eigvec_rotate_ref(U, *ops, tauk),),
        library=lambda: torch.matmul(U, Wn),
        tols=(_gamma(mi, dtype) * mag,),
        tol_reason="2(m+2)eps·(|U||W|)_ij·|inv_j| per entry: two length-m "
                   "dot products (Higham gamma_m), W generated in the "
                   "working type",
        bytes=item * (mi * mi + n * n + 4 * n),
        flops=2.0 * mi ** 3 + mi * mi,
        exact_zero=outside,
        # _apply_factor puts U's own column in place of deflated ones.
        keep=~f.defl)


def _rotate2_case(U, L, m, rng, dtype) -> Case:
    """A solved fused pair (sigma = +0.5 then -0.5) whose first update
    deflates every seventh direction (z1 = 0 there), so factor 1 carries
    deflated identity columns e_{cid1[j]} under a permuted cid1."""
    n = U.shape[0]
    mi = int(m)
    mask = rankone.active_mask(n, m)
    z1 = torch.as_tensor(rng.normal(size=n), dtype=dtype, device=U.device)
    z1[torch.arange(n, device=U.device) % 7 == 3] = 0.0
    z1 = torch.where(mask, z1, 0.0)
    z2 = torch.where(mask, torch.as_tensor(rng.normal(size=n), dtype=dtype,
                                           device=U.device), 0.0)
    half = torch.tensor(0.5, dtype=dtype, device=U.device)
    pf = rankone._pair_solve(L, z1, half, z2, -half, m,
                             iters=engine.resolve_iters(None, dtype),
                             method="gu", precise=True)
    ops = (pf.z1.to(dtype), pf.d1, pf.org1, pf.inv1.to(dtype),
           pf.defl1.to(dtype), pf.cid1, pf.z2.to(dtype), pf.d2, pf.org2,
           pf.inv2.to(dtype), pf.defl2.to(dtype), pf.cid2)
    taus = dict(tau1=pf.tau1, tau2=pf.tau2)
    W1 = eref.cauchy_factor_ref(*ops[:6], tau=pf.tau1)
    W2 = eref.cauchy_factor_ref(*ops[6:], tau=pf.tau2)
    mag = (U.double().abs() @ W1.double().abs()) @ W2.double().abs()
    rows, cols = eref.pruned_region_mask(n, n, mi, block=eops.ROTATE2_TILE)
    rows, cols = rows.to(U.device), cols.to(U.device)
    item = U.element_size()
    return Case(
        name="eigvec_rotate2",
        kernel=lambda: (eops.rotate_vectors2(U, *ops, m, **taus),),
        plain=lambda: (eref.eigvec_rotate2_ref(U, *ops, **taus),),
        library=lambda: torch.matmul(torch.matmul(U, W1), W2),
        tols=(_gamma(2 * mi, dtype) * mag,),
        tol_reason="2(2m+2)eps·(|U||W1||W2|)_ij per entry: the second "
                   "length-m product carries the first one's error "
                   "(Higham gamma_m twice), both factors generated in the "
                   "working type alike",
        bytes=item * (mi * mi + n * n + 4 * n) + 8 * 6 * n + 4 * 2 * n,
        flops=4.0 * mi ** 3 + 2.0 * mi * mi,
        exact_zero=~(rows[:, None] & cols[None, :]) & mask[None, :],
        # rank_one_update_pair puts U's own column in place of inactive
        # ones (the kernel writes them as zeros inside the active tiles).
        keep=mask)


def _project_case(U, m, rng, dtype) -> Case:
    n = U.shape[0]
    mi = int(m)
    V = torch.as_tensor(rng.normal(size=(n, 2)), dtype=dtype, device=U.device)
    Vm = torch.where(rankone.active_mask(n, m)[:, None], V, 0.0)
    mag = U.double().abs().T @ Vm.double().abs()
    live = torch.arange(n, device=U.device) < (
        -(-mi // eops.PROJECT_SLAB) * eops.PROJECT_SLAB)
    item = U.element_size()
    return Case(
        name="eigvec_project",
        kernel=lambda: (eops.project_vectors(U, V, m),),
        plain=lambda: (eref.eigvec_project_ref(U, V, m),),
        library=lambda: U.T @ Vm,
        tols=(_gamma(mi, dtype) * mag,),
        tol_reason="2(m+2)eps·(|U|ᵀ|V|)_ij per entry: two length-m dot "
                   "products",
        bytes=item * (mi * mi + 2 * mi + 2 * n),
        flops=2.0 * mi * mi * 2,
        exact_zero=~live[:, None].expand(n, 2))


def _epilogue_tol(sq_terms: Tensor, spec: kf.KernelSpec, dim: int,
                  dtype) -> Tensor:
    """Bound on |Δk| per entry from rounding the norm expansion (dim-length
    sums of magnitude ``sq_terms``) through the epilogue's d2-Lipschitz
    constant, plus a few ulps of exp."""
    eps = torch.finfo(dtype).eps
    lip = (spec.scale / spec.sigma if spec.name == "rbf"
           else 1.5 * spec.scale / spec.sigma ** 2)
    return 2.0 * (dim + 4) * eps * sq_terms * lip + 8.0 * eps * spec.scale


def _krow_case(U, X, K1, m, rng, spec, dtype) -> Case:
    n, dim = X.shape
    mi = int(m)
    x_new = torch.as_tensor(rng.normal(size=dim), dtype=dtype,
                            device=U.device)
    aux = torch.stack([torch.ones_like(K1), K1], dim=1).contiguous()
    Xd, xd = X.double(), x_new.double()
    terms = (Xd * Xd).sum(1) + (xd * xd).sum() + 2 * (Xd @ xd).abs()
    # a is an exact zero on rows at or beyond m.
    tol_a = torch.where(rankone.active_mask(n, m),
                        _epilogue_tol(terms, spec, dim, dtype), 0.0)
    a_ref, _ = krow_project_ref(U, X, x_new, aux, m, spec=spec)
    V = torch.cat([a_ref[:, None], aux], 1).double()
    V[mi:] = 0.0
    Ua = U.double().abs()
    tol_p = _gamma(mi, dtype) * (Ua.T @ V.abs())
    tol_p[:, 0] += Ua.T @ tol_a        # a's own error, through |U|
    item = U.element_size()
    return Case(
        name="krow_project",
        kernel=lambda: kops.krow_project(U, X, x_new, aux, m, spec=spec),
        plain=lambda: krow_project_ref(U, X, x_new, aux, m, spec=spec),
        library=None,
        tols=(tol_a, tol_p),
        tol_reason="per entry. a_i: (d+4)eps-rounded norm expansion "
                   "times the epilogue's d2-Lipschitz constant (0 at "
                   "i >= m); P_iq: 2(m+2)eps·(|U|ᵀ|[a|aux]|)_iq, plus "
                   "(|U|ᵀ tol_a)_i in column 0",
        bytes=item * (mi * mi + mi * dim + dim + 2 * mi + n + 3 * n),
        flops=2.0 * mi * mi * 3 + mi * (3 * dim + 20))


def _transform_case(U, L, X, m, rng, spec, dtype) -> Case:
    n, dim = X.shape
    mi = int(m)
    xq = torch.as_tensor(rng.normal(size=(N_QUERIES, dim)), dtype=dtype,
                         device=U.device)
    C = min(N_COMPONENTS, max(mi, 1))
    top = torch.argsort(torch.where(rankone.active_mask(n, m), -L,
                                    torch.inf), stable=True)[:C]
    S = (U[:, top] / torch.sqrt(torch.clamp_min(L[top], 1e-6))).contiguous()
    Xd, qd = X.double(), xq.double()
    terms = ((qd * qd).sum(1)[:, None] + (Xd * Xd).sum(1)[None, :]
             + 2 * (qd @ Xd.T).abs())[:, :mi]
    tol_k = _epilogue_tol(terms, spec, dim, dtype)
    Kq = kf.gram_block(xq.double(), Xd, spec=spec)[:, :mi].abs()
    Sa = S.double().abs()[:mi]
    tol_y = _gamma(mi, dtype) * (Kq @ Sa) + tol_k @ Sa
    tol_r = _gamma(mi, dtype) * Kq.sum(1) + tol_k.sum(1)
    item = U.element_size()
    return Case(
        name="transform_project",
        kernel=lambda: nops.transform_project(xq, X, S, m, spec=spec),
        plain=lambda: transform_project_ref(xq, X, S, m, spec=spec),
        library=None,
        tols=(tol_y, tol_r),
        tol_reason="per entry. Y_ic: 2(m+2)eps·(|Kq||S|)_ic + "
                   "(tol_Kq |S|)_ic; rowsum_i: 2(m+2)eps·(|Kq|1)_i + "
                   "(tol_Kq 1)_i, tol_Kq the epilogue error of each Kq "
                   "entry (norm expansion times d2-Lipschitz)",
        bytes=item * (N_QUERIES * dim + mi * dim + mi * C
                      + N_QUERIES * (C + 1)),
        flops=N_QUERIES * mi * (3.0 * dim + 2 * C + 20))


def cases(n: int, m: int, dtype, device, seed: int = 0) -> list[Case]:
    """The KPCA path's kernels' cases at bucket ``n`` with ``m`` active
    pairs."""
    U, L, mt, X, rng = _state(n, m, dtype, device, seed)
    spec = kf.KernelSpec(name="rbf", sigma=float(DIM))
    K1 = torch.where(rankone.active_mask(n, mt),
                     torch.as_tensor(rng.uniform(50.0, 150.0, size=n),
                                     dtype=dtype, device=device), 0.0)
    return [_rotate_case(U, L, mt, rng, dtype),
            _rotate2_case(U, L, mt, rng, dtype),
            _project_case(U, mt, rng, dtype),
            _krow_case(U, X, K1, mt, rng, spec, dtype),
            _transform_case(U, L, X, mt, rng, spec, dtype)]


def scaled_gram_tol(B: Tensor, s: Tensor, dtype) -> Tensor:
    """Per-entry bound on two evaluations of B diag(s) Bᵀ of width k:
    2(k+2)eps·((|B||s|)|B|ᵀ)_ij (the scaled left operand is rounded alike
    in both)."""
    Bd = B.double().abs()
    return _gamma(B.shape[1], dtype) * ((Bd * s.double().abs()) @ Bd.T)


def gram_cases(n: int, k: int, dtype, device, seed: int = 0) -> list[Case]:
    """The Nyström reconstruction's case: B (n, k) as ``reconstruct_tilde``
    forms it (kernel values through an orthonormal basis) and s its
    pseudo-inverse spectrum, log-uniform over four decades."""
    rng = np.random.default_rng(seed)
    B = torch.as_tensor(rng.normal(size=(n, k)), dtype=dtype, device=device)
    s = torch.as_tensor(10.0 ** rng.uniform(-2.0, 2.0, size=k), dtype=dtype,
                        device=device)
    item = B.element_size()
    return [Case(
        name="scaled_gram",
        kernel=lambda: (nops.scaled_gram(B, s),),
        plain=lambda: (nref.scaled_gram_ref(B, s),),
        library=lambda: torch.matmul(B * s, B.T),
        tols=(scaled_gram_tol(B, s, dtype),),
        tol_reason="2(k+2)eps·((|B||s|)|B|ᵀ)_ij per entry: two length-k "
                   "dot products (Higham gamma_k), the scale rounded alike",
        bytes=item * (n * k + k + n * n),
        # K̃ is symmetric: the function needs the n(n+1)/2 dot products of
        # one triangle, though the kernel computes both.
        flops=1.0 * n * (n + 1) * k)]


def rbf_gram_tol(x: Tensor, y: Tensor, sigma: float, dtype) -> Tensor:
    """Per-entry bound on two evaluations of exp(-max(d2, 0)/sigma) by the
    norm expansion: each rounds d2 by at most (d+2)eps·(|x_i| + |y_j|)²
    (the length-d sums of |x_i|², |y_j|² and x_i·y_j, and the expansion's
    two additions), and exp of an argument off by t moves G by G·(e^t - 1)
    ≈ G·t.  So ``_epilogue_tol``'s bound on |Δk|, weighted by G: an entry
    far from the diagonal (G small) is held to its own small bound.  Its
    8 eps covers the two exp evaluations (CUDA's expf is within 2 ulp);
    the type's smallest normal number covers subnormal outputs."""
    xd, yd = x.double(), y.double()
    terms = ((xd * xd).sum(1).sqrt()[:, None]
             + (yd * yd).sum(1).sqrt()[None, :]) ** 2
    G = rbf_gram_ref(xd, yd, sigma)
    spec = kf.KernelSpec(name="rbf", sigma=float(sigma))
    return (G * _epilogue_tol(terms, spec, x.shape[1], dtype)
            + torch.finfo(dtype).tiny)


def rbf_gram_case(x: Tensor, y: Tensor, sigma: float) -> Case:
    """The dense RBF gram of x (n, d) against y (m, d).  Where y is x the
    gram is symmetric: the function reads x once and needs the n(n+1)/2
    entries of one triangle, though the kernel computes both."""
    n, dim = x.shape
    m = y.shape[0]
    item = x.element_size()
    sym = y is x
    return Case(
        name="rbf_gram",
        kernel=lambda: (kops.gram(x, y, sigma),),
        plain=lambda: (rbf_gram_ref(x, y, sigma),),
        library=None,
        tols=(rbf_gram_tol(x, y, sigma, x.dtype),),
        tol_reason="per entry G_ij·(2(d+4)eps·(|x_i|+|y_j|)²/sigma + 8eps) "
                   "+ tiny: each evaluation rounds d2 by (d+2)eps·(|x_i|+"
                   "|y_j|)², which moves exp(-d2/sigma) by G_ij times that "
                   "over sigma; exp itself within 2 ulp",
        bytes=item * (n * dim + (0 if sym else m * dim) + n * m),
        flops=(1.0 * n * (n + 1) if sym else 2.0 * n * m) * (dim + 2))


def rbf_gram_cases(n: int, m: int, dim: int, dtype, device, seed: int = 0
                   ) -> list[Case]:
    """x (n, d) standard normal and sigma = d, as the roofline draws them;
    y is x itself where n = m (the roofline's gram k(X, X), whose diagonal
    is a clamped rounding residue), else a second draw."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n, dim)), dtype=dtype,
                        device=device)
    y = x if n == m else torch.as_tensor(rng.normal(size=(m, dim)),
                                         dtype=dtype, device=device)
    return [rbf_gram_case(x, y, float(dim))]


def compare(case: Case) -> dict:
    """Run the kernel and its plain version on the same inputs; raise if
    any entry of an output is off by more than its own tolerance or a
    pruned entry is not an exact zero."""
    got, want = case.kernel(), case.plain()
    if got[0].is_cuda:
        torch.cuda.synchronize()
    errs, ratios = [], []
    for k, (g, w, tol) in enumerate(zip(got, want, case.tols)):
        if k == 0 and case.keep is not None:
            g, w, tol = g[:, case.keep], w[:, case.keep], tol[:, case.keep]
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{case.name}: output shape {g.shape} vs "
                                 f"{w.shape}, or not finite")
        err = (g.double() - w.double()).abs()
        tol = tol.to(err.device).expand_as(err)
        bad = ~(err <= tol)
        if bad.any():
            at = tuple(int(i) for i in bad.nonzero()[0])
            raise AssertionError(
                f"{case.name}: output {k} entry {at}: |kernel - plain| = "
                f"{float(err[at]):.3e} exceeds its bound {float(tol[at]):.3e}"
                f" ({int(bad.sum())} of {err.numel()} entries out)")
        errs.append(float(err.max()) if err.numel() else 0.0)
        ratios.append(float((err / tol)[tol > 0].max())
                      if bool((tol > 0).any()) else 0.0)
    if case.exact_zero is not None and torch.any(got[0][case.exact_zero]
                                                 != 0):
        raise AssertionError(f"{case.name}: pruned region not exact zeros")
    return {"max_abs_err": max(errs), "errs": errs,
            "max_err_over_tol": max(ratios), "errs_over_tol": ratios,
            "max_tols": [float(t.max()) if t.numel() else 0.0
                         for t in case.tols],
            "tol_reason": case.tol_reason}


def device_ms(fn: Callable[[], object], reps: int = 25, warmup: int = 3,
              attempts: int = 3) -> tuple[float, float]:
    """(device ms per call, device launches per call) of ``fn``: the sum
    of the device activity records (kernels, copies, sets) of ``reps``
    calls under ``torch.profiler``, divided by ``reps``, after ``warmup``
    calls.  Gaps between launches and the host's work are not counted.
    Operands stay in L2 between calls, as on the main path, where the
    previous step just wrote them.

    Every call issues the same device work, so the record count is a
    multiple of ``reps``; a profile that recorded nothing or lost records
    (CUPTI drops a whole buffer now and then) is taken again, up to
    ``attempts`` times, and then raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if spans and len(spans) % reps == 0:
            return sum(spans) / reps / 1e3, len(spans) / reps
    raise RuntimeError(f"the profiler recorded {len(spans)} device records "
                       f"for {reps} calls in each of {attempts} attempts")


def call_ms(fn: Callable[[], object], reps: int = 25, warmup: int = 3
            ) -> float:
    """Median time of one call of ``fn`` in ms, between two CUDA events
    recorded on the host's launch path (the wrapper's host work and the
    launch latency included), over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))
