"""Each CUDA kernel against its plain version, on the card.

``cases(n, m, dtype, device)`` builds, for every kernel of the KPCA path,
the inputs the main path hands it at capacity-bucket ``n`` with ``m``
active pairs (a real solved rotation factor or fused pair with deflated
columns, an orthonormal active block of U, stored points and queries as
the service draws them), and ``gram_cases(n, k, dtype, device)`` those of
the Nyström reconstruction (B of n rows and width k), and
``rbf_gram_cases(n, m, dim, dtype, device)`` those of the dense RBF gram
(the roofline's k(X, X) where n = m), ``flash_attention_case`` and
``ssd_intra_chunk_case`` those of the LM prefill's two kernels at a
given shape, and ``flash_attention_bwd_case`` and
``ssd_intra_chunk_bwd_case`` those of their backward kernels; each
returns a
``Case`` per kernel: the kernel call, its plain version, the one PyTorch
call that computes the same function where there is one, the tolerance
the comparison is held to and why, and the bound on its time.
``compare`` runs both versions and checks them; ``error_vs_exact`` holds
both to a float64 product of the same operands where the case has one.
Used by ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.

Tolerances are per output entry, from the componentwise forward error
bound of a length-K dot product (Higham's gamma_K = K·eps per term
magnitude): two evaluations that each accumulate in the working type
differ at entry (i, j) by at most 2(K+2)·eps·(|A|·|B|)_ij, plus the
propagated error of a kernel epilogue where one is evaluated (its
Lipschitz constant in d2 times the rounding of the norm expansion, entry
by entry).  Each entry is held to its own bound, so a small column (the
k-row projection's Uᵀa beside Uᵀk1) is not judged by a large one.

Time bounds use the H100 SXM data sheet at 700 W: 3.35 TB/s of HBM,
67 TFLOP/s in float32 (CUDA cores; one TF32 pass misses the float32
bars), 67 TFLOP/s in float64 (the FP64 tensor cores, full IEEE float64)
and 989 TFLOP/s in bfloat16 (dense tensor cores); a bound takes the card's
peak for the type, whatever unit the kernel uses, except where a case
names its own: float32 ``eigvec_rotate`` and ``scaled_gram`` count their
three TF32 products at 495 TFLOP/s (the float32-accurate split the
kernels run; below the float32 roof).  Bytes count
each input read once and each output written once; operations count what
these inputs need (the active m, not the capacity).

``cases`` also holds, after the main path's ones, a row-block case of
``eigvec_rotate``, ``eigvec_rotate2``, ``eigvec_project`` and
``krow_project`` (rows n/4 .. 3n/4 of the state), of ``eigvec_rotate2``
on rows m .. n (wholly past the active rows: exact zeros), ``krow_project``
without aux columns (Algorithm 1's prologue), and ``transform_project``
at 20 components, at the roofline's 512 queries of 64 components and at
one component (the KRR predict head); ``features_case`` holds
``transform_project`` at C = M (the Nyström feature head).
``Case.variant`` names each.

``batched_cases(n, ms, dtype, device)`` holds the five kernels of the KPCA
path over a leading tenant axis: tenant b's operands are those of
``cases(n, ms[b], ...)``'s main-path case (its own state, its own m), and
the case is one launch for every tenant (``stack_cases``); its ``singles``
are the B single launches, which each tenant of the batched launch must
equal bit for bit.

Times are device times: ``device_ms`` reads the kernels' own start and end
from the profiler's CUDA activity records (CUPTI), so the host's work in a
wrapper (operand checks, allocation, the ctypes call) is not counted;
where the profiler records nothing, ``queued_ms`` times the calls between
CUDA events, queued behind a spin kernel so that the host's work is
hidden.
``call_ms`` times whole calls between two CUDA events, host work and
launch latency included, as the main path pays them.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import torch.nn.functional as F

from repro_torch.core import engine, kernels_fn as kf, rankone
from repro_torch.kernels.eigvec_update import ops as eops
from repro_torch.kernels.eigvec_update import ref as eref
from repro_torch.kernels.nystrom_recon import ops as nops
from repro_torch.kernels.nystrom_recon import ref as nref
from repro_torch.kernels.nystrom_recon.ref import transform_project_ref
from repro_torch.kernels.rbf_gram import ops as kops
from repro_torch.kernels.flash_attn import ops as fops
from repro_torch.kernels.flash_attn.ref import (LOG2E,
                                                flash_attention_bwd_ref,
                                                flash_attention_lse_ref,
                                                flash_attention_ref)
from repro_torch.kernels.rbf_gram.ref import krow_project_ref, rbf_gram_ref
from repro_torch.kernels.ssd_chunk import ops as sops
from repro_torch.kernels.ssd_chunk.ref import (ssd_intra_chunk_bwd_ref,
                                               ssd_intra_chunk_ref)

Tensor = torch.Tensor

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12,
              torch.bfloat16: 989e12}
TF32_FLOPS = 495e12          # dense TF32 tensor cores

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
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attn/flash_attn.py:73"),
    # The forward TPU kernel's gradient: the reference differentiates its
    # jnp attention, the port this kernel (no pallas_call of its own).
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attn/flash_attn.py:73"),
    "ssd_intra_chunk": ("src/repro_torch/kernels/csrc/ssd_intra_chunk.cu",
                        "src/repro/kernels/ssd_chunk/ssd_chunk.py:48"),
    # Likewise: the reference differentiates its jnp scan.
    "ssd_intra_chunk_bwd": (
        "src/repro_torch/kernels/csrc/ssd_intra_chunk_bwd.cu",
        "src/repro/kernels/ssd_chunk/ssd_chunk.py:48"),
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
    # Mask of output 0 the kernel prunes, or a tuple of one per output
    # (None where an output prunes nothing).
    exact_zero: Tensor | tuple[Tensor | None, ...] | None = None
    keep: Tensor | None = None         # columns of output 0 the caller keeps
    variant: str = ""                  # "" for the main path's shape
    peak: float | None = None          # flop/s of the bound, else the type's
    ops_label: str = "operations"      # what bounds it when operations do
    # Output 0 in float64 from the same rounded operands: the exact product
    # the kernel's and the plain version's errors are measured against.
    exact: Callable[[], Tensor] | None = None
    symmetric: bool = False            # output 0 must equal its transpose
    # (function, args, kwargs) of the kernel's, the plain version's and
    # the library's calls, where the case can be stacked over tenants.
    calls: dict | None = None
    # The single launches, one per tenant, stacked (batched cases only),
    # and the same launches unstacked (their device time).
    singles: Callable[[], tuple] | None = None
    loop: Callable[[], object] | None = None
    tenants: int | None = None

    def bound(self, dtype) -> tuple[float, str]:
        """(least time in ms, what bounds it) on an H100 SXM at 700 W."""
        t_bytes = self.bytes / HBM_BYTES_PER_S
        t_ops = self.flops / (self.peak or PEAK_FLOPS[dtype])
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else self.ops_label)


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


def _rotate_case(U, L, m, rng, dtype, block=None) -> Case:
    """A solved rotation factor applied to U, or with ``block`` = (R, r0)
    to its rows r0 .. r0 + R (the row-block form)."""
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
    eye = torch.eye(n, dtype=dtype, device=U.device)
    Wn = eref.eigvec_rotate_ref(eye, *ops, tauk)             # W * inv, stored
    W = eref.eigvec_rotate_ref(eye, zk, dk, orgk, torch.ones_like(invk),
                               tauk)                         # W as rounded
    one = torch.ones(n, dtype=torch.float64, device=U.device)
    W64 = torch.where(~f.defl[None, :], eref.eigvec_rotate_ref(
        torch.diag(one), zk.double(), dk, orgk, one, tauk), 0.0)
    R, r0 = block or (n, 0)
    Ub = U[r0:r0 + R]
    rn = min(max(mi - r0, 0), R)                # rows the function needs
    mag = (Ub.double().abs() @ W64.abs()) * invk.double().abs()
    rows, cols = eref.pruned_region_mask(R, n, mi, r0, block=eops.ROTATE_TILE,
                                         device=U.device)
    live = rows[:, None] & cols[None, :]
    outside = ~live & ~f.defl[None, :]
    item = U.element_size()
    f32 = dtype == torch.float32
    at = dict(row_offset=r0) if block else {}
    return Case(
        name="eigvec_rotate",
        variant=f"rows {r0}:{r0 + R}" if block else "",
        kernel=lambda: (eops.rotate_vectors(Ub, *ops, m, tau=tauk, **at),),
        plain=lambda: (eref.eigvec_rotate_ref(Ub, *ops, tauk, m,
                                              at.get("row_offset")),),
        library=lambda: torch.matmul(Ub, Wn),
        calls={"kernel": (eops.rotate_vectors, (Ub, *ops, m),
                          dict(tau=tauk, **at)),
               "plain": (eref.eigvec_rotate_ref,
                         (Ub, *ops, tauk, m, at.get("row_offset")), {}),
               "library": (torch.matmul, (Ub, Wn), {}),
               "exact": (Ub, W, invk, live)},
        tols=(_gamma(mi, dtype) * mag,),
        tol_reason="2(m+2)eps·(|U||W|)_ij·|inv_j| per entry: two length-m "
                   "dot products (Higham gamma_m), W formed in the working "
                   "type",
        bytes=item * (rn * mi + R * n + 4 * n),
        # float32: three TF32 products on the tensor cores (the split that
        # keeps float32's accuracy); float64: one product on the CUDA cores.
        flops=(6.0 if f32 else 2.0) * rn * mi * mi + (0 if f32 else rn * mi),
        peak=TF32_FLOPS if f32 else None,
        ops_label="operations, 3×TF32" if f32 else "operations",
        exact_zero=outside,
        # _apply_factor puts U's own column in place of deflated ones.
        keep=~f.defl,
        exact=lambda: torch.where(live, (Ub.double() @ W.double())
                                  * invk.double(), 0.0))


def _rotate2_case(U, L, m, rng, dtype, block=None) -> Case:
    """A solved fused pair (sigma = +0.5 then -0.5) whose first update
    deflates every seventh direction (z1 = 0 there), so factor 1 carries
    deflated identity columns e_{cid1[j]} under a permuted cid1; with
    ``block`` = (R, r0) applied to U's rows r0 .. r0 + R (the row-block
    form)."""
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
    R, r0 = block or (n, 0)
    Ub = U[r0:r0 + R]
    rn = min(max(mi - r0, 0), R)                # rows the function needs
    mag = (Ub.double().abs() @ W1.double().abs()) @ W2.double().abs()
    rows, cols = eref.pruned_region_mask(R, n, mi, r0,
                                         block=eops.ROTATE2_TILE,
                                         device=U.device)
    item = U.element_size()
    at = dict(row_offset=r0) if block else {}
    return Case(
        name="eigvec_rotate2",
        variant=f"rows {r0}:{r0 + R}" if block else "",
        kernel=lambda: (eops.rotate_vectors2(Ub, *ops, m, **taus, **at),),
        plain=lambda: (eref.eigvec_rotate2_ref(Ub, *ops, m,
                                               at.get("row_offset"),
                                               **taus),),
        library=lambda: torch.matmul(torch.matmul(Ub, W1), W2),
        calls={"kernel": (eops.rotate_vectors2, (Ub, *ops, m),
                          dict(**taus, **at)),
               "plain": (eref.eigvec_rotate2_ref,
                         (Ub, *ops, m, at.get("row_offset")), taus),
               "library": (_two_products, (Ub, W1, W2), {})},
        tols=(_gamma(2 * mi, dtype) * mag,),
        tol_reason="2(2m+2)eps·(|U||W1||W2|)_ij per entry: the second "
                   "length-m product carries the first one's error "
                   "(Higham gamma_m twice), both factors generated in the "
                   "working type alike",
        # U's live rows of the active columns and C, z, inv and defl of
        # both factors in T; d, org and tau in f64; cid in int32.  The
        # function needs (U_b W1) W2 over the r live rows: 4 r m^2, and the
        # factors' m^2 entries each.
        bytes=item * (rn * mi + R * n + 6 * n) + 8 * 6 * n + 4 * 2 * n,
        flops=4.0 * rn * mi * mi + 2.0 * mi * mi,
        exact_zero=~(rows[:, None] & cols[None, :]) & mask[None, :],
        # rank_one_update_pair puts U's own column in place of inactive
        # ones (the kernel writes them as zeros inside the active tiles).
        keep=mask)


def _project_case(U, m, rng, dtype, block=None) -> Case:
    """Uᵀ V over two columns, or with ``block`` = (R, r0) the partial of
    U's rows r0 .. r0 + R (the row-block form)."""
    n = U.shape[0]
    mi = int(m)
    R, r0 = block or (n, 0)
    Ub = U[r0:r0 + R]
    rn = min(max(mi - r0, 0), R)                # rows the function sums
    V = torch.as_tensor(rng.normal(size=(R, 2)), dtype=dtype, device=U.device)
    Vm = torch.where((torch.arange(R, device=U.device) < rn)[:, None], V, 0.0)
    mag = Ub.double().abs().T @ Vm.double().abs()
    live = torch.arange(n, device=U.device) < (
        -(-mi // eops.PROJECT_SLAB) * eops.PROJECT_SLAB)
    item = U.element_size()
    at = dict(row_offset=r0) if block else {}
    return Case(
        name="eigvec_project",
        variant=f"rows {r0}:{r0 + R}" if block else "",
        kernel=lambda: (eops.project_vectors(Ub, V, m, **at),),
        plain=lambda: (eref.eigvec_project_ref(Ub, V, m,
                                               at.get("row_offset")),),
        library=lambda: Ub.T @ Vm,
        calls={"kernel": (eops.project_vectors, (Ub, V, m), at),
               "plain": (eref.eigvec_project_ref,
                         (Ub, V, m, at.get("row_offset")), {}),
               "library": (_tmatmul, (Ub, Vm), {})},
        tols=(_gamma(rn, dtype) * mag,),
        tol_reason="2(r+2)eps·(|U|ᵀ|V|)_ij per entry: two dot products over "
                   "the r live rows",
        bytes=item * (rn * mi + 2 * rn + 2 * n),
        flops=2.0 * rn * mi * 2,
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


def _krow_case(U, X, K1, m, rng, spec, dtype, block=None,
               aux_cols: int = 2) -> Case:
    """The fused prologue with aux = [1 | K1] (Algorithm 2's), or with
    ``aux_cols`` = 0 none (Algorithm 1's); with ``block`` = (R, r0) on
    U's rows r0 .. r0 + R (the row-block form)."""
    n, dim = X.shape
    mi = int(m)
    R, r0 = block or (n, 0)
    rn = min(max(mi - r0, 0), R)                # live rows of the block
    x_new = torch.as_tensor(rng.normal(size=dim), dtype=dtype,
                            device=U.device)
    aux = torch.stack([torch.ones_like(K1), K1], dim=1)[:, :aux_cols]
    Ub, Xb = U[r0:r0 + R], X[r0:r0 + R]
    auxb = aux[r0:r0 + R].contiguous()
    Xd, xd = Xb.double(), x_new.double()
    terms = (Xd * Xd).sum(1) + (xd * xd).sum() + 2 * (Xd @ xd).abs()
    # a is an exact zero on rows at or beyond m.
    masked = torch.arange(R, device=U.device) >= rn
    tol_a = torch.where(~masked, _epilogue_tol(terms, spec, dim, dtype), 0.0)
    at = dict(row_offset=r0) if block else {}
    a_ref, _ = krow_project_ref(Ub, Xb, x_new, auxb, m, at.get("row_offset"),
                                spec=spec)
    V = torch.cat([a_ref[:, None], auxb], 1).double()
    V[rn:] = 0.0
    Ua = Ub.double().abs()
    tol_p = _gamma(rn, dtype) * (Ua.T @ V.abs())
    tol_p[:, 0] += Ua.T @ tol_a        # a's own error, through |U|
    pruned = torch.arange(n, device=U.device) >= (
        -(-mi // eops.PROJECT_SLAB) * eops.PROJECT_SLAB)
    item = U.element_size()
    ncol = 1 + aux_cols
    variant = ", ".join(([f"rows {r0}:{r0 + R}"] if block else [])
                        + ([f"naux {aux_cols}"] if aux_cols != 2 else []))
    return Case(
        name="krow_project",
        variant=variant,
        kernel=lambda: kops.krow_project(Ub, Xb, x_new, auxb, m, spec=spec,
                                         **at),
        plain=lambda: krow_project_ref(Ub, Xb, x_new, auxb, m,
                                       at.get("row_offset"), spec=spec),
        library=None,
        calls={"kernel": (kops.krow_project, (Ub, Xb, x_new, auxb, m),
                          dict(spec=spec, **at)),
               "plain": (krow_project_ref,
                         (Ub, Xb, x_new, auxb, m, at.get("row_offset")),
                         dict(spec=spec)),
               "library": None},
        tols=(tol_a, tol_p),
        tol_reason="per entry. a_i: (d+4)eps-rounded norm expansion "
                   "times the epilogue's d2-Lipschitz constant (0 at "
                   "i >= m); P_iq: 2(r+2)eps·(|U|ᵀ|[a|aux]|)_iq over the "
                   "r live rows, plus (|U|ᵀ tol_a)_i in column 0",
        bytes=item * (rn * mi + rn * dim + dim + aux_cols * rn + R
                      + n * ncol),
        flops=2.0 * rn * mi * ncol + rn * (3 * dim + 20),
        exact_zero=(masked, pruned[:, None].expand(n, ncol)))


def transform_tol(xq: Tensor, X: Tensor, S: Tensor, m: int,
                  spec: kf.KernelSpec, dtype) -> tuple[Tensor, Tensor]:
    """Per-entry bounds on two evaluations of a snapshot query (Y, rowsum)
    = (K(xq, X[:m]) S[:m], K(xq, X[:m]) 1): Y_ic within
    2(m+2)eps·(|Kq||S|)_ic + (tol_Kq |S|)_ic, rowsum_i within
    2(m+2)eps·(|Kq|1)_i + (tol_Kq 1)_i, tol_Kq the epilogue error of each
    Kq entry (norm expansion times d2-Lipschitz)."""
    dim = X.shape[1]
    Xd, qd = X.double(), xq.double()
    terms = ((qd * qd).sum(1)[:, None] + (Xd * Xd).sum(1)[None, :]
             + 2 * (qd @ Xd.T).abs())[:, :m]
    tol_k = _epilogue_tol(terms, spec, dim, dtype)
    Kq = kf.gram_block(qd, Xd, spec=spec)[:, :m].abs()
    Sa = S.double().abs()[:m]
    return (_gamma(m, dtype) * (Kq @ Sa) + tol_k @ Sa,
            _gamma(m, dtype) * Kq.sum(1) + tol_k.sum(1))


def _transform_case(U, L, X, m, rng, spec, dtype, nq: int = N_QUERIES,
                    comps: int = N_COMPONENTS, features: bool = False
                    ) -> Case:
    """``nq`` queries projected on the top ``comps`` components (the
    service's 64 and 8 unless the variant names others), or with
    ``features`` on the Nyström feature head's S = sqrt(m/n)·U·λ⁺, all n
    columns (zero past m)."""
    n, dim = X.shape
    mi = int(m)
    xq = torch.as_tensor(rng.normal(size=(nq, dim)), dtype=dtype,
                         device=U.device)
    if features:
        C = comps = n
        mask = rankone.active_mask(n, m)
        pinv = torch.where(mask, 1.0 / torch.where(mask, L, 1.0), 0.0)
        S = (math.sqrt(mi / n) * U * pinv[None, :]).contiguous()
    else:
        C = min(comps, max(mi, 1))
        top = torch.argsort(torch.where(rankone.active_mask(n, m), -L,
                                        torch.inf), stable=True)[:C]
        S = (U[:, top]
             / torch.sqrt(torch.clamp_min(L[top], 1e-6))).contiguous()
    tol_y, tol_r = transform_tol(xq, X, S, mi, spec, dtype)
    item = U.element_size()
    variant = ", ".join(([f"Q {nq}"] if nq != N_QUERIES else [])
                        + ([f"C {comps}"] if comps != N_COMPONENTS else [])
                        + (["features"] if features else []))
    return Case(
        name="transform_project",
        variant=variant,
        kernel=lambda: nops.transform_project(xq, X, S, m, spec=spec),
        plain=lambda: transform_project_ref(xq, X, S, m, spec=spec),
        library=None,
        calls={"kernel": (nops.transform_project, (xq, X, S, m),
                          dict(spec=spec)),
               "plain": (transform_project_ref, (xq, X, S, m),
                         dict(spec=spec)),
               "library": None},
        tols=(tol_y, tol_r),
        tol_reason="per entry. Y_ic: 2(m+2)eps·(|Kq||S|)_ic + "
                   "(tol_Kq |S|)_ic; rowsum_i: 2(m+2)eps·(|Kq|1)_i + "
                   "(tol_Kq 1)_i, tol_Kq the epilogue error of each Kq "
                   "entry (norm expansion times d2-Lipschitz)",
        bytes=item * (nq * dim + mi * dim + mi * C + nq * (C + 1)),
        flops=nq * mi * (3.0 * dim + 2 * C + 20))


def _context(n: int, m: int, dtype, device, seed: int):
    U, L, mt, X, rng = _state(n, m, dtype, device, seed)
    spec = kf.KernelSpec(name="rbf", sigma=float(DIM))
    K1 = torch.where(rankone.active_mask(n, mt),
                     torch.as_tensor(rng.uniform(50.0, 150.0, size=n),
                                     dtype=dtype, device=device), 0.0)
    return U, L, mt, X, rng, spec, K1


def _main_cases(U, L, mt, X, rng, spec, K1, dtype) -> list[Case]:
    """The five kernels at the main path's shapes (the order fixes what
    each draws from ``rng``)."""
    return [_rotate_case(U, L, mt, rng, dtype),
            _rotate2_case(U, L, mt, rng, dtype),
            _project_case(U, mt, rng, dtype),
            _krow_case(U, X, K1, mt, rng, spec, dtype),
            _transform_case(U, L, X, mt, rng, spec, dtype)]


def cases(n: int, m: int, dtype, device, seed: int = 0) -> list[Case]:
    """The KPCA path's kernels' cases at bucket ``n`` with ``m`` active
    pairs."""
    U, L, mt, X, rng, spec, K1 = _context(n, m, dtype, device, seed)
    block = (n // 2, n // 4)
    # Rows m .. n: a block wholly past the active rows (none where m = n).
    past = [(n - m, m)] if m < n else []
    return [*_main_cases(U, L, mt, X, rng, spec, K1, dtype),
            _rotate_case(U, L, mt, rng, dtype, block),
            *[_rotate2_case(U, L, mt, np.random.default_rng(seed + 1),
                            dtype, b) for b in [block, *past]],
            _project_case(U, mt, rng, dtype, block),
            _krow_case(U, X, K1, mt, rng, spec, dtype, block),
            _krow_case(U, X, K1, mt, rng, spec, dtype, aux_cols=0),
            _transform_case(U, L, X, mt, rng, spec, dtype, comps=20),
            _transform_case(U, L, X, mt, rng, spec, dtype, nq=512,
                            comps=64),
            _transform_case(U, L, X, mt, rng, spec, dtype, comps=1)]


def _two_products(u: Tensor, w1: Tensor, w2: Tensor) -> Tensor:
    return torch.matmul(torch.matmul(u, w1), w2)


def _tmatmul(u: Tensor, v: Tensor) -> Tensor:
    return u.mT @ v


def _stack(vals: list):
    """Tenants' values of one argument: tensors stacked on a leading axis,
    anything else (a row offset, a kernel spec) shared."""
    if torch.is_tensor(vals[0]):
        return torch.stack(vals).contiguous()
    return vals[0]


def _stacked_call(calls: list[tuple]) -> Callable[[], object]:
    fn = calls[0][0]
    args = [_stack([c[1][i] for c in calls]) for i in range(len(calls[0][1]))]
    kwargs = {k: _stack([c[2][k] for c in calls]) for k in calls[0][2]}
    return lambda: fn(*args, **kwargs)


def stack_cases(singles: list[Case]) -> Case:
    """One case over a leading tenant axis from B cases of one kernel and
    one shape (tenant b's operands are case b's): one launch of the
    batched wrapper; its plain version, tolerances, pruned entries and
    bound are the tenants' stacked (the bound's bytes and operations
    summed); ``singles`` runs the B single launches."""
    c0 = singles[0]
    kernel = _stacked_call([c.calls["kernel"] for c in singles])
    plain = _stacked_call([c.calls["plain"] for c in singles])
    lib = (None if c0.calls["library"] is None else _stacked_call(
        [c.calls["library"] for c in singles]))

    def as_tuple(fn):
        def call():
            out = fn()
            return out if isinstance(out, tuple) else (out,)
        return call

    def singles_out():
        outs = [c.kernel() for c in singles]
        return tuple(torch.stack(o) for o in zip(*outs))

    def stacked_zero(k):
        zs = [c.exact_zero if not isinstance(c.exact_zero, tuple)
              else c.exact_zero[k] for c in singles]
        return None if zs[0] is None else torch.stack(zs)

    nout = len(c0.tols)
    exact_zero = (tuple(stacked_zero(k) for k in range(nout))
                  if isinstance(c0.exact_zero, tuple) else stacked_zero(0))
    exact = None
    if "exact" in c0.calls:
        Ub, W, inv, live = (torch.stack(v) for v in zip(
            *[c.calls["exact"] for c in singles]))
        exact = lambda: torch.where(  # noqa: E731
            live, (Ub.double() @ W.double()) * inv.double()[:, None, :], 0.0)
    return Case(
        name=c0.name, variant=f"B {len(singles)}",
        kernel=as_tuple(kernel), plain=as_tuple(plain), library=lib,
        tols=tuple(torch.stack(t) for t in zip(*[c.tols for c in singles])),
        tol_reason=c0.tol_reason + "; per tenant",
        bytes=sum(c.bytes for c in singles),
        flops=sum(c.flops for c in singles),
        exact_zero=exact_zero,
        keep=(None if c0.keep is None
              else torch.stack([c.keep for c in singles])),
        peak=c0.peak, ops_label=c0.ops_label, exact=exact,
        singles=singles_out, loop=lambda: [c.kernel() for c in singles],
        tenants=len(singles))


BATCHED = ("eigvec_rotate", "eigvec_rotate2", "eigvec_project",
           "krow_project", "transform_project")


def batched_cases(n: int, ms, dtype, device, seed: int = 0) -> list[Case]:
    """The five kernels of the KPCA path over a tenant axis at bucket n,
    tenant b with ms[b] active pairs (its own state and operands: the
    main-path case of ``cases(n, ms[b], ..., seed + b)``)."""
    per = [_main_cases(*_context(n, m, dtype, device, seed + b), dtype)
           for b, m in enumerate(ms)]
    return [stack_cases(list(group)) for group in zip(*per)]


def batched_bitwise(case: Case) -> bool:
    """Whether each tenant of the batched launch equals the single launch
    on its operands bit for bit."""
    return all(torch.equal(a, b) for a, b in zip(case.kernel(),
                                                 case.singles()))


def features_case(n: int, m: int, dtype, device, seed: int = 0) -> Case:
    """``transform_project`` as the Nyström feature head calls it: 64
    queries against a capacity-``n`` snapshot with ``m`` landmarks,
    C = n columns."""
    U, L, mt, X, rng = _state(n, m, dtype, device, seed)
    spec = kf.KernelSpec(name="rbf", sigma=float(DIM))
    return _transform_case(U, L, X, mt, rng, spec, dtype, features=True)


def scaled_gram_tol(B: Tensor, s: Tensor, dtype) -> Tensor:
    """Per-entry bound on two evaluations of B diag(s) Bᵀ of width k:
    2(k+2)eps·((|B||s|)|B|ᵀ)_ij (the scaled left operand is rounded alike
    in both)."""
    Bd = B.double().abs()
    return _gamma(B.shape[1], dtype) * ((Bd * s.double().abs()) @ Bd.T)


def scaled_gram_case(B: Tensor, s: Tensor) -> Case:
    """K̃ = B diag(s) Bᵀ for B (n, k) and s (k,)."""
    n, k = B.shape
    dtype = B.dtype
    item = B.element_size()
    f32 = dtype == torch.float32
    return Case(
        name="scaled_gram",
        kernel=lambda: (nops.scaled_gram(B, s),),
        plain=lambda: (nref.scaled_gram_ref(B, s),),
        library=lambda: torch.matmul(B * s, B.T),
        tols=(scaled_gram_tol(B, s, dtype),),
        tol_reason="2(k+2)eps·((|B||s|)|B|ᵀ)_ij per entry: two length-k "
                   "dot products (Higham gamma_k), the scale rounded alike",
        bytes=item * (n * k + k + n * n),
        # K̃ is symmetric: the function needs the n(n+1)/2 dot products of
        # one triangle.  float32: three TF32 products on the tensor cores
        # (the split that keeps float32's accuracy); float64: one product.
        flops=(3.0 if f32 else 1.0) * n * (n + 1) * k,
        peak=TF32_FLOPS if f32 else None,
        ops_label="operations, 3×TF32" if f32 else "operations",
        # float32: the float64 product of the same rounded operands (B·s
        # as the plain version rounds it, and B), which both are held to.
        exact=(lambda: (B * s).double() @ B.double().T) if f32 else None,
        symmetric=True)


def gram_cases(n: int, k: int, dtype, device, seed: int = 0) -> list[Case]:
    """The Nyström reconstruction's case: B (n, k) as ``reconstruct_tilde``
    forms it (kernel values through an orthonormal basis) and s its
    pseudo-inverse spectrum, log-uniform over four decades."""
    rng = np.random.default_rng(seed)
    B = torch.as_tensor(rng.normal(size=(n, k)), dtype=dtype, device=device)
    s = torch.as_tensor(10.0 ** rng.uniform(-2.0, 2.0, size=k), dtype=dtype,
                        device=device)
    return [scaled_gram_case(B, s)]


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
    entries of one triangle, which is what the kernel computes."""
    n, dim = x.shape
    m = y.shape[0]
    item = x.element_size()
    sym = y is x
    f32 = x.dtype == torch.float32
    entries = n * (n + 1) / 2 if sym else 1.0 * n * m
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
        # Each entry a length-d dot product and 4 flops of the norm
        # expansion (float32 on the CUDA cores, float64 on DMMA: both at
        # 67 TFLOP/s).
        flops=entries * (2.0 * dim + 4),
        # float32: the float64 gram of the same operands, which both are
        # held to.
        exact=(lambda: rbf_gram_ref(x.double(), y.double(), sigma))
        if f32 else None,
        symmetric=sym)


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


def _unit_roundoff(dtype) -> float:
    """Half the type's eps; 0 for float32 and wider, where the LM kernels'
    casts to the operand type are exact."""
    return 0.0 if dtype in (torch.float32, torch.float64) else (
        torch.finfo(dtype).eps / 2)


def flash_attention_tol(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Per-entry bound on two evaluations of causal attention (layout
    (B, T, H, hd), kv head h // (H / Hkv)) that sum in float32 and round p
    and the output to the operands' type u.  With w the softmax weights
    and a_tc = Σ_s w_ts |v_sc|:
      - p and the output rounded to the type: 2u + 2u, each times a;
      - float32 sums of T terms (the PV product and l): 4(T+2)eps;
      - exp and its argument s - m (|s - m| < 64 where p matters), and one
        rescale by exp(m_old - m_new) per 64-key tile: (64 + 8 T/64)eps;
      - the scores, length-hd dot products scaled by 1/sqrt(hd), differ by
        at most δ_t = 2(hd+2)eps·scale·max_s (|q_t|·|k_s|); softmax moves
        each weight by at most a factor e^{±2δ}, so o by 2δ_t·a.
    Computed one kv head (its group of q heads) at a time, in float32."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    eps = torch.finfo(torch.float32).eps
    u = _unit_roundoff(q.dtype)
    scale = 1.0 / hd ** 0.5
    rel = 4 * u + (4 * (T + 2) + 64 + 8 * -(-T // 64)) * eps
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    tol = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for j in range(Hkv):
        qj = q[:, :, j * g:(j + 1) * g].float()
        kj, vj = k[:, :, j].float(), v[:, :, j].float().abs()
        s = torch.einsum("btgd,bsd->bgts", qj, kj) * scale
        w = torch.softmax(torch.where(causal, s, -torch.inf), dim=-1)
        del s
        a = torch.einsum("bgts,bsd->btgd", w, vj)
        del w
        qk = torch.einsum("btgd,bsd->bgts", qj.abs(), kj.abs())
        delta = 2 * (hd + 2) * eps * scale * torch.where(
            causal, qk, 0.0).amax(dim=-1)                    # (B, g, T)
        del qk
        tol[:, :, j * g:(j + 1) * g] = a * (
            rel + 2 * delta.permute(0, 2, 1)[..., None])
    return tol + torch.finfo(torch.float32).tiny


def flash_attention_work(B: int, T: int, H: int, Hkv: int, hd: int,
                         item: int) -> tuple[float, float]:
    """(bytes, flops) the causal function needs: q, k, v read once and out
    written once; 4 hd flops (QKᵀ and PV) for each pair s <= t of each
    head."""
    return (item * B * T * hd * (2 * H + 2 * Hkv),
            4.0 * hd * H * B * T * (T + 1) / 2)


def ssd_intra_chunk_work(G: int, Q: int, N: int, H: int, P: int,
                         item: int) -> tuple[float, float]:
    """(bytes, flops) the intra-chunk term needs: c, b, x (``item`` bytes
    each entry) and cum (float32) read once, y written once; per pair
    s <= t the score once (2N, shared by the heads) and per head the
    decay, its product and the apply (2P + 2)."""
    return (item * (2 * G * Q * N + 2 * G * Q * H * P) + 4 * G * Q * H,
            1.0 * G * Q * (Q + 1) / 2 * (2 * N + H * (2 * P + 2)))


def ssd_intra_chunk_bwd_work(G: int, Q: int, N: int, H: int, P: int,
                             item: int) -> tuple[float, float]:
    """(bytes, flops) the backward needs: c, b, x, dy (``item`` bytes each
    entry) and cum (float32) read once, dc, db, dx and dcum written once;
    per pair s <= t the score (2N, shared by the heads), dc's and db's
    terms (2N each), and per head dM (2P), dx's term (2P) and the decay,
    m, dS's term and Z (8)."""
    return (item * (3 * G * Q * H * P + 4 * G * Q * N) + 8 * G * Q * H,
            1.0 * G * Q * (Q + 1) / 2 * (6 * N + H * (4 * P + 8)))


def _attention_operands(B: int, T: int, H: int, Hkv: int, hd: int, dtype,
                        device, seed: int, extra: int = 0
                        ) -> tuple[Tensor, ...]:
    """q (B, T, H, hd), k and v (B, T, Hkv, hd) and ``extra`` more (B, T,
    H, hd) draws, standard normal from ``seed``, in ``dtype``."""
    rng = np.random.default_rng(seed)

    def draw(h):
        return torch.as_tensor(rng.normal(size=(B, T, h, hd)),
                               dtype=torch.float32).to(dtype).to(device)

    return (draw(H), draw(Hkv), draw(Hkv)) + tuple(draw(H)
                                                   for _ in range(extra))


def flash_attention_case(B: int, T: int, H: int, Hkv: int, hd: int, dtype,
                         device, seed: int = 0) -> Case:
    """Causal attention at (B, T, H, Hkv, hd): q, k, v standard normal, as
    an unnormalised projection of a normed hidden state gives them
    (scores of unit spread after the 1/sqrt(hd) scale).  The library call
    is ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
    on the (B, H, T, hd) views, timed as a yardstick only."""
    q, k, v = _attention_operands(B, T, H, Hkv, hd, dtype, device, seed)
    item = q.element_size()
    return Case(
        name="flash_attention",
        kernel=lambda: (fops.causal_attention(q, k, v),),
        plain=lambda: (flash_attention_ref(q, k, v),),
        library=lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True),
        tols=(flash_attention_tol(q, k, v),),
        tol_reason="per entry a_tc·(4u + (4(T+2) + 64 + 8T/64)eps32 + "
                   "2δ_t), a_tc = Σ_s w_ts|v_sc|, u the operands' unit "
                   "roundoff (p and the output rounded), δ_t = 2(hd+2)"
                   "eps32·max_s(|q_t|·|k_s|)/sqrt(hd) the scores' error "
                   "through the softmax",
        **dict(zip(("bytes", "flops"),
                   flash_attention_work(B, T, H, Hkv, hd, item))))


def flash_attention_lse_tol(q: Tensor, k: Tensor, lse: Tensor) -> Tensor:
    """Per-row bound on two float32 evaluations of the causal log-sum-exp
    in base 2 (``flash_attention_lse_ref``'s units; ``lse`` (B, H, T) the
    plain version's): with x_ts = s_ts·log2(e)/sqrt(hd) the exponents,
      - the scores' error δ_t (``flash_attention_tol``) moves every
        exponent by at most δ_t·log2(e), and so the log-sum-exp;
      - l = Σ_s 2^(x_ts - m), a float32 sum of T terms, each within exp2's
        2 ulp, rescaled once a 64-key tile: (4(T+2) + 64 + 8T/64)eps
        relative, which log2 turns into log2(e) times that;
      - x, log2(l) and m + log2(l) each rounded once in each evaluation:
        4 eps·(max_s |x_ts| + |lse_t|).
    One kv head (its group of q heads) at a time, in float32."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    eps = torch.finfo(torch.float32).eps
    scale = 1.0 / hd ** 0.5
    rel = (4 * (T + 2) + 64 + 8 * -(-T // 64)) * eps
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    tol = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    for j in range(Hkv):
        qj, kj = q[:, :, j * g:(j + 1) * g].float(), k[:, :, j].float()
        s = torch.einsum("btgd,bsd->bgts", qj, kj) * scale
        x_max = torch.where(causal, s.abs(), 0.0).amax(dim=-1) * LOG2E
        del s
        qk = torch.einsum("btgd,bsd->bgts", qj.abs(), kj.abs())
        delta = 2 * (hd + 2) * eps * scale * torch.where(
            causal, qk, 0.0).amax(dim=-1)                    # (B, g, T)
        del qk
        tol[:, j * g:(j + 1) * g] = (
            LOG2E * (rel + 2 * delta)
            + 4 * eps * (x_max + lse[:, j * g:(j + 1) * g].abs()))
    return tol + torch.finfo(torch.float32).tiny


def flash_attention_lse_case(B: int, T: int, H: int, Hkv: int, hd: int,
                             device, seed: int = 0) -> Case:
    """The bfloat16 forward as a gradient step calls it: the output and
    each row's log-sum-exp in base 2 (``fops.attention_with_lse``), at
    ``flash_attention_case``'s operands and bound for the output; the
    plain versions are ``flash_attention_ref`` and
    ``flash_attention_lse_ref``.  The library call is
    ``scaled_dot_product_attention`` as in that case (it returns no
    log-sum-exp)."""
    case = flash_attention_case(B, T, H, Hkv, hd, torch.bfloat16, device,
                                seed)
    q, k, v = _attention_operands(B, T, H, Hkv, hd, torch.bfloat16, device,
                                  seed)
    lse = flash_attention_lse_ref(q, k)
    return dataclasses.replace(
        case, variant="lse",
        kernel=lambda: fops.attention_with_lse(q, k, v),
        plain=lambda: (flash_attention_ref(q, k, v), lse),
        tols=(case.tols[0], flash_attention_lse_tol(q, k, lse)),
        tol_reason=case.tol_reason + "; lse per row log2(e)·((4(T+2) + 64 "
                   "+ 8T/64)eps32 + 2δ_t) + 4eps32·(max_s|x_ts| + |lse_t|), "
                   "x the base-2 exponents",
        # The forward's reads and flops, and the float32 lse written.
        bytes=case.bytes + 4.0 * B * H * T)


def flash_attention_bwd_tol(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                            dout: Tensor, grads: tuple[Tensor, ...]
                            ) -> tuple[Tensor, Tensor, Tensor]:
    """Per-entry bounds on two evaluations of the backward (dq, dk, dv)
    that read the same operands into float32, sum in float32 in different
    orders and round each output to the operands' type once (u its unit
    roundoff; ``grads`` the plain version's outputs):
      - the scores and dP = dout vᵀ, length-hd float32 dot products, and
        D = rowsum(dout ∘ out), and the output sums of at most T terms
        (over the group's heads: gT): each term within γ = 2(gT + hd +
        2)eps of its magnitude;
      - P = exp(S - lse): the scores' error δ_t = 2(hd+2)eps·scale·max_s
        |q_t||k_s| moves P by a factor e^{±2δ}, and exp, lse by (64 + 8
        T/64)eps;
    so with rel = γ + 2δ + (64 + 8T/64)eps and the magnitudes A of each
    output's terms (A_dv = Pᵀ|dout|, A_dS = P∘(|dout||v|ᵀ + rowsum(|dout|
    ∘|out|) + |dP - D|), A_dq = scale·A_dS|k|, A_dk = scale·A_dSᵀ|q|):
    tol = rel·A + 2u|out|, the last for the two roundings to the type.
    In bfloat16 the kernel takes P and dS as the A operands of its
    products, rounded to the type (the plain version rounds them alike):
      - dv = Σ_t bf16(P_ts) dout_t: each evaluation moves each term by at
        most u·P_ts|dout_t|, so two evaluations differ by 2u·Pᵀ|dout|
        more;
      - dq = scale·Σ_s bf16(dS_ts) k_s and dk = scale·Σ_t bf16(dS_ts) q_t:
        likewise 2u·scale·|dS||k| and 2u·scale·|dS|ᵀ|q|, |dS| = P∘|dP - D|.
    In float32 both roundings are exact (u = 0) and the bound is the one
    above.  One kv head (its group of q heads) at a time, in float32."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    eps = torch.finfo(torch.float32).eps
    u = _unit_roundoff(q.dtype)
    scale = 1.0 / hd ** 0.5
    base = (2 * (g * T + hd + 2) + 64 + 8 * -(-T // 64)) * eps
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    tq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    tk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    tv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for j in range(Hkv):
        heads = slice(j * g, (j + 1) * g)
        qj, oj, doj = (x[:, :, heads].float() for x in (q, out, dout))
        kj, vj = k[:, :, j].float(), v[:, :, j].float()
        s = torch.einsum("btgd,bsd->bgts", qj, kj) * scale
        p = torch.softmax(torch.where(causal, s, -torch.inf), dim=-1)
        del s
        qk = torch.einsum("btgd,bsd->bgts", qj.abs(), kj.abs())
        delta = 2 * (hd + 2) * eps * scale * torch.where(
            causal, qk, 0.0).amax(dim=-1, keepdim=True)      # (B, g, T, 1)
        del qk
        rel = base + 2 * delta
        dsum = (doj * oj).sum(-1).permute(0, 2, 1)[..., None]
        dsum_abs = (doj.abs() * oj.abs()).sum(-1).permute(0, 2, 1)[..., None]
        dp = torch.einsum("btgd,bsd->bgts", doj, vj)
        ds_abs = p * (dp - dsum).abs()
        a_ds = (p * (torch.einsum("btgd,bsd->bgts", doj.abs(), vj.abs())
                     + dsum_abs) + ds_abs) * rel + 2 * u * ds_abs
        del dp, ds_abs
        tv[:, :, j] = torch.einsum("bgts,btgd->bsd", p * (rel + 2 * u),
                                   doj.abs())
        del p
        tq[:, :, heads] = scale * torch.einsum("bgts,bsd->btgd", a_ds,
                                               kj.abs())
        tk[:, :, j] = scale * torch.einsum("bgts,btgd->bsd", a_ds, qj.abs())
    tiny = torch.finfo(torch.float32).tiny
    return tuple(t + 2 * u * gr.float().abs() + tiny
                 for t, gr in zip((tq, tk, tv), grads))


def flash_attention_bwd_work(B: int, T: int, H: int, Hkv: int, hd: int,
                             item: int) -> tuple[float, float]:
    """(bytes, flops) the backward needs: q, out, dout (H heads) and k, v
    read once, dq, dk, dv written once; five products of 2 hd flops (S,
    dP, dv, dk, dq) for each pair s <= t of each q head."""
    return (item * B * T * hd * (4 * H + 4 * Hkv),
            10.0 * hd * H * B * T * (T + 1) / 2)


def flash_attention_bwd_case(B: int, T: int, H: int, Hkv: int, hd: int,
                             dtype, device, seed: int = 0) -> Case:
    """The backward at (B, T, H, Hkv, hd): q, k, v standard normal as in
    ``flash_attention_case``, out their attention (the plain forward, in
    ``dtype``), dout standard normal.  The library call is the backward
    of ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
    alone (its forward graph kept), timed as a yardstick only."""
    q, k, v, dout = _attention_operands(B, T, H, Hkv, hd, dtype, device,
                                        seed, extra=1)
    out = flash_attention_ref(q, k, v)
    lse = flash_attention_lse_ref(q, k)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse)
    item = q.element_size()
    lib_in = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)
    lib_dout = dout.transpose(1, 2)
    return Case(
        name="flash_attention_bwd",
        kernel=lambda: fops.attention_backward(q, k, v, out, dout, lse),
        plain=lambda: flash_attention_bwd_ref(q, k, v, out, dout, lse),
        library=lambda: torch.autograd.grad(lib_out, lib_in, lib_dout,
                                            retain_graph=True),
        tols=flash_attention_bwd_tol(q, k, v, out, dout, want),
        tol_reason="per entry rel·A + 2u|grad|, rel = 2(gT+hd+2)eps32 + "
                   "(64 + 8T/64)eps32 + 2δ_t, A the magnitudes of the "
                   "output's terms (Pᵀ|dout|, scale·A_dS|k|, scale·"
                   "A_dSᵀ|q|, A_dS = P∘(|dout||v|ᵀ + Σ|dout||out| + "
                   "|dP - D|)), u the operands' unit roundoff; plus the "
                   "bf16 A operands P and dS: 2u·Pᵀ|dout| (dv), "
                   "2u·scale·|dS||k| (dq), 2u·scale·|dS|ᵀ|q| (dk)",
        **dict(zip(("bytes", "flops"),
                   flash_attention_bwd_work(B, T, H, Hkv, hd, item))))


def ssd_intra_chunk_tol(c: Tensor, b: Tensor, x: Tensor, cum: Tensor
                        ) -> Tensor:
    """Per-entry bound on two evaluations of the intra-chunk term that sum
    in float32 and round m and y to x's type u.  With D the decay
    exp(cum_t - cum_s) (s <= t, else 0) and M = (c·b)∘D:
      - m rounded to the type in each and its float32 product and exp
        (within 4 ulp): (2u + 12 eps)|M|;
      - the scores, length-N float32 dot products: 2(N+2)eps(|c||b|ᵀ)∘D;
      - y, a float32 sum of Q terms, then rounded: 2(Q+2)eps + 2u;
    so tol = ((4u + (2Q+16)eps)|M| + 2(N+2)eps(|c||b|ᵀ)∘D) @ |x|, per
    chunk and head, in float64, one chunk at a time."""
    G, Q, N = c.shape
    eps = torch.finfo(torch.float32).eps
    u = _unit_roundoff(x.dtype)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=c.device).tril()
    tol = torch.empty(x.shape, dtype=torch.float64, device=x.device)
    for gi in range(G):
        cg, bg = c[gi].double(), b[gi].double()
        ldiff = cum[gi].double()[:, None, :] - cum[gi].double()[None, :, :]
        D = torch.where(causal[..., None],
                        torch.exp(torch.where(causal[..., None], ldiff, 0.0)),
                        0.0)                                   # (Q, Q, H)
        weight = ((4 * u + (2 * Q + 16) * eps) * (cg @ bg.T).abs()[..., None]
                  + 2 * (N + 2) * eps * (cg.abs() @ bg.abs().T)[..., None]
                  ) * D
        tol[gi] = torch.einsum("tsh,shp->thp", weight, x[gi].double().abs())
    return tol + torch.finfo(torch.float32).tiny


def ssd_operands(G: int, Q: int, N: int, H: int, P: int, dtype, device,
                 seed: int = 0, decay: float = 0.2, with_dy: bool = False
                 ) -> tuple[Tensor, ...]:
    """c, b (G, Q, N) of spread 0.3 and x (G, Q, H, P) standard normal in
    ``dtype``, cum (G, Q, H) float32 falling by uniform(0, ``decay``) a
    step, drawn from ``seed`` in that order; with ``with_dy`` also dy
    (G, Q, H, P) standard normal in ``dtype``, drawn after them."""
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale,
                               dtype=torch.float32).to(dtype).to(device)

    c, b = draw(G, Q, N, scale=0.3), draw(G, Q, N, scale=0.3)
    x = draw(G, Q, H, P)
    cum = torch.as_tensor(-np.cumsum(rng.uniform(0, decay, (G, Q, H)),
                                     axis=1),
                          dtype=torch.float32, device=device)
    return (c, b, x, cum, draw(G, Q, H, P)) if with_dy else (c, b, x, cum)


def ssd_intra_chunk_case(G: int, Q: int, N: int, H: int, P: int, dtype,
                         device, seed: int = 0, decay: float = 0.2) -> Case:
    """The intra-chunk term at (G, Q, N, H, P): c, b of spread 0.3 and x
    standard normal in ``dtype``, cum float32 falling by uniform(0,
    ``decay``) per step (0.2: the reference's test inputs; a steeper
    decay drives exp(cum_t - cum_s) below float32's normal range).  No
    single PyTorch call computes the function."""
    c, b, x, cum = ssd_operands(G, Q, N, H, P, dtype, device, seed, decay)
    item = x.element_size()
    return Case(
        name="ssd_intra_chunk",
        kernel=lambda: (sops.intra_chunk(c, b, x, cum),),
        plain=lambda: (ssd_intra_chunk_ref(c, b, x, cum),),
        library=None,
        tols=(ssd_intra_chunk_tol(c, b, x, cum),),
        tol_reason="per entry ((4u + (2Q+16)eps32)|M| + 2(N+2)eps32"
                   "(|c||b|ᵀ)∘D) @ |x|, M = (c·b)∘D, D the decay below "
                   "the diagonal, u x's unit roundoff (m and y rounded)",
        **dict(zip(("bytes", "flops"),
                   ssd_intra_chunk_work(G, Q, N, H, P, item))))


def ssd_intra_chunk_bwd_tol(c: Tensor, b: Tensor, x: Tensor, cum: Tensor,
                            dy: Tensor, grads: tuple[Tensor, ...]
                            ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-entry bounds on two evaluations of the backward (dc, db, dx,
    dcum) that read the same operands into float32, sum in float32 in
    different orders and round m, dM, dc, db and dx to x's type u at the
    same points (``grads`` the plain version's outputs).  With D the decay
    (0 above the diagonal), S = c·bᵀ, M = S∘D, dm = dy·xᵀ masked, A =
    |dy||x|ᵀ masked, eps float32's and s_u the type's subnormal spacing
    (2^-133 in bfloat16, 0 in float32, where the casts are exact):
      - S, a length-N float32 dot product: δS = 2(N+2)eps|c||b|ᵀ; exp and
        the product S·D within 6 eps: E_M = δS∘D + 6eps|M|; m rounded in
        each: E_m = E_M + 2u|M| + s_u;
      - dm, length P: 2(P+2)eps·A, rounded in each: E_dm = 2(P+2)eps·A +
        2u|dm| + s_u (a rounding can land on either side);
      - dS = Σ_h dM∘D over H heads: E_dS = Σ_h (E_dm + (2H+8)eps|dm|)∘D,
        and dc = dS B, db = dSᵀ C sum Q terms: W = E_dS + 2(Q+2)eps·Σ_h
        |dm|∘D, tol_dc = W|b| + 2u|dc|, tol_db = Wᵀ|c| + 2u|db|;
      - dx_h = m_hᵀ dy_h over Q terms: (E_m + 2(Q+2)eps|M|)ᵀ|dy| + 2u|dx|;
      - Z = dM∘M: E_Z = E_dm|M| + |dm|E_M + 2eps|dm||M|, and dcum's two
        sums of Q terms: R = E_Z + 2(Q+2)eps|dm||M|, tol_dcum[t] = Σ_s
        R[t, s] + Σ_t' R[t', t] + 2eps|dcum|.
    Per chunk, in float64; every bound plus float32's smallest normal."""
    G, Q, N = c.shape
    H, P = x.shape[2:]
    eps = torch.finfo(torch.float32).eps
    u = _unit_roundoff(x.dtype)
    sub = 0.0 if u == 0.0 else 2.0 ** -133
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=c.device).tril()[..., None]
    live = causal.double()
    tols = [torch.empty(t.shape, dtype=torch.float64, device=t.device)
            for t in grads]
    for gi in range(G):
        cg, bg = c[gi].double(), b[gi].double()
        xg, dyg = x[gi].double(), dy[gi].double()
        ldiff = cum[gi].double()[:, None, :] - cum[gi].double()[None, :, :]
        D = torch.where(causal, torch.exp(torch.where(causal, ldiff, 0.0)),
                        0.0)                                   # (Q, Q, H)
        M = ((cg @ bg.T)[..., None] * D).abs()
        E_M = (2 * (N + 2) * eps * (cg.abs() @ bg.abs().T)[..., None] * D
               + 6 * eps * M)
        E_m = E_M + 2 * u * M + sub * live
        dm = torch.where(causal, torch.einsum("thp,shp->tsh", dyg, xg),
                         0.0).abs()
        A = torch.where(causal, torch.einsum("thp,shp->tsh", dyg.abs(),
                                             xg.abs()), 0.0)
        E_dm = 2 * (P + 2) * eps * A + 2 * u * dm + sub * live
        W = (((E_dm + (2 * H + 8) * eps * dm) * D).sum(-1)
             + 2 * (Q + 2) * eps * (dm * D).sum(-1))
        tols[0][gi] = W @ bg.abs()
        tols[1][gi] = W.T @ cg.abs()
        tols[2][gi] = torch.einsum("tsh,thp->shp",
                                   E_m + 2 * (Q + 2) * eps * M, dyg.abs())
        R = (E_dm * M + dm * E_M + (2 + 2 * (Q + 2)) * eps * dm * M)
        tols[3][gi] = R.sum(1) + R.sum(0)
    tiny = torch.finfo(torch.float32).tiny
    out = [t + 2 * u * gr.double().abs() + tiny
           for t, gr in zip(tols[:3], grads[:3])]
    return (*out, tols[3] + 2 * eps * grads[3].double().abs() + tiny)


def ssd_intra_chunk_bwd_case(G: int, Q: int, N: int, H: int, P: int, dtype,
                             device, seed: int = 0, decay: float = 0.2
                             ) -> Case:
    """The backward at (G, Q, N, H, P): ``ssd_intra_chunk_case``'s
    operands and dy (``ssd_operands``).  No single PyTorch call computes
    the function."""
    c, b, x, cum, dy = ssd_operands(G, Q, N, H, P, dtype, device, seed,
                                    decay, with_dy=True)
    want = ssd_intra_chunk_bwd_ref(c, b, x, cum, dy)
    return Case(
        name="ssd_intra_chunk_bwd",
        kernel=lambda: sops.intra_chunk_backward(c, b, x, cum, dy),
        plain=lambda: ssd_intra_chunk_bwd_ref(c, b, x, cum, dy),
        library=None,
        tols=ssd_intra_chunk_bwd_tol(c, b, x, cum, dy, want),
        tol_reason="per entry, from the float32 sums (2(K+2)eps32 of the "
                   "terms' magnitudes for S, dM, dS, dc, db, dx, dcum) and "
                   "the casts of m and dM to x's type (2u of their "
                   "magnitude each, and a bf16 subnormal step), carried "
                   "through the products; dc, db, dx rounded: 2u|out|",
        **dict(zip(("bytes", "flops"),
                   ssd_intra_chunk_bwd_work(G, Q, N, H, P,
                                            x.element_size()))))


def compare(case: Case) -> dict:
    """Run the kernel and its plain version on the same inputs; raise if
    any entry of an output is off by more than its own tolerance or a
    pruned entry is not an exact zero."""
    got, want = case.kernel(), case.plain()
    if got[0].is_cuda:
        torch.cuda.synchronize()
    errs, ratios = [], []
    for k, (g, w, tol) in enumerate(zip(got, want, case.tols)):
        if g.shape != w.shape:
            raise AssertionError(f"{case.name}: output shape {g.shape} vs "
                                 f"{w.shape}")
        if k == 0 and case.keep is not None:
            # Only the columns the caller keeps (per tenant where batched).
            sel = case.keep.to(g.device)[..., None, :]
            g, w = torch.where(sel, g, 0.0), torch.where(sel, w, 0.0)
        if not torch.isfinite(g).all():
            raise AssertionError(f"{case.name}: output {k} not finite")
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
    zeros = (case.exact_zero if isinstance(case.exact_zero, tuple)
             else (case.exact_zero,))
    for k, (g, z) in enumerate(zip(got, zeros)):
        if z is not None and torch.any(g[z.to(g.device)] != 0):
            raise AssertionError(f"{case.name}: output {k}'s pruned region "
                                 f"not exact zeros")
    return {"max_abs_err": max(errs), "errs": errs,
            "max_err_over_tol": max(ratios), "errs_over_tol": ratios,
            "max_tols": [float(t.max()) if t.numel() else 0.0
                         for t in case.tols],
            "tol_reason": case.tol_reason}


def repeats_bitwise(case: Case) -> bool:
    """Whether two runs of the kernel give bit for bit the same outputs
    (no atomics, no order that depends on scheduling)."""
    first, second = case.kernel(), case.kernel()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def error_vs_exact(case: Case) -> dict:
    """The kernel's and the plain version's largest error against the
    case's float64 product of the same operands (``Case.exact``), over the
    columns the caller keeps, and their ratio."""
    exact = case.exact()
    cols = (case.keep if case.keep is not None
            else torch.ones(exact.shape[-1], dtype=torch.bool,
                            device=exact.device))
    errs = {}
    for key, fn in (("kernel", case.kernel), ("plain", case.plain)):
        out = fn()[0]
        err = (out.double() - exact).abs()
        errs[key] = float(torch.where(cols[..., None, :], err, 0.0).max())
    return {"kernel_err_vs_f64": errs["kernel"],
            "plain_err_vs_f64": errs["plain"],
            "err_ratio": (errs["kernel"] / errs["plain"] if errs["plain"] > 0
                          else 0.0 if errs["kernel"] == 0 else float("inf"))}


def device_ms(fn: Callable[[], object], reps: int = 25, warmup: int = 3,
              attempts: int = 3) -> tuple[float, float | None]:
    """(device ms per call, device launches per call) of ``fn``: the device
    activity records (kernels, copies, sets) of ``reps`` calls under
    ``torch.profiler``, after ``warmup`` calls, per call.  Gaps between
    launches and the host's work are not counted.  Operands stay in L2
    between calls, as on the main path, where the previous step just
    wrote them.

    Every call issues the same device work, so each record name comes
    ``k`` times a call: a name's per-call time is ``k`` times the mean of
    its records.  A record that the profiler did not attribute now and
    then (one of 25 after the LM phase on an H100) is so made up by its
    name's others; a profile that recorded nothing, or lost more than a
    tenth of a name's records (CUPTI drops a whole buffer now and then),
    is taken again, up to ``attempts`` times.  If every attempt failed
    (on one H100 host the profiler recorded no device activity at all once
    a prefill had been profiled), the time is ``queued_ms``'s instead and
    the launches per call are None: not measured."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        per_call = {n: max(1, round(len(v) / reps))
                    for n, v in by_name.items()}
        if by_name and all(abs(len(v) - per_call[n] * reps) <= reps // 10
                           for n, v in by_name.items()):
            ms = sum(per_call[n] * float(np.mean(v))
                     for n, v in by_name.items()) / 1e3
            return ms, float(sum(per_call.values()))
    return queued_ms(fn, reps=reps, warmup=0), None


def queued_ms(fn: Callable[[], object], reps: int = 25, warmup: int = 3
              ) -> float:
    """Device ms per call of ``fn`` between two CUDA events, with the
    ``reps`` calls queued behind a spin kernel: the host launches them all
    while the device spins, so the events time the device running them
    back to back and not the host's work between launches.  The gaps
    between consecutive launches on the device (about a microsecond each)
    are counted, unlike in ``device_ms``'s records.  A call that waits for
    the device on the host (a ``.item()``) ends the queue early and is
    timed as ``call_ms`` times it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    # Spin twice the host's time for the calls at up to 2 GHz, and 1 ms
    # more.
    torch.cuda._sleep(int(4e9 * host_s) + 2_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_breakdown(fn: Callable[[], object]) -> tuple[dict, float]:
    """({device record name: summed ms}, wall ms) of one call of ``fn``
    under ``torch.profiler`` (after one warm-up call), the wall time
    between two synchronisations around it.  The records' sum against the
    wall time gives the device's busy share.  The dict is empty where the
    profiler recorded no device activity."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out, wall


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
