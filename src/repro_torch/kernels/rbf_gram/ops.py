"""Wrappers for the RBF gram kernel and the fused kernel-row + projection
kernel (the ingest prologue): a CPU tensor runs ``ref.rbf_gram_ref`` /
``ref.krow_project_ref``, a CUDA tensor launches ``csrc/rbf_gram.cu`` /
``csrc/krow_project.cu`` or raises."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import kernels_fn as kf
from repro_torch.kernels import cuda
from repro_torch.kernels.rbf_gram.ref import krow_project_ref, rbf_gram_ref

Tensor = torch.Tensor

# Kernels the fused CUDA epilogues implement, with their code in csrc.
FUSED_KERNELS = {"rbf": 0, "matern32": 1}
NAUX = 8            # projected columns: the kernel row + up to 7 aux
PROJECT_COLS = 64   # columns of U per cluster (csrc/project_tile.cuh)
PROJECT_SLAB = 32   # its pruning granule: P's rows past ceil(m/32)·32 are 0


class ProjectGeometry(NamedTuple):
    """How ``krow_project`` (``csrc/project_tile.cuh``, shared with
    ``eigvec_project``) spreads a call over the card: one cluster of
    ``ranks`` blocks per ``cols``-column slab of U; rank q sums the live
    rows of the block's chunks q, q + ranks, ... (``chunk`` rows each) and
    stages their rows of a, and finishes columns q·cols/ranks .. of its
    slab, adding the ranks' partials; slab 0's ranks also write a, its
    masked rows as zeros (``zero_rows``).  Slabs at or beyond the live
    columns ceil(m/32)·32 write zeros from rank 0."""
    slabs: int
    ranks: int = 8
    cols: int = PROJECT_COLS
    chunk: int = 128
    threads: int = 256

    def rows(self, rank: int, live: int) -> list[range]:
        """The live rows rank ``rank`` sums (and, in slab 0, writes a of),
        chunk by chunk."""
        return [range(i, min(live, i + self.chunk))
                for i in range(rank * self.chunk, live,
                               self.ranks * self.chunk)]

    def zero_rows(self, rank: int, live: int, R: int) -> list[int]:
        """The masked rows of a that rank ``rank`` of slab 0 writes: its
        threads take rows live + rank·threads + t, stepping
        threads·ranks."""
        return [i for i in range(live, R)
                if (i - live) // self.threads % self.ranks == rank]

    def columns(self, slab: int, rank: int, n: int, m: int) -> range:
        """The output rows of P (columns of U) rank ``rank`` of ``slab``
        writes, with m active columns."""
        live = min(n, -(-m // PROJECT_SLAB) * PROJECT_SLAB)
        c0 = slab * self.cols
        if c0 >= live:                     # pruned: rank 0 writes zeros
            return (range(min(c0, n), min(c0 + self.cols, n)) if rank == 0
                    else range(0))
        share = self.cols // self.ranks
        c0 += rank * share
        return range(min(c0, n), min(c0 + share, n))


def project_geometry(n: int) -> ProjectGeometry:
    """The launch of ``krow_project`` on a state n columns wide."""
    return ProjectGeometry(slabs=-(-n // PROJECT_COLS))


def fused_kind(spec: kf.KernelSpec, name: str) -> int:
    """The epilogue code of ``spec`` for a fused CUDA kernel; raises for a
    kernel the epilogues do not implement."""
    if spec.name not in FUSED_KERNELS:
        raise ValueError(f"{name}: the fused CUDA kernel implements "
                         f"{sorted(FUSED_KERNELS)}, not {spec.name!r}")
    return FUSED_KERNELS[spec.name]


def same_storage(x: Tensor, y: Tensor) -> bool:
    """Whether y is x: the same data, shape and strides."""
    return (x.data_ptr() == y.data_ptr() and x.shape == y.shape
            and x.stride() == y.stride())


def gram(x: Tensor, y: Tensor, sigma) -> Tensor:
    """G = exp(-|x_i - y_j|²/sigma) for x (n, d) and y (m, d) by the norm
    expansion, the norms and the exp epilogue in the same kernel; sums in
    the operands' type.  Where y is x (``same_storage``) the kernel
    computes one triangle and mirrors it, so G equals its transpose
    exactly.  One launch: float32 on the CUDA cores (32 x 32 cells),
    float64 on DMMA (64 x 64 cells)."""
    if x.device.type == "cpu":
        return rbf_gram_ref(x, y, sigma)
    dtype = cuda.check_operands("rbf_gram", x, y)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"rbf_gram: need x (n, d) and y (m, d), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    n, dim = x.shape
    m = y.shape[0]
    out = torch.empty((n, m), dtype=dtype, device=x.device)
    cuda.launch("rbf_gram", dtype, x, y, out, n, m, dim, float(sigma),
                int(same_storage(x, y)))
    return out


def krow_project(u: Tensor, x: Tensor, x_new: Tensor, aux: Tensor,
                 num_active, *, spec: kf.KernelSpec,
                 row_offset: int | None = None) -> tuple[Tensor, Tensor]:
    """(a, P): the masked kernel row a = k(X, x_new)·[row < m] and
    P = Uᵀ[a | aux·[row < m]] in one pass over U.  ``u`` (R, n) may be a
    row block whose first row is the state's row ``row_offset`` (a host
    int; rows are masked by their global index), x (R, d), x_new (d,),
    aux (R, naux) with 0 <= naux <= 7; a is (R,), P the block's (n, 1 +
    naux) partial.  Every operand may carry a leading tenant axis B, with
    counts (B,): one launch for the B tenants.  Masked rows of a and
    output rows of P at or beyond ceil(m/32)·32 are exact zeros."""
    if u.device.type == "cpu":
        return krow_project_ref(u, x, x_new, aux, num_active, row_offset,
                                spec=spec)
    kind = fused_kind(spec, "krow_project")
    x_new, aux = x_new.contiguous(), aux.contiguous()
    dtype = cuda.check_operands("krow_project", u, x, x_new, aux)
    if u.dim() not in (2, 3) or x.dim() != u.dim() or aux.dim() != u.dim():
        raise ValueError(f"krow_project: need u (R, n), x (R, d), aux "
                         f"(R, naux), got {u.shape}, {x.shape}, {aux.shape}")
    nb = u.shape[0] if u.dim() == 3 else None
    lead = u.shape[:-2]
    R, n = u.shape[-2:]
    dim = x.shape[-1]
    naux = aux.shape[-1]
    if (x.shape != lead + (R, dim) or x_new.shape != lead + (dim,)
            or aux.shape != lead + (R, naux)):
        raise ValueError(f"krow_project: shapes u {u.shape}, x {x.shape}, "
                         f"x_new {x_new.shape}, aux {aux.shape}")
    if naux + 1 > NAUX:
        raise ValueError(f"krow_project: at most {NAUX - 1} aux columns, "
                         f"got {naux}")
    r0 = 0 if row_offset is None else int(row_offset)
    m = cuda.active_count(num_active, u.device, nb)
    a = torch.empty(lead + (R,), dtype=dtype, device=u.device)
    P = torch.empty(lead + (n, 1 + naux), dtype=dtype, device=u.device)
    geo = project_geometry(n)
    cuda.launch("krow_project", dtype, u, x, x_new, aux, m, a, P, R, n, dim,
                naux, r0, nb or 1, geo.slabs, geo.ranks, kind,
                float(spec.sigma), float(spec.scale))
    return a, P
