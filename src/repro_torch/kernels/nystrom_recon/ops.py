"""Wrappers for the Nyström reconstruction and the fused batched-transform
kernels: a CPU tensor runs ``ref.scaled_gram_ref`` /
``ref.transform_project_ref``, a CUDA tensor launches
``csrc/scaled_gram.cu`` / ``csrc/transform_project.cu`` or raises."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import kernels_fn as kf
from repro_torch.kernels import cuda
from repro_torch.kernels.nystrom_recon.ref import (scaled_gram_ref,
                                                   transform_project_ref)
from repro_torch.kernels.rbf_gram.ops import fused_kind

Tensor = torch.Tensor

GRAM_SLAB = 32      # float32 scaled_gram: width of a TF32 plane's k slab
# transform_project's geometry (csrc/transform_project.cu's constants).
TRANSFORM_QUERIES = 8       # queries per block
TRANSFORM_RANKS = 8         # blocks of a cluster, splitting the points
TRANSFORM_CHUNK = 64        # points a rank stages at once
TRANSFORM_TILES = (8, 16, 32, 64)   # component tiles, one kernel each


class TransformGeometry(NamedTuple):
    """How ``transform_project`` spreads a call over the card: a block per
    (query tile, component tile, rank); the ``ranks`` blocks of a tile form
    one cluster and split the active points j < m in ``chunk``-point
    chunks, rank r taking chunks r, r + ranks, ...; rank r finishes the
    tile's entries e = r, r + ranks, ... of the row-major (q_tile,
    c_tile + 1) partial (column c_tile is the row sum, written by component
    tile 0 only)."""
    grid: tuple[int, int]      # (ranks x query tiles, component tiles)
    q_tile: int
    c_tile: int
    ranks: int
    chunk: int

    def points(self, rank: int, m: int) -> list[range]:
        """The points rank ``rank`` sums, chunk by chunk."""
        return [range(j, min(m, j + self.chunk))
                for j in range(rank * self.chunk, m,
                               self.ranks * self.chunk)]

    def entries(self, bx: int, by: int, rank: int, nq: int, ncomp: int
                ) -> list[tuple[int, int]]:
        """The (query, column) entries the block (bx, by) of rank ``rank``
        writes; column ``ncomp`` stands for the row sum."""
        q0, c0 = bx // self.ranks * self.q_tile, by * self.c_tile
        out = []
        for e in range(rank, self.q_tile * (self.c_tile + 1), self.ranks):
            q, c = q0 + e // (self.c_tile + 1), e % (self.c_tile + 1)
            if q >= nq:
                continue
            if c == self.c_tile:
                if by == 0:
                    out.append((q, ncomp))
            elif c0 + c < ncomp:
                out.append((q, c0 + c))
        return out


def transform_geometry(nq: int, ncomp: int) -> TransformGeometry:
    """The launch of ``transform_project`` for ``nq`` queries and ``ncomp``
    components: the narrowest tile that holds them, 64 columns a tile
    beyond 64."""
    c_tile = next((t for t in TRANSFORM_TILES if t >= ncomp),
                  TRANSFORM_TILES[-1])
    return TransformGeometry(
        grid=(TRANSFORM_RANKS * -(-nq // TRANSFORM_QUERIES),
              -(-ncomp // c_tile)),
        q_tile=TRANSFORM_QUERIES, c_tile=c_tile, ranks=TRANSFORM_RANKS,
        chunk=TRANSFORM_CHUNK)


def scaled_gram(b: Tensor, s: Tensor) -> Tensor:
    """K̃ = B diag(s) Bᵀ for B (n, k) and s (k,): one triangle computed, the
    other mirrored (K̃ equals its transpose exactly), the scale applied to
    the left operand as it is read, so the scaled copy of B is never
    stored.  float32 runs three TF32 products on the tensor cores (B's
    TF32 head and tail planes in scratch); float64 runs DMMA."""
    if b.device.type == "cpu":
        return scaled_gram_ref(b, s)
    s = s.to(b.dtype)
    dtype = cuda.check_operands("scaled_gram", b, s)
    if b.dim() != 2 or s.shape != (b.shape[1],):
        raise ValueError(f"scaled_gram: need b (n, k) and s (k,), got "
                         f"{b.shape} and {s.shape}")
    n, k = b.shape
    out = torch.empty((n, n), dtype=dtype, device=b.device)
    if dtype == torch.float32:
        # TMA reads B's rows: 16-byte row strides and base.  Zero columns
        # (and zero scales) add nothing to K̃.
        kp = -(-k // 4) * 4
        if kp != k:
            b, s = F.pad(b, (0, kp - k)), F.pad(s, (0, kp - k))
        b, s = (x.clone() if x.data_ptr() % 16 else x for x in (b, s))
        k = kp
        scratch = torch.empty(2 * n * -(-k // GRAM_SLAB) * GRAM_SLAB,
                              dtype=dtype, device=b.device)
    else:
        scratch = b.new_empty(0)
    cuda.launch("scaled_gram", dtype, b, s, scratch, out, n, k)
    return out


def transform_project(xq: Tensor, x: Tensor, s: Tensor, num_active, *,
                      spec: kf.KernelSpec) -> tuple[Tensor, Tensor]:
    """(Y, rowsum): Y = Kq_masked @ s and rowsum = Kq_masked @ 1 for a
    query batch xq (Q, d) against stored points x (n, d) and a projection
    s (n, C), any C >= 1; the query gram is never stored.  One launch, on
    ``transform_geometry(Q, C)``.  Every operand may carry a leading tenant
    axis B, with counts (B,): one launch for the B tenants, the tenant on
    the grid's z axis."""
    if s.device.type == "cpu":
        return transform_project_ref(xq, x, s, num_active, spec=spec)
    kind = fused_kind(spec, "transform_project")
    xq = xq.to(s.dtype).contiguous()
    x = x.to(s.dtype).contiguous()
    s = s.contiguous()
    dtype = cuda.check_operands("transform_project", s, xq, x)
    if s.dim() not in (2, 3) or xq.dim() != s.dim():
        raise ValueError(f"transform_project: shapes xq {xq.shape}, "
                         f"x {x.shape}, s {s.shape}")
    nb = s.shape[0] if s.dim() == 3 else None
    lead = s.shape[:-2]
    n, ncomp = s.shape[-2:]
    nq, dim = xq.shape[-2:]
    if x.shape != lead + (n, dim) or xq.shape[:-2] != lead:
        raise ValueError(f"transform_project: shapes xq {xq.shape}, "
                         f"x {x.shape}, s {s.shape}")
    if ncomp < 1:
        raise ValueError("transform_project takes at least one component")
    m = cuda.active_count(num_active, s.device, nb)
    y = torch.empty(lead + (nq, ncomp), dtype=dtype, device=s.device)
    rs = torch.empty(lead + (nq,), dtype=dtype, device=s.device)
    geo = transform_geometry(nq, ncomp)
    cuda.launch("transform_project", dtype, xq, x, s, m, y, rs, nq, n, dim,
                ncomp, kind, float(spec.sigma), float(spec.scale), *geo.grid,
                nb or 1, geo.q_tile, geo.c_tile, geo.ranks, geo.chunk)
    return y, rs
