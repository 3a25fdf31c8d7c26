"""Kernel functions k(x, y) and related utilities.

The paper uses the RBF kernel k(x,y) = exp(-||x-y||^2 / sigma) with sigma
set by the median heuristic.  Linear, polynomial and Matern-3/2 kernels
are provided as well.  RBF and Matern-3/2 are written term for term as in
the reference (norm expansion, ``max(d2, 0)``), because the fused CUDA
kernels' epilogues (``kernels/csrc/common.cuh``) repeat them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class KernelSpec:
    """Declarative kernel configuration (hashable)."""

    name: str = "rbf"
    sigma: float = 1.0          # RBF / matern bandwidth
    degree: int = 3             # polynomial degree
    coef0: float = 1.0          # polynomial bias
    scale: float = 1.0          # output scale


def _sqdist(x: Tensor, y: Tensor) -> Tensor:
    """Pairwise squared euclidean distances, (n,d),(m,d) -> (n,m), over
    any leading (tenant) dims."""
    xn = torch.sum(x * x, dim=-1)[..., :, None]
    yn = torch.sum(y * y, dim=-1)[..., None, :]
    d2 = xn + yn - 2.0 * (x @ y.mT)
    return torch.clamp_min(d2, 0.0)


def gram_block(x: Tensor, y: Tensor, *, spec: KernelSpec) -> Tensor:
    """Dense gram block K[i,j] = k(x_i, y_j); x (..., n, d) and y (..., m, d)
    may share leading (tenant) dims."""
    if spec.name == "rbf":
        return spec.scale * torch.exp(-_sqdist(x, y) / spec.sigma)
    if spec.name == "linear":
        return spec.scale * (x @ y.mT)
    if spec.name == "poly":
        return spec.scale * (x @ y.mT + spec.coef0) ** spec.degree
    if spec.name == "matern32":
        r = torch.sqrt(_sqdist(x, y) + 1e-30)
        a = math.sqrt(3.0) * r / spec.sigma
        return spec.scale * (1.0 + a) * torch.exp(-a)
    raise ValueError(f"unknown kernel {spec.name!r}")


def kernel_row(x_new: Tensor, xs: Tensor, *, spec: KernelSpec) -> Tensor:
    """a = [k(x_1, x_new), ..., k(x_m, x_new)] — the streaming hot path;
    x_new (..., d) against xs (..., m, d)."""
    return gram_block(xs, x_new[..., None, :], spec=spec)[..., 0]


def constant_diag(spec: KernelSpec) -> float | None:
    """k(x, x) when it is input-independent (stationary kernels: RBF,
    Matern), else None — lets consumers evaluate diagonal sums without
    the row points (``nystrom.trace_error``)."""
    return spec.scale if spec.name in ("rbf", "matern32") else None


def kernel_diag(x: Tensor, *, spec: KernelSpec) -> Tensor:
    """k(x_i, x_i) for each row of x (..., d) (constant 'scale' for RBF and
    Matern)."""
    if spec.name in ("rbf", "matern32"):
        return torch.full(x.shape[:-1], spec.scale, dtype=x.dtype,
                          device=x.device)
    if spec.name == "linear":
        return spec.scale * torch.sum(x * x, dim=-1)
    if spec.name == "poly":
        return spec.scale * (torch.sum(x * x, dim=-1)
                             + spec.coef0) ** spec.degree
    raise ValueError(f"unknown kernel {spec.name!r}")


def median_heuristic(x: Tensor, max_points: int = 512) -> Tensor:
    """sigma = median of pairwise squared distances over a subset (paper
    §5).  ``torch.median`` returns the lower middle value; the quantile
    averages the two middle values as ``jnp.median`` does."""
    sub = x[:max_points]
    d2 = _sqdist(sub, sub)
    iu = torch.triu_indices(sub.shape[0], sub.shape[0], offset=1,
                            device=x.device)
    return torch.quantile(d2[iu[0], iu[1]], 0.5)


def center_gram(K: Tensor) -> Tensor:
    """Mean-adjusted kernel matrix K' = (I-1)K(I-1), eq. (1) of the paper."""
    n = K.shape[0]
    one = torch.full((n, n), 1.0 / n, dtype=K.dtype, device=K.device)
    return K - one @ K - K @ one + one @ K @ one
