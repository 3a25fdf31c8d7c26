"""Offline stand-ins for the paper's UCI datasets (Magic, Yeast).

The port's own copy of the reference's ``repro/data/uci_like.py`` (numpy
only; the port imports nothing of the reference).  The same seed gives the
same arrays in both packages.  The paper's experiments run on
deterministic synthetic datasets matched to the originals' shape and
coarse statistics:

* Magic gamma telescope: n≈19020, d=10, continuous, heavy-tailed and
  correlated features, two overlapping clusters (gamma/hadron).
* Yeast: n≈1484, d=8, continuous in [0,1], several small clusters
  (protein localization sites).

Both are mixtures of anisotropic Gaussians pushed through mild
non-linearities — enough structure that kernel PCA spectra decay the way
the paper's figures show (fast early decay, long tail).
"""
from __future__ import annotations

import numpy as np


def magic_like(n: int = 19020, d: int = 10, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n1 = int(n * 0.65)
    cov1 = _rand_cov(rng, d, scale=2.0)
    cov2 = _rand_cov(rng, d, scale=3.0)
    x1 = rng.multivariate_normal(np.zeros(d), cov1, size=n1)
    x2 = rng.multivariate_normal(rng.normal(0, 1.5, d), cov2, size=n - n1)
    x = np.concatenate([x1, x2], axis=0)
    # heavy tails on a few features, as in the telescope shower statistics
    x[:, :3] = np.sign(x[:, :3]) * np.abs(x[:, :3]) ** 1.5
    rng.shuffle(x)
    return x.astype(np.float64)


def yeast_like(n: int = 1484, d: int = 8, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, size=(6, d))
    weights = np.array([0.31, 0.29, 0.16, 0.11, 0.07, 0.06])
    counts = np.floor(weights * n).astype(int)
    counts[0] += n - counts.sum()
    xs = [rng.normal(c, 0.08, size=(k, d)) for c, k in zip(centers, counts)]
    x = np.clip(np.concatenate(xs, axis=0), 0.0, 1.0)
    rng.shuffle(x)
    return x.astype(np.float64)


def load_dataset(name: str, n: int | None = None, seed: int = 0) -> np.ndarray:
    if name == "magic":
        x = magic_like(seed=seed)
    elif name == "yeast":
        x = yeast_like(seed=seed)
    else:
        raise ValueError(name)
    if n is not None:
        x = x[:n]
    # standardize, as is conventional before the RBF median heuristic
    return (x - x.mean(0)) / np.maximum(x.std(0), 1e-9)


def _rand_cov(rng, d: int, scale: float = 1.0) -> np.ndarray:
    a = rng.normal(size=(d, d))
    cov = a @ a.T / d
    # exponentially decaying eigenvalue profile (correlated features)
    w, v = np.linalg.eigh(cov)
    w = scale * np.exp(-np.arange(d)[::-1] / 2.5)
    return (v * w) @ v.T
