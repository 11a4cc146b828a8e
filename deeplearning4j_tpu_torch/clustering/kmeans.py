"""KMeans clustering — device-native Lloyd iterations.

Port of ``deeplearning4j_tpu/clustering/kmeans.py`` (reference parity:
``clustering/kmeans/KMeansClustering.java:29`` over
``BaseClusteringAlgorithm.java:50``, applyTo:71: fixed cluster count,
convergence or fixed-iteration termination).

:func:`lloyd` is the reference's ``_lloyd`` on the points' device:
assignment from the [N, K] distances ``‖x‖² + ‖c‖² - 2x·cᵀ`` (in that
form), update as a one-hot segment mean, an empty cluster keeping its
old centroid; the loop runs while ``it < max_iter and moved > tol``
with ``moved`` starting at ``inf`` (one host read of ``moved`` a
step); labels are assigned once more after the loop, and the inertia is
the sum of the row minima.  k-means++ seeding draws from a
``torch.Generator`` (the reference's ``jax.random.choice`` draws cannot
be reproduced), so parity with the reference goes through
:func:`lloyd` from given initial centroids.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class KMeansConfig:
    n_clusters: int = 8
    max_iterations: int = 100
    tolerance: float = 1e-4      # centroid movement convergence
    init: str = "kmeans++"       # or "random"
    seed: int = 0


def _pairwise_sq_dist(x: Tensor, c: Tensor) -> Tensor:
    """[N, D] x [K, D] -> [N, K] squared euclidean, matmul-dominant."""
    xn = torch.sum(x * x, dim=1, keepdim=True)
    cn = torch.sum(c * c, dim=1)
    return xn + cn[None, :] - 2.0 * (x @ c.T)


def _assign(x: Tensor, c: Tensor) -> Tensor:
    return torch.argmin(_pairwise_sq_dist(x, c), dim=1)


def lloyd(x: Tensor, init_centroids: Tensor, max_iter: int, tol: float
          ) -> Tuple[Tensor, Tensor, Tensor, int]:
    """Lloyd iterations from ``init_centroids`` [K, D]: (centroids,
    labels int64 [N], inertia scalar tensor, iterations run)."""
    k = init_centroids.shape[0]
    c = init_centroids
    tol = float(np.float32(tol))        # compared in fp32, as the reference
    it, moved = 0, float("inf")
    while it < max_iter and moved > tol:
        labels = _assign(x, c)
        one_hot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # [N, K]
        counts = one_hot.sum(dim=0)                                   # [K]
        sums = one_hot.T @ x                                          # [K, D]
        new_c = sums / counts.clamp_min(1.0)[:, None]
        # keep empty clusters where they were
        new_c = torch.where(counts[:, None] > 0, new_c, c)
        moved = float(torch.linalg.norm(new_c - c, dim=1).max())
        c = new_c
        it += 1
    d2 = _pairwise_sq_dist(x, c)
    return c, torch.argmin(d2, dim=1), d2.min(dim=1).values.sum(), it


def _kmeanspp_init(x: Tensor, k: int, gen: torch.Generator) -> Tensor:
    """k-means++ seeding: the first centre uniform, each next one drawn
    with probability proportional to its squared distance to the nearest
    centre so far (draws on the CPU generator ``gen``)."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (), generator=gen))
    centroids = [x[first]]
    d2 = _pairwise_sq_dist(x, x[first][None, :])[:, 0]
    for _ in range(1, k):
        probs = (d2 / d2.sum().clamp_min(1e-12)).clamp_min(0.0)
        idx = int(torch.multinomial(probs.double().cpu(), 1, generator=gen))
        c = x[idx]
        centroids.append(c)
        d2 = torch.minimum(d2, _pairwise_sq_dist(x, c[None, :])[:, 0])
    return torch.stack(centroids)


class KMeansClustering:
    """apply_to(points) -> labels; centroids in .centroids."""

    def __init__(self, config: Optional[KMeansConfig] = None,
                 device: DeviceLike = None, **kw):
        self.config = config or KMeansConfig(**kw)
        self.device = resolve_device(device)
        self.centroids: Optional[Tensor] = None
        #: the centroids the last fit started from
        self.init_centroids_: Optional[Tensor] = None
        self.inertia_: Optional[float] = None
        self.n_iter_: int = 0

    def _points(self, x) -> Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        return x.to(self.device, torch.float32)

    def fit(self, x) -> "KMeansClustering":
        cfg = self.config
        x = self._points(x)
        gen = torch.Generator().manual_seed(cfg.seed)
        if cfg.init == "kmeans++":
            init = _kmeanspp_init(x, cfg.n_clusters, gen)
        else:
            idx = torch.randperm(x.shape[0], generator=gen)
            init = x[idx[:cfg.n_clusters].to(x.device)]
        c, labels, inertia, iters = lloyd(
            x, init, cfg.max_iterations, cfg.tolerance)
        self.init_centroids_ = init
        self.centroids = c
        self.labels_ = labels
        self.inertia_ = float(inertia)
        self.n_iter_ = iters
        return self

    def apply_to(self, x) -> Tensor:
        """BaseClusteringAlgorithm.applyTo parity."""
        self.fit(x)
        return self.labels_

    def predict(self, x) -> Tensor:
        return _assign(self._points(x), self.centroids)
