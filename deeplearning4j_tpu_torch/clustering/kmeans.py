"""KMeans by Lloyd iterations on the device (port of
`deeplearning4j_tpu/clustering/kmeans.py`).

Reference parity: `clustering/kmeans/KMeansClustering.java` +
`clustering/cluster/` — k-means++ style seeding, iteration cap,
convergence by centroid movement.

The points live on the device in float32: each iteration is the
distance product and its argmin (`_assign`) and the one-hot product of
the new centroids (`_update`), as the JAX package's jitted pair. The
k-means++ seeding runs on the host copy with the same numpy draws, so
both packages start from the same centroids for the same seed; the loop
reads the largest centroid move once an iteration (the JAX package's
convergence test, one host sync an iteration).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.device import resolve_device


def _assign(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    # pairwise sq-distances via the matmul identity
    p2 = torch.sum(points * points, dim=1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=1)
    d = p2 - 2.0 * points @ centroids.T + c2
    return torch.argmin(d, dim=1)


def _update(points: torch.Tensor, k_onehot: torch.Tensor):
    counts = torch.sum(k_onehot, dim=0)
    sums = k_onehot.T @ points
    return sums / torch.clamp(counts, min=1.0)[:, None], counts


class KMeansClustering:
    """`device`: where the iterations run, the CUDA device unless the
    caller passes `"cpu"` (no card and no explicit CPU raises)."""

    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-4,
                 seed: int = 0, *, device=None):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None

    def fit(self, points) -> "KMeansClustering":
        host = np.asarray(points, np.float32)
        pts = torch.as_tensor(host, device=self.device)
        n = host.shape[0]
        rng = np.random.default_rng(self.seed)

        # k-means++ seeding (host; k small)
        centroids = [host[rng.integers(n)]]
        for _ in range(1, self.k):
            d = np.min(
                [np.sum((host - c) ** 2, axis=1) for c in centroids],
                axis=0)
            probs = d / max(d.sum(), 1e-12)
            centroids.append(host[rng.choice(n, p=probs)])
        cent = torch.as_tensor(np.stack(centroids), device=self.device)

        for _ in range(self.max_iterations):
            a = _assign(pts, cent)
            onehot = (a[:, None] == torch.arange(
                self.k, device=self.device)).to(torch.float32)
            new_cent, counts = _update(pts, onehot)
            # keep empty clusters where they were
            new_cent = torch.where(counts[:, None] > 0, new_cent, cent)
            move = float(torch.max(torch.linalg.vector_norm(
                new_cent - cent, dim=1)))
            cent = new_cent
            if move < self.tol:
                break
        self.centroids = cent.cpu().numpy()
        return self

    def predict(self, points) -> np.ndarray:
        pts = torch.as_tensor(np.asarray(points, np.float32),
                              device=self.device)
        cent = torch.as_tensor(self.centroids, device=self.device)
        # centroids set by hand may be float64: promote as JAX does
        dt = torch.promote_types(pts.dtype, cent.dtype)
        return _assign(pts.to(dt), cent.to(dt)).cpu().numpy()

    def inertia(self, points) -> float:
        a = self.predict(points)
        return float(np.sum((np.asarray(points) - self.centroids[a]) ** 2))
