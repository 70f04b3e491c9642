"""t-SNE as dense / blocked tensor iterations on the device (port of
`deeplearning4j_tpu/clustering/tsne.py`).

Reference parity: `plot/BarnesHutTsne.java:65` / `plot/Tsne.java:36` — the
same perplexity-calibrated P matrix, early exaggeration, and momentum
gradient descent. The reference approximates the repulsive forces with a
Barnes-Hut quadtree over a VPTree kNN graph. The two paths here, chosen
by n, are the JAX package's:

- exact (small n): the dense O(n²) pairwise form, a couple of products
  an iteration. It runs in float64 on every device (the JAX package's
  `_fit_exact` casts to float64 too; its tests run with x64 on); the
  per-point perplexity search stays the host's numpy loop.
- blocked (large n), float32: a blocked kNN sweep (O(n²) products,
  O(n·block) memory) builds the sparse symmetrized P; the perplexity
  search is vectorized over the [n, k] distances; attraction is an
  `index_add_` over the 2nk sparse entries (JAX's `segment_sum`);
  repulsion stays exact, computed in [block, n] tiles (JAX's `lax.map`
  over row blocks becomes a loop over blocks, its `lax.scan` a loop).

Every iteration of either path is device work only: the loop reads
nothing back (no host sync) until the embedding is returned.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.device import resolve_device


def _pairwise_sq_dists(x):
    s = torch.sum(x * x, dim=1)
    return s[:, None] - 2.0 * x @ x.T + s[None, :]


def _calibrate_p(dists: np.ndarray, perplexity: float, tol=1e-5, iters=50):
    """Binary-search per-point precision to hit the target perplexity
    (reference: Tsne.java computeGaussianPerplexity)."""
    n = dists.shape[0]
    target = np.log(perplexity)
    P = np.zeros((n, n))
    for i in range(n):
        beta_lo, beta_hi, beta = -np.inf, np.inf, 1.0
        di = np.delete(dists[i], i)
        for _ in range(iters):
            p = np.exp(-di * beta)
            sum_p = max(p.sum(), 1e-12)
            H = np.log(sum_p) + beta * np.sum(di * p) / sum_p
            diff = H - target
            if abs(diff) < tol:
                break
            if diff > 0:
                beta_lo = beta
                beta = beta * 2 if beta_hi == np.inf else (beta + beta_hi) / 2
            else:
                beta_hi = beta
                beta = beta / 2 if beta_lo == -np.inf else (beta + beta_lo) / 2
        row = np.exp(-di * beta)
        row = row / max(row.sum(), 1e-12)
        P[i, np.arange(n) != i] = row
    return P


def _gains_step(y, grad, gains, velocity, momentum, lr):
    """Delta-bar-delta gains, the momentum step, recentring."""
    same_sign = torch.sign(grad) == torch.sign(velocity)
    gains = torch.where(same_sign, gains * 0.8, gains + 0.2)
    gains = torch.clamp(gains, min=0.01)
    velocity = momentum * velocity - lr * gains * grad
    y = y + velocity
    return y - torch.mean(y, dim=0), gains, velocity


def _tsne_step(y, p, gains, velocity, momentum, lr):
    d2 = _pairwise_sq_dists(y)
    q_num = 1.0 / (1.0 + d2)
    q_num = q_num - torch.diag(torch.diag(q_num))
    q = q_num / torch.clamp(torch.sum(q_num), min=1e-12)
    pq = (p - torch.clamp(q, min=1e-12)) * q_num
    grad = 4.0 * ((torch.diag(torch.sum(pq, dim=1)) - pq) @ y)
    return _gains_step(y, grad, gains, velocity, momentum, lr)


# --------------------------------------------------- blocked (large-n) path
def _pad_rows(x, block):
    n = x.shape[0]
    pad = (-n) % block
    if pad:
        x = torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), np.inf,
                                     dtype=x.dtype, device=x.device)])
    return x, n + pad


def _knn_blocked(x, k: int, block: int):
    """k nearest neighbors by blocked exact sweep: each block computes
    one [block, n] distance tile and keeps its top-k — O(n²) products,
    O(n·block) memory (the VPTree's role in `BarnesHutTsne.java`).
    Self-distances and padding columns are masked to +inf."""
    n = x.shape[0]
    xp, n_pad = _pad_rows(x, block)
    xz = torch.where(torch.isfinite(xp), xp, 0.0)
    sq = torch.where(torch.isfinite(xp[:, 0]),
                     torch.sum(xz ** 2, dim=1), np.inf)
    col = torch.arange(n_pad, device=x.device)[None, :]
    dists, idx = [], []
    for i in range(n_pad // block):
        rows = xz[i * block:(i + 1) * block]
        rsq = sq[i * block:(i + 1) * block]
        d2 = rsq[:, None] - 2.0 * rows @ xz.T + sq[None, :]
        row_ids = i * block + torch.arange(block, device=x.device)[:, None]
        d2 = torch.where((col == row_ids) | (col >= n), np.inf, d2)
        neg, ix = torch.topk(-d2, k)
        dists.append(-neg)
        idx.append(ix)
    return torch.cat(dists)[:n], torch.cat(idx)[:n]


def _calibrate_p_knn(d2, perplexity: float, iters: int = 50):
    """Vectorized per-point precision search over the [n, k] kNN distance
    matrix — every point's binary search advances in lockstep on the
    device (reference: computeGaussianPerplexity's scalar loop)."""
    target = torch.log(torch.tensor(perplexity, dtype=d2.dtype,
                                    device=d2.device))
    n = d2.shape[0]
    # subtract the row min for numerical stability (shift-invariant H)
    d2 = d2 - d2[:, :1]
    beta = torch.ones(n, dtype=d2.dtype, device=d2.device)
    lo = torch.full((n,), -np.inf, dtype=d2.dtype, device=d2.device)
    hi = torch.full((n,), np.inf, dtype=d2.dtype, device=d2.device)
    for _ in range(iters):
        p = torch.exp(-d2 * beta[:, None])
        sum_p = torch.clamp(p.sum(1), min=1e-12)
        H = torch.log(sum_p) + beta * (d2 * p).sum(1) / sum_p
        hot = H > target            # entropy too high -> raise beta
        lo = torch.where(hot, beta, lo)
        hi = torch.where(hot, hi, beta)
        beta = torch.where(
            hot,
            torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(torch.isneginf(lo), beta / 2.0, (beta + lo) / 2.0))
    p = torch.exp(-d2 * beta[:, None])
    return p / torch.clamp(p.sum(1, keepdim=True), min=1e-12)


def _tsne_step_blocked(y, rows, cols, vals, gains, velocity, momentum, lr,
                       block: int):
    """One gradient step with sparse attraction + blocked EXACT repulsion.

    grad_i = 4 [ Σ_j p_ij q_ij (y_i - y_j)  -  (1/Z) Σ_j q_ij² (y_i - y_j) ]
    where q_ij = 1/(1+|y_i-y_j|²). The attractive sum runs over the 2nk
    sparse symmetrized-P entries (`index_add_`); the repulsive sum and Z
    are computed in [block, n] tiles so peak memory is O(n·block)."""
    n = y.shape[0]
    # attraction over sparse entries
    diff = y[rows] - y[cols]
    qn = 1.0 / (1.0 + torch.sum(diff * diff, dim=1))
    attr = torch.zeros_like(y).index_add_(0, rows,
                                          (vals * qn)[:, None] * diff)

    # blocked exact repulsion
    yp, n_pad = _pad_rows(y, block)
    yz = torch.where(torch.isfinite(yp), yp, 0.0)
    sq = torch.sum(yz * yz, dim=1)
    col = torch.arange(n_pad, device=y.device)[None, :]
    rep_blocks, z_blocks = [], []
    for i in range(n_pad // block):
        rows_y = yz[i * block:(i + 1) * block]
        rsq = sq[i * block:(i + 1) * block]
        d2 = rsq[:, None] - 2.0 * rows_y @ yz.T + sq[None, :]
        rid = i * block + torch.arange(block, device=y.device)[:, None]
        q = 1.0 / (1.0 + d2)
        q = torch.where((col == rid) | (col >= n) | (rid >= n), 0.0, q)
        q2 = q * q
        rep_blocks.append(q2.sum(1)[:, None] * rows_y - q2 @ yz)
        z_blocks.append(q.sum())
    rep = torch.cat(rep_blocks)[:n]
    z = torch.clamp(torch.stack(z_blocks).sum(), min=1e-12)

    grad = 4.0 * (attr - rep / z)
    return _gains_step(y, grad, gains, velocity, momentum, lr)


class BarnesHutTsne:
    """Reference-named t-SNE: exact dense for small n, blocked-sparse for
    large n (see module docstring). `method`: 'auto' (default — exact up
    to `exact_threshold` points), 'exact', or 'blocked'. `device`: where
    the iterations run, the CUDA device unless the caller passes `"cpu"`
    (no card and no explicit CPU raises)."""

    def __init__(self, *, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 500,
                 early_exaggeration: float = 12.0, momentum: float = 0.8,
                 seed: int = 0, method: str = "auto",
                 exact_threshold: int = 2048, block: int = 1024,
                 n_neighbors: Optional[int] = None, device=None):
        if method not in ("auto", "exact", "blocked"):
            raise ValueError(f"method must be auto|exact|blocked, got {method!r}")
        self.n_components = n_components
        self.perplexity = perplexity
        self.lr = learning_rate
        self.n_iter = n_iter
        self.early_exaggeration = early_exaggeration
        self.momentum = momentum
        self.seed = seed
        self.method = method
        self.exact_threshold = exact_threshold
        self.block = block
        self.n_neighbors = n_neighbors
        self.device = resolve_device(device)
        self.embedding_: Optional[np.ndarray] = None

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x)
        n = x.shape[0]
        method = self.method
        if method == "auto":
            method = "exact" if n <= self.exact_threshold else "blocked"
        if method == "exact":
            return self._fit_exact(np.asarray(x, np.float64))
        return self._fit_blocked(np.asarray(x, np.float32))

    def _rates(self, it: int, exag: int):
        """(momentum, learning rate) of iteration `it` as the float32
        values the JAX package passes its step (0.8 is not exact in
        float32)."""
        mom = 0.5 if it < exag else self.momentum
        return float(np.float32(mom)), float(np.float32(self.lr))

    def _fit_exact(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        dev = self.device
        d2 = _pairwise_sq_dists(torch.as_tensor(x, device=dev)).cpu().numpy()
        P = _calibrate_p(d2, min(self.perplexity, (n - 1) / 3))
        P = (P + P.T) / (2 * n)
        P = np.maximum(P, 1e-12)

        rng = np.random.default_rng(self.seed)
        y = torch.as_tensor(rng.standard_normal((n, self.n_components))
                            * 1e-2, device=dev)
        gains = torch.ones_like(y)
        vel = torch.zeros_like(y)
        exag = int(self.n_iter * 0.25)
        p_dev = torch.as_tensor(P, device=dev)
        p_exag = p_dev * self.early_exaggeration
        for it in range(self.n_iter):
            y, gains, vel = _tsne_step(y, p_exag if it < exag else p_dev,
                                       gains, vel, *self._rates(it, exag))
        self.embedding_ = y.cpu().numpy()
        return self.embedding_

    def _fit_blocked(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        dev = self.device
        perp = min(self.perplexity, (n - 1) / 3)
        if self.n_neighbors is not None and self.n_neighbors < 1:
            raise ValueError(f"n_neighbors must be >=1, got {self.n_neighbors}")
        k = min(n - 1, self.n_neighbors if self.n_neighbors is not None
                else max(4, int(3 * perp)))
        block = min(self.block, n)
        d2, idx = _knn_blocked(torch.as_tensor(x, device=dev), k, block)
        p = _calibrate_p_knn(d2.to(torch.float32), perp)

        # symmetrize the sparse P: every directed entry (i, j, p_ij/2n)
        # also contributes (j, i, p_ij/2n) — 2nk COO entries
        rows = torch.arange(n, device=dev).repeat_interleave(k)
        cols = idx.reshape(-1)
        vals = p.reshape(-1) / (2.0 * n)
        rows, cols = torch.cat([rows, cols]), torch.cat([cols, rows])
        vals = torch.cat([vals, vals])

        rng = np.random.default_rng(self.seed)
        y = torch.as_tensor(rng.standard_normal((n, self.n_components))
                            * 1e-2, dtype=torch.float32, device=dev)
        gains = torch.ones_like(y)
        vel = torch.zeros_like(y)
        exag = int(self.n_iter * 0.25)
        v_exag = vals * self.early_exaggeration
        for it in range(self.n_iter):
            y, gains, vel = _tsne_step_blocked(
                y, rows, cols, v_exag if it < exag else vals, gains, vel,
                *self._rates(it, exag), block)
        self.embedding_ = y.cpu().numpy()
        return self.embedding_
