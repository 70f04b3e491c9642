"""Vantage-point tree for exact k-NN search.

A copy of `deeplearning4j_tpu/clustering/vptree.py`, which imports
nothing of JAX: the port keeps its own.

Reference parity: `clustering/vptree/VPTree.java:39,224` — metric-space
partitioning with median-distance split; backs the nearest-neighbor server
(reference: deeplearning4j-nearestneighbor-server).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional["_Node"] = None
        self.outside: Optional["_Node"] = None


def _dist(a, b, metric: str):
    if metric == "euclidean":
        d = a - b
        return float(np.sqrt(np.sum(d * d)))
    if metric == "cosine":
        na = np.linalg.norm(a) + 1e-12
        nb = np.linalg.norm(b) + 1e-12
        return float(1.0 - (a @ b) / (na * nb))
    raise ValueError(metric)


class VPTree:
    def __init__(self, items: np.ndarray, metric: str = "euclidean",
                 seed: int = 0):
        self.items = np.asarray(items, np.float64)
        self.metric = metric
        self._rng = np.random.default_rng(seed)
        idx = list(range(len(self.items)))
        self.root = self._build(idx)

    def _build(self, idx: List[int]) -> Optional[_Node]:
        if not idx:
            return None
        i = idx[self._rng.integers(len(idx))]
        idx = [j for j in idx if j != i]
        node = _Node(i)
        if idx:
            d = np.array([_dist(self.items[i], self.items[j], self.metric)
                          for j in idx])
            med = float(np.median(d))
            node.threshold = med
            inside = [j for j, dj in zip(idx, d) if dj <= med]
            outside = [j for j, dj in zip(idx, d) if dj > med]
            node.inside = self._build(inside)
            node.outside = self._build(outside)
        return node

    def search(self, target, k: int = 1) -> Tuple[List[int], List[float]]:
        """k nearest neighbors. Reference: `VPTree.search(...):224`."""
        target = np.asarray(target, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negated distance
        tau = [np.inf]

        def visit(node: Optional[_Node]):
            if node is None:
                return
            d = _dist(target, self.items[node.index], self.metric)
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d < node.threshold:
                visit(node.inside)
                if d + tau[0] >= node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        pairs = sorted([(-nd, i) for nd, i in heap])
        return [i for _, i in pairs], [d for d, _ in pairs]
