"""KD-tree for low-dimensional exact NN.

A copy of `deeplearning4j_tpu/clustering/kdtree.py`, which imports
nothing of JAX: the port keeps its own.

Reference parity: `clustering/kdtree/KDTree.java`.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _KDNode:
    __slots__ = ("index", "axis", "left", "right")

    def __init__(self, index, axis):
        self.index = index
        self.axis = axis
        self.left: Optional["_KDNode"] = None
        self.right: Optional["_KDNode"] = None


class KDTree:
    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, np.float64)
        self.root = self._build(list(range(len(self.points))), 0)

    def _build(self, idx: List[int], depth: int) -> Optional[_KDNode]:
        if not idx:
            return None
        axis = depth % self.points.shape[1]
        idx.sort(key=lambda i: self.points[i, axis])
        mid = len(idx) // 2
        node = _KDNode(idx[mid], axis)
        node.left = self._build(idx[:mid], depth + 1)
        node.right = self._build(idx[mid + 1:], depth + 1)
        return node

    def nn(self, target, k: int = 1) -> Tuple[List[int], List[float]]:
        target = np.asarray(target, np.float64)
        heap: List[Tuple[float, int]] = []

        def visit(node):
            if node is None:
                return
            p = self.points[node.index]
            d = float(np.linalg.norm(p - target))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            diff = target[node.axis] - p[node.axis]
            near, far = (node.left, node.right) if diff <= 0 else \
                (node.right, node.left)
            visit(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far)

        visit(self.root)
        pairs = sorted([(-nd, i) for nd, i in heap])
        return [i for _, i in pairs], [d for d, _ in pairs]
