"""Vectorized random-walk generation.

A copy of `deeplearning4j_tpu/graph/walks.py`,
which imports nothing of JAX: the port keeps its own.

Reference parity: `deeplearning4j-graph/.../iterator/RandomWalkIterator.java`
(uniform walks), `WeightedRandomWalkIterator.java` (edge-weight-biased walks),
and the SequenceVectors graph walkers
(`deeplearning4j-nlp/.../models/sequencevectors/graph/walkers/impl/` —
RandomWalker, WeightedWalker, PopularityWalker, NearestVertexWalker).

TPU redesign: instead of one iterator object yielding one walk at a time
(the reference threads N iterators for parallelism —
`iterator/parallel/RandomWalkGraphIteratorProvider.java`), ALL walks advance
in lockstep as a single `[n_walks]` frontier vector: each step is one
vectorized gather into the padded neighbor table. Generating the full
`[n_walks, walk_length]` matrix at once feeds device-side batched skipgram
directly — no per-walk Python loop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Graph, NoEdgeHandling


class RandomWalker:
    """Uniform random walks. Reference: `iterator/RandomWalkIterator.java`
    (next() loop choosing a uniform neighbor per step)."""

    def __init__(self, graph: Graph, walk_length: int, *, seed: int = 0,
                 no_edge_handling: NoEdgeHandling =
                 NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.no_edge_handling = no_edge_handling

    def walks(self, starts: Optional[np.ndarray] = None) -> np.ndarray:
        """[n_walks, walk_length+1] vertex-index matrix; starts defaults to
        every vertex once (the reference iterates all vertices in order)."""
        nbrs, _, degs = self.graph.neighbor_table()
        if starts is None:
            starts = np.arange(self.graph.num_vertices(), dtype=np.int64)
        self._check_disconnected(degs, starts)
        rng = np.random.default_rng(self.seed)
        n = len(starts)
        out = np.empty((n, self.walk_length + 1), dtype=np.int64)
        out[:, 0] = starts
        cur = starts
        for t in range(1, self.walk_length + 1):
            d = degs[cur]
            choice = (rng.random(n) * np.maximum(d, 1)).astype(np.int64)
            nxt = nbrs[cur, choice]
            cur = np.where(d > 0, nxt, cur)  # self-loop on disconnected
            out[:, t] = cur
        return out

    def _check_disconnected(self, degs, starts):
        if (self.no_edge_handling is NoEdgeHandling.EXCEPTION_ON_DISCONNECTED
                and (degs[starts] == 0).any()):
            bad = int(starts[np.argmax(degs[starts] == 0)])
            raise ValueError(
                f"Vertex {bad} has no edges "
                "(NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)")


class WeightedWalker(RandomWalker):
    """Edge-weight-biased walks. Reference:
    `iterator/WeightedRandomWalkIterator.java` (cumulative-weight sampling)."""

    def walks(self, starts: Optional[np.ndarray] = None) -> np.ndarray:
        nbrs, wts, degs = self.graph.neighbor_table()
        if starts is None:
            starts = np.arange(self.graph.num_vertices(), dtype=np.int64)
        self._check_disconnected(degs, starts)
        rng = np.random.default_rng(self.seed)
        # cumulative weights per row for inverse-CDF sampling
        cum = np.cumsum(wts, axis=1)
        tot = np.maximum(cum[:, -1], 1e-30)
        n = len(starts)
        out = np.empty((n, self.walk_length + 1), dtype=np.int64)
        out[:, 0] = starts
        cur = starts
        for t in range(1, self.walk_length + 1):
            u = rng.random(n) * tot[cur]
            choice = (cum[cur] < u[:, None]).sum(axis=1)
            choice = np.minimum(choice, np.maximum(degs[cur] - 1, 0))
            nxt = nbrs[cur, choice]
            cur = np.where(degs[cur] > 0, nxt, cur)
            out[:, t] = cur
        return out


class Node2VecWalker(RandomWalker):
    """node2vec p/q-biased second-order walks — capability extension beyond
    the reference (its NLP stack names `models/node2vec/` but ships no
    complete trainer); return parameter p, in-out parameter q per Grover &
    Leskovec 2016."""

    def __init__(self, graph: Graph, walk_length: int, *, p: float = 1.0,
                 q: float = 1.0, seed: int = 0,
                 no_edge_handling: NoEdgeHandling =
                 NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED):
        super().__init__(graph, walk_length, seed=seed,
                         no_edge_handling=no_edge_handling)
        self.p = p
        self.q = q

    def walks(self, starts: Optional[np.ndarray] = None) -> np.ndarray:
        nbrs, wts, degs = self.graph.neighbor_table()
        if starts is None:
            starts = np.arange(self.graph.num_vertices(), dtype=np.int64)
        self._check_disconnected(degs, starts)
        rng = np.random.default_rng(self.seed)
        n = len(starts)
        max_d = nbrs.shape[1]
        # Sorted neighbor rows (padding → sentinel V, no vertex id collides)
        # enable a fully vectorized dist(prev, x) == 1 membership test via
        # one flat searchsorted per step — no per-row Python loops.
        V = self.graph.num_vertices()
        col = np.arange(max_d)[None, :]
        snbrs = np.sort(np.where(col < degs[:, None], nbrs, V), axis=1)
        row_off = (np.arange(n, dtype=np.int64) * (V + 2))[:, None]
        out = np.empty((n, self.walk_length + 1), dtype=np.int64)
        out[:, 0] = starts
        prev = starts.copy()
        d0 = degs[starts]
        choice = (rng.random(n) * np.maximum(d0, 1)).astype(np.int64)
        cur = np.where(d0 > 0, nbrs[starts, choice], starts)
        if self.walk_length >= 1:
            out[:, 1] = cur
        valid = np.arange(max_d)[None, :]
        for t in range(2, self.walk_length + 1):
            cand = nbrs[cur]                              # [n, max_d]
            w = wts[cur].copy()
            w[valid >= degs[cur][:, None]] = 0.0
            # bias: back to prev → w/p ; dist(prev,·)==1 → w ; else → w/q
            back = cand == prev[:, None]
            # keys are globally sorted: rows ascend, offsets jump by V+2
            sorted_keys = (snbrs[prev] + row_off).ravel()
            cand_keys = (cand + row_off).ravel()
            pos = np.searchsorted(sorted_keys, cand_keys)
            hit = pos < sorted_keys.size
            hit[hit] = sorted_keys[pos[hit]] == cand_keys[hit]
            is_nbr = hit.reshape(n, max_d)
            alpha = np.where(back, 1.0 / self.p,
                             np.where(is_nbr, 1.0, 1.0 / self.q))
            w = w * alpha
            cum = np.cumsum(w, axis=1)
            tot = np.maximum(cum[:, -1], 1e-30)
            u = rng.random(n) * tot
            choice = (cum < u[:, None]).sum(axis=1)
            choice = np.minimum(choice, np.maximum(degs[cur] - 1, 0))
            nxt = np.where(degs[cur] > 0, cand[np.arange(n), choice], cur)
            prev, cur = cur, nxt
            out[:, t] = cur
        return out


def generate_walks(graph: Graph, *, walk_length: int = 10,
                   walks_per_vertex: int = 1, weighted: bool = False,
                   seed: int = 0) -> np.ndarray:
    """All-vertices walk matrix [V * walks_per_vertex, walk_length+1] —
    the vectorized equivalent of the reference's
    `GraphWalkIteratorProvider.getGraphWalkIterators` fan-out."""
    cls = WeightedWalker if weighted else RandomWalker
    mats = []
    V = graph.num_vertices()
    for k in range(walks_per_vertex):
        walker = cls(graph, walk_length, seed=seed + k)
        mats.append(walker.walks(np.arange(V, dtype=np.int64)))
    return np.concatenate(mats, axis=0)
