"""Graph data structures + loaders.

A copy of `deeplearning4j_tpu/graph/api.py`,
which imports nothing of JAX: the port keeps its own.

Reference parity: `deeplearning4j-graph/src/main/java/org/deeplearning4j/graph/`
— `api/IGraph.java` (vertex/edge contract), `api/Vertex.java`, `api/Edge.java`,
`api/NoEdgeHandling.java`, `graph/Graph.java` (adjacency-list impl), and the
edge-list loaders `data/GraphLoader.java` +
`data/impl/{DelimitedEdgeLineProcessor,WeightedEdgeLineProcessor}.java`.

TPU redesign: vertices are dense ints and adjacency is stored as padded
numpy arrays (`[V, max_degree]` neighbor table + degree vector) so that walk
generation is fully vectorized over thousands of walkers at once — the walk
table feeds device-side batched skipgram training directly.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class NoEdgeHandling(enum.Enum):
    """Reference: `graph/api/NoEdgeHandling.java` — what a walker does when
    it reaches a vertex with no outgoing edges."""

    SELF_LOOP_ON_DISCONNECTED = "self_loop"
    EXCEPTION_ON_DISCONNECTED = "exception"


@dataclasses.dataclass
class Vertex:
    """Reference: `graph/api/Vertex.java` — index + arbitrary value."""

    index: int
    value: Any = None


@dataclasses.dataclass
class Edge:
    """Reference: `graph/api/Edge.java`."""

    src: int
    dst: int
    value: Any = None
    directed: bool = False

    @property
    def weight(self) -> float:
        return float(self.value) if self.value is not None else 1.0


class Graph:
    """Adjacency-list graph over dense integer vertices.

    Reference: `graph/graph/Graph.java` (extends `api/BaseGraph.java`).
    Supports directed/undirected edges, optional weights, vertex values,
    and exports padded neighbor tables for vectorized walks.
    """

    def __init__(self, num_vertices: int, *,
                 vertex_values: Optional[Sequence[Any]] = None):
        if num_vertices <= 0:
            raise ValueError("num_vertices must be positive")
        self._adj: List[List[Tuple[int, float]]] = [
            [] for _ in range(num_vertices)]
        self.vertices = [
            Vertex(i, vertex_values[i] if vertex_values else None)
            for i in range(num_vertices)
        ]
        self._dirty = True
        self._nbr_table: Optional[np.ndarray] = None
        self._weight_table: Optional[np.ndarray] = None
        self._degrees: Optional[np.ndarray] = None

    # ------------------------------------------------------------- mutation
    def add_edge(self, src: int, dst: int, value: Any = None,
                 directed: bool = False) -> None:
        """Reference: `Graph.addEdge`. Undirected edges are stored in both
        adjacency lists (BaseGraph semantics)."""
        w = float(value) if value is not None else 1.0
        self._adj[src].append((dst, w))
        if not directed and src != dst:
            self._adj[dst].append((src, w))
        self._dirty = True

    def add_edges(self, edges: Iterable[Edge]) -> None:
        for e in edges:
            self.add_edge(e.src, e.dst, e.value, e.directed)

    # -------------------------------------------------------------- queries
    def num_vertices(self) -> int:
        return len(self._adj)

    def num_edges(self) -> int:
        return sum(len(a) for a in self._adj)

    def get_vertex(self, i: int) -> Vertex:
        return self.vertices[i]

    def get_connected_vertex_indices(self, i: int) -> List[int]:
        """Reference: `Graph.getConnectedVertexIndices`."""
        return [d for d, _ in self._adj[i]]

    def degree(self, i: int) -> int:
        """Reference: `Graph.getVertexDegree`."""
        return len(self._adj[i])

    def degrees(self) -> np.ndarray:
        self._build_tables()
        return self._degrees

    # ---------------------------------------------------- vectorized export
    def _build_tables(self) -> None:
        if not self._dirty:
            return
        V = self.num_vertices()
        degs = np.array([len(a) for a in self._adj], dtype=np.int64)
        max_d = max(int(degs.max()), 1) if V else 1
        nbrs = np.zeros((V, max_d), dtype=np.int64)
        wts = np.zeros((V, max_d), dtype=np.float64)
        for i, a in enumerate(self._adj):
            # self-loop padding keeps gather in-bounds for degree-0 rows
            nbrs[i, :] = i
            for j, (d, w) in enumerate(a):
                nbrs[i, j] = d
                wts[i, j] = w
        self._nbr_table, self._weight_table, self._degrees = nbrs, wts, degs
        self._dirty = False

    def neighbor_table(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(neighbors [V, max_deg], weights [V, max_deg], degrees [V]) —
        padded arrays for vectorized walk generation."""
        self._build_tables()
        return self._nbr_table, self._weight_table, self._degrees


def load_edge_list(path_or_lines, num_vertices: int, *, delimiter: str = ",",
                   directed: bool = False) -> Graph:
    """Unweighted edge-list loader ("src,dst" per line). Reference:
    `data/GraphLoader.loadUndirectedGraphEdgeListFile` +
    `data/impl/DelimitedEdgeLineProcessor.java`."""
    g = Graph(num_vertices)
    for line in _iter_lines(path_or_lines):
        parts = line.split(delimiter)
        if len(parts) < 2:
            continue
        g.add_edge(int(parts[0]), int(parts[1]), directed=directed)
    return g


def load_weighted_edge_list(path_or_lines, num_vertices: int, *,
                            delimiter: str = ",",
                            directed: bool = False) -> Graph:
    """Weighted edge-list loader ("src,dst,weight"). Reference:
    `data/GraphLoader.loadWeightedEdgeListFile` +
    `data/impl/WeightedEdgeLineProcessor.java`."""
    g = Graph(num_vertices)
    for line in _iter_lines(path_or_lines):
        parts = line.split(delimiter)
        if len(parts) < 3:
            continue
        g.add_edge(int(parts[0]), int(parts[1]), float(parts[2]),
                   directed=directed)
    return g


def _iter_lines(path_or_lines) -> Iterable[str]:
    if isinstance(path_or_lines, (list, tuple)):
        yield from (l.strip() for l in path_or_lines if l.strip())
        return
    with open(path_or_lines) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line
