"""DeepWalk graph embeddings with degree-based Huffman hierarchical softmax
(port of `deeplearning4j_tpu/graph/deepwalk.py`).

Reference parity: `deeplearning4j-graph/.../models/deepwalk/DeepWalk.java`
(initialize from vertex degrees :67-93, fit over walk iterators :95-191,
skipgram window pairs trained via hierarchical softmax in
`models/embeddings/InMemoryGraphLookupTable.java`), Huffman coding over
degrees `models/deepwalk/GraphHuffman.java:39` (buildTree), query surface
`models/GraphVectors.java` / `models/embeddings/GraphVectorsImpl.java`
(similarity, verticesNearest), and text serialization
`models/loader/GraphVectorSerializer.java`.

The reference spawns one thread per walk iterator, each doing per-pair
sigmoid updates into shared arrays (DeepWalk.java:114-156). Here the
whole walk matrix is generated vectorized on the host (graph/walks.py,
numpy draws from `seed`) and training is batched hierarchical-softmax
skipgram steps of `nlp/sequence_vectors.py` on the device (`device=`,
the CUDA device unless the caller asks for the CPU): one step handles
~10^4 (center, context) pairs — gathers, BCE over Huffman code bits,
the summed row gradients, SGD. `save` writes the JAX package's text
format, and each package loads the other's files.
"""

from __future__ import annotations

import heapq
import json
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Graph
from deeplearning4j_tpu_torch.graph.walks import generate_walks
from deeplearning4j_tpu_torch.utils.device import resolve_device


class GraphHuffman:
    """Huffman coding over vertex degrees. Reference:
    `models/deepwalk/GraphHuffman.java:39` (buildTree over vertexDegree[]);
    codes cap at maxCodeLength=64 bits there, unconstrained here."""

    def __init__(self, degrees: np.ndarray):
        n = len(degrees)
        self.n_vertices = n
        self.n_inner = max(n - 1, 1)
        codes: List[List[int]] = [[] for _ in range(n)]
        points: List[List[int]] = [[] for _ in range(n)]
        if n > 1:
            heap: List[Tuple[int, int]] = [(int(degrees[i]), i)
                                           for i in range(n)]
            heapq.heapify(heap)
            parent, binary = {}, {}
            nxt = n
            while len(heap) > 1:
                c1, i1 = heapq.heappop(heap)
                c2, i2 = heapq.heappop(heap)
                parent[i1], parent[i2] = nxt, nxt
                binary[i1], binary[i2] = 0, 1
                heapq.heappush(heap, (c1 + c2, nxt))
                nxt += 1
            root = heap[0][1]
            for i in range(n):
                code, pts = [], []
                node = i
                while node != root:
                    code.append(binary[node])
                    p = parent[node]
                    pts.append(p - n)
                    node = p
                codes[i] = list(reversed(code))
                points[i] = list(reversed(pts))
        self._codes, self._points = codes, points

    def get_code(self, vertex: int) -> List[int]:
        """Reference: `GraphHuffman.getCode/getCodeString:111-131`."""
        return self._codes[vertex]

    def get_code_length(self, vertex: int) -> int:
        return len(self._codes[vertex])

    def get_path_inner_nodes(self, vertex: int) -> List[int]:
        """Reference: `GraphHuffman.getPathInnerNodes:132`."""
        return self._points[vertex]

    def padded(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        lens = np.array([len(c) for c in self._codes], dtype=np.int64)
        L = max(int(lens.max()) if len(lens) else 1, 1)
        V = self.n_vertices
        codes = np.zeros((V, L), dtype=np.int32)
        points = np.zeros((V, L), dtype=np.int32)
        for i in range(V):
            c, p = self._codes[i], self._points[i]
            codes[i, :len(c)] = c
            points[i, :len(p)] = p
        return codes, points, lens


class DeepWalk:
    """Reference: `models/deepwalk/DeepWalk.java` Builder surface
    (vectorSize :205, learningRate :211, windowSize :217, seed :226) mapped
    to kwargs; `fit(graph, walkLength)` :95. `device`: where the steps
    run, the CUDA device unless the caller passes `"cpu"`."""

    def __init__(self, *, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.01, walks_per_vertex: int = 1,
                 weighted_walks: bool = False, batch_size: int = 8192,
                 epochs: int = 1, seed: int = 12345, device=None):
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.walks_per_vertex = walks_per_vertex
        self.weighted_walks = weighted_walks
        self.batch_size = batch_size
        self.epochs = epochs
        self.seed = seed
        self.vertex_vectors: Optional[np.ndarray] = None  # syn0 [V,D]
        self._inner: Optional[np.ndarray] = None          # syn1 [V-1,D]
        self.huffman: Optional[GraphHuffman] = None

    # ------------------------------------------------------------ lifecycle
    def initialize(self, graph_or_degrees) -> "DeepWalk":
        """Build the Huffman tree + init vectors. Reference:
        `DeepWalk.initialize:67-93` (uniform init scaled by vector size)."""
        degrees = (graph_or_degrees.degrees()
                   if isinstance(graph_or_degrees, Graph)
                   else np.asarray(graph_or_degrees))
        # clamp isolated vertices to weight 1 so the query-facing
        # GraphHuffman and the training engine's Huffman tree are built
        # from the SAME weights (warm-start consistency)
        degrees = np.maximum(np.asarray(degrees), 1)
        V, D = len(degrees), self.vector_size
        self._degrees = degrees
        self.huffman = GraphHuffman(degrees)
        rng = np.random.default_rng(self.seed)
        self.vertex_vectors = (
            (rng.random((V, D), dtype=np.float32) - 0.5) / D)
        self._inner = np.zeros((max(V - 1, 1), D), dtype=np.float32)
        return self

    def fit(self, graph: Graph, walk_length: int = 10) -> "DeepWalk":
        """Generate walks + train. Reference: `DeepWalk.fit:95-112`."""
        if self.huffman is None:
            self.initialize(graph)
        walks = generate_walks(
            graph, walk_length=walk_length,
            walks_per_vertex=self.walks_per_vertex,
            weighted=self.weighted_walks, seed=self.seed)
        return self.fit_walks(walks)

    def fit_walks(self, walks: np.ndarray) -> "DeepWalk":
        """Train on a precomputed walk matrix [N, L] — the equivalent of
        `DeepWalk.fit(GraphWalkIterator):158-191` skipgram windows.

        Training runs on the shared SequenceVectors engine (the reference
        routes DeepWalk through SequenceVectors the same way): walks become
        element sequences, vertex DEGREES become the vocab counts (so the
        engine's count-based Huffman tree is the reference's degree-based
        GraphHuffman), full fixed window, constant learning rate."""
        from deeplearning4j_tpu_torch.nlp.sequence_vectors import (
            SequenceVectors,
        )

        if self.huffman is None:
            raise RuntimeError("call initialize() first")
        sv = SequenceVectors(
            layer_size=self.vector_size, window=self.window_size,
            min_count=0, hierarchic_softmax=True, subsampling=0.0,
            epochs=self.epochs, learning_rate=self.learning_rate,
            min_learning_rate=self.learning_rate,   # constant LR (reference)
            batch_size=self.batch_size, seed=self.seed,
            dynamic_window=False, device=self.device)
        sv.initial_syn0 = self.vertex_vectors
        sv.initial_syn1 = self._inner
        # walk entries already ARE vocab indices (vertex ids) — the indexed
        # fast path skips per-element string lookups; vocab index == vertex
        # id, so trained syn0 rows come back vertex-aligned.
        sv.fit_indexed(np.asarray(walks), self._degrees)
        self.vertex_vectors = sv.syn0
        self._inner = sv._syn1
        return self

    # -------------------------------------------------------------- queries
    def get_vertex_vector(self, i: int) -> np.ndarray:
        """Reference: `GraphVectorsImpl.getVertexVector`."""
        return self.vertex_vectors[i]

    def similarity(self, a: int, b: int) -> float:
        """Cosine similarity. Reference: `GraphVectorsImpl.similarity`."""
        va, vb = self.vertex_vectors[a], self.vertex_vectors[b]
        denom = np.linalg.norm(va) * np.linalg.norm(vb) + 1e-12
        return float(va @ vb / denom)

    def vertices_nearest(self, vertex: int, top: int = 10) -> List[int]:
        """Reference: `GraphVectorsImpl.verticesNearest`."""
        v = self.vertex_vectors[vertex]
        norms = np.linalg.norm(self.vertex_vectors, axis=1) + 1e-12
        sims = self.vertex_vectors @ v / (norms * (np.linalg.norm(v) + 1e-12))
        order = np.argsort(-sims)
        return [int(i) for i in order if i != vertex][:top]

    @property
    def num_vertices(self) -> int:
        return len(self.vertex_vectors)

    # ---------------------------------------------------------------- serde
    def save(self, path: str) -> None:
        """Text format: header json + one `index<TAB>v0 v1 ...` line per
        vertex. Reference: `GraphVectorSerializer.writeGraphVectors`."""
        with open(path, "w") as f:
            f.write(json.dumps({
                "vector_size": self.vector_size,
                "window_size": self.window_size,
                "num_vertices": self.num_vertices,
            }) + "\n")
            for i, row in enumerate(self.vertex_vectors):
                f.write(str(i) + "\t" + " ".join(
                    repr(float(x)) for x in row) + "\n")

    @classmethod
    def load(cls, path: str, device=None) -> "DeepWalk":
        """Reference: `GraphVectorSerializer.loadTxtVectors`. `device`:
        where a later `fit` of the loaded model runs."""
        with open(path) as f:
            head = json.loads(f.readline())
            dw = cls(vector_size=head["vector_size"],
                     window_size=head.get("window_size", 5), device=device)
            vecs = np.zeros((head["num_vertices"], head["vector_size"]),
                            dtype=np.float32)
            for line in f:
                idx, rest = line.split("\t", 1)
                vecs[int(idx)] = np.array(rest.split(), dtype=np.float32)
        dw.vertex_vectors = vecs
        return dw


class Node2Vec(DeepWalk):
    """node2vec = DeepWalk's trainer over p/q-biased second-order walks
    (Grover & Leskovec 2016). Capability extension: the reference's NLP
    stack names `models/node2vec/` but ships no complete trainer; here
    the biased `Node2VecWalker` feeds the same hierarchical-softmax
    skip-gram engine as DeepWalk."""

    def __init__(self, *, p: float = 1.0, q: float = 1.0, **kw):
        super().__init__(**kw)
        self.p = p
        self.q = q

    def fit(self, graph: Graph, walk_length: int = 10) -> "Node2Vec":
        from deeplearning4j_tpu_torch.graph.walks import Node2VecWalker

        if self.huffman is None:
            self.initialize(graph)
        walker = Node2VecWalker(graph, walk_length, p=self.p, q=self.q,
                                seed=self.seed)
        starts = np.tile(np.arange(graph.num_vertices(), dtype=np.int64),
                         self.walks_per_vertex)
        self.fit_walks(walker.walks(starts))
        return self
