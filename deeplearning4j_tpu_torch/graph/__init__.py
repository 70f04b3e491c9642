"""Graph embeddings: graph API, random walks, DeepWalk (port of
`deeplearning4j_tpu/graph/`).

Reference parity: `deeplearning4j-graph/` — graph structures
(`graph/api/IGraph.java`, `graph/graph/Graph.java`), random-walk iterators
(`graph/iterator/RandomWalkIterator.java`, `WeightedRandomWalkIterator.java`),
DeepWalk (`graph/models/deepwalk/DeepWalk.java`) with degree-based Huffman
coding (`graph/models/deepwalk/GraphHuffman.java`), vector queries
(`graph/models/GraphVectors.java`) and serialization
(`graph/models/loader/GraphVectorSerializer.java`).

The graph and the walks are host numpy (copies of the JAX package's
modules); DeepWalk's and Node2Vec's steps run on the device through
`nlp/sequence_vectors.py`. The package exports the JAX package's
`__all__`, resolved at first use.
"""

from deeplearning4j_tpu_torch import _lazy_getattr

_EXPORTS = {
    "graph.api": (
        "Edge", "Graph", "NoEdgeHandling", "Vertex", "load_edge_list",
        "load_weighted_edge_list",
    ),
    "graph.walks": (
        "Node2VecWalker", "RandomWalker", "WeightedWalker", "generate_walks",
    ),
    "graph.deepwalk": (
        "DeepWalk", "GraphHuffman", "Node2Vec",
    ),
}
_LAZY = {n: (f"deeplearning4j_tpu_torch.{m}", n)
         for m, names in _EXPORTS.items() for n in names}


__getattr__ = _lazy_getattr(__name__, _LAZY)

__all__ = list(_LAZY)
