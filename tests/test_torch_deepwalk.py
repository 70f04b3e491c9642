"""The port's graph package against the JAX package's: the graph API and
loaders, the walkers (numpy draws from one seed: walks equal entry for
entry), `GraphHuffman`, `DeepWalk` and `Node2Vec` fits (tables within
float32 tolerance, `TABLE_RTOL` of their largest |value|) and the text
files each package saves and the other loads."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import graph as J
from deeplearning4j_tpu_torch import graph as P

TABLE_RTOL = 1e-5


def two_rings(pkg, n=12, weighted=False):
    """Two rings joined by one edge, with a chord in each."""
    g = pkg.Graph(2 * n)
    for base in (0, n):
        for i in range(n):
            g.add_edge(base + i, base + (i + 1) % n,
                       (1.0 + i % 3) if weighted else None)
        g.add_edge(base, base + n // 2)
    g.add_edge(0, n)
    return g


def assert_tables(got, want, what):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert np.abs(got - want).max() <= TABLE_RTOL * scale, what


def test_graph_api_and_loaders_equal(tmp_path):
    a, b = two_rings(J, weighted=True), two_rings(P, weighted=True)
    assert (a.num_vertices(), a.num_edges()) == (b.num_vertices(),
                                                 b.num_edges())
    for i in range(a.num_vertices()):
        assert a.get_connected_vertex_indices(i) == \
            b.get_connected_vertex_indices(i)
        assert a.degree(i) == b.degree(i)
    assert np.array_equal(a.degrees(), b.degrees())
    for x, y in zip(a.neighbor_table(), b.neighbor_table()):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    a.add_edge(3, 5, directed=True)
    b.add_edge(3, 5, directed=True)
    assert a.get_connected_vertex_indices(3) == \
        b.get_connected_vertex_indices(3)
    (tmp_path / "e.csv").write_text("0,1\n1,2\n# note\n2,0\n\n3,1\n")
    (tmp_path / "w.tsv").write_text("0\t1\t2.5\n1\t2\t0.5\n")
    ga = J.load_edge_list(str(tmp_path / "e.csv"), 4)
    gb = P.load_edge_list(str(tmp_path / "e.csv"), 4)
    for x, y in zip(ga.neighbor_table(), gb.neighbor_table()):
        assert np.array_equal(x, y)
    ga = J.load_weighted_edge_list(str(tmp_path / "w.tsv"), 3,
                                   delimiter="\t")
    gb = P.load_weighted_edge_list(str(tmp_path / "w.tsv"), 3,
                                   delimiter="\t")
    for x, y in zip(ga.neighbor_table(), gb.neighbor_table()):
        assert np.array_equal(x, y)
    assert J.NoEdgeHandling.EXCEPTION_ON_DISCONNECTED.name == \
        P.NoEdgeHandling.EXCEPTION_ON_DISCONNECTED.name


@pytest.mark.parametrize("walker", ["RandomWalker", "WeightedWalker",
                                    "Node2VecWalker"])
@pytest.mark.parametrize("seed", [0, 7])
def test_walks_equal(walker, seed):
    kw = {"p": 0.5, "q": 2.0} if walker == "Node2VecWalker" else {}
    a = getattr(J, walker)(two_rings(J, weighted=True), 9, seed=seed, **kw)
    b = getattr(P, walker)(two_rings(P, weighted=True), 9, seed=seed, **kw)
    wa, wb = a.walks(), b.walks()
    assert wa.dtype == wb.dtype and np.array_equal(wa, wb)
    starts = np.array([3, 3, 20, 0], dtype=np.int64)
    assert np.array_equal(a.walks(starts), b.walks(starts))


def test_generate_walks_and_disconnected_handling_equal():
    for weighted in (False, True):
        wa = J.generate_walks(two_rings(J, weighted=True), walk_length=6,
                              walks_per_vertex=3, weighted=weighted, seed=4)
        wb = P.generate_walks(two_rings(P, weighted=True), walk_length=6,
                              walks_per_vertex=3, weighted=weighted, seed=4)
        assert np.array_equal(wa, wb)
    ga, gb = J.Graph(3), P.Graph(3)
    ga.add_edge(0, 1)
    gb.add_edge(0, 1)
    assert np.array_equal(J.RandomWalker(ga, 4).walks(),
                          P.RandomWalker(gb, 4).walks())
    for pkg, g in ((J, ga), (P, gb)):
        w = pkg.RandomWalker(g, 4, no_edge_handling=(
            pkg.NoEdgeHandling.EXCEPTION_ON_DISCONNECTED))
        with pytest.raises(ValueError):
            w.walks(np.array([2], dtype=np.int64))


def test_graph_huffman_equal():
    degrees = np.array([5, 1, 1, 3, 8, 2, 2, 1, 6])
    a, b = J.GraphHuffman(degrees), P.GraphHuffman(degrees)
    for v in range(len(degrees)):
        assert a.get_code(v) == b.get_code(v)
        assert a.get_path_inner_nodes(v) == b.get_path_inner_nodes(v)
        assert a.get_code_length(v) == b.get_code_length(v)
    for x, y in zip(a.padded(), b.padded()):
        assert x.dtype == y.dtype and np.array_equal(x, y)


KW = dict(vector_size=16, window_size=3, walks_per_vertex=2,
          batch_size=1024, seed=5)


def test_deepwalk_tables_match_jax():
    a = J.DeepWalk(**KW).fit(two_rings(J), walk_length=8)
    b = P.DeepWalk(**KW, device="cpu").fit(two_rings(P), walk_length=8)
    assert_tables(b.vertex_vectors, a.vertex_vectors, "vertex_vectors")
    assert_tables(b._inner, a._inner, "inner")
    assert b._inner.shape[0] == b.num_vertices - 1
    for v in (0, 5, 13):
        assert a.vertices_nearest(v, 4) == b.vertices_nearest(v, 4)
        assert abs(a.similarity(v, 1) - b.similarity(v, 1)) < 1e-5
    assert np.array_equal(a.get_vertex_vector(3), a.vertex_vectors[3])


def test_deepwalk_initialize_from_degrees_and_fit_walks_match_jax():
    g = two_rings(J)
    walks = J.generate_walks(g, walk_length=6, walks_per_vertex=2, seed=1)
    a = J.DeepWalk(**KW).initialize(g.degrees())
    b = P.DeepWalk(**KW, device="cpu").initialize(g.degrees())
    assert np.array_equal(a.vertex_vectors, b.vertex_vectors)
    a.fit_walks(walks)
    b.fit_walks(walks)
    assert_tables(b.vertex_vectors, a.vertex_vectors, "vertex_vectors")
    with pytest.raises(RuntimeError):
        P.DeepWalk(device="cpu").fit_walks(walks)


def test_node2vec_tables_match_jax():
    kw = dict(KW, p=0.5, q=2.0)
    a = J.Node2Vec(**kw).fit(two_rings(J), walk_length=8)
    b = P.Node2Vec(**kw, device="cpu").fit(two_rings(P), walk_length=8)
    assert_tables(b.vertex_vectors, a.vertex_vectors, "vertex_vectors")
    assert_tables(b._inner, a._inner, "inner")


def test_save_and_load_cross_packages(tmp_path):
    a = J.DeepWalk(**KW).fit(two_rings(J), walk_length=8)
    b = P.DeepWalk(**KW, device="cpu").fit(two_rings(P), walk_length=8)
    b.vertex_vectors = a.vertex_vectors.copy()   # one table, both writers
    a.save(str(tmp_path / "j.txt"))
    b.save(str(tmp_path / "p.txt"))
    assert (tmp_path / "j.txt").read_bytes() == \
        (tmp_path / "p.txt").read_bytes()
    pj = P.DeepWalk.load(str(tmp_path / "j.txt"), device="cpu")
    jp = J.DeepWalk.load(str(tmp_path / "p.txt"))
    for m in (pj, jp):
        assert np.array_equal(m.vertex_vectors, a.vertex_vectors)
        assert (m.vector_size, m.window_size) == (16, 3)


def test_deepwalk_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (P.DeepWalk, P.Node2Vec):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls()
    assert P.DeepWalk(device="cpu").device == torch.device("cpu")
