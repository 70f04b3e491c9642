"""The port's clustering library and k-NN server
(`deeplearning4j_tpu_torch.clustering`, `serving.knn_server`) against
the JAX package's, on the CPU (`tests/test_clustering_serving.py`'s
cases, each with a counterpart).

Tolerances: k-means runs in float32 in both packages from the same
k-means++ seeds (host numpy draws): assignments equal, centroids and
inertia within 1e-5 relative. Exact t-SNE is float64 in both (JAX's
tests run with x64 on): 10 iterations within 1e-9 of the embedding's
largest |value|. Blocked t-SNE is float32: 10 iterations within 1e-4
of the largest |value| (the neighbour lists may order ties differently,
so the attraction sums in another order). The VP-tree, the KD-tree and
the k-NN server are numpy on the host in both packages: equal answers.
"""

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import clustering as jcl
from deeplearning4j_tpu.clustering import tsne as jtsne
from deeplearning4j_tpu.serving import NearestNeighborsServer as JaxKnn
from deeplearning4j_tpu_torch import clustering as pcl
from deeplearning4j_tpu_torch.clustering import tsne as ptsne
from deeplearning4j_tpu_torch.observe.syncmon import HostSyncMonitor
from deeplearning4j_tpu_torch.serving import NearestNeighborsServer

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """t-SNE's blocked path runs thousands of small ops; with one
    intra-op pool a worker per core (the suite runs several workers on
    one host) their pools oversubscribe the cores and each op waits on
    the others' (one case took 365 s beside the suite, 7 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
EXACT_TOL = 1e-9
BLOCKED_TOL = 1e-4


def _blobs(n_per=50, seed=0, dim=2):
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0], [10, 10], [-10, 10]], np.float64)
    if dim > 2:
        centers = np.concatenate(
            [centers, rng.standard_normal((3, dim - 2)) * 10], axis=1)
    pts = np.concatenate([
        c + rng.standard_normal((n_per, dim)) for c in centers])
    return pts, np.repeat(np.arange(3), n_per)


def _separated(emb, labels, step_i=7, step_j=11):
    within, cross = [], []
    for i in range(0, len(emb), step_i):
        for j in range(0, len(emb), step_j):
            d = np.linalg.norm(emb[i] - emb[j])
            (within if labels[i] == labels[j] else cross).append(d)
    return np.mean(within) < 0.5 * np.mean(cross)


def _syncs(fn):
    with HostSyncMonitor(device="cpu") as mon:
        fn()
    return mon.syncs


# --------------------------------------------------------------- kmeans
class TestKMeans:
    @pytest.mark.parametrize("seed,k,dim", [(0, 3, 2), (1, 3, 2),
                                            (2, 5, 16)])
    def test_matches_jax(self, seed, k, dim):
        pts, _ = _blobs(seed=seed, dim=dim)
        j = jcl.KMeansClustering(k, seed=seed).fit(pts)
        p = pcl.KMeansClustering(k, seed=seed, **CPU).fit(pts)
        np.testing.assert_array_equal(p.predict(pts), j.predict(pts))
        np.testing.assert_allclose(p.centroids, j.centroids, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(p.inertia(pts), j.inertia(pts),
                                   rtol=1e-5)

    def test_seeding_is_jaxs(self):
        # max_iterations 0: the k-means++ seeds alone
        pts, _ = _blobs(seed=4, dim=5)
        j = jcl.KMeansClustering(4, max_iterations=0, seed=3).fit(pts)
        p = pcl.KMeansClustering(4, max_iterations=0, seed=3,
                                 **CPU).fit(pts)
        np.testing.assert_array_equal(p.centroids, j.centroids)

    def test_recovers_blobs(self):
        pts, labels = _blobs()
        pred = pcl.KMeansClustering(3, seed=1, **CPU).fit(pts).predict(pts)
        for c in range(3):
            counts = np.bincount(pred[labels == c], minlength=3)
            assert counts.max() / counts.sum() > 0.95

    def test_inertia_decreases_vs_random(self):
        pts, _ = _blobs()
        km = pcl.KMeansClustering(3, seed=0, **CPU).fit(pts)
        rand = pcl.KMeansClustering(3, max_iterations=0, seed=0, **CPU)
        rand.centroids = np.random.default_rng(5).standard_normal((3, 2)) \
            * 10
        assert km.inertia(pts) < rand.inertia(pts)

    def test_one_read_an_iteration(self):
        """The convergence test reads the largest move once an iteration
        (JAX's loop): tol 0 runs every iteration."""
        pts, _ = _blobs(seed=2)
        reads = [_syncs(lambda n=n: pcl.KMeansClustering(
            3, max_iterations=n, tol=0.0, seed=0, **CPU).fit(pts))
            for n in (2, 5)]
        assert reads[1] - reads[0] == 3


def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pcl.KMeansClustering(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pcl.BarnesHutTsne()


# ---------------------------------------------------------------- trees
class TestTrees:
    @pytest.mark.parametrize("metric", ["euclidean", "cosine"])
    def test_vptree_matches_bruteforce_and_jax(self, metric):
        rng = np.random.default_rng(0)
        pts = rng.standard_normal((200, 8))
        tree, jtree = pcl.VPTree(pts, metric=metric), \
            jcl.VPTree(pts, metric=metric)
        for _ in range(5):
            q = rng.standard_normal(8)
            idx, dist = tree.search(q, 5)
            assert (idx, dist) == jtree.search(q, 5)
            if metric == "euclidean":
                brute = np.argsort(np.linalg.norm(pts - q, axis=1))[:5]
                assert set(idx) == set(brute.tolist())
            assert dist == sorted(dist)
        assert tree.search(pts[7], 1)[0][0] == 7

    def test_kdtree_matches_bruteforce_and_jax(self):
        rng = np.random.default_rng(2)
        pts = rng.standard_normal((150, 3))
        tree, jtree = pcl.KDTree(pts), jcl.KDTree(pts)
        for _ in range(5):
            q = rng.standard_normal(3)
            idx, dist = tree.nn(q, 4)
            assert (idx, dist) == jtree.nn(q, 4)
            brute = np.argsort(np.linalg.norm(pts - q, axis=1))[:4]
            assert set(idx) == set(brute.tolist())


# ----------------------------------------------------------------- tsne
def _tsne_pair(x, **kw):
    j = jcl.BarnesHutTsne(**kw).fit_transform(x)
    p = pcl.BarnesHutTsne(**kw, **CPU).fit_transform(x)
    return j, p


class TestTsne:
    def test_exact_ten_iterations_match_jax(self):
        x = np.random.default_rng(0).standard_normal((60, 5))
        j, p = _tsne_pair(x, n_iter=10, perplexity=10, method="exact")
        assert p.dtype == j.dtype == np.float64
        np.testing.assert_allclose(p, j, rtol=0,
                                   atol=EXACT_TOL * np.abs(j).max())

    def test_blocked_ten_iterations_match_jax(self):
        pts, _ = _blobs(n_per=100, seed=1, dim=6)     # 300 points
        j, p = _tsne_pair(pts, n_iter=10, perplexity=10, method="blocked",
                          block=64)
        assert p.dtype == j.dtype == np.float32
        np.testing.assert_allclose(p, j, rtol=0,
                                   atol=BLOCKED_TOL * np.abs(j).max())

    def test_knn_blocked_matches_jax_and_bruteforce(self):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((57, 5)).astype(np.float32)
        d2, idx = ptsne._knn_blocked(torch.as_tensor(x), 6, 16)
        jd2, jidx = jtsne._knn_blocked(jnp.asarray(x), 6, 16)
        full = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(full, np.inf)
        brute = np.argsort(full, axis=1)[:, :6]
        for i in range(57):
            # the same neighbour sets (ties may order differently)
            assert set(idx[i].tolist()) == set(np.asarray(jidx)[i]) \
                == set(brute[i]), i
        # distances: ascending, equal to JAX's, the self-distance and
        # the padding rows (57 -> 64) masked out
        np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5,
                                   atol=1e-5)
        assert bool((d2[:, 1:] >= d2[:, :-1]).all())
        assert d2.shape == (57, 6) and bool(torch.isfinite(d2).all())

    def test_calibrated_p_matches_jax(self):
        rng = np.random.default_rng(4)
        d2 = np.sort(rng.random((40, 12)).astype(np.float32) * 5, axis=1)
        p = ptsne._calibrate_p_knn(torch.as_tensor(d2), 5.0)
        jp = jtsne._calibrate_p_knn(jnp.asarray(d2), jnp.asarray(
            5.0, jnp.float32))
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(p.sum(1).numpy(), 1.0, rtol=1e-6)

    @pytest.mark.parametrize("method", ["exact", "blocked"])
    def test_no_host_read_an_iteration(self, method):
        pts, _ = _blobs(n_per=20)
        kw = dict(perplexity=5, method=method, block=16, seed=0, **CPU)
        reads = [_syncs(lambda n=n: pcl.BarnesHutTsne(
            n_iter=n, **kw).fit_transform(pts)) for n in (2, 12)]
        assert reads[0] == reads[1]

    def test_preserves_cluster_structure(self):
        pts, labels = _blobs(n_per=30)
        emb = pcl.BarnesHutTsne(n_iter=250, perplexity=10, seed=0,
                                **CPU).fit_transform(pts)
        assert emb.shape == (90, 2) and _separated(emb, labels)

    def test_blocked_preserves_cluster_structure(self):
        pts, labels = _blobs(n_per=200)
        emb = pcl.BarnesHutTsne(n_iter=250, perplexity=30, seed=0,
                                method="blocked", block=128,
                                **CPU).fit_transform(pts)
        assert emb.shape == (600, 2)
        assert _separated(emb, labels, 41, 53)
        assert abs(emb.mean(0)).max() < 1e-3 * abs(emb).max()

    def test_auto_dispatch(self):
        t = pcl.BarnesHutTsne(method="auto", exact_threshold=10, n_iter=5,
                              **CPU)
        t.fit_transform(_blobs(n_per=10)[0])
        assert t.embedding_.dtype == np.float32     # the blocked path

    def test_bad_method_rejected(self):
        with pytest.raises(ValueError, match="method"):
            pcl.BarnesHutTsne(method="quantum", **CPU)

    def test_n_neighbors_clamped_and_validated(self):
        pts, _ = _blobs(n_per=10)   # 30 points
        t = pcl.BarnesHutTsne(method="blocked", n_iter=3, n_neighbors=64,
                              **CPU)
        assert t.fit_transform(pts).shape == (30, 2)
        with pytest.raises(ValueError, match="n_neighbors"):
            pcl.BarnesHutTsne(method="blocked", n_neighbors=0,
                              **CPU).fit_transform(pts)


# ----------------------------------------------------------- knn server
def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_knn_server_answers_as_jax(metric):
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((50, 4))
    srv = NearestNeighborsServer(pts, port=0, metric=metric)
    jsrv = JaxKnn(pts, port=0, metric=metric)
    port, jport = srv.start(), jsrv.start()
    try:
        out = _post(port, "/knn", {"ndarray": pts[3].tolist(), "k": 3})
        assert out["results"][0]["index"] == 3
        assert out["results"][0]["distance"] == pytest.approx(0.0, abs=1e-12)
        out2 = _post(port, "/knnindex", {"index": 3, "k": 2})
        assert all(r["index"] != 3 for r in out2["results"])
        assert _get(port, "/healthz") == _get(jport, "/healthz") == \
            {"status": "ok", "points": 50}
        for q in range(6):
            vec = rng.standard_normal(4).tolist()
            body = {"ndarray": vec, "k": 1 + q}
            assert _post(port, "/knn", body) == _post(jport, "/knn", body)
            body = {"index": q * 7, "k": 1 + q}
            assert _post(port, "/knnindex", body) == \
                _post(jport, "/knnindex", body)
        # a request without its field is the client's fault: 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/knn", {"k": 3})
        assert ei.value.code == 400
    finally:
        srv.stop()
        jsrv.stop()
