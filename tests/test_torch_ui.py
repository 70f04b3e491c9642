"""The port's training UI (`deeplearning4j_tpu_torch.ui`) against the
JAX package's (`tests/test_ui.py`'s classes, each with a counterpart
here), on the CPU.

Both packages fit the same two-layer net (test_ui.py's sizes: 4 -> 8 ->
3, batch 32) from the JAX net's weights, in float64 so the two fits stay
within 1e-15 of each other; then:

- the reports agree key for key: every statistic within 1e-6 relative
  (JAX takes them in float32, the port accumulates float32 values in
  float64), or within 1e-6 of its leaf's largest |value| where a mean
  cancels to near zero; histogram counts exactly, histogram edges within
  1e-12 relative (the parameters themselves differ by ~1e-16);
- a conv net's activation PNG is byte for byte JAX's;
- storage files cross both ways;
- every GET route of both servers answers alike after the same fits
  (within the same tolerances, volatile keys aside), and byte for byte
  over the same stored records;
- the remote router, the t-SNE upload, i18n and `updates_since` tailing
  behave as JAX's.
"""

import dataclasses
import json
import re
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.graph import ElementWiseVertex as JaxEW
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import (
    ConvolutionLayer as JConv, DenseLayer as JDense, OutputLayer as JOut,
    SubsamplingLayer as JPool,
)
from deeplearning4j_tpu.optim.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.ui import convolutional as jconv
from deeplearning4j_tpu.ui import stats as jstats
from deeplearning4j_tpu_torch import ui as pui
from deeplearning4j_tpu_torch.models import ComputationGraph
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.observe.syncmon import HostSyncMonitor
from deeplearning4j_tpu_torch.ui import convolutional as pconv
from deeplearning4j_tpu_torch.ui import stats as pstats

STAT_RTOL = 1e-6       # JAX's float32 statistics against float64 sums
EDGE_RTOL = 1e-12      # histogram edges of float64 parameters
ATOL = 1e-12
# values that differ by run (clocks, rates, memory, versions)
VOLATILE = {"timestamp", "minibatches_per_second", "memory_rss_mb",
            "device_memory", "now", "software", "hardware"}
SID = "s"


def _conf(dtype="float64"):
    return (JaxNNC.builder().seed(12345).dtype(dtype).updater(JaxSgd(0.1))
            .list()
            .layer(JDense(n_in=4, n_out=8, activation="tanh"))
            .layer(JOut(n_in=8, n_out=3, activation="softmax",
                        loss="negativeloglikelihood"))
            .build())


def _twin(jnet, cls=MultiLayerNetwork, conf_cls=MultiLayerConfiguration):
    """The port's net on the CPU with the JAX net's weights."""
    pnet = cls(conf_cls.from_json(jnet.conf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    return pnet


def _pair(dtype="float64"):
    jnet = JaxNet(_conf(dtype)).init()
    return jnet, _twin(jnet)


def toy_data(n=64, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(dtype)
    y = np.eye(3, dtype=dtype)[rng.integers(0, 3, n)]
    return x, y


def _fit_both(epochs=2, k=1, listener=True, **kw):
    """Both packages' nets fit the same data with a StatsListener each
    (same session and worker ids) into in-memory storages; returns
    (jax storage, port storage, jax net, port net)."""
    jnet, pnet = _pair()
    js, ps = jui.InMemoryStatsStorage(), pui.InMemoryStatsStorage()
    if listener:
        jnet.set_listeners(jui.StatsListener(js, 1, session_id=SID, **kw))
        pnet.set_listeners(pui.StatsListener(ps, 1, session_id=SID, **kw))
    x, y = toy_data()
    # K 1: 2 batches of 32 an epoch; K 4: 8 of 8, two windows
    fit_kw = dict(epochs=epochs, batch_size=32 if k == 1 else 8,
                  steps_per_dispatch=k)
    jnet.fit(x, y, **fit_kw)
    pnet.fit(x, y, **fit_kw)
    return js, ps, jnet, pnet


def _scale(d):
    """The magnitude a statistics dict's float32 sums are taken at: the
    largest |value| of a parameter's (max, min) or an activation's mean
    magnitude. A mean near zero is a sum that cancels, so its float32
    error is relative to this scale, not to the mean."""
    def mag(v):
        if isinstance(v, list):   # a timeline of the dashboard's
            return max((abs(x) for x in v if x is not None), default=0.0)
        return abs(v)

    if "max" in d and "min" in d and "counts" not in d:
        return max(mag(d["max"]), mag(d["min"]))
    return mag(d.get("mean_magnitude", 0.0))


def _close(got, want, path="", rtol=STAT_RTOL, atol=ATOL):
    """Nested JSON values: the same keys and lengths; numbers within
    `rtol` relative, and within `rtol` of their dict's `_scale` (ints and
    strings exactly); histogram `counts` exactly and their `min`/`max`
    within EDGE_RTOL; VOLATILE keys' values skipped."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        hist = "counts" in want
        inner = max(ATOL, STAT_RTOL * _scale(want))
        for k in want:
            if k in VOLATILE:
                continue
            _close(got[k], want[k], f"{path}/{k}",
                   EDGE_RTOL if hist and k in ("min", "max") else rtol,
                   ATOL if hist else inner)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]", rtol, atol)
    elif isinstance(want, float) and not isinstance(got, bool):
        assert isinstance(got, (int, float)), path
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=path)
    else:
        assert got == want, (path, got, want)


def _updates(storage):
    return [u.content for u in storage.get_all_updates(
        SID, "StatsListener", "local")]


def _histogram(x, bins=20):
    """The port's histogram of one array, as JAX's `_histogram` gives
    it: a tree of one leaf through `segment_histograms`."""
    lengths, seg = pstats.segments([x.size], "cpu")
    counts, lo, hi = pstats.segment_histograms(
        torch.as_tensor(x).reshape(-1), lengths, seg, bins)
    return {"counts": counts[0].tolist(), "min": float(lo[0]),
            "max": float(hi[0])}


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=10) as r:
        return r.read()


def _get_json(url, path):
    return json.loads(_get(url, path))


@pytest.fixture(scope="module")
def fitted():
    """The reference fit: 2 epochs x 2 batches, histograms and
    activations collected."""
    return _fit_both(collect_histograms=True, collect_activations=True)


@pytest.fixture
def servers():
    jsrv, psrv = jui.UIServer(port=0), pui.UIServer(port=0)
    try:
        yield (jsrv, f"http://127.0.0.1:{jsrv.port}",
               psrv, f"http://127.0.0.1:{psrv.port}")
    finally:
        jsrv.stop()
        psrv.stop()


# ------------------------------------------------------------- storage
class TestStatsStorage:
    def rec(self, P, sid="s1", tid="StatsListener", wid="w1", ts=1.0, **kw):
        return P(sid, tid, wid, ts, dict(kw))

    @pytest.mark.parametrize("pkg", [jui, pui], ids=["jax", "port"])
    def test_update_and_query(self, pkg):
        st = pkg.InMemoryStatsStorage()
        st.put_static_info(self.rec(pkg.Persistable, ts=0.5, model="m"))
        st.put_update(self.rec(pkg.Persistable, ts=1.0, score=2.0))
        st.put_update(self.rec(pkg.Persistable, ts=2.0, score=1.0))
        assert st.list_session_ids() == ["s1"]
        assert st.list_type_ids("s1") == ["StatsListener"]
        assert st.list_worker_ids("s1") == ["w1"]
        assert st.num_updates("s1", "StatsListener", "w1") == 2
        assert st.get_latest_update("s1", "StatsListener",
                                    "w1").content["score"] == 1.0
        assert len(st.get_all_updates_after("s1", "StatsListener", "w1",
                                            1.5)) == 1

    def test_listener_events_match_jax(self):
        kinds = []
        for pkg in (jui, pui):
            st, events = pkg.InMemoryStatsStorage(), []
            st.register_stats_storage_listener(events.append)
            st.put_static_info(self.rec(pkg.Persistable))
            st.put_update(self.rec(pkg.Persistable, ts=2.0))
            st.deregister_stats_storage_listener(events.append)
            st.put_update(self.rec(pkg.Persistable, ts=3.0))
            kinds.append([dataclasses.astuple(e) for e in events])
        assert kinds[0] == kinds[1]
        assert [k[0] for k in kinds[1]] == ["new_session", "post_static",
                                            "post_update"]

    @pytest.mark.parametrize("writer,reader", [(jui, pui), (pui, jui)],
                             ids=["jax-to-port", "port-to-jax"])
    def test_file_storage_crosses_packages(self, tmp_path, writer, reader):
        p = str(tmp_path / "stats.jsonl")
        st = writer.FileStatsStorage(p)
        st.put_static_info(self.rec(writer.Persistable, model="m"))
        st.put_update(self.rec(writer.Persistable, ts=3.0, score=0.5))
        st.close()
        st2 = reader.FileStatsStorage(p)
        assert st2.num_updates("s1", "StatsListener", "w1") == 1
        assert st2.get_static_info("s1", "StatsListener",
                                   "w1").content["model"] == "m"
        st2.put_update(self.rec(reader.Persistable, ts=4.0, score=0.25))
        st2.close()
        st3 = writer.FileStatsStorage(p)
        assert [u.content["score"] for u in st3.get_all_updates(
            "s1", "StatsListener", "w1")] == [0.5, 0.25]
        st3.close()

    def test_fit_files_are_the_same_bytes(self, tmp_path, fitted):
        """A fit's records written by each package's FileStatsStorage
        give the same file."""
        js, ps, _, _ = fitted
        paths = []
        for name, pkg, src in (("j", jui, js), ("p", pui, js)):
            path = tmp_path / f"{name}.jsonl"
            st = pkg.FileStatsStorage(str(path))
            for tid in src.list_type_ids(SID):
                for wid in src.list_worker_ids(SID, tid):
                    st.put_static_info(pkg.Persistable(
                        **dataclasses.asdict(src.get_static_info(
                            SID, tid, wid))))
                    for u in src.get_all_updates(SID, tid, wid):
                        st.put_update(pkg.Persistable(
                            **dataclasses.asdict(u)))
            st.close()
            paths.append(path)
        assert paths[0].read_bytes() == paths[1].read_bytes()
        # and the port's own fit replays in the JAX package
        path = tmp_path / "port_fit.jsonl"
        st = pui.FileStatsStorage(str(path))
        for u in ps.get_all_updates(SID, "StatsListener", "local"):
            st.put_update(u)
        st.close()
        back = jui.FileStatsStorage(str(path))
        assert [u.content for u in back.get_all_updates(
            SID, "StatsListener", "local")] == _updates(ps)
        back.close()


# ------------------------------------------------------------ listener
class TestStatsListener:
    def test_reports_match_jax(self, fitted):
        js, ps, jnet, pnet = fitted
        jr, pr = _updates(js), _updates(ps)
        assert len(jr) == len(pr) == 4        # 2 epochs * 2 batches
        for j, p in zip(jr, pr):
            assert list(p) == list(j)         # the same keys, in order
            _close(p, j)
        assert "update_histograms" not in pr[0] and \
            "update_histograms" in pr[1]
        # population std (ddof 0), as jnp.std
        w = pnet.params_tree["layer0_denselayer"]["W"].reshape(-1)
        np.testing.assert_allclose(
            pr[-1]["param_stats"]["layer0_denselayer/W"]["std"],
            float(torch.std(w.float().double(), correction=0)), rtol=1e-12)
        jst = js.get_static_info(SID, "StatsListener", "local").content
        pst = ps.get_static_info(SID, "StatsListener", "local").content
        assert set(pst) == set(jst)
        assert pst["num_params"] == jst["num_params"] == pnet.num_params()
        assert pst["config_json"] == jst["config_json"]
        assert set(pst["software"]) == {"torch_version", "cuda", "backend"}
        assert pst["software"]["backend"] == "cpu"
        assert set(pst["hardware"]) == set(jst["hardware"])

    @pytest.mark.parametrize("frequency", [2, 3])
    def test_frequency_thinning(self, frequency):
        js, ps = jui.InMemoryStatsStorage(), pui.InMemoryStatsStorage()
        jnet, pnet = _pair()
        jnet.set_listeners(jui.StatsListener(js, frequency, session_id=SID))
        pnet.set_listeners(pui.StatsListener(ps, frequency, session_id=SID))
        x, y = toy_data()
        jnet.fit(x, y, epochs=2, batch_size=32)
        pnet.fit(x, y, epochs=2, batch_size=32)
        assert ps.num_updates(SID, "StatsListener", "local") == \
            js.num_updates(SID, "StatsListener", "local") == 4 // frequency
        for j, p in zip(_updates(js), _updates(ps)):
            assert p["iteration"] == j["iteration"]
            _close(p, j)

    @pytest.mark.parametrize("k", [1, 4])
    def test_activation_stats_under_k_step_dispatch(self, k):
        """`_last_features` is kept by the per-step and the K-step fit
        paths, so `collect_activations` reports the activations of the
        window's last batch as JAX's does."""
        js, ps, _, _ = _fit_both(epochs=1, k=k, collect_activations=True)
        jr, pr = _updates(js), _updates(ps)
        assert len(pr) == len(jr) == (2 if k == 1 else 8)
        for j, p in zip(jr, pr):
            assert set(p["activation_stats"]) == set(j["activation_stats"])
            _close(p["activation_stats"], j["activation_stats"])

    def test_leaf_names_follow_jax_flatten_order(self):
        """Keys sorted at every level (not insertion order), joined by
        "/", empty dicts and `()` holding no leaf."""
        tree = {"b": {"z": np.ones(2), "a": np.zeros(3)},
                "a": {"W": np.ones((2, 2))}, "c": {}, "d": ()}
        want = jstats._leaf_names(jax.tree_util.tree_map(np.asarray, tree))
        got = [n for n, _ in pstats.named_leaves(
            {k: ({kk: torch.as_tensor(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else v) for k, v in tree.items()})]
        assert got == want == ["a/W", "b/a", "b/z"]

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_leaf_stats_match_jax_tree_stats(self, dtype):
        rng = np.random.default_rng(1)
        tree = {"l0": {"W": rng.standard_normal((8, 5)).astype(dtype) + 0.3,
                       "b": rng.random(5).astype(dtype)},
                "l1": {"W": rng.standard_normal((5, 3)).astype(dtype)}}
        want = jstats._to_plain(jax.device_get(jstats._tree_stats(tree)))
        leaves = pstats.named_leaves(jax.tree_util.tree_map(
            torch.as_tensor, tree))
        lengths, seg = pstats.segments([x.numel() for _, x in leaves], "cpu")
        rows = pstats.segment_stats(
            torch.cat([x.reshape(-1) for _, x in leaves]), lengths, seg)
        for (name, _), row in zip(leaves, rows.tolist()):
            got = dict(zip(pstats.STAT_KEYS, row))
            assert list(got) == list(want[name])
            _close(got, want[name])

    def test_segment_histograms_are_each_leafs(self):
        """The flat, segmented histograms of a tree equal each leaf's
        `np.histogram` (a constant leaf and a one-element leaf among
        them)."""
        rng = np.random.default_rng(2)
        xs = [rng.standard_normal(300).astype(np.float32),
              np.full(5, -1.5, np.float32), np.array([2.0], np.float32),
              (rng.random(1000) * 1e-3).astype(np.float32)]
        lengths, seg = pstats.segments([len(x) for x in xs], "cpu")
        counts, lo, hi = pstats.segment_histograms(
            torch.as_tensor(np.concatenate(xs)), lengths, seg, 20)
        for i, x in enumerate(xs):
            assert {"counts": counts[i].tolist(), "min": float(lo[i]),
                    "max": float(hi[i])} == jstats._histogram(x, 20)

    @pytest.mark.parametrize("case", [
        "normal32", "normal64", "uniform32", "constant32", "constant64",
        "edges32", "ties64", "tiny32", "one32", "wide64"])
    def test_histogram_counts_are_numpys(self, case):
        """`ui.stats.segment_histograms` against `np.histogram(x,
        bins=20)` (JAX's `_histogram`): counts and edges exactly on the
        CPU."""
        rng = np.random.default_rng(7)
        x = {"normal32": rng.standard_normal(1000).astype(np.float32),
             "normal64": rng.standard_normal(1000),
             "uniform32": rng.random(4097).astype(np.float32),
             "constant32": np.full(7, 0.25, np.float32),
             "constant64": np.full(3, -2.0),
             # values on every edge of [0, 20]
             "edges32": np.arange(21, dtype=np.float32).repeat(3),
             "ties64": rng.integers(-3, 4, 500).astype(np.float64) / 7,
             "tiny32": (rng.standard_normal(300) * 1e-30).astype(np.float32),
             "one32": np.array([3.5], np.float32),
             "wide64": np.concatenate([rng.standard_normal(200) * 1e6,
                                       [1e-300, -1e-300]])}[case]
        want = jstats._histogram(x, 20)
        got = _histogram(x)
        assert got == want
        assert sum(got["counts"]) == x.size

    def test_mixed_dtype_tree_maps_rows_back_to_names(self):
        """Leaves of three dtypes interleaved in name order: each group
        is reduced flat, and every row lands on its own name (statistics
        against float64 numpy, histograms against `np.histogram`,
        updates against the difference in the leaf's dtype)."""
        import types

        rng = np.random.default_rng(5)
        dts = {"a": torch.float64, "b": torch.float32, "c": torch.bfloat16,
               "d": torch.float64}
        tree = {k: {"W": torch.as_tensor(rng.standard_normal(
            (3 + i, 4))).to(dt)} for i, (k, dt) in enumerate(dts.items())}
        model = types.SimpleNamespace(params_tree=tree)
        st = pui.InMemoryStatsStorage()
        lis = pui.StatsListener(st, 1, session_id=SID,
                                collect_histograms=True)
        before = {k: v["W"].clone() for k, v in tree.items()}
        lis.iteration_done(model, 1, 0, torch.tensor(0.5))
        for v in tree.values():
            v["W"].add_(torch.as_tensor(rng.standard_normal(
                tuple(v["W"].shape)) * 0.01).to(v["W"].dtype))
        lis.iteration_done(model, 2, 0, torch.tensor(0.25))
        rep = _updates(st)[-1]
        assert rep["score"] == 0.25
        for k in dts:
            name, w = f"{k}/W", tree[k]["W"]
            xd = w.float().double().numpy().ravel()
            want = {"max": xd.max(), "mean": xd.mean(),
                    "mean_magnitude": np.abs(xd).mean(), "min": xd.min(),
                    "norm2": np.linalg.norm(xd), "std": xd.std()}
            for key, v in want.items():
                assert rep["param_stats"][name][key] == pytest.approx(
                    v, rel=1e-12, abs=1e-15), (name, key)
            u = (w - before[k]).to(torch.float64 if w.dtype ==
                                   torch.float64 else torch.float32)
            u = u.numpy().ravel()
            assert rep["update_stats"][name]["norm2"] == pytest.approx(
                np.linalg.norm(u), rel=1e-12)
            assert rep["update_histograms"][name] == jstats._histogram(
                u, 20)
            assert rep["param_histograms"][name] == jstats._histogram(
                w.to(torch.float64 if w.dtype == torch.float64
                     else torch.float32).numpy().ravel(), 20)

    @pytest.mark.parametrize("case", ["normal32", "uniform32",
                                      "constant32", "edges32", "bf16"])
    def test_histogram_follows_numpy_1_edges(self, case, monkeypatch):
        """Beside NumPy 1 the port takes float32 data's edges in float64,
        rounded to float32 once, as NumPy 1's `linspace` did (NumPy 2
        takes them in float32): held to NumPy 1's uniform-bin path,
        written out here in numpy."""
        rng = np.random.default_rng(8)
        x = {"normal32": (rng.standard_normal(5000) * 0.02)
             .astype(np.float32),
             "uniform32": (rng.random(4097) - 0.5).astype(np.float32),
             "constant32": np.full(7, 0.3, np.float32),
             "edges32": np.arange(-10, 11, dtype=np.float32).repeat(3),
             "bf16": torch.as_tensor(rng.standard_normal(20000) * 0.03)
             .to(torch.bfloat16).float().numpy()}[case]
        lo, hi = x.min(), x.max()
        lo64, hi64 = np.float64(lo), np.float64(hi)
        if lo == hi:
            lo64, hi64 = lo64 - 0.5, hi64 + 0.5
        edges = np.arange(21, dtype=np.float64) * ((hi64 - lo64) / 20) \
            + lo64
        edges[-1] = hi64
        edges = edges.astype(np.float32)
        f = (x - np.float32(lo64)) / np.float32(hi64 - lo64) * 20
        idx = f.astype(np.intp)
        idx[idx == 20] -= 1
        idx[x < edges[idx]] -= 1
        idx[(x >= edges[idx + 1]) & (idx != 19)] += 1
        want = np.bincount(idx, minlength=20).tolist()
        monkeypatch.setattr(pstats, "_EDGES_IN_FLOAT64", True)
        assert _histogram(x) == {"counts": want, "min": float(edges[0]),
                                 "max": float(edges[-1])}

    def test_one_readback_a_report(self):
        """A report reads one packed tensor back: the fit with the
        listener makes exactly one host read more a report than without
        (a CPU monitor counts reads of CPU tensors)."""
        counts = []
        for listen in (False, True):
            _, pnet = _pair()
            if listen:
                lis = pui.StatsListener(pui.InMemoryStatsStorage(), 1,
                                        collect_histograms=True,
                                        collect_activations=True)
                pnet.set_listeners(lis)
            x, y = toy_data()
            with HostSyncMonitor(device="cpu") as mon:
                pnet.fit(x, y, epochs=2, batch_size=32)
            counts.append(mon.syncs)
        assert counts[1] - counts[0] == 4
        # score + 6 stats x 4 leaves + 2 x 4 update stats + 2 x 4
        # histograms of 22 + 3 x 2 activation stats
        assert lis.last_readback_bytes == 8 * (1 + 24 + 8 + 8 * 22 + 6)


# -------------------------------------------------------------- servers
def _jax_get_routes():
    """The GET routes of JAX's `_Handler.do_GET`, read from its source."""
    import inspect

    src = inspect.getsource(jui.server._Handler.do_GET)
    routes = re.findall(r'^\s+"(/[^"]*|)":', src, re.M)
    assert len(routes) >= 20
    return routes


class TestUIServer:
    def test_overview_endpoint(self, fitted, servers):
        js, ps, _, _ = fitted
        jsrv, jurl, psrv, purl = servers
        jsrv.attach(js)
        psrv.attach(ps)
        page = _get(purl, "/").decode()
        assert "Training overview" in page
        got, want = _get_json(purl, "/train/overview"), \
            _get_json(jurl, "/train/overview")
        assert len(got["scores"]) == 4
        assert got["static"]["model_class"] == "MultiLayerNetwork"
        _close(got, want)

    def test_remote_router_roundtrip(self, servers):
        for srv, url, pkg in ((servers[0], servers[1], jui),
                              (servers[2], servers[3], pui)):
            srv.enable_remote_listener()
            router = pkg.RemoteStatsRouter(url, raise_on_error=True)
            router.put_static_info(pkg.Persistable("s9", "T", "w", 1.0,
                                                   {"model": "x"}))
            router.put_update(pkg.Persistable("s9", "T", "w", 2.0,
                                              {"score": 3.0}))
        jst, pst = servers[0].storage, servers[2].storage
        assert pst.list_session_ids() == jst.list_session_ids() == ["s9"]
        assert pst.get_latest_update("s9", "T", "w") == \
            pui.Persistable(**dataclasses.asdict(
                jst.get_latest_update("s9", "T", "w")))

    def test_port_router_posts_to_jax_server_and_back(self, servers):
        """The wire format is shared: each package's router feeds the
        other's receiver."""
        jsrv, jurl, psrv, purl = servers
        jsrv.enable_remote_listener()
        psrv.enable_remote_listener()
        pui.RemoteStatsRouter(jurl, raise_on_error=True).put_update(
            pui.Persistable("a", "T", "w", 1.0, {"score": 1.5}))
        jui.RemoteStatsRouter(purl, raise_on_error=True).put_update(
            jui.Persistable("b", "T", "w", 2.0, {"score": 2.5}))
        assert jsrv.storage.get_latest_update(
            "a", "T", "w").content == {"score": 1.5}
        assert psrv.storage.get_latest_update(
            "b", "T", "w").content == {"score": 2.5}

    def test_remote_disabled_404(self, servers):
        for url, pkg in ((servers[1], jui), (servers[3], pui)):
            router = pkg.RemoteStatsRouter(url, raise_on_error=True)
            with pytest.raises(urllib.error.HTTPError) as ei:
                router.put_update(pkg.Persistable("s", "T", "w", 1.0, {}))
            assert ei.value.code == 404

    def test_silent_router_drops_on_error(self, servers):
        # raise_on_error False (the default): the listener never blocks
        router = pui.RemoteStatsRouter(servers[3], timeout=2.0)
        router.put_update(pui.Persistable("s", "T", "w", 1.0, {}))

    def test_every_route_after_the_same_fits(self, fitted, servers):
        """Every GET route's answer from the port's server after the
        port's fit against JAX's after JAX's: JSON within the stated
        tolerances (volatile keys aside), HTML pages and the script of
        the same kind."""
        js, ps, _, _ = fitted
        jsrv, jurl, psrv, purl = servers
        jsrv.attach(js)
        psrv.attach(ps)
        for route in _jax_get_routes():
            jb, pb = _get(jurl, route), _get(purl, route)
            if route.endswith(".html") or route in ("", "/train",
                                                    "/train/activations"):
                assert pb.startswith(b"<!doctype html>"), route
                assert jb.startswith(b"<!doctype html>"), route
            elif route == "/js/app.js":
                assert pb == jb
            elif route == "/train/activations/data":
                assert pb == jb == pconv.empty_png()
            else:
                _close(json.loads(pb), json.loads(jb), route)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(purl, "/no/such/route")
        assert ei.value.code == 404

    def test_every_route_is_jaxs_over_the_same_records(self, fitted,
                                                       servers, tmp_path):
        """The port's fit written to a file and replayed by both
        packages: every GET route answers byte for byte as JAX's."""
        _, ps, _, _ = fitted
        path = str(tmp_path / "run.jsonl")
        st = pui.FileStatsStorage(path)
        st.put_static_info(ps.get_static_info(SID, "StatsListener",
                                              "local"))
        for u in ps.get_all_updates(SID, "StatsListener", "local"):
            st.put_update(u)
        st.close()
        jst, pst = jui.FileStatsStorage(path), pui.FileStatsStorage(path)
        jsrv, jurl, psrv, purl = servers
        jsrv.attach(jst)
        psrv.attach(pst)
        mid = _updates(ps)[1]["timestamp"]
        for route in _jax_get_routes() + [f"/train/updates?since={mid}"]:
            assert _get(purl, route) == _get(jurl, route), route
        jst.close()
        pst.close()


# ----------------------------------------------------------- components
class TestComponents:
    """Reference: deeplearning4j-ui-components — JSON-serializable chart
    components, each also rendered to inline SVG/HTML."""

    @staticmethod
    def _comps(pkg):
        return [
            pkg.ChartLine(title="l", series_names=("a",), x=((0.0, 1.0),),
                          y=((2.0, 3.0),)),
            pkg.ChartHistogram(title="h", lower_bounds=(0.0, 1.0),
                               upper_bounds=(1.0, 2.0), counts=(3.0, 5.0)),
            pkg.ChartScatter(title="s", series_names=("c0",), x=((1.0,),),
                             y=((2.0,),)),
            pkg.ChartHorizontalBar(title="b", labels=("p", "q"),
                                   values=(1.0, 2.0)),
            pkg.ChartStackedArea(title="sa", series_names=("a", "b"),
                                 x=(0.0, 1.0), y=((1.0, 2.0), (3.0, 1.0))),
            pkg.ChartTimeline(title="t", lanes=("etl", "step"),
                              entries=((0, 0.0, 1.0, "load"),
                                       (1, 1.0, 2.5, "train"))),
            pkg.ComponentTable(title="tb", header=("k", "v"),
                               rows=(("a", "1"),)),
            pkg.ComponentText(text="hello"),
        ]

    def test_json_and_render_match_jax_both_ways(self):
        for src, dst in ((pui, jui), (jui, pui)):
            div = src.ComponentDiv(children=tuple(self._comps(src)))
            acc = src.DecoratorAccordion(title="acc", children=(div,))
            back = dst.Component.from_json(acc.to_json())
            assert isinstance(back, dst.DecoratorAccordion)
            assert back.to_json() == acc.to_json()
            assert back.render() == acc.render()
            assert [type(c).__name__ for c in back.children[0].children] \
                == [type(c).__name__ for c in self._comps(src)]

    def test_line_chart_svg_has_series(self):
        svg = pui.ChartLine(series_names=("score",), x=((0, 1, 2),),
                            y=((3.0, 2.0, 1.0),), title="Score").render()
        assert "polyline" in svg and "Score" in svg and "score" in svg
        assert svg == jui.ChartLine(series_names=("score",), x=((0, 1, 2),),
                                    y=((3.0, 2.0, 1.0),),
                                    title="Score").render()


# ------------------------------------------------------------ dashboard
class TestTrainDashboard:
    def test_model_endpoint_serves_norm_timelines_and_histograms(
            self, fitted, servers):
        js, ps, _, _ = fitted
        jsrv, jurl, psrv, purl = servers
        jsrv.attach(js)
        psrv.attach(ps)
        m = _get_json(purl, "/train/model")
        _close(m, _get_json(jurl, "/train/model"))
        some = next(iter(m["layers"].values()))
        assert len(some["iterations"]) >= 4
        assert all(v is not None for v in some["param_norm"])
        assert any(v is not None for v in some["update_norm"])
        assert m["param_histograms"] and m["activations"]
        cj = _get_json(purl, "/train/model/components")
        assert pui.Component.from_dict(cj).render()
        for page in ("/train/model.html", "/train/overview.html",
                     "/train/system.html"):
            assert b"<svg" in _get(purl, page)

    def test_system_endpoint(self, fitted, servers):
        js, ps, _, _ = fitted
        servers[0].attach(js)
        servers[2].attach(ps)
        s = _get_json(servers[3], "/train/system")
        assert s["memory_rss_mb"] and s["static"]["hardware"]
        _close(s, _get_json(servers[1], "/train/system"))


class TestTsneViewer:
    def test_upload_and_view(self, servers):
        pts = np.random.default_rng(0).standard_normal((30, 2))
        labels = ["a", "b", "c"] * 10
        servers[0].upload_tsne(pts, labels)
        servers[2].upload_tsne(pts, labels)
        d = _get_json(servers[3], "/tsne")
        assert len(d["x"]) == 30 and set(d["labels"]) == {"a", "b", "c"}
        assert d == _get_json(servers[1], "/tsne")
        html = _get(servers[3], "/tsne.html")
        assert b"<svg" in html and b"circle" in html
        assert html == _get(servers[1], "/tsne.html")

    def test_http_upload(self, servers):
        for srv, url in ((servers[0], servers[1]), (servers[2], servers[3])):
            srv.enable_remote_listener()
            body = json.dumps({"x": [0.0, 1.0], "y": [1.0, 2.0],
                               "labels": ["p", "q"]}).encode()
            urllib.request.urlopen(urllib.request.Request(
                f"{url}/tsne", data=body,
                headers={"Content-Type": "application/json"}),
                timeout=5).read()
            assert _get_json(url, "/tsne")["x"] == [0.0, 1.0]
            bad = urllib.request.Request(f"{url}/tsne", data=b"{nope",
                                         headers={"Content-Type":
                                                  "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(bad, timeout=5)
            assert ei.value.code == 400

    def test_http_upload_gated_when_remote_disabled(self, servers):
        for url in (servers[1], servers[3]):
            req = urllib.request.Request(
                f"{url}/tsne", data=b"{}",
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=5)
            assert ei.value.code == 404


class TestLiveModules:
    """Histogram + flow modules and the polling client."""

    def test_histogram_endpoint_and_page(self, fitted, servers):
        js, ps, _, _ = fitted
        servers[0].attach(js)
        servers[2].attach(ps)
        d = _get_json(servers[3], "/train/histogram")
        _close(d, _get_json(servers[1], "/train/histogram"))
        one = next(iter(d["param_histograms"].values()))
        assert one["counts"] and one["min"] <= one["max"]
        assert sum(next(iter(d["update_histograms"].values()))["counts"]) > 0
        page = _get(servers[3], "/train/histogram.html").decode()
        assert 'data-page="histogram"' in page and "/js/app.js" in page
        assert "(updates)" in page and "(parameters)" in page

    def test_flow_endpoint_mln_chain(self, fitted, servers):
        js, ps, _, _ = fitted
        servers[0].attach(js)
        servers[2].attach(ps)
        d = _get_json(servers[3], "/train/flow")
        _close(d, _get_json(servers[1], "/train/flow"))
        names = [n["name"] for n in d["nodes"]]
        assert names[0] == "input" and len(names) == 3
        assert d["edges"] == [[names[0], names[1]], [names[1], names[2]]]
        assert d["activations"]

    def test_flow_endpoint_cg_dag(self, servers):
        conf = (JaxNNC.builder()
                .seed(0).dtype("float64").updater(JaxSgd(0.1))
                .activation("tanh")
                .graph_builder().add_inputs("in")
                .add_layer("d1", JDense(n_out=8), "in")
                .add_layer("d2", JDense(n_out=8), "d1")
                .add_vertex("skip", JaxEW(op="add"), "d1", "d2")
                .add_layer("out", JOut(n_out=3, activation="softmax"),
                           "skip")
                .set_outputs("out")
                .set_input_types(JaxInputType.feed_forward(4)).build())
        jnet = JaxGraph(conf).init()
        pnet = _twin(jnet, ComputationGraph, ComputationGraphConfiguration)
        x, y = toy_data()
        for net, pkg, srv in ((jnet, jui, servers[0]),
                              (pnet, pui, servers[2])):
            st = pkg.InMemoryStatsStorage()
            srv.attach(st)
            net.set_listeners(pkg.StatsListener(
                st, 1, session_id=SID, collect_histograms=True,
                collect_activations=True))
            net.fit(x, y, epochs=1)
        jr, pr = (_updates(srv.storage) for srv in (servers[0], servers[2]))
        assert len(pr) == len(jr) > 0
        for j, p in zip(jr, pr):
            assert list(p) == list(j)        # no activation_stats on a CG
            _close(p, j)
        d = _get_json(servers[3], "/train/flow")
        _close(d, _get_json(servers[1], "/train/flow"))
        assert [n["name"] for n in d["nodes"]][0] == "in"
        assert ["d1", "skip"] in d["edges"] and ["d2", "skip"] in d["edges"]

    def test_updates_since_is_incremental(self, servers):
        js, ps, _, _ = _fit_both(epochs=1)
        servers[2].attach(ps)
        url = servers[3]
        d0 = _get_json(url, "/train/updates")
        assert len(d0["records"]) == 2
        mid = d0["records"][0]["timestamp"]
        assert len(_get_json(url, f"/train/updates?since={mid}")[
            "records"]) == 1
        seen = {(r["worker_id"], r["timestamp"]) for r in d0["records"]}
        d2 = _get_json(url, f"/train/updates?since={d0['now']}")
        seen |= {(r["worker_id"], r["timestamp"]) for r in d2["records"]}
        assert len(seen) == 2 and d2["now"] >= d0["now"]
        assert _get_json(url, f"/train/updates?since={d0['now'] + 60}")[
            "records"] == []
        assert _get_json(url, "/train/updates?since=nope")["records"] == \
            d0["records"]

    def test_app_js_served_and_pages_wired(self, servers):
        js = _get(servers[3], "/js/app.js").decode()
        assert "renderHistogram" in js and "renderFlow" in js
        for page, key in (("/", "overview"), ("/train/model.html", "model"),
                          ("/train/flow.html", "flow"),
                          ("/train/system.html", "system"),
                          ("/tsne.html", "tsne")):
            html = _get(servers[3], page).decode()
            assert f'data-page="{key}"' in html and "/js/app.js" in html
            assert "id=live" in html
            assert html == _get(servers[1], page).decode()


# ------------------------------------------------------- conv activations
def _conv_pair(dtype):
    conf = (JaxNNC.builder().seed(0).dtype(dtype).updater(JaxSgd(0.1))
            .activation("relu")
            .list(JConv(n_out=4, kernel=(3, 3)),
                  JPool(pooling="max", kernel=(2, 2), stride=(2, 2)),
                  JDense(n_out=16),
                  JOut(n_out=3, activation="softmax"))
            .set_input_type(JaxInputType.convolutional(10, 10, 1))
            .build())
    jnet = JaxNet(conf).init()
    return jnet, _twin(jnet)


class TestConvolutionalModule:
    def test_png_encoder_and_tiling_are_jaxs(self):
        img = (np.arange(48).reshape(6, 8) * 5).astype(np.uint8)
        assert pconv.encode_grayscale_png(img) == \
            jconv.encode_grayscale_png(img)
        assert pconv.empty_png() == jconv.empty_png()
        act = np.random.default_rng(0).random((5, 5, 7)).astype(np.float32)
        grid = pconv.tile_feature_maps(act)
        assert grid.shape == (3 * 6 + 1, 3 * 6 + 1)
        np.testing.assert_array_equal(grid, jconv.tile_feature_maps(act))

    def test_feed_forward_is_nhwc_as_jax(self):
        jnet, pnet = _conv_pair("float64")
        x = np.random.default_rng(0).random((2, 10, 10, 1))
        for j, p in zip(jnet.feed_forward(x), pnet.feed_forward(x)):
            assert tuple(p.shape) == tuple(np.asarray(j).shape)
            np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0,
                                       atol=1e-12)

    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    def test_listener_png_is_jaxs_and_served(self, dtype, servers):
        """The activation PNG after the same fit on shared weights, byte
        for byte (float32 too: the maps agree within a few ulps and no
        pixel lies at a rounding boundary of the 0-255 scale here)."""
        jnet, pnet = _conv_pair(dtype)
        r = np.random.default_rng(0)
        x = r.random((8, 10, 10, 1)).astype(dtype)
        y = np.eye(3, dtype=dtype)[r.integers(0, 3, 8)]
        before = _get(servers[3], "/train/activations/data")
        assert before == pconv.empty_png()
        recs = []
        for net, pkg, mod, srv in ((jnet, jui, jconv, servers[0]),
                                   (pnet, pui, pconv, servers[2])):
            st = pkg.InMemoryStatsStorage()
            srv.attach(st)
            net.set_listeners(mod.ConvolutionalIterationListener(
                st, frequency=1, session_id=SID, examples=2))
            net.fit(x, y, epochs=2, batch_size=8)
            recs.append(st.get_static_info(SID, "ConvolutionalListener",
                                           "local").content)
        assert recs[1] == recs[0]
        assert len(recs[1]["layers"]) == 2   # conv + pooling maps
        png = _get(servers[3], "/train/activations/data")
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > len(before)
        assert png == _get(servers[1], "/train/activations/data")
        page = _get(servers[3], "/train/activations.html").decode()
        assert "actimg" in page and "/train/activations/data" in page


class TestI18N:
    def test_message_lookup_and_fallback(self):
        from deeplearning4j_tpu.ui.i18n import DefaultI18N as JaxI18N
        from deeplearning4j_tpu_torch.ui.i18n import DefaultI18N

        i, j = DefaultI18N(), JaxI18N()
        for inst in (i, j):
            inst.load_properties("xx", "train.custom=Xx!")
        assert i.get_message("train.nav.overview", "ja") == "概要"
        assert i.get_message("train.custom", "xx") == "Xx!"
        assert i.get_message("train.nav.overview", "xx") == "Overview"
        assert i.get_message("no.such.key") == "no.such.key"
        assert i.languages() == j.languages()
        for lang in i.languages():
            for key in ("train.nav.overview", "train.nav.tsne",
                        "train.activations.title", "train.custom",
                        "no.such.key"):
                assert i.get_message(key, lang) == j.get_message(key, lang)

    def test_server_nav_localizes(self, servers):
        from deeplearning4j_tpu.ui.i18n import i18n as jax_i18n
        from deeplearning4j_tpu_torch.ui.i18n import i18n

        try:
            url = servers[3]
            assert ">Overview</a>" in _get(url, "/").decode()
            urllib.request.urlopen(url + "/setlang/ja")
            assert "概要" in _get(url, "/").decode()
            assert _get_json(url, "/lang")["current"] == "ja"
            urllib.request.urlopen(servers[1] + "/setlang/ja")
            assert _get(url, "/") == _get(servers[1], "/")
        finally:
            i18n().set_default_language("en")
            jax_i18n().set_default_language("en")


class TestTailingAtScale:
    """The /train/updates?since= contract against a large stored run:
    every record delivered at least once, pages not per-record polls."""

    N_RECORDS = 5000

    def _big_storage(self, pkg):
        st = pkg.InMemoryStatsStorage()
        for i in range(self.N_RECORDS):
            st.put_update(pkg.Persistable(
                session_id="big", type_id="StatsListener",
                worker_id=f"w{i % 4}", timestamp=1000.0 + i * 0.01,
                content={"iteration": i, "score": 1.0 / (i + 1)}))
        return st

    def test_incremental_polls_cover_everything_once(self, servers):
        pages = []
        for srv, base, pkg in ((servers[0], servers[1], jui),
                               (servers[2], servers[3], pui)):
            srv.attach(self._big_storage(pkg))
            url = f"{base}/train/updates"
            seen, cursor, polls = {}, 0.0, []
            while True:
                blob = _get_json(url, f"?since={cursor}")
                polls.append((blob["now"], len(blob["records"])))
                for r in blob["records"]:
                    seen[(r["worker_id"], r["timestamp"])] = \
                        r["content"]["iteration"]
                if blob["now"] <= cursor:
                    break
                cursor = blob["now"]
            assert len(seen) == self.N_RECORDS
            assert sorted(seen.values()) == list(range(self.N_RECORDS))
            assert len(polls) < 10
            assert len(_get_json(url, f"?since={cursor}")["records"]) < 200
            pages.append(polls)
        assert pages[1] == pages[0]

    def test_late_arrival_inside_grace_window_not_lost(self, servers):
        st = self._big_storage(pui)
        servers[2].attach(st)
        url = f"{servers[3]}/train/updates"
        blob = _get_json(url, "?since=0")
        last_ts = max(r["timestamp"] for r in blob["records"])
        st.put_update(pui.Persistable(
            session_id="big", type_id="StatsListener", worker_id="late",
            timestamp=last_ts - 0.5, content={"iteration": -1,
                                              "score": 0.0}))
        blob2 = _get_json(url, f"?since={blob['now']}")
        assert any(r["worker_id"] == "late" for r in blob2["records"])
