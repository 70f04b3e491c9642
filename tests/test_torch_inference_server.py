"""The HTTP front of the PyTorch port (`serving.InferenceServer`) against
the JAX package's, on the CPU: both servers on 127.0.0.1 over the same
weights (a 2-block TextGenerationTransformer, d_model 32, vocabulary
64).

`/generate` streams (SSE frames and "stream": false) must equal JAX's
token for token, `/output` within 1e-5, `/metrics` must carry JAX's JSON
keys and Prometheus content type; the error statuses (400 on a bad body,
503 on slot exhaustion), `/generate/cancel`, the three dispatch modes,
and the routes that wait for the observe modules (501 naming A8). Every
HTTP call and future has a timeout, and every server is stopped in a
`finally`."""

import functools
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration

V = 64
T = 32
TIMEOUT = 60


@functools.lru_cache(maxsize=None)
def _pair(seed=1, t=T):
    jconf = JaxTGT(num_classes=V, input_shape=(t, 1), d_model=32,
                   num_heads=4, num_blocks=2, seed=seed).conf()
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    return jnet, pnet


def _server(pkg, net, **kw):
    if pkg == "jax":
        from deeplearning4j_tpu.serving.inference_server import (
            InferenceServer,
        )
    else:
        from deeplearning4j_tpu_torch.serving import InferenceServer
    srv = InferenceServer(net, **kw)
    srv.start()
    return srv


def _call(srv, path, body=None, headers=None):
    """(status, content type, raw body) of one request."""
    url = f"http://127.0.0.1:{srv.port}{path}"
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _json(srv, path, body=None):
    status, _, raw = _call(srv, path, body)
    return status, json.loads(raw)


def _sse(srv, body):
    """The SSE frames of one /generate, as dicts."""
    status, ctype, raw = _call(srv, "/generate", body)
    assert status == 200 and ctype == "text/event-stream", (status, raw)
    return [json.loads(line[len("data: "):])
            for line in raw.decode().split("\n\n") if line]


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, n).tolist() for n in lengths]


@pytest.fixture(scope="module")
def servers():
    jnet, pnet = _pair()
    srvs = {}
    try:
        for pkg, net in (("jax", jnet), ("torch", pnet)):
            srvs[pkg] = _server(pkg, net, decode_slots=2,
                                decode_fused_k=4, decode_page_len=8)
        yield srvs
    finally:
        for s in srvs.values():
            s.stop()


def test_generate_streams_equal_jax(servers):
    prompts = _prompts(1, [5, 12])
    for p in prompts:
        body = {"prompt_ids": p, "max_tokens": 9, "greedy": True}
        frames = {k: _sse(s, body) for k, s in servers.items()}
        for k, fr in frames.items():
            assert set(fr[0]) == {"session", "model"}, (k, fr[0])
            assert fr[-1]["done"] and fr[-1]["outcome"] == "completed"
            assert [f["index"] for f in fr[1:-1]] == list(range(9))
        assert [set(f) for f in frames["torch"]] == \
            [set(f) for f in frames["jax"]]
        assert frames["torch"][1:] == frames["jax"][1:]
        whole = {k: _json(s, "/generate", dict(body, stream=False))
                 for k, s in servers.items()}
        assert whole["torch"][0] == whole["jax"][0] == 200
        assert whole["torch"][1]["tokens"] == whole["jax"][1]["tokens"] == \
            [f["token"] for f in frames["torch"][1:-1]]
        assert set(whole["torch"][1]) == set(whole["jax"][1])


def test_output_within_1e5_of_jax_and_of_the_net(servers):
    _, pnet = _pair()
    x = np.random.default_rng(2).integers(0, V, (3, T, 1)).astype(
        np.float32)
    got = {k: _json(s, "/output", {"ndarray": x.tolist()})
           for k, s in servers.items()}
    assert got["torch"][0] == got["jax"][0] == 200
    yt = np.asarray(got["torch"][1]["output"])
    yj = np.asarray(got["jax"][1]["output"])
    assert yt.shape == (3, T, V)
    np.testing.assert_allclose(yt, yj, atol=1e-5)
    np.testing.assert_allclose(yt, pnet.output(x).numpy(), atol=1e-6)
    assert got["torch"][1]["version"] == got["jax"][1]["version"] == 1


def test_metrics_models_healthz_sessions_match_jax(servers):
    for s in servers.values():
        _json(s, "/generate", {"prompt_ids": [1, 2, 3], "max_tokens": 3,
                               "greedy": True, "stream": False})
    m = {k: _json(s, "/metrics")[1] for k, s in servers.items()}
    assert set(m["torch"]) == set(m["jax"])
    assert set(m["torch"]["decode"]["default"]) == \
        set(m["jax"]["decode"]["default"])
    dec = m["torch"]["decode"]["default"]
    assert dec["tokens_streamed"] >= 3 and dec["prefix_cache"]["enabled"]
    prom = {k: _call(s, "/metrics", headers={"Accept": "text/plain"})
            for k, s in servers.items()}
    assert prom["torch"][0] == 200
    assert prom["torch"][1] == prom["jax"][1]
    assert b"serving_decode_tokens_total" in prom["torch"][2]
    assert _call(servers["torch"], "/metrics?format=prometheus")[1] == \
        prom["jax"][1]
    for path in ("/models", "/healthz", "/sessions"):
        got = {k: _json(s, path) for k, s in servers.items()}
        assert got["torch"][0] == 200
        assert set(got["torch"][1]) <= set(got["jax"][1]), path
    h = _json(servers["torch"], "/healthz")[1]
    assert h["status"] == "ok" and "default@decode" in h["models"]
    assert _json(servers["torch"], "/models")[1]["models"]["default"][
        "version"] == 1


@pytest.mark.parametrize("body", [
    b"{not json", b"[1, 2]", {"max_tokens": 3},
    {"prompt_ids": [1, 2], "max_tokens": "many"},
    {"prompt_ids": [1, V + 5]}, {"prompt_ids": [1, 2], "model": "nope"}])
def test_bad_generate_bodies_are_400_as_in_jax(servers, body):
    got = {k: _call(s, "/generate", body)[0] for k, s in servers.items()}
    assert got["torch"] == got["jax"] == 400


def test_bad_output_bodies_are_400(servers):
    for body in ({"ndarray": [1, 2, 3]}, {"nd": []},
                 {"ndarray": [[1.0]], "deadline_ms": "soon"}):
        assert _call(servers["torch"], "/output", body)[0] == 400


def test_slot_exhaustion_is_503_and_cancel_frees_the_slot():
    _, pnet = _pair(t=128)
    srv = _server("torch", pnet, decode_slots=1, decode_fused_k=1)
    try:
        pool = srv._decode["default"].pool
        slot = pool.alloc()
        status, body = _json(srv, "/generate", {"prompt_ids": [1, 2],
                                                "max_tokens": 4})
        assert status == 503 and "slot" in body["error"]
        pool.free(slot)
        url = f"http://127.0.0.1:{srv.port}/generate"
        req = urllib.request.Request(url, data=json.dumps(
            {"prompt_ids": [1, 2, 3], "max_tokens": 120,
             "greedy": True}).encode())
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            first = json.loads(r.readline().decode()[len("data: "):])
            status, out = _json(srv, "/generate/cancel",
                                {"session": first["session"]})
            assert status == 200 and out["cancelled"] is True
            frames = [json.loads(line[len("data: "):])
                      for line in r.read().decode().splitlines()
                      if line.startswith("data: ")]
        assert frames[-1]["outcome"] == "cancelled"
        assert len(frames) - 1 < 120
        snap = _json(srv, "/sessions")[1]["decode"]["default"]
        assert snap["slots"]["in_use"] == 0
        assert snap["sessions"]["cancelled"] == 1
        assert _json(srv, "/generate/cancel",
                     {"session": "s999999"})[1]["cancelled"] is False
    finally:
        srv.stop()


@pytest.mark.parametrize("path", ["/devices", "/flight", "/trace",
                                  "/series", "/slo", "/trace/abc",
                                  "/flight/latest"])
def test_observe_routes_answer_501_naming_a8(servers, path):
    status, body = _json(servers["torch"], path)
    assert status == 501 and "A8" in body["error"]


def test_refusals_name_their_roadmap_items():
    from deeplearning4j_tpu_torch.serving import InferenceServer

    with pytest.raises(NotImplementedError, match="A8"):
        InferenceServer(slo=True)
    with pytest.raises(NotImplementedError, match="A6"):
        InferenceServer(mesh=object())
    status, body = _json_post_501()
    assert status == 501 and "A8" in body["error"]


def _json_post_501():
    from deeplearning4j_tpu_torch.serving import InferenceServer

    srv = InferenceServer()
    srv.start()
    try:
        return _json(srv, "/flight/dump", {"reason": "x"})
    finally:
        srv.stop()


@pytest.mark.parametrize("mode", [dict(scheduler="collect"),
                                  dict(batched=False)])
def test_output_through_the_collector_and_direct(mode):
    _, pnet = _pair()
    srv = _server("torch", pnet, **mode)
    try:
        x = np.random.default_rng(3).integers(0, V, (2, T, 1)).astype(
            np.float32)
        results = [None] * 3

        def client(i):
            results[i] = _json(srv, "/output", {"ndarray": x.tolist()})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        want = pnet.output(x).numpy()
        for status, body in results:
            assert status == 200
            np.testing.assert_allclose(np.asarray(body["output"]), want,
                                       atol=1e-6)
        with pytest.raises(ValueError, match="continuous"):
            srv.enable_decode_sessions()
    finally:
        srv.stop()


def test_stop_leaves_no_server_thread():
    _, pnet = _pair()
    before = set(threading.enumerate())
    srv = _server("torch", pnet, decode_slots=1, decode_fused_k=4)
    try:
        _sse(srv, {"prompt_ids": [1, 2], "max_tokens": 3})
    finally:
        srv.stop()
    left = [t for t in set(threading.enumerate()) - before
            if t.is_alive()]
    assert left == [], left


@pytest.mark.parametrize("manager_ends_it", [True, False])
def test_stop_returns_while_a_session_never_finishes(manager_ends_it):
    """A session that never advances holds its SSE handler; `stop()`
    still returns. The client's last frame is the manager's abort, or,
    when the manager cannot end the session either, the server's own
    once `stop_grace_s` has passed."""
    import time

    _, pnet = _pair()
    srv = _server("torch", pnet, decode_slots=1, decode_fused_k=4)
    srv.stop_grace_s = 0.5
    mgr = srv._decode["default"]
    mgr._submit_next = lambda sess: None        # never advances
    if not manager_ends_it:
        mgr._finish = lambda sess, **kw: None   # and is never ended
    frames = []
    client = threading.Thread(target=lambda: frames.extend(
        _sse(srv, {"prompt_ids": [1, 2], "max_tokens": 3})), daemon=True)
    stopper = threading.Thread(target=srv.stop, daemon=True)
    try:
        client.start()
        deadline = time.monotonic() + TIMEOUT
        while (mgr.snapshot()["sessions"]["active"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert mgr.snapshot()["sessions"]["active"] == 1
    finally:
        stopper.start()
        stopper.join(timeout=TIMEOUT)
    assert not stopper.is_alive(), "stop() hung on a live session"
    client.join(timeout=TIMEOUT)
    assert not client.is_alive()
    assert frames[0].keys() == {"session", "model"}
    want = ({"error": "decode session manager shut down",
             "outcome": "failed"} if manager_ends_it
            else {"error": "server stopped", "outcome": "cancelled"})
    assert frames[1:] == [want]


@pytest.mark.parametrize("kw", [dict(slo_objectives=[]),
                                dict(series_interval=1.0)],
                         ids=["slo_objectives", "series_interval"])
def test_observe_arguments_refuse_naming_a8(kw):
    from deeplearning4j_tpu_torch.serving import InferenceServer

    with pytest.raises(NotImplementedError, match="A8") as e:
        InferenceServer(**kw)
    assert next(iter(kw)) in str(e.value)
