"""The port's native host runtime (`deeplearning4j_tpu_torch/native/`)
against the JAX package's: the C++ sources are the same files, built by
g++ into the port's own `_build/`; each entry point gives the same
result as JAX's native library and as the port's NumPy fallback (the
path taken where no compiler is present)."""

import filecmp
import os
import struct

import numpy as np
import pytest

from deeplearning4j_tpu import native as J
from deeplearning4j_tpu_torch import native as P

_REAL_GET_LIB = P.get_lib


def port(name, *args, fallback=False, **kw):
    """`P.name(*args, **kw)` with the port's library bound, or with no
    library (`fallback`): every entry point then takes its NumPy path."""
    saved = P.get_lib
    P.get_lib = (lambda: None) if fallback else _REAL_GET_LIB
    try:
        return getattr(P, name)(*args, **kw)
    finally:
        P.get_lib = saved


def three(name, *args, **kw):
    """JAX's native result, the port's native and the port's fallback."""
    return (getattr(J, name)(*args, **kw), port(name, *args, **kw),
            port(name, *args, fallback=True, **kw))


def test_both_libraries_build_from_the_same_sources():
    assert J.available() and P.available()
    assert P._LIB_PATH != J._LIB_PATH
    assert os.path.dirname(P._LIB_PATH).endswith(
        os.path.join("deeplearning4j_tpu_torch", "_build"))
    names = sorted(f for f in os.listdir(J._SRC_DIR) if f.endswith(".cpp"))
    assert names == sorted(f for f in os.listdir(P._SRC_DIR)
                           if f.endswith(".cpp"))
    for f in names:
        assert filecmp.cmp(os.path.join(J._SRC_DIR, f),
                           os.path.join(P._SRC_DIR, f), shallow=False)


@pytest.mark.parametrize("cap", [None, 7])
def test_threshold_encode_equal(cap):
    grad = np.random.default_rng(0).standard_normal(500).astype(
        np.float32) * 0.1
    outs = []
    for run in (J.threshold_encode,
                lambda *a, **k: port("threshold_encode", *a, **k),
                lambda *a, **k: port("threshold_encode", *a, fallback=True,
                                     **k)):
        g = grad.copy()        # the residual is written back into it
        idx, sg = run(g, 0.05, max_elements=cap)
        outs.append((idx, sg, g))
    for got in outs[1:]:
        for x, y in zip(got, outs[0]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_threshold_decode_equal():
    idx = np.array([0, 3, 3, 9, -1, 50], dtype=np.int32)
    signs = np.array([1, 0, 0, 1, 1, 1], dtype=np.uint8)
    targets = [np.ones(10, np.float32) for _ in range(3)]
    J.threshold_decode(targets[0], 0.25, idx, signs)
    port("threshold_decode", targets[1], 0.25, idx, signs)
    port("threshold_decode", targets[2], 0.25, idx, signs, fallback=True)
    assert np.array_equal(targets[0], targets[1])
    assert np.array_equal(targets[0], targets[2])


@pytest.mark.parametrize("text", [
    "1,2,3\n4,5,6\n", "1.5,-2e3\r\n\r\n3,4\r\n", "7\n", "1,,3\n4,5,6\n",
])
def test_parse_csv_equal(text):
    a, b, c = three("parse_csv", text)
    assert a.dtype == b.dtype == c.dtype
    assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("dtype,code", [(np.uint8, 0x08), (np.int16, 0x0B),
                                        (np.float32, 0x0D)])
def test_read_idx_equal(dtype, code):
    arr = (np.arange(24).reshape(2, 3, 4) * 3).astype(dtype)
    data = bytes([0, 0, code, 3]) + b"".join(
        struct.pack(">I", d) for d in arr.shape) + \
        arr.astype(np.dtype(dtype).newbyteorder(">")).tobytes()
    for o in three("read_idx", data):
        assert o.dtype == arr.dtype and np.array_equal(o, arr)


def test_u8_to_f32_and_one_hot_equal():
    px = np.arange(256, dtype=np.uint8).reshape(16, 16)
    a, b, c = three("u8_to_f32", px)
    assert np.array_equal(a, b) and np.array_equal(a, c)
    a, b, c = three("one_hot", np.array([0, 3, 1, 7, -1, 2]), 4)
    assert np.array_equal(a, b) and np.array_equal(a, c)


def _w2v_body(words, vecs, crlf=False):
    out = b""
    for w, v in zip(words, vecs):
        out += w.encode() + b" " + v.astype("<f4").tobytes() + (
            b"\r\n" if crlf else b"\n")
    return out


@pytest.mark.parametrize("crlf", [False, True])
def test_w2v_parse_equal(crlf):
    words = ["alpha", "β", "日本", "x"]
    vecs = np.random.default_rng(1).standard_normal((4, 5)).astype(
        np.float32)
    body = _w2v_body(words, vecs, crlf)
    (wa, ma), (wb, mb), none = three("w2v_parse", body, 4, 5)
    assert wa == wb == words
    assert np.array_equal(ma, mb) and np.array_equal(ma, vecs)
    assert none is None          # callers then parse in Python
    with pytest.raises(ValueError):
        port("w2v_parse", body[:-12], 4, 5)


def test_workspace_equal():
    for mod in (J, P):
        ws = mod.Workspace(1 << 12)
        a = ws.alloc((8, 8), np.float32)
        a[:] = 1
        b = ws.alloc(10, np.uint8, align=64)
        assert ws.used >= 8 * 8 * 4 + 10 and ws.high_water == ws.used
        with pytest.raises(RuntimeError):
            ws.close()
        del a, b
        ws.reset()
        assert ws.used == 0
        with pytest.raises(MemoryError):
            ws.alloc(1 << 13)
        ws.close()
    ws = port("Workspace", 64, fallback=True)
    assert ws.alloc((100,)).shape == (100,) and ws.used == 0
    ws.close()
