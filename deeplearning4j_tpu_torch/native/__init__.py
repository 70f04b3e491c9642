"""Native (C++) host runtime: threshold codec, record decoding, staging
arena (port of `deeplearning4j_tpu/native/__init__.py`).

The reference's native substrate enters through external deps — libnd4j's
threshold-compression ops (EncodingHandler.java:65), DataVec record readers,
and ND4J MemoryWorkspace (SURVEY.md §2.8). Here the equivalents are C++
sources under ``csrc/`` (copies of the JAX package's) compiled on demand
with g++ into one shared library under `deeplearning4j_tpu_torch/_build/`
(listed in `.gitignore`) and bound via ctypes; every entry point has a
NumPy fallback so the package works (slower) where no compiler is
present.

The device never goes through here — the CUDA kernels live in the
package's own `csrc/`. This is the HOST side: feeding, compressing,
staging, and the word2vec binary codec `nlp/serializer.py` reads with.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_SRC_DIR = os.path.join(os.path.dirname(__file__), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libdl4jtpu.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _sources():
    return sorted(
        os.path.join(_SRC_DIR, f)
        for f in os.listdir(_SRC_DIR) if f.endswith(".cpp"))


def _needs_build() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(s) > lib_mtime for s in _sources())


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # one temporary name a process: test workers may build at once
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
           "-o", tmp] + _sources()
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32p, u8p, f32p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                            ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(ctypes.c_float))
    lib.dl4j_threshold_encode.restype = i64
    lib.dl4j_threshold_encode.argtypes = [f32p, i64, ctypes.c_float, i32p,
                                          u8p, i64]
    lib.dl4j_threshold_decode.restype = None
    lib.dl4j_threshold_decode.argtypes = [f32p, i64, ctypes.c_float, i32p,
                                          u8p, i64]
    lib.dl4j_csv_parse.restype = i64
    lib.dl4j_csv_parse.argtypes = [ctypes.c_char_p, i64, ctypes.c_char, f32p,
                                   i64, ctypes.POINTER(i64),
                                   ctypes.POINTER(i64)]
    lib.dl4j_idx_header.restype = i64
    lib.dl4j_idx_header.argtypes = [u8p, i64, ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(i64)]
    lib.dl4j_u8_to_f32.restype = None
    lib.dl4j_u8_to_f32.argtypes = [u8p, i64, ctypes.c_float, f32p]
    lib.dl4j_one_hot.restype = None
    lib.dl4j_one_hot.argtypes = [i32p, i64, ctypes.c_int32, f32p]
    lib.dl4j_w2v_parse.restype = i64
    lib.dl4j_w2v_parse.argtypes = [u8p, i64, i64, i64, f32p, u8p, i64,
                                   ctypes.POINTER(i64)]
    lib.dl4j_arena_create.restype = ctypes.c_void_p
    lib.dl4j_arena_create.argtypes = [i64]
    lib.dl4j_arena_destroy.restype = None
    lib.dl4j_arena_destroy.argtypes = [ctypes.c_void_p]
    lib.dl4j_arena_alloc.restype = ctypes.c_void_p
    lib.dl4j_arena_alloc.argtypes = [ctypes.c_void_p, i64, i64]
    lib.dl4j_arena_reset.restype = None
    lib.dl4j_arena_reset.argtypes = [ctypes.c_void_p]
    lib.dl4j_arena_used.restype = i64
    lib.dl4j_arena_used.argtypes = [ctypes.c_void_p]
    lib.dl4j_arena_high_water.restype = i64
    lib.dl4j_arena_high_water.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if the
    toolchain is unavailable (callers fall back to NumPy)."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if _needs_build() and not _build():
                _build_failed = True
                return None
            _lib = _bind(ctypes.CDLL(_LIB_PATH))
        except OSError:
            _build_failed = True
            return None
    return _lib


def available() -> bool:
    return get_lib() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ---------------------------------------------------------------------------
# Threshold codec (EncodingHandler.java:26-102 equivalent).

def threshold_encode(grad: np.ndarray, threshold: float,
                     max_elements: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Strom-style 1-bit sparse encoding of a flat float32 gradient.

    Mutates ``grad`` in place to hold the residual (the part below the
    threshold, accumulated for later rounds). Returns (indices int32,
    signs uint8 — 1 for +threshold, 0 for -threshold).
    """
    if grad.dtype != np.float32 or not grad.flags["C_CONTIGUOUS"]:
        raise ValueError("grad must be C-contiguous float32")
    n = grad.size
    cap = n if max_elements is None else min(int(max_elements), n)
    lib = get_lib()
    if lib is not None:
        idx = np.empty(cap, dtype=np.int32)
        signs = np.empty(cap, dtype=np.uint8)
        m = lib.dl4j_threshold_encode(_f32p(grad), n, ctypes.c_float(threshold),
                                      _i32p(idx), _u8p(signs), cap)
        return idx[:m].copy(), signs[:m].copy()
    flat = grad.reshape(-1)
    hits = np.flatnonzero(np.abs(flat) >= threshold)[:cap]
    signs = (flat[hits] > 0).astype(np.uint8)
    flat[hits] -= np.where(signs, threshold, -threshold).astype(np.float32)
    return hits.astype(np.int32), signs


def threshold_decode(target: np.ndarray, threshold: float, indices: np.ndarray,
                     signs: np.ndarray) -> None:
    """Applies a sparse encoded update into ``target`` in place."""
    if target.dtype != np.float32 or not target.flags["C_CONTIGUOUS"]:
        raise ValueError("target must be C-contiguous float32")
    lib = get_lib()
    if lib is not None:
        idx = np.ascontiguousarray(indices, dtype=np.int32)
        sg = np.ascontiguousarray(signs, dtype=np.uint8)
        lib.dl4j_threshold_decode(_f32p(target), target.size,
                                  ctypes.c_float(threshold), _i32p(idx),
                                  _u8p(sg), idx.size)
        return
    flat = target.reshape(-1)
    idx = indices.astype(np.int64)
    ok = (idx >= 0) & (idx < flat.size)  # native path skips out-of-range too
    np.add.at(flat, idx[ok],
              np.where(signs.astype(bool)[ok], threshold, -threshold)
              .astype(np.float32))


# ---------------------------------------------------------------------------
# Record decoding (DataVec equivalent).

def parse_csv(text: str, delimiter: str = ",") -> np.ndarray:
    """Numeric CSV text → float32 matrix [rows, cols]."""
    lib = get_lib()
    if lib is None:
        rows = [r for r in text.splitlines() if r.strip()]
        return np.asarray(
            [[float(v) if _is_num(v) else 0.0 for v in r.split(delimiter)]
             for r in rows], dtype=np.float32)
    raw = text.encode()
    # Worst case one value per two bytes.
    cap = max(16, len(raw))
    out = np.empty(cap, dtype=np.float32)
    n_rows = ctypes.c_int64()
    n_cols = ctypes.c_int64()
    written = lib.dl4j_csv_parse(raw, len(raw), ctypes.c_char(
        delimiter.encode()), _f32p(out), cap, ctypes.byref(n_rows),
        ctypes.byref(n_cols))
    if written < 0:
        raise ValueError("csv buffer overflow")
    r, c = n_rows.value, n_cols.value
    if r * c != written:
        raise ValueError("ragged csv rows")
    return out[:written].reshape(r, c).copy()


def _is_num(v: str) -> bool:
    try:
        float(v)
        return True
    except ValueError:
        return False


def read_idx(data: bytes) -> np.ndarray:
    """IDX (MNIST ubyte/int/float) container → ndarray.

    Replaces the reference's MnistManager binary readers
    (deeplearning4j-core/.../datasets/mnist/)."""
    dtype_map = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                 0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    if lib is not None:
        dt = ctypes.c_int32()
        nd = ctypes.c_int32()
        dims = (ctypes.c_int64 * 8)()
        off = lib.dl4j_idx_header(_u8p(buf), buf.size, ctypes.byref(dt),
                                  ctypes.byref(nd), dims)
        if off < 0:
            raise ValueError("bad idx header")
        shape = tuple(dims[i] for i in range(nd.value))
        np_dt = dtype_map[dt.value]
    else:
        if len(data) < 4 or data[0] or data[1]:
            raise ValueError("bad idx header")
        np_dt = dtype_map[data[2]]
        nd_ = data[3]
        shape = tuple(int.from_bytes(data[4 + 4 * i:8 + 4 * i], "big")
                      for i in range(nd_))
        off = 4 + 4 * nd_
    arr = np.frombuffer(data, dtype=np.dtype(np_dt).newbyteorder(">"),
                        offset=int(off))
    return arr.reshape(shape).astype(np_dt)


def u8_to_f32(pixels: np.ndarray, scale: float = 1.0 / 255.0) -> np.ndarray:
    """uint8 image bytes → scaled float32 (pixel normalisation hot loop)."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    lib = get_lib()
    if lib is None:
        return pixels.astype(np.float32) * scale
    out = np.empty(pixels.shape, dtype=np.float32)
    lib.dl4j_u8_to_f32(_u8p(pixels), pixels.size, ctypes.c_float(scale),
                       _f32p(out))
    return out


def one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    lib = get_lib()
    if lib is None:
        out = np.zeros((labels.size, num_classes), dtype=np.float32)
        ok = (labels >= 0) & (labels < num_classes)
        out[np.arange(labels.size)[ok], labels[ok]] = 1.0
        return out
    out = np.empty((labels.size, num_classes), dtype=np.float32)
    lib.dl4j_one_hot(_i32p(labels), labels.size, num_classes, _f32p(out))
    return out


def w2v_parse(body: bytes, n_words: int, dim: int):
    """Google word2vec binary body (after the "V D\\n" header) →
    (words list[str], vectors [V, D] float32) in one C++ scan with bulk
    vector memcpy — the host-side hot path for GB-scale pretrained
    embedding loads (WordVectorSerializer.loadGoogleModel equivalent).

    Returns None when the native library is unavailable or the host is
    big-endian (format floats are little-endian); callers then use their
    Python path."""
    import sys

    lib = get_lib()
    if lib is None or sys.byteorder != "little":
        return None
    buf = np.frombuffer(body, dtype=np.uint8)
    vecs = np.empty((n_words, dim), dtype=np.float32)
    # Tight word-bytes bound: the body is words + separators + vectors,
    # so word bytes <= body - vectors (allocating the full body size
    # would double peak memory on GB-scale loads).
    words_cap = max(buf.size - n_words * dim * 4, 1)
    words_buf = np.empty(words_cap, dtype=np.uint8)
    offsets = np.zeros(n_words + 1, dtype=np.int64)
    consumed = lib.dl4j_w2v_parse(
        _u8p(buf), buf.size, n_words, dim, _f32p(vecs), _u8p(words_buf),
        words_buf.size,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if consumed < 0:
        raise ValueError(
            "malformed word2vec binary body (truncated record, missing "
            "separator, or empty word)")
    words = [bytes(words_buf[offsets[i]:offsets[i + 1]]).decode("utf-8")
             for i in range(n_words)]
    return words, vecs


# ---------------------------------------------------------------------------
# Staging arena (MemoryWorkspace host-side equivalent).

class Workspace:
    """Bump-allocated host staging arena for input-pipeline batches.

    Allocate numpy views inside the arena, feed them to the device, then
    ``reset()`` to reuse the memory next batch — the host-side analogue of
    ND4J's cyclic MemoryWorkspace (SURVEY.md §2.8 item 1). Falls back to
    plain numpy allocation without the native library.
    """

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        lib = get_lib()
        self._lib = lib
        self._views: list = []  # weakrefs to issued arrays (UAF guard)
        self._handle = (lib.dl4j_arena_create(self.capacity)
                        if lib is not None else None)
        if lib is not None and not self._handle:
            raise MemoryError("arena allocation failed")

    def alloc(self, shape, dtype=np.float32, align: int = 128) -> np.ndarray:
        dtype = np.dtype(dtype)
        if self._handle is None:
            return np.empty(shape, dtype=dtype)
        size = int(np.prod(shape)) * dtype.itemsize
        ptr = self._lib.dl4j_arena_alloc(self._handle, size, align)
        if not ptr:
            raise MemoryError(
                f"workspace exhausted ({self.used}/{self.capacity} bytes)")
        buf = (ctypes.c_char * size).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        import weakref
        self._views.append(weakref.ref(arr))
        return arr

    def reset(self) -> None:
        if self._handle is not None:
            self._lib.dl4j_arena_reset(self._handle)
        self._views = [r for r in self._views if r() is not None]

    @property
    def used(self) -> int:
        return (self._lib.dl4j_arena_used(self._handle)
                if self._handle is not None else 0)

    @property
    def high_water(self) -> int:
        return (self._lib.dl4j_arena_high_water(self._handle)
                if self._handle is not None else 0)

    def close(self, force: bool = False) -> None:
        """Frees the arena. Refuses (unless force=True) while arrays
        allocated from it are still referenced — their memory would be
        freed under them (use-after-free)."""
        if self._handle is None:
            return
        if not force:
            live = sum(1 for r in self._views if r() is not None)
            if live:
                raise RuntimeError(
                    f"workspace still has {live} live array view(s); drop "
                    "them first or close(force=True)")
        self._lib.dl4j_arena_destroy(self._handle)
        self._handle = None
        self._views = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close(force=True)  # GC decided: nothing can reach the views
        except Exception:  # __del__ must never raise
            pass
