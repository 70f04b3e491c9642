"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into a shared library with a
plain C interface, loaded with `ctypes`. The build runs at first use,
into `deeplearning4j_tpu_torch/_build/` (listed in `.gitignore`); the
library name carries a digest of its source, so an edited kernel is
rebuilt and a stale one is never loaded. `build()` starts one `nvcc` per
source that needs it, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module of the
port on machines with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# source stem -> {C function: (restype, argtypes)}; every pointer and the
# stream are c_void_p so ctypes never truncates them to 32 bits
SOURCES: Dict[str, Dict[str, tuple]] = {
    "decode_attention": {
        # q k v scale_k scale_v out qpos end, S L H Hkv Dh window
        # rolling, scale, dtype cache_dtype, stream
        "dl4j_decode_attention": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                 _I, _F, _I, _I, _P]),
        # q k v scale_k scale_v out page_table qpos, S NP Lp H Hkv Dh
        # window, scale, dtype cache_dtype, stream
        "dl4j_paged_decode_attention": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                 _I, _F, _I, _I, _P]),
        "dl4j_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "banded_attention": {
        # q k v o, B T H Hkv Dh window causal, scale, dtype, stream
        "dl4j_banded_attention": (
            _I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
        "dl4j_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_attention": {
        "dl4j_flash_fwd": (
            _I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P]),
        "dl4j_flash_bwd_dkdv": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                 _I, _P]),
        "dl4j_flash_bwd_dq": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                 _P]),
        "dl4j_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "fused_update": {
        "dl4j_adam_multi": (
            _I, [_P, _I, _I, _I, _P, _F, _F, _F, _F, _F, _I, _P]),
        "dl4j_nesterov_multi": (
            _I, [_P, _I, _I, _I, _P, _F, _I, _P]),
        "dl4j_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "lstm": {
        # xw rw p h0 c0 mask hs cs gates hT cT, T B H, residuals, stream
        "dl4j_lstm_fwd": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                 _I, _P]),
        # dhs gates cs rwT p mask dhT dcT c0 dxw dh0 dc0 dp_part, T B H
        "dl4j_lstm_bwd": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                 _I, _I, _P]),
        # hs h0 dxw dp_part drw dp, T B H, tiles
        "dl4j_lstm_bwd_weights": (
            _I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
        "dl4j_lstm_batch_tile": (_I, []),
        "dl4j_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "conv_fused": {
        "dl4j_conv_stats_tile_m": (_I, []),
        # x w y part sums, M K N, dtype, stream
        "dl4j_matmul_stats": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
        # x w y part sums, B H W C N, dtype, stream
        "dl4j_conv3x3_stats": (
            _I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
        # x w y part sums, M K N, bn stages, stream
        "dl4j_matmul_stats_wgmma": (
            _I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        # x w y part sums, B H W C N, bn stages, stream
        "dl4j_conv3x3_stats_wgmma": (
            _I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
        "dl4j_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def _target(name: str) -> Path:
    # the digest covers the shared headers too: an edited header rebuilds
    # every source
    text = b"".join(p.read_bytes() for p in
                    [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source (default: all) whose library is not
    built yet, one `nvcc` process per source, all started together.
    Returns {name: seconds} for the sources built now; raises with the
    compiler's output when any build fails. `nvcc -Xptxas -v` reports
    (registers, shared memory, spills) go to `_build/<name>.log`."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    built, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return built


def library(name: str) -> ctypes.CDLL:
    """The loaded library for source `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (res, args) in SOURCES[name].items():
                f = getattr(lib, fn)
                f.restype = res
                f.argtypes = args
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc:
        msg = lib.dl4j_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
