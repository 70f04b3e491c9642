#!/usr/bin/env python3
"""B4 design 2 with p taken in two forms of the exponential, against the
plain version and design 1, on one card.

    python3 tools/torch_b4_exp_forms.py

`folded::banded_fwd_folded_kernel` (`csrc/banded_attention.cu`) takes
each p as 2^(s scale log2 e - m) on the SFU (`ex2.approx.ftz`, the
running max kept in that base-2 scale) unless it is built with
`-DDL4J_BAND_EXPF=1`, which takes design 1's IEEE form, expf(s scale -
m). This builds both, side by side, into
`deeplearning4j_tpu_torch/_build/` and reads, at `chip_smoke.py`'s
float32 B4 shapes (path_w's first) on the same inputs for both forms and
for design 1 (from the same library): the largest error against
`banded_reference` (design 1's limit is 2e-5, `chip_smoke.TOL`), the
outputs where the forms differ, and each one's time (cold L2,
`chip_smoke.time_ms`). Prints one JSON line a shape and the card's name
and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

FORMS = {"ex2_approx": 0, "expf": 1}      # form -> DL4J_BAND_EXPF


def build_forms(out_dir: Path):
    """{form: the loaded library}, both built at once."""
    from deeplearning4j_tpu_torch.ops import cuda_build as cb

    procs = {}
    for form, flag in FORMS.items():
        out = out_dir / f"libbanded_attention_{form}.so"
        cmd = [cb.nvcc_path(), *cb.NVCC_FLAGS, f"-DDL4J_BAND_EXPF={flag}",
               "-o", str(out), str(cb.CSRC / "banded_attention.cu")]
        procs[form] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for form, (proc, out) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc ({form}) failed:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, (res, args) in cb.SOURCES["banded_attention"].items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        libs[form] = lib
    return libs


def fwd(lib, q, k, v, w, causal, design):
    from deeplearning4j_tpu_torch.ops import cuda_build as cb

    b, t, h, dh = q.shape
    o = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, t, h,
            k.shape[2], dh, min(w, t), int(causal), dh ** -0.5)
    if design == "folded":
        rc = lib.dl4j_banded_attention_folded(*args, stream)
    else:
        rc = lib.dl4j_banded_attention(*args, 0, stream)
    cb.check(lib, rc, f"banded_attention ({design})")
    return o


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_b4_exp_forms: needs a CUDA card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import banded_attention as ba
    from deeplearning4j_tpu_torch.ops import cuda_build as cb

    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    print(cs.gpu_name_and_limit(), flush=True)
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        libs = build_forms(Path(tmp))
        gen = torch.Generator().manual_seed(0)
        flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        for c in cs.banded_cases():
            if c["dtype"] != torch.float32:
                continue
            b, t, h, hkv, dh, w, causal = (c[x] for x in (
                "b", "t", "h", "hkv", "dh", "w", "causal"))
            q, k, v = (torch.randn(b, t, n, dh, generator=gen).to("cuda")
                       for n in (h, hkv, hkv))
            ref = ba.banded_reference(q, k, v, w, causal)
            row = {"phase": "b4_exp_forms", **{x: c[x] for x in (
                "b", "t", "h", "hkv", "dh", "w", "causal")}}
            outs = {}
            for form, lib in libs.items():
                o = fwd(lib, q, k, v, w, causal, "folded")
                outs[form] = o
                row[form] = {"max_abs_err": (o - ref).abs().max().item(),
                             "ms": cs.time_ms(lambda: fwd(
                                 lib, q, k, v, w, causal, "folded"), flush)}
                cs.check(row[form]["max_abs_err"] <= cs.TOL[torch.float32][0],
                         f"{form} {row}: past design 1's limit")
            lib = libs["expf"]
            o1 = fwd(lib, q, k, v, w, causal, "ffma")
            row["ffma"] = {"max_abs_err": (o1 - ref).abs().max().item(),
                           "ms": cs.time_ms(lambda: fwd(
                               lib, q, k, v, w, causal, "ffma"), flush)}
            row["outputs_that_differ"] = int(
                (outs["ex2_approx"] != outs["expf"]).sum())
            cs.emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
