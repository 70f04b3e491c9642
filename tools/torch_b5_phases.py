#!/usr/bin/env python3
"""Where a launch of B5's design 2 goes, by knocking out its phases, on
one card.

    python3 tools/torch_b5_phases.py

Builds `csrc/decode_attention.cu` five times into
`deeplearning4j_tpu_torch/_build/phases_b5/`, each with one edit of
`split_body` (the design-2 body B5 and B6 share):

- `full`: as it is;
- `no_load`: the tiles' copies move no bytes (`cp.async` with a source
  size of 0: zero-filled, the addresses still computed and issued);
- `no_fold`: the warps skip every tile's scores and P·V;
- `no_merge`: every live split writes its own o, as a lone split does
  (no partial, no counter, no last-block merge);
- `none`: all three.

The knocked-out kernels compute wrong outputs: they are timed, never
used (`full` is held to the plain version). At Path B's shape (S 8, H 8,
Hkv 2, Dh 64, a float32 ring of 2303, window 256, `chip_smoke.py`'s
positions, the split size `b5_splits` picks) each is timed from a CUDA
graph with a cold L2 (`chip_smoke.graph_ms`), beside design 1 (from the
same library) and an all-empty grid (every slot at end -1: the launch's fixed cost). Prints
one JSON line, then the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

LOAD = """        cp_async16(kst + off, kc + row * DH + c * EPC, live);
        cp_async16(kst + kTileBytes / 2 + off, vc + row * DH + c * EPC,
                   live);"""
FOLD = """    if (nw <= 0) continue;"""
MERGE = """    if (nlive == 1) {
      out[row0 + i] = o / fmaxf(lb, 1e-30f);"""
MERGE_END = """  if (nlive == 1) return;
  __threadfence();"""
EDITS = {
    "no_load": [(LOAD, LOAD.replace("live);", "false);"))],
    "no_fold": [(FOLD, "    if (nw <= 0 || nkeys > 0) continue;")],
    "no_merge": [(MERGE, MERGE.replace("nlive == 1", "nlive >= 1")),
                 (MERGE_END, MERGE_END.replace("nlive == 1", "nlive >= 1"))],
}
EDITS["none"] = [e for k in ("no_load", "no_fold", "no_merge")
                 for e in EDITS[k]]


def build(out_dir: Path):
    """{variant: the loaded library}, all built at once."""
    from deeplearning4j_tpu_torch.ops import cuda_build as cb

    src = (cb.CSRC / "decode_attention.cu").read_text()
    procs = {}
    for name in ("full", *EDITS):
        text = src
        for old, new in EDITS.get(name, []):
            cs.check(text.count(old) == 1, f"{name}: edit not found")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [cb.nvcc_path(), *cb.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc ({name}) failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, (res, args) in cb.SOURCES["decode_attention"].items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_b5_phases: needs a CUDA card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import banded_attention as ba
    from deeplearning4j_tpu_torch.ops import cuda_build as cb

    out_dir = cb.BUILD_DIR / "phases_b5"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(out_dir)
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    side = torch.cuda.Stream()
    S, H, hkv, Dh, L, w = 8, 8, 2, 64, 2303, 256
    c, nsplit = ba.b5_splits(S, hkv, L, w, ba._sm_count(flush.device),
                             ba.split_tile_keys(Dh, torch.float32))
    q = torch.randn(S, H, Dh, generator=gen).to("cuda")
    k, v = (torch.randn(S, L, hkv, Dh, generator=gen).to("cuda")
            for _ in range(2))
    spread = torch.tensor([0, 5, 255, 1000, 2302, 2303, 2900, 5000],
                          dtype=torch.int32, device="cuda")
    work = torch.empty(S * hkv * nsplit * (H // hkv) * (Dh + 2),
                       device="cuda")
    counters = torch.zeros(S * hkv, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)

    def launch(lib, qpos):
        rc = lib.dl4j_decode_attention_split(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
            out.data_ptr(), qpos.data_ptr(), qpos.data_ptr(),
            work.data_ptr(), counters.data_ptr(), S, L, H, hkv, Dh, w, 1, c,
            nsplit, Dh ** -0.5, 0,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cb.check(lib, rc, "decode_attention_split")

    launch(libs["full"], spread)
    torch.cuda.synchronize()
    ref = ba.decode_attention_plain(q, k, v, spread, spread, w, True)
    err = (out - ref).abs().max().item()
    cs.check(err <= cs.TOL[torch.float32][0], f"full: max abs err {err}")
    row = {"phase": "b5_phases", "S": S, "H": H, "Hkv": hkv, "Dh": Dh,
           "L": L, "window": w, "split_keys": c, "nsplit": nsplit,
           "full_max_abs_err": err}
    for name, lib in libs.items():
        row[f"{name}_ms"] = cs.graph_ms(lambda: launch(lib, spread), flush,
                                        side)
    empty = torch.full_like(spread, -1)
    row["empty_grid_ms"] = cs.graph_ms(lambda: launch(libs["full"], empty),
                                       flush, side)
    def design_1():
        lib = libs["full"]
        rc = lib.dl4j_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
            out.data_ptr(), spread.data_ptr(), spread.data_ptr(), S, L, H,
            hkv, Dh, w, 1, Dh ** -0.5, 0, 0,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cb.check(lib, rc, "decode_attention")

    row["ffma_ms"] = cs.graph_ms(design_1, flush, side)
    cs.emit(row)
    print(cs.gpu_name_and_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
