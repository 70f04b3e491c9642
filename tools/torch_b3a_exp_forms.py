#!/usr/bin/env python3
"""B3a design 2 with p taken in two forms of the exponential, against the
plain version, on one card.

    python3 tools/torch_b3a_exp_forms.py

`tc::fwd_wgmma_kernel` (`csrc/flash_attention.cu`) computes each p as
2^(s scale log2 e - m log2 e) on the SFU (`ex2.approx.ftz`) unless it is
built with `-DDL4J_FWD_EXPF=1`, which takes design 1's and the plain
version's form, expf(s scale - m). This builds both, side by side, into
`deeplearning4j_tpu_torch/_build/` and reads, at every bfloat16 shape at
Dh 64 and 128 of `chip_smoke.py`'s flash rows and on the same inputs for
both forms:

- `past_2e-5_limit`: the outputs past design 1's limit, 2e-5 plus one
  bf16 step of the plain version that rounds p against 64-key tiles;
- `excess_share`: the largest error past one bf16 step, over the largest
  |o|, against that plain version, and `unrounded_excess_share` the same
  against the plain version that leaves p unrounded (C6's control);
- `lse_err` and the kernel's time `ms` (cold L2, `chip_smoke.time_ms`).

Prints one JSON line a shape and the card's name and power limit. Needs
a CUDA card.
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

FORMS = {"ex2_approx": 0, "expf": 1}      # form -> DL4J_FWD_EXPF


def build_forms(out_dir: Path):
    """{form: the loaded library}, both built at once."""
    from deeplearning4j_tpu_torch.ops import cuda_build as cb

    procs = {}
    for form, flag in FORMS.items():
        out = out_dir / f"libflash_attention_{form}.so"
        cmd = [cb.nvcc_path(), *cb.NVCC_FLAGS, f"-DDL4J_FWD_EXPF={flag}",
               "-o", str(out), str(cb.CSRC / "flash_attention.cu")]
        procs[form] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for form, (proc, out) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc ({form}) failed:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn in ("dl4j_flash_fwd_wgmma", "dl4j_cuda_error_string"):
            res, args = cb.SOURCES["flash_attention"][fn]
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        libs[form] = lib
    return libs


def fwd(lib, q, k, v, causal):
    """(o, lse) from `dl4j_flash_fwd_wgmma` of `lib`."""
    from deeplearning4j_tpu_torch.ops import cuda_build as cb

    bh, tq, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    rc = lib.dl4j_flash_fwd_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, tq, k.shape[1], dh, dh ** -0.5, int(causal),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    cb.check(lib, rc, "flash_attention_fwd (wgmma)")
    return o, lse


def excess_share(o, ref):
    """The largest |o - ref| past one bf16 step of ref, over max |ref|."""
    ref = ref.float()
    past = ((o.float() - ref).abs() - 2.0 ** -7 * ref.abs()).max().item()
    return max(past, 0.0) / ref.abs().max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_b3a_exp_forms: needs a CUDA card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import attention as fa
    from deeplearning4j_tpu_torch.ops import cuda_build as cb

    torch.backends.cuda.matmul.allow_tf32 = False
    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    print(cs.gpu_name_and_limit(), flush=True)
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        libs = build_forms(Path(tmp))
        gen = torch.Generator().manual_seed(0)
        flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        for c in cs.flash_cases():
            if c["dtype"] != torch.bfloat16 or \
                    c["dh"] not in fa.WGMMA_HEAD_DIMS:
                continue
            bh, tq, tk, dh, causal = (c[x] for x in
                                      ("bh", "tq", "tk", "dh", "causal"))
            q, k, v = (torch.randn(bh, t, dh, generator=gen)
                       .to("cuda", torch.bfloat16) for t in (tq, tk, tk))
            o_ref, lse_ref = fa.flash_attention_plain(
                q, k, v, causal, block_k=fa.KERNEL_BLOCK_K)
            o_f32, _ = fa.flash_attention_plain(q.float(), k.float(),
                                                v.float(), causal)
            limit = 2e-5 + 2.0 ** -7 * o_ref.float().abs()
            row = {"phase": "b3a_exp_forms", "bh": bh, "tq": tq, "tk": tk,
                   "dh": dh, "causal": causal, "outputs": o_ref.numel()}
            outs = {}
            for form, lib in libs.items():
                o, lse = fwd(lib, q, k, v, causal)
                outs[form] = o
                row[form] = {
                    "past_2e-5_limit": int(((o.float() - o_ref.float())
                                            .abs() > limit).sum()),
                    "excess_share": excess_share(o, o_ref),
                    "unrounded_excess_share": excess_share(o, o_f32),
                    "lse_err": (lse - lse_ref).abs().max().item(),
                    "ms": cs.time_ms(lambda: fwd(lib, q, k, v, causal),
                                     flush)}
            row["outputs_that_differ"] = int(
                (outs["ex2_approx"] != outs["expf"]).sum())
            cs.emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
