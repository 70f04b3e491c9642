"""The float32 conv+BN statistics kernels B7a/B7b in design 3 ("tf32x3":
3xTF32 on the tensor cores) beside design 1 ("ffma") and the float32
library calls, on the card, and `path_r_f32`'s step on both designs.

Kernels: design 3 is built once for each flush group, `csrc/conv_fused.cu`
with its `kFlush` (the k8 steps whose products share a fresh accumulator
before it is added to the float32 sum) set by a text patch to 1, 2 and 4,
each by its own `nvcc` (all at once) into `build/b7_variants/`, and
launched through its `dl4j_*_stats_tf32x3`. At every `path_r` shape
(`chip_smoke.b7_path_shapes()`: 15 B7a and 4 B7b shapes, K up to 2048 and
9·C up to 4608) on seeded Gaussian inputs, and at four of them on
post-ReLU x and on small integers (TF32-exact), each variant, then design
1 and the library yardstick (`torch.matmul` or `F.conv2d` for y alone,
float32, TF32 off): the time (CUDA events, a 256 MB L2 flush before each
launch, `chip_smoke.time_ms`), its share of the design's bound
(`chip_smoke.b7_bound`), and the largest error of y, Σy and Σy² against
the plain version in float64 on the same inputs (a share of the largest
|ref|); the guard is design 3's over design 1's (at most 2; where design
1 is exact, design 3 must be too). The summary sums each variant over a
`path_r` step.

Path: `path_r_f32` (`chip_smoke.path_r(..., dtype="float32")`: ResNet-50,
224x224, batch 128, 12 steps, TF32 off) with every B7 call on design 3
and on design 1, in turns (3, 1, 1, 3), by patching
`ops.conv_fused.b7_design` in this process alone. One JSON line a shape
and a run, the card's name and power limit first.

`--only wgmma` times design 2 (bfloat16) alone at every `path_r` shape,
with `chip_smoke.time_ms` and with `chip_smoke.queued_ms` (the host
queued ahead of the card, so the events time the kernel and not a slow
host), for a tree against another (`--root`).

    python tools/torch_b7_tf32.py [--root DIR] [--label NAME]
                                  [--only kernels|path|wgmma]

`--root` imports `deeplearning4j_tpu_torch` from another tree, so two
versions compare in one call.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "build" / "b7_variants"
FLUSHES = (1, 2, 4)
# (kernel, shape) run on the other kinds of data too
DATA_SHAPES = (("conv1x1_bn_stats", (100352, 256, 128)),
               ("conv1x1_bn_stats", (6272, 2048, 512)),
               ("conv3x3_bn_stats", (128, 14, 14, 256, 256)),
               ("conv3x3_bn_stats", (128, 56, 56, 64, 64)))
_C = {"conv1x1_bn_stats": "dl4j_matmul_stats_tf32x3",
      "conv3x3_bn_stats": "dl4j_conv3x3_stats_tf32x3"}


def build_variants(cf, cuda_build):
    """{kFlush: {kernel: its design 3 entry point}}, each flush group's
    library built from the package's source with kFlush patched."""
    text = (Path(cf.__file__).parents[1] / "csrc" / "conv_fused.cu") \
        .read_text()
    pat = r"constexpr int kFlush = \d+;"
    if len(re.findall(pat, text)) != 1:
        raise RuntimeError("conv_fused.cu: kFlush not found once")
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kf in FLUSHES:
        cu = OUT / f"conv_fused_k{kf}.cu"
        cu.write_text(re.sub(pat, f"constexpr int kFlush = {kf};", text))
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
               str(Path(cf.__file__).parents[1] / "csrc"), "-o",
               str(OUT / f"libconv_fused_k{kf}.so"), str(cu)]
        procs[kf] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
    fns = {}
    for kf, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"kFlush {kf}: nvcc failed\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT / f"libconv_fused_k{kf}.so"))
        fns[kf] = {}
        for kernel, name in _C.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = \
                cuda_build.SOURCES["conv_fused"][name]
            fns[kf][kernel] = fn
    return fns


def launch_variant(fn, kernel, x, w, shape, cf):
    """(y, Σy, Σy²) of one design 3 variant, allocated as `_launch` does."""
    m = shape[0] if kernel == "conv1x1_bn_stats" else \
        shape[0] * shape[1] * shape[2]
    n = shape[-1]
    y = torch.empty((m, n), device="cuda")
    part = torch.empty((2, -(-m // 128), n), device="cuda")
    sums = torch.empty((2, n), device="cuda")
    planes = torch.empty(2 * w.numel(), device="cuda")
    rc = fn(x.data_ptr(), w.data_ptr(), planes.data_ptr(), y.data_ptr(),
            part.data_ptr(), sums.data_ptr(), *shape, *cf.tf32x3_tile(shape),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"{kernel} {shape}: CUDA error {rc}")
    return y, sums[0], sums[1]


def inputs(kernel, shape, gen, data, cs):
    """Seeded float32 inputs on the card: "gauss" (x ~ N(0, 1), w scaled
    by its fan in), or `chip_smoke.b7_data`'s "relu" and "ints"."""
    *lead, cin, n = shape
    if data != "gauss":
        x, w = cs.b7_data(kernel, shape, data, gen)
        return x.cuda(), w.cuda()
    kshape = (cin, n) if kernel == "conv1x1_bn_stats" else (3, 3, cin, n)
    fan = cin * (9 if kernel == "conv3x3_bn_stats" else 1)
    return (torch.randn(*lead, cin, generator=gen).cuda(),
            (torch.randn(*kshape, generator=gen) / fan ** 0.5).cuda())


def library_call(kernel, x, w):
    import torch.nn.functional as F

    if kernel == "conv1x1_bn_stats":
        return lambda: torch.matmul(x, w)
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
    return lambda: F.conv2d(xc, wc, padding=1)


def guard(mine, ffma):
    """Design 3's error over design 1's on each output; 0 where both are
    exact, inf where design 3 alone is not."""
    return {n: mine[n] / ffma[n] if ffma[n] else
            (0.0 if mine[n] == 0 else float("inf")) for n in ffma}


def kernel_row(kernel, shape, per_step, data, flush, gen, fns, cs, cf):
    x, w = inputs(kernel, shape, gen, data, cs)
    plain = cf.matmul_with_channel_stats_plain \
        if kernel == "conv1x1_bn_stats" \
        else cf.conv3x3_with_channel_stats_plain
    ref64 = plain(x.double(), w.double())
    calls = {"ffma": lambda: cf._launch(kernel, x, w, shape, "ffma")}
    for kf in FLUSHES:
        calls[f"tf32x3/k{kf}"] = (lambda fn=fns[kf][kernel]: launch_variant(
            fn, kernel, x, w, shape, cf))
    row = {"kernel": kernel, "shape": list(shape), "data": data,
           "launches_per_path_r_step": per_step if data == "gauss" else 0}
    for name, call in calls.items():
        design = name.split("/")[0]
        got, again = call(), call()
        torch.cuda.synchronize()
        ms = cs.time_ms(call, flush)
        bms, by = cs.b7_bound(kernel, shape, torch.float32, design)
        row[name] = {"ms": ms, "bound_ms": bms, "bound_by": by,
                     "bound_share": bms / ms,
                     "tflops": cs.b7_flops(kernel, shape) / ms / 1e9,
                     "f64_share": cs.b7_f64_shares(got, ref64),
                     "bit_equal_repeat": all(torch.equal(a, b) for a, b
                                             in zip(got, again))}
        del got, again
    for name in calls:
        if name != "ffma":
            row[name]["guard_ratio"] = guard(row[name]["f64_share"],
                                             row["ffma"]["f64_share"])
    row["library_ms"] = cs.time_ms(library_call(kernel, x, w), flush)
    print(json.dumps(row), flush=True)
    del x, w, ref64
    torch.cuda.empty_cache()
    return row


def kernels(label, cs, cf, cuda_build):
    fns = build_variants(cf, cuda_build)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator().manual_seed(25)
    cases = [(k, s, n, "gauss")
             for (k, s), n in sorted(cs.b7_path_shapes().items())]
    cases += [(k, s, 0, d) for d in ("relu", "ints") for k, s in DATA_SHAPES]
    rows = [kernel_row(k, s, n, d, flush, gen, fns, cs, cf)
            for k, s, n, d in cases]
    del flush
    names = ["ffma"] + [f"tf32x3/k{kf}" for kf in FLUSHES]
    for kernel in cs.B7_KERNELS:
        mine = [r for r in rows if r["kernel"] == kernel]
        step = [r for r in mine if r["launches_per_path_r_step"]]
        total = {n: sum(r[n]["ms"] * r["launches_per_path_r_step"]
                        for r in step) for n in names}
        total["library"] = sum(r["library_ms"] * r["launches_per_path_r_step"]
                               for r in step)
        bound = {d: sum(cs.b7_bound(kernel, tuple(r["shape"]),
                                    torch.float32, d)[0]
                        * r["launches_per_path_r_step"] for r in step)
                 for d in ("ffma", "tf32x3")}
        worst = {n: {d: max(max(r[n]["guard_ratio"].values())
                            for r in mine if r["data"] == d)
                     for d in ("gauss", "relu", "ints")}
                 for n in names if n != "ffma"}
        print(json.dumps({"label": label, "kernel": kernel,
                          "step_ms": total, "bound_ms": bound,
                          "guard_ratio_max": worst,
                          "per": "path_r_f32 step, float32"}), flush=True)


def wgmma(label, cs, cf):
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator().manual_seed(25)
    total = {"ms": 0.0, "queued_ms": 0.0}
    for (kernel, shape), n in sorted(cs.b7_path_shapes().items()):
        x, w = (t.to(torch.bfloat16)
                for t in inputs(kernel, shape, gen, "gauss", cs))

        def call():
            return cf._launch(kernel, x, w, shape, "wgmma")

        row = {"label": label, "kernel": kernel, "shape": list(shape),
               "launches_per_path_r_step": n, "ms": cs.time_ms(call, flush),
               "queued_ms": cs.queued_ms(call, flush)}
        for k in total:
            total[k] += n * row[k]
        print(json.dumps(row), flush=True)
        del x, w
    print(json.dumps({"label": label, "design": "wgmma",
                      "per": "path_r step, bfloat16", **total}), flush=True)


def path(label, cs, cf):
    rng = np.random.default_rng(25)
    images = cs.image_batches(rng, 4, 128, 224, 1000)
    chosen = cf.b7_design
    want = dict(cs.PATH_R_DESIGN)

    def ffma(dtype, shape, ptrs):
        return "ffma"

    out = {}
    for run, design in enumerate(("tf32x3", "ffma", "ffma", "tf32x3")):
        cf.b7_design = chosen if design == "tf32x3" else ffma
        cs.PATH_R_DESIGN["float32"] = design
        try:
            row = cs.path_r(images, dtype="float32")
        finally:
            cf.b7_design = chosen
            cs.PATH_R_DESIGN.update(want)
        keep = {k: row[k] for k in ("step_ms_p50", "step_ms_max",
                                    "images_per_s_steps_3_12",
                                    "max_memory_allocated_bytes",
                                    "epoch_mean_loss")}
        out.setdefault(design, []).append(keep)
        print(json.dumps({"label": label, "run": run, "design": design,
                          **keep}), flush=True)
    p50 = {d: [r["step_ms_p50"] for r in rows] for d, rows in out.items()}
    print(json.dumps({"label": label, "path_r_f32_step_ms_p50": p50,
                      "ffma_minus_tf32x3_ms": float(
                          np.mean(p50["ffma"]) - np.mean(p50["tf32x3"]))}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--only", choices=("kernels", "path", "wgmma"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_b7_tf32: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import conv_fused as cf
    from deeplearning4j_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.gpu_name_and_limit(), flush=True)
    print(json.dumps({"label": args.label, "package": cf.__file__,
                      "build_s": cuda_build.build(
                          ["conv_fused"] if args.only == "wgmma" else None)}),
          flush=True)
    if args.only == "wgmma":
        wgmma(args.label, cs, cf)
        return 0
    if args.only != "path":
        kernels(args.label, cs, cf, cuda_build)
    if args.only != "kernels":
        path(args.label, cs, cf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
