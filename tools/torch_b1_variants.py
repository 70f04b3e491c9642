#!/usr/bin/env python3
"""Variants of design 2 of the fused updates B1a / B1b against design 1,
on one card.

    python3 tools/torch_b1_variants.py

Builds `csrc/fused_update.cu` again with other constants of design 2
(shared-memory stages a block, blocks an SM, consumer warps a block, and
the leaves of the smaller gradient-address parameter block; the variant
the source uses is one of them), one `nvcc` each, all at once,
into `deeplearning4j_tpu_torch/_build/b1_variants/`, and times each, and
design 1, on one launch plan (`ops/fused_update.UpdatePlan`) as
`chip_smoke.queued_ms` times the kernels (a 256 MB L2 flush before each
launch, the host queued ahead of the card), in the order design 1, the variants, the variants backwards,
design 1, at the leaf sets of `chip_smoke.py`'s main paths: `path_t`'s
82 float32 leaves, InceptionResNetV1's 272 and the VGG transfer head's
6 (Adam); GoogLeNet's 173, AlexNet's 16 and `path_l`'s 10 (Nesterovs).
One JSON line a leaf set (each variant's two times and its share of the
bytes bound), then the card's name and power limit. Needs a CUDA card
and `nvcc`.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

# name -> (stages, consumer warps, blocks an SM, leaves of the smaller
# gradient-address block: its bytes are 8 a leaf)
VARIANTS = {"s4_b1": (4, 8, 1, 512), "s3_b2": (3, 8, 2, 512),
            "s2_b2": (2, 8, 2, 512), "s4_w16_b1": (4, 16, 1, 512),
            "s6_b1": (6, 8, 1, 512), "s3_b2_cap32": (3, 8, 2, 32)}


def build_variants():
    """{name: loaded library} of every variant, built in parallel."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "fused_update.cu").read_text()
    out_dir = cuda_build.BUILD_DIR / "b1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (stages, warps, per_sm, cap) in VARIANTS.items():
        text = re.sub(r"constexpr int kStages = \d+;",
                      f"constexpr int kStages = {stages};", src)
        text = re.sub(r"constexpr int kConsumerWarps = \d+;",
                      f"constexpr int kConsumerWarps = {warps};", text)
        text = re.sub(r"__launch_bounds__\(kBlockThreads, \d+\)",
                      f"__launch_bounds__(kBlockThreads, {per_sm})", text)
        text = re.sub(r"constexpr int kSmallCap = \d+;",
                      f"constexpr int kSmallCap = {cap};", text)
        path = out_dir / f"fused_update_{name}.cu"
        path.write_text(text)
        lib = out_dir / f"libfused_update_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
             str(cuda_build.CSRC), "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(path))
        for fn, (res, args) in cuda_build.SOURCES["fused_update"].items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = res, args
        cuda_build.check(lib, lib.dl4j_fused_update_prepare(),
                         f"variant {name} prepare")
        libs[name] = lib
    return libs


def leaf_sets():
    """(name, kind, shapes) of the main paths' B1 launches."""
    from deeplearning4j_tpu_torch import zoo

    out = [("path_t", "adam", cs.tree_shapes(cs.shape_tree(
        cs.build_net("cuda", num_blocks=6, seed=3).params_tree)))]
    for name, kind, model, size in (
            ("inception_resnet_v1", "adam", zoo.InceptionResNetV1, 160),
            ("googlenet", "nesterov", zoo.GoogLeNet, 224),
            ("alexnet", "nesterov", zoo.AlexNet, 224)):
        net = model(num_classes=1000, input_shape=(size, size, 3)).init(
            device="cuda")
        out.append((name, kind, cs.tree_shapes(cs.shape_tree(
            net.params_tree))))
        del net
    out.append(("vgg_head", "adam", [(25088, 4096), (4096,), (4096, 4096),
                                     (4096,), (4096, 10), (10,)]))
    out.append(("path_l", "nesterov", cs.tree_shapes(cs.shape_tree(
        cs.build_lstm_net("cuda", seed=3).params_tree))))
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_b1_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import fused_update as fu

    base = fu._lib()
    libs = build_variants()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    scalar = torch.tensor(1e-3, device="cuda")
    try:
        for name, kind, shapes in leaf_sets():
            leaves = cs.b1_leaves(kind, shapes, torch.float32, 7)
            cols = list(zip(*leaves))
            grads = list(cols[1])
            hyper = (dict(beta1=0.9, beta2=0.999, eps=1e-8)
                     if kind == "adam" else dict(momentum=0.9))
            plans, times = {}, {}
            order = ["multi", *VARIANTS, *reversed(VARIANTS), "multi"]
            for v in order:
                per_sm = 2 if v == "multi" else VARIANTS[v][2]
                fu._LIB[:] = [base if v == "multi" else libs[v]]
                if per_sm not in plans:
                    plans[per_sm] = fu.UpdatePlan(
                        kind, cols[0], cols[2] if kind == "adam" else None,
                        cols[-1], sms=sms * per_sm // fu.BLOCKS_PER_SM)
                plan = plans[per_sm]
                design = "multi" if v == "multi" else "persistent"
                times.setdefault(v, []).append(cs.queued_ms(
                    lambda: plan.launch(grads, scalar, design=design,
                                        **hyper), flush))
            n = sum(p.numel() for p in cols[0])
            bound = (7 if kind == "adam" else 5) * n * 4 \
                / cs.HBM_BYTES_PER_S * 1e3
            cs.emit({"tool": "torch_b1_variants", "leaves": name,
                     "kernel": f"{kind}_update", "n_leaves": len(shapes),
                     "elements": n, "bound_ms": bound,
                     "ms": {v: t for v, t in times.items()},
                     "bound_share": {v: bound / float(np.mean(t))
                                     for v, t in times.items()},
                     "variants": {v: dict(zip(("stages", "consumer_warps",
                                              "blocks_per_sm", "small_cap"),
                                             c))
                                  for v, c in VARIANTS.items()}})
            del leaves, cols, grads, plans
            torch.cuda.empty_cache()
    finally:
        fu._LIB[:] = [base]
    print(cs.gpu_name_and_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
