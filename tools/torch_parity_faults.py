#!/usr/bin/env python3
"""Whether `chip_smoke.py`'s bfloat16 train-step parity check catches a
wrong step, on one card.

    python3 tools/torch_parity_faults.py [--batches 3]

Runs `chip_smoke.train_parity` in bfloat16 (2 blocks, T 256, batch 2,
two Adam steps, the card against the CPU) with `chip_smoke.py`'s limits
(`TRAIN_PARITY_BF16`), first sound over `--batches` batches, then once
with each planted fault, made in memory on the card's side only (no
source file changes):

- `skip_update`: the second step's Adam update leaves the largest leaf
  (and its moments) as they were;
- `dk_tile_zero`: B3b's dK loses its first 64 keys (a key tile) in every
  launch;
- `dq_rows_swapped`: B3c's dQ comes back with neighbouring query rows
  swapped (a wrong lane map: plausible values in the wrong places);
- `dq_scaled`: B3c's dQ comes back 2^-5 too large.

Each run prints `chip_smoke.py`'s own row (losses, the parameters past
their limit and the update gaps) and the checks that failed. The last
line is one JSON object: each run's readings and whether the checks
caught it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


@contextlib.contextmanager
def patched(module, name, wrap):
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def skip_update(orig):
    """Wraps `UpdatePlan.launch`, through which every B1a launch goes."""
    calls = {"n": 0}

    def launch(plan, grads, scalar, **kw):
        calls["n"] += 1
        if calls["n"] != 2 or plan.kind != "adam" or not plan.cuda:
            return orig(plan, grads, scalar, **kw)
        params, ms, vs = plan.leaves()
        i = max(range(len(params)), key=lambda j: params[j].numel())
        kept = [t[i].clone() for t in (params, ms, vs)]
        orig(plan, grads, scalar, **kw)
        for t, x in zip((params, ms, vs), kept):
            t[i].copy_(x)

    return launch


def dk_tile_zero(orig):
    def launch(*args, **kw):
        dk, dv = orig(*args, **kw)
        dk[:, :64] = 0
        return dk, dv

    return launch


def dq_rows_swapped(orig):
    def launch(*args, **kw):
        dq = orig(*args, **kw)
        bh, t, dh = dq.shape
        return dq.reshape(bh, t // 2, 2, dh).flip(2).reshape(bh, t, dh)

    return launch


def dq_scaled(orig):
    def launch(*args, **kw):
        return orig(*args, **kw) * (1 + 2.0 ** -5)

    return launch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=3,
                    help="sound runs, each on its own batch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_parity_faults: needs a CUDA card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import attention as fa
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import fused_update as fu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build()
    failed = []
    real_check = cs.check

    def record(cond, msg):
        if not cond:
            failed.append(msg[:300])

    runs = [(f"sound_{i}", i, None) for i in range(args.batches)]
    runs += [("skip_update", 0, (fu.UpdatePlan, "launch", skip_update)),
             ("dk_tile_zero", 0, (fa, "launch_bwd_dkdv", dk_tile_zero)),
             ("dq_rows_swapped", 0, (fa, "launch_bwd_dq", dq_rows_swapped)),
             ("dq_scaled", 0, (fa, "launch_bwd_dq", dq_scaled))]
    out = []
    cs.check = record
    try:
        for name, seed, fault in runs:
            failed.clear()
            with (patched(*fault) if fault else contextlib.nullcontext()):
                row = cs.train_parity(np.random.default_rng(seed),
                                      f"train_parity_bf16/{name}",
                                      **cs.TRAIN_PARITY_BF16)
            out.append({"run": name, "caught": bool(failed),
                        "failed_checks": list(failed),
                        **{k: row[k] for k in (
                            "loss_rel_err", "max_param_abs_err",
                            "params_over_tolerance", "update_gap_tree",
                            "update_gap_leaf_max")}})
            print(json.dumps(out[-1]), flush=True)
    finally:
        cs.check = real_check
    print(cs.gpu_name_and_limit())
    print(json.dumps({"runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
