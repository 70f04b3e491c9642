"""The updaters' own B1 call, as a training step makes it, against
`torch.optim`'s fused step over the same leaves, on the card.

Over `path_i`'s updates: InceptionResNetV1's 272 float32 leaves under
`Adam(1e-3)` (kernel B1a), GoogLeNet's 173 and AlexNet's 16 under
`Nesterovs(1e-2, 0.9)` (B1b), each model at its published widths
(`deeplearning4j_tpu_torch.zoo`). Every call gets a gradient tree of its
own (16 sets at their own addresses, cycled), as each step's backward
makes them anew. Reported, as JSON lines:

- `host_ms`: the host clock over 50 calls without a sync (what a K 1
  train step waits for before its next launch);
- `updater_ms`: CUDA events around each of 30 calls, a 256 MB L2 flush
  before each (the device's time for the call, with the host's in it
  where the host is the slower);
- `host_ms_cold`: the median host time of 20 calls, each after a walk
  over 256 MB of host memory (the CPU's caches cold, as a step's
  backward leaves them; the walk is not timed);
- `library_ms`, `library_host_ms`, `library_host_ms_cold`: the same
  clocks for `torch.optim.Adam(fused=True)` /
  `SGD(nesterov=True, fused=True)`;
- where the tree has launch plans (`ops/fused_update.UpdatePlan`), the
  kernel alone in each design on one plan and one gradient set (events
  as above, each launch queued behind a ~1 ms spin of the card so the
  host's checks stay out of them, in the order multi, persistent,
  persistent, multi): `kernel_ms`.

It uses only the updaters' public call, so it runs against any tree of
the port: `python tools/torch_b1_updater.py --label change` from the
repo's root, or from an unpacked older tree (`git archive`) with this
file copied into its `tools/`, to compare two versions in one chip call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CALLS, SETS, EVENT_CALLS, COLD_CALLS = 50, 16, 30, 20
_EVICT = np.ones(32 << 20)          # 256 MB of float64


def shape_tree(model, size):
    net = model(num_classes=1000, input_shape=(size, size, 3)).init(
        device="cuda")
    tree = {n: {k: tuple(t.shape) for k, t in sub.items()}
            for n, sub in net.params_tree.items()}
    del net
    torch.cuda.empty_cache()
    return tree


def draw(stree, g, scale=1.0, positive=False):
    return {n: {k: (torch.rand(s, generator=g, device="cuda") if positive
                    else scale * torch.randn(s, generator=g,
                                             device="cuda"))
                for k, s in sub.items()} for n, sub in stree.items()}


def queued_ms(fn, flush, lead_cycles=2_000_000):
    """Event ms a call over EVENT_CALLS calls, each after an L2 flush
    behind a ~1 ms spin of the card, so the launch is queued before the
    card reaches it: the kernel's time, not the host's."""
    for i in range(3):
        fn(i)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(EVENT_CALLS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(EVENT_CALLS)]
    for i, (s, e) in enumerate(zip(starts, ends)):
        torch.cuda._sleep(lead_cycles)
        flush.zero_()
        s.record()
        fn(i)
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / EVENT_CALLS


def clocks(fn, flush):
    """(host ms a call over CALLS calls without a sync, event ms a call
    over EVENT_CALLS calls each after an L2 flush); `fn(i)` is call i."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(CALLS):
        fn(i)
    host = (time.perf_counter() - t0) / CALLS * 1e3
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(EVENT_CALLS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(EVENT_CALLS)]
    for i, (s, e) in enumerate(zip(starts, ends)):
        flush.zero_()
        s.record()
        fn(i)
        e.record()
    torch.cuda.synchronize()
    return host, sum(s.elapsed_time(e) for s, e in zip(starts, ends)) \
        / EVENT_CALLS


def cold_host_ms(fn):
    """Median host ms of COLD_CALLS calls, each after a walk over
    `_EVICT` (not timed)."""
    times = []
    for i in range(COLD_CALLS):
        float(_EVICT.sum())
        t0 = time.perf_counter()
        fn(i)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def run(label, name, kind, stree, lr, flush):
    from deeplearning4j_tpu_torch.optim.updaters import Adam, Nesterovs

    g = torch.Generator(device="cuda").manual_seed(0)
    p = draw(stree, g)
    if kind == "adam":
        u = Adam(lr)
        state = {"m": draw(stree, g, 0.1), "v": draw(stree, g,
                                                     positive=True)}
    else:
        u = Nesterovs(lr, momentum=0.9)
        state = {"v": draw(stree, g, 0.1)}
    grads = [draw(stree, g) for _ in range(SETS)]
    step = torch.tensor(4, dtype=torch.int64, device="cuda")
    def call(i):
        u.update_with_params(grads[i % SETS], state, p, step)

    host, events = clocks(call, flush)
    cold = cold_host_ms(call)
    leaves = [t for sub in p.values() for t in sub.values()]
    gl = [[t for sub in gr.values() for t in sub.values()] for gr in grads]
    ps = [torch.nn.Parameter(t) for t in leaves]
    opt = (torch.optim.Adam(ps, lr=lr, fused=True) if kind == "adam" else
           torch.optim.SGD(ps, lr=lr, momentum=0.9, nesterov=True,
                           fused=True))

    def lib_step(i):
        for prm, gr in zip(ps, gl[i % SETS]):
            prm.grad = gr
        opt.step()

    lib_host, lib_events = clocks(lib_step, flush)
    lib_cold = cold_host_ms(lib_step)
    del opt, ps
    kernel_ms = {}
    from deeplearning4j_tpu_torch.ops import fused_update as fu
    if hasattr(fu, "UpdatePlan"):
        ms = ([t for sub in state["m"].values() for t in sub.values()]
              if kind == "adam" else None)
        vs = [t for sub in state["v"].values() for t in sub.values()]
        plan = fu.UpdatePlan(kind, leaves, ms, vs)
        scalar = torch.tensor(lr, device="cuda")
        for d in ("multi", "persistent", "persistent", "multi"):
            kernel_ms.setdefault(d, []).append(queued_ms(
                lambda i: plan.launch(gl[0], scalar, design=d), flush))
    row = {"tool": "torch_b1_updater", "label": label, "leaves": name,
           "kernel": f"{kind}_update", "n_leaves": len(leaves),
           "elements": sum(t.numel() for t in leaves), "grad_sets": SETS,
           "host_ms": host, "host_ms_cold": cold, "updater_ms": events,
           "library_host_ms": lib_host, "library_host_ms_cold": lib_cold,
           "library_ms": lib_events,
           "kernel_ms": kernel_ms}
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_b1_updater: needs a CUDA card", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch import zoo

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    run(args.label, "inception_resnet_v1", "adam",
        shape_tree(zoo.InceptionResNetV1, 160), 1e-3, flush)
    run(args.label, "googlenet", "nesterov",
        shape_tree(zoo.GoogLeNet, 224), 1e-2, flush)
    run(args.label, "alexnet", "nesterov",
        shape_tree(zoo.AlexNet, 224), 1e-2, flush)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
