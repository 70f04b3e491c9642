"""Data-parallel ResNet-50 across cards: `ParallelWrapper` over N NCCL
ranks, one a card (BASELINE config #5 across cards), and whether a
K-step window of its step captures as one CUDA graph with NCCL inside.

`python3 tools/torch_dp_multicard.py --ranks 4` on a host with 4 cards
spawns 4 rank processes of this file, joined over 127.0.0.1. Each rank
builds `chip_smoke.resnet_conf()`'s ResNet-50 (bf16, fused conv+BN,
Nesterovs) and, on PyTorch's deterministic algorithms:

1. fits it under `ParallelWrapper` (sharded moments), 64 images a rank,
   6 steps at K 1: step ms by CUDA events, the exchange's ms a step (the
   wrapper's gradient all-reduce and parameter all-gather, host clock
   with a sync), the ledger's bytes a step;
2. drives fresh twins of the net (same seeds, same batches) through the
   net's K-step window (`_fused_dispatch`) with CUDA graphs on: 3
   windows of K 2 (the first runs eagerly, the second is captured, the
   third replayed), and K 1 on the other twin; reports whether the
   capture held NCCL's collectives, and the largest gap of losses and
   parameters between K 2 and K 1 (0: bit-equal).

Rank 0 prints one JSON line with every rank's figures beside the card's
name and power limit. `--device cpu --backend gloo --size 32` rehearses
it on the CPU (no capture there: the window runs its steps directly).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS, K = 6, 2


def _leaves(net):
    from deeplearning4j_tpu_torch.optim.updaters import tree_leaves

    return [t.detach().float().cpu() for tree in (
        net.params_tree, net.updater_state, net.state_tree)
        for t in tree_leaves(tree)]


def rank_main(args):
    import numpy as np
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.observe.commsmon import get_comm_ledger
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, initialize_distributed,
    )
    from deeplearning4j_tpu_torch.parallel import data_parallel as dpm

    rank, world, dev = args.rank, args.ranks, args.device
    if dev == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(f"127.0.0.1:{args.port}", world, rank,
                           backend=args.backend, timeout_s=120)
    device = f"cuda:{rank}" if dev == "cuda" else "cpu"

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    exchange = {"ms": 0.0}

    def timed(fn):
        def run(*a):
            sync()
            t0 = time.perf_counter()
            out = fn(*a)
            sync()
            exchange["ms"] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    dpm._DataParallelStep.reduce = timed(dpm._DataParallelStep.reduce)
    dpm._DataParallelStep._all_gather = timed(
        dpm._DataParallelStep._all_gather)
    batches = cs.image_batches(np.random.default_rng(30), STEPS,
                               64 * world, args.size, 1000)

    def net():
        return ComputationGraph(cs.resnet_conf(size=args.size,
                                               dtype=args.dtype),
                                device=device).init()

    out = {"rank": rank}

    def progress(what):
        if rank == 0:
            print(f"torch_dp_multicard: {what}", file=sys.stderr, flush=True)

    progress(f"joined {world} ranks on {args.backend}")
    with cs.deterministic():
        # 1. the wrapper's fit at K 1
        a = net()
        pw = ParallelWrapper(a)
        events, losses = [], []
        from deeplearning4j_tpu_torch.optim.listeners import TrainingListener

        class Clock(TrainingListener):
            def iteration_done(self, model, iteration, epoch, score):
                losses.append(score)
                if dev == "cuda":
                    e = torch.cuda.Event(enable_timing=True)
                    e.record()
                    events.append(e)

        a.listeners.append(Clock())
        ledger = get_comm_ledger()
        mark = ledger.mark()
        sync()
        t0 = time.perf_counter()
        pw.fit(batches, epochs=1)
        sync()
        out["fit_s"] = time.perf_counter() - t0
        ops = ledger.since(mark)
        out["losses"] = [float(x) for x in losses]
        if events:
            out["step_ms"] = [events[i].elapsed_time(events[i + 1])
                              for i in range(len(events) - 1)]
        out["exchange_ms_per_step"] = exchange["ms"] / STEPS
        by = {}
        for op in ops:
            key = f"{op['kind']}:{op['purpose']}"
            by[key] = by.get(key, 0) + op["payload_bytes"] / STEPS
        out["ledger_payload_bytes_per_step"] = by
        out["staged_ops"] = sum(op["staged"] for op in ops)
        del a, pw
        progress(f"K 1 fit done: {out['fit_s']:.1f} s")

        # 2. K 2 windows through CUDA graphs against K 1
        twins = []
        for _ in range(2):
            n = net()
            w = ParallelWrapper(n)
            n.cuda_graphs = True
            n._start_steps()
            twins.append((n, w))
        (k1, w1), (k2, w2) = twins
        local = [k1._put_batch(w1._local_rows(b)) for b in batches]
        l1 = [k1._fit_batch(b) for b in local]
        l2, err = [], None
        progress("K 1 twin done; K 2 windows next")
        try:
            for j in range(0, STEPS, K):
                l2 += list(k2._fused_dispatch(local[j:j + K]))
                sync()
                progress(f"window {j // K + 1} of {STEPS // K} done")
        except Exception as e:          # the finding, reported
            err = f"{type(e).__name__}: {e}"[:400]
        out["graph_stats"] = dict(k2._graphs.stats.get("fit", {}))
        out["fit_stats"] = dict(k2.fit_stats)
        out["capture_error"] = err
        if err is None:
            gap = max([abs(float(x) - float(y)) for x, y in zip(l1, l2)]
                      + [(x - y).abs().max().item()
                         for x, y in zip(_leaves(k1), _leaves(k2))])
            out["k2_vs_k1_max_abs"] = gap
            out["k2_losses"] = [float(x) for x in l2]
        out["k1_losses"] = [float(x) for x in l1]
    parts = [None] * world
    torch.distributed.all_gather_object(parts, out)
    if rank == 0:
        print(json.dumps({"tool": "torch_dp_multicard", "ranks": world,
                          "backend": args.backend, "size": args.size,
                          "dtype": args.dtype, "batch_per_rank": 64,
                          "card": cs.gpu_name_and_limit()
                          if dev == "cuda" else "cpu",
                          "per_rank": parts}), flush=True)
    torch.distributed.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args)
        return 0
    if args.device == "cuda":
        # built once here; the ranks load the libraries
        from deeplearning4j_tpu_torch.ops import cuda_build
        cuda_build.build(["conv_fused", "fused_update"])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    base = [sys.executable, os.path.abspath(__file__), "--ranks",
            str(args.ranks), "--device", args.device, "--backend",
            args.backend, "--size", str(args.size), "--dtype", args.dtype,
            "--port", str(port)]
    procs = [subprocess.Popen(base + ["--rank", str(r)], env=env)
             for r in range(args.ranks)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(codes)


if __name__ == "__main__":
    sys.exit(main())
