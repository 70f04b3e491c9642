#!/usr/bin/env python3
"""Where `chip_smoke.path_h`'s HTTP wave spends the time the direct
manager does not.

    python3 tools/torch_http_probe.py [--rounds 2]

Path A's model (6 blocks, d_model 512, T 2048, seed 7) and its 8 cold
1024-token prompts (the first 8 draws of `np.random.default_rng(0)`),
64 greedy tokens each. Each round serves the wave once through the
direct `DecodeSessionManager` and twice through a fresh
`InferenceServer` on 127.0.0.1 (8 SSE client threads), without and with
TCP_NODELAY on the server's sockets. For an HTTP wave it prints, in ms
from the moment the first client started: when each session's
admission (`open_session`) began and ended, the server's TTFT (from
admission) and the client's TTFT (from its request), with tokens/s, the
dispatch counters and the server's ITL p50. One JSON line a wave, after
the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import socketserver
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def direct(net, prompts):
    registry, sched, mgr = cs.control_plane(net, slots=8, chunk=128, k=8)
    try:
        _, wave = cs.serve_wave(mgr, prompts, [True] * 8, 64, 256)
        return wave
    finally:
        sched.shutdown()
        registry.close()


def http(net, prompts, nodelay: bool):
    from deeplearning4j_tpu_torch.serving import InferenceServer

    socketserver.StreamRequestHandler.disable_nagle_algorithm = nodelay
    srv = InferenceServer(net, decode_slots=8, decode_prefill_chunk=128,
                          decode_fused_k=8)
    mgr = srv._decode["default"]
    opened = []
    open_session = mgr.open_session

    def timed_open(*a, **kw):
        t = time.monotonic()
        sess = open_session(*a, **kw)
        opened.append((t, time.monotonic(), sess))
        return sess

    mgr.open_session = timed_open
    port = srv.start()
    try:
        t0 = time.monotonic()
        clients = [cs.SseClient(port, p, 64) for p in prompts]
        for c in clients:
            c.result()
        wall = time.monotonic() - t0
        snap = mgr.snapshot()
    finally:
        srv.stop()
    return {"nodelay": nodelay, "wall_s": wall, "tok_s": 512 / wall,
            "admit_start_ms": sorted((a - t0) * 1e3 for a, _, _ in opened),
            "admit_end_ms": sorted((b - t0) * 1e3 for _, b, _ in opened),
            "server_ttft_ms": sorted(s.ttft_ms for _, _, s in opened),
            "client_ttft_ms": sorted(c.ttft_ms() for c in clients),
            "dispatches": snap["dispatches"],
            "itl_p50": snap["itl_ms"]["p50"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_http_probe: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_name_and_limit(), flush=True)
    cuda_build.build(["decode_attention"])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 1024) for _ in range(8)]
    net = cs.build_net("cuda", num_blocks=6, seed=7)
    for _ in range(args.rounds):
        print(json.dumps({"direct": direct(net, prompts)}), flush=True)
        for nodelay in (False, True):
            print(json.dumps(http(net, prompts, nodelay)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
