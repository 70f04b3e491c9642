"""Replica process entry point (port of
`deeplearning4j_tpu/serving/fleet/replica_main.py`):

    python -m deeplearning4j_tpu_torch.serving.fleet.replica_main \
        --config '{"name": "r0", "role": "prefill", ...}'

Each replica is its own interpreter on its own device: the process
boundary is the fleet's isolation unit (a replica kill takes down one
process, never the fleet). The config is declarative; the model is
rebuilt from its spec with seeded init, so every replica of the same spec
holds the same weights without weight bytes crossing the wire.

Device: the replica runs on the card (`cuda`), and refuses to start
when none is present, unless `FLEET_REPLICA_PLATFORM=cpu` asks for the
CPU (the variable JAX's replica reads, whose default is the CPU instead).

Prints exactly one `FLEET_REPLICA_READY port=<p>` line on stdout once the
HTTP server is listening (the launcher's rendezvous), then blocks until
SIGTERM/SIGINT.

Config keys (all optional but `model`):
  name, role            — replica identity + fleet role
  port                  — 0 (default) = ephemeral
  model                 — builder spec, e.g. {"kind": "bench_lm",
                          "seed": 0, "vocab": 32, "blocks": 1}
  decode_slots          — KV slots (default 4)
  prefill_chunk, fused_k, kv_dtype, page_len
                        — forwarded to enable_decode_sessions
  slo                   — {"interval": s, "objectives": [SLO kwargs]}
                          turns on the series sampler + SLO engine
                          (the router's drain signal)
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading

ENV_PLATFORM = "FLEET_REPLICA_PLATFORM"


def replica_device() -> str:
    """The device a replica's models live on: "cuda" unless
    FLEET_REPLICA_PLATFORM is "cpu"; with no card present that raises."""
    import torch

    if os.environ.get(ENV_PLATFORM, "").strip().lower() == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"a fleet replica runs on the card and no CUDA device is "
            f"present; set {ENV_PLATFORM}=cpu to run it on the CPU")
    return "cuda"


def build_bench_lm(spec: dict):
    """The fleet's bench/test model: a small seeded transformer LM with a
    NON-rolling uniform cache, which makes it pageable
    (`prefix_cache_capable`) and so handoff-capable; `seed` varies the
    weights for hot-swap legs. Built on `replica_device()`."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        PositionEmbeddingLayer, TransformerEncoderBlock,
    )
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        EmbeddingSequenceLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    V = int(spec.get("vocab", 32))
    chunk = int(spec.get("chunk", 8))
    max_cache = int(spec.get("max_cache", 128))
    layers = [EmbeddingSequenceLayer(n_in=V, n_out=32),
              PositionEmbeddingLayer(max_length=256)]
    for _ in range(int(spec.get("blocks", 1))):
        layers.append(TransformerEncoderBlock(
            num_heads=4, causal=True, window=32,
            rolling_cache=False, max_cache=max_cache))
    layers.append(RnnOutputLayer(n_out=V, activation="softmax"))
    conf = (NeuralNetConfiguration.builder()
            .seed(int(spec.get("seed", 0)))
            .updater(Adam(1e-3)).activation("identity")
            .list(*layers)
            .set_input_type(InputType.recurrent(1, chunk)).build())
    return MultiLayerNetwork(conf, device=replica_device()).init()


def make_server(config: dict):
    """Build a ReplicaServer from a declarative config (shared by the
    process entry below and in-process tests)."""
    from deeplearning4j_tpu_torch.serving.fleet.replica import (
        ReplicaServer, build_from_spec, register_model_builder,
    )
    register_model_builder("bench_lm", build_bench_lm)
    net = build_from_spec(config["model"])
    slo_cfg = config.get("slo") or {}
    objectives = None
    if slo_cfg.get("objectives"):
        from deeplearning4j_tpu_torch.observe.slo import SLO
        objectives = [SLO(kw.pop("name"), **kw)
                      for kw in (dict(o) for o in slo_cfg["objectives"])]
    srv = ReplicaServer(
        net,
        port=int(config.get("port", 0)),
        role=config.get("role", "mixed"),
        replica_name=config.get("name", "replica"),
        decode_slots=int(config.get("decode_slots", 4)),
        decode_prefill_chunk=int(config.get("prefill_chunk", 8)),
        decode_fused_k=config.get("fused_k"),
        decode_kv_dtype=config.get("kv_dtype"),
        decode_page_len=config.get("page_len"),
        max_batch_size=int(config.get("max_batch_size", 8)),
        queue_capacity=int(config.get("queue_capacity", 64)),
        slo=bool(slo_cfg),
        slo_objectives=objectives,
        series_interval=slo_cfg.get("interval"))
    return srv


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    raw = os.environ.get("FLEET_REPLICA_CONFIG", "{}")
    if "--config" in argv:
        raw = argv[argv.index("--config") + 1]
    config = json.loads(raw)
    replica_device()            # no card and no CPU request: fail here
    srv = make_server(config)
    port = srv.start()
    print(f"FLEET_REPLICA_READY port={port}", flush=True)
    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    stop.wait()
    srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
