"""Serving fleet: a router tier over N InferenceServer replicas (port of
`deeplearning4j_tpu/serving/fleet/`).

The single-replica stack (scheduler -> sessions -> paged KVSlotPool ->
radix prefix cache) is one process on one card; this package turns it
into a horizontally scalable tier:

- `handoff`   — dtype-aware KV page serialization (quantized bytes +
                in-page scale rows, never dequantized) between the paged
                pools of two replicas, wire format "kv-handoff-v1",
                byte-compatible with the JAX package's.
- `replica`   — ReplicaServer: an InferenceServer plus the /fleet/*
                control surface (role, prefill-only admission, KV
                export/import, drain, coordinated deploy).
- `router`    — FleetRouter: the HTTP front door. Disaggregated
                prefill->decode scheduling, sticky + prefix-overlap +
                load-aware placement, SLO-driven drain/reroute,
                mid-stream failover, fleet-wide hot-swap with rollback.
- `obsplane`  — the router's scrapes, fleet series and SLOs, stitched
                cross-process traces and incident bundles.
- `launcher`  — spawn replica processes (distinct interpreters, each on
                its own card or the CPU) for smoke tests and chaos runs.
"""

from deeplearning4j_tpu_torch.serving.fleet.handoff import (  # noqa: F401
    HandoffError, export_prefix, install_prefix, payload_bytes)
from deeplearning4j_tpu_torch.serving.fleet.replica import (  # noqa: F401
    ReplicaServer)
from deeplearning4j_tpu_torch.serving.fleet.router import (   # noqa: F401
    FleetRouter, ReplicaHandle)
from deeplearning4j_tpu_torch.serving.fleet.launcher import (  # noqa: F401
    ReplicaProcess, launch_replica)
