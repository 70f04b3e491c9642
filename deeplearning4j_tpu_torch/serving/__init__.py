"""Serving of the PyTorch port: the HTTP front (`InferenceServer`), the
control plane (registry with hot-swap, scheduler, metrics) and stateful
decode sessions over the KV slot pool, speculative decoding included.

`KerasGatewayServer` imports, fits and serves Keras models over HTTP.
The fleet (`serving/fleet/`: replicas, the router, the KV handoff) is a
tier above one server. `NearestNeighborsServer` answers k-NN queries
over a VP-tree.
"""

from deeplearning4j_tpu_torch.serving.http_base import (
    HttpError, JsonHttpServer, StreamResponse, TextResponse,
)
from deeplearning4j_tpu_torch.serving.inference_server import (
    InferenceServer, ModelServer,
)
from deeplearning4j_tpu_torch.serving.keras_gateway import KerasGatewayServer
from deeplearning4j_tpu_torch.serving.knn_server import NearestNeighborsServer
from deeplearning4j_tpu_torch.serving.kv_pool import (
    IncompatibleSessionSwapError, KVSlotPool, SlotPoolExhaustedError,
)
from deeplearning4j_tpu_torch.serving.metrics import ServingStats
from deeplearning4j_tpu_torch.serving.prefix_cache import PrefixCache
from deeplearning4j_tpu_torch.serving.registry import (
    DeployRolledBackError, ModelEntry, ModelRegistry,
)
from deeplearning4j_tpu_torch.serving.scheduler import (
    AdmissionPolicy, ContinuousBatchingScheduler, DeadlineExceededError,
    RequestShedError, SchedulerClosedError, WorkerCrashError,
)
from deeplearning4j_tpu_torch.serving.sessions import (
    DecodeSession, DecodeSessionManager,
)

__all__ = [
    "AdmissionPolicy", "ContinuousBatchingScheduler", "DecodeSession",
    "DecodeSessionManager", "DeadlineExceededError",
    "DeployRolledBackError", "HttpError", "IncompatibleSessionSwapError",
    "InferenceServer", "JsonHttpServer", "KerasGatewayServer", "KVSlotPool",
    "ModelEntry",
    "ModelRegistry", "ModelServer", "NearestNeighborsServer", "PrefixCache",
    "RequestShedError",
    "SchedulerClosedError", "ServingStats", "SlotPoolExhaustedError",
    "StreamResponse", "TextResponse", "WorkerCrashError",
]
