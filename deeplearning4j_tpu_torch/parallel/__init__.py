"""Parallelism of the PyTorch port (the counterpart of
`deeplearning4j_tpu/parallel/`).

A rank is a process on one device; the mesh is a `DeviceMesh` over the
default process group (`mesh.py`), and every collective goes through
`distributed.py`'s wrappers into commsmon's ledger. Ported: the mesh
and the sharding spine, `ParallelWrapper` (data parallelism with
replica-sharded moments and FSDP rules), sharded checkpoints with exact
resume, elastic preemption, the chaos injectors, the threshold-coded
gradient exchange, and the one-card bucketed batch runner behind the
serving registry (`inference.ParallelInference`).

Not ported yet (ROADMAP A6, its second part): tensor-parallel rules'
application, ring attention, pipeline and expert parallelism, the
asynchronous parameter server, the training masters and the estimator.
Their names resolve to functions that raise naming the item.
"""

from deeplearning4j_tpu_torch.parallel.mesh import (
    MeshContext, MeshSpec, current_mesh_context, device_count,
    local_device_count, make_mesh, set_mesh_context, use_mesh_context,
)
from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.sharding import (
    ShardingRules, batch_sharding, fsdp_rules, replicate, shard_params,
    tensor_parallel_rules,
)
from deeplearning4j_tpu_torch.parallel.inference import (
    InferenceMode, ParallelInference,
)
from deeplearning4j_tpu_torch.parallel.distributed import (
    initialize_distributed,
)
from deeplearning4j_tpu_torch.parallel.checkpoint import ShardedCheckpointer
from deeplearning4j_tpu_torch.parallel.elastic import (
    ElasticTrainer, PreemptionHandler,
)
from deeplearning4j_tpu_torch.parallel.chaos import (
    CheckpointIOFault, FailingIterator, InjectedFault, SigtermAtStep,
    StallingIterator,
)

# names of the JAX package's `parallel` that wait for A6's second part
WAITING = {name: "A6" for name in (
    "AsyncParameterServer", "AsyncTrainer",
    "PipelineParallel", "PipelinedNetwork", "make_pipeline_fn",
    "make_pipeline_1f1b_fn", "partition_for_pipeline", "stack_stage_params",
    "split_microbatches",
    "MoEFeedForward", "moe_ffn", "top_k_gating", "expert_sharding",
    "expert_mesh",
    "TrainingMaster", "ParameterAveragingTrainingMaster",
    "DistributedTrainingMaster", "PhaseStats", "NetworkEstimator",
    "distributed_evaluate", "export_timeline_html")}


def _waiting(name: str, item: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"parallel.{name} is not ported yet (ROADMAP.md {item}, its "
            f"second part); the port refuses it rather than ignore it")

    refuse.__name__ = name
    refuse.__qualname__ = name
    refuse.__doc__ = f"Not ported yet (ROADMAP.md {item}): raises."
    return refuse


def __getattr__(name):
    """A name waiting for A6's second part resolves to a function that
    raises naming it."""
    if name in WAITING:
        value = _waiting(name, WAITING[name])
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ShardedCheckpointer", "ElasticTrainer", "PreemptionHandler",
    "CheckpointIOFault", "FailingIterator", "InjectedFault", "SigtermAtStep",
    "StallingIterator",
    "MeshContext", "MeshSpec", "current_mesh_context", "set_mesh_context",
    "use_mesh_context",
    "make_mesh", "device_count", "local_device_count",
    "ParallelWrapper", "ParallelInference", "InferenceMode",
    "ShardingRules", "shard_params", "replicate", "batch_sharding",
    "fsdp_rules", "tensor_parallel_rules", "initialize_distributed",
] + list(WAITING)
