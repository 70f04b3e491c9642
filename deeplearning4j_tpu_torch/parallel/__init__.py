"""Parallelism of the PyTorch port: so far the one-card bucketed batch
runner behind the serving registry (`inference.ParallelInference`). The
mesh-wide runners (data, tensor, pipeline and expert parallelism) are
not ported yet (ROADMAP A6)."""

from deeplearning4j_tpu_torch.parallel.inference import (
    InferenceMode, ParallelInference,
)

__all__ = ["InferenceMode", "ParallelInference"]
