"""Model runtimes of the PyTorch port."""

from deeplearning4j_tpu_torch.models.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork

__all__ = ["ComputationGraph", "MultiLayerNetwork"]
