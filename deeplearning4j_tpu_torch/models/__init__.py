"""Model runtimes of the PyTorch port, the conv+BN fusion pass
(`models/fusion.py`) and transfer learning (`models/transfer.py`)."""

from deeplearning4j_tpu_torch.models.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.models.fusion import fuse_conv_bn
from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork

__all__ = ["ComputationGraph", "MultiLayerNetwork", "fuse_conv_bn"]
