"""Config DSL and layers of the PyTorch port (port of
`deeplearning4j_tpu/nn/`)."""

from deeplearning4j_tpu_torch import _lazy_getattr

_LAZY = {
    "InputType": ("deeplearning4j_tpu_torch.nn.inputs", "InputType"),
    "Activation": ("deeplearning4j_tpu_torch.nn.activations", "Activation"),
    "LossFunction": ("deeplearning4j_tpu_torch.nn.losses", "LossFunction"),
    "WeightInit": ("deeplearning4j_tpu_torch.nn.initializers", "WeightInit"),
}


__getattr__ = _lazy_getattr(__name__, _LAZY)

__all__ = list(_LAZY)
