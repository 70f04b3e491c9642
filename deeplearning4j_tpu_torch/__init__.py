"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

The port mirrors the JAX package's module paths (`nn/layers/attention.py`
here is the counterpart of `deeplearning4j_tpu/nn/layers/attention.py`)
and keeps its parameter names and layouts, so a JAX `params_tree` loads
unchanged through `models.convert.params_from_numpy`. It imports torch
and never jax: every Pallas kernel on a ported path is a hand-written
CUDA kernel for Hopper (`csrc/`), built at first use into `_build/`.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; with no GPU and no explicit CPU request they raise.

The package exports the JAX package's top-level names (`InputType`,
`NeuralNetConfiguration`, `MultiLayerNetwork`, `save_model`, ...), and
each subpackage its JAX counterpart's `__all__`. They resolve lazily at
first use, so `import deeplearning4j_tpu_torch` imports no model module
and builds no kernel.

Slice 1 covers decode serving of the zoo transformer: the config DSL,
the layers a `TextGenerationTransformer` uses, the per-slot decode path
with the slot and paged decode-attention kernels (B5, B6), and the
session manager over the continuous-batching scheduler. Slice 2 trains
the same model: losses, updaters, schedules, listeners, the fit loop
and data iterators, with flash attention forward and backward (B3a,
B3b, B3c) and the fused multi-tensor Adam (B1a). Later slices add the
recurrent family, sliding-window attention, quantized KV caches and
ResNet-50 with fused conv+BN; slice 13 the CNN zoo (LeNet, SimpleCNN,
VGG), the canned datasets, evaluation (`eval/`, `predict` and
`evaluate*` on both runtimes), model files both packages read
(`models/serialize.py`), gradient checks and early stopping; slice 21
the rest of the CNN family (AlexNet, the Inception zoo), Keras import,
transfer learning, pretrained loading and the DL4J zip container.
"""

__version__ = "0.1.0"

_LAZY = {
    "InputType": ("deeplearning4j_tpu_torch.nn.inputs", "InputType"),
    "Activation": ("deeplearning4j_tpu_torch.nn.activations", "Activation"),
    "LossFunction": ("deeplearning4j_tpu_torch.nn.losses", "LossFunction"),
    "WeightInit": ("deeplearning4j_tpu_torch.nn.initializers", "WeightInit"),
    "NeuralNetConfiguration": ("deeplearning4j_tpu_torch.nn.config",
                               "NeuralNetConfiguration"),
    "MultiLayerNetwork": ("deeplearning4j_tpu_torch.models",
                          "MultiLayerNetwork"),
    "ComputationGraph": ("deeplearning4j_tpu_torch.models",
                         "ComputationGraph"),
    "Evaluation": ("deeplearning4j_tpu_torch.eval", "Evaluation"),
    "save_model": ("deeplearning4j_tpu_torch.models.serialize", "save_model"),
    "load_model": ("deeplearning4j_tpu_torch.models.serialize", "load_model"),
}



def _lazy_getattr(module_name: str, table: dict):
    """A module `__getattr__` resolving the names of `table` (name ->
    (module, attribute)) at first use and caching each in the module, so
    importing a package imports none of the modules behind its names.
    Every subpackage that re-exports names uses it."""
    def __getattr__(name):
        if name not in table:
            raise AttributeError(f"module {module_name!r} has no attribute "
                                 f"{name!r}")
        import importlib
        import sys

        mod, attr = table[name]
        value = getattr(importlib.import_module(mod), attr)
        setattr(sys.modules[module_name], name, value)
        return value
    return __getattr__


__getattr__ = _lazy_getattr(__name__, _LAZY)

__all__ = list(_LAZY) + ["__version__"]
