"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

The port mirrors the JAX package's module paths (`nn/layers/attention.py`
here is the counterpart of `deeplearning4j_tpu/nn/layers/attention.py`)
and keeps its parameter names and layouts, so a JAX `params_tree` loads
unchanged through `models.convert.params_from_numpy`. It imports torch
and never jax: every Pallas kernel on a ported path is a hand-written
CUDA kernel for Hopper (`csrc/`), built at first use into `_build/`.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; with no GPU and no explicit CPU request they raise.

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
(`models/serialize.py`), gradient checks and early stopping.
"""

__version__ = "0.1.0"
