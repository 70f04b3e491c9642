"""Kernels of the PyTorch port (CUDA sources in `csrc/`) and their
dispatch policies. The JAX package's `ops/__init__.py` names resolve
here lazily, so importing the package builds no kernel; its TPU-only
`banded_eligible` and `fused_update_available` (the Pallas kernels'
TPU-backend checks) have no counterpart: the port's dispatch policies
live in `ops/kernel_defaults.py`. `ops.banded_attention` is the kernel
module of that name, as each kernel's module is here (its launch counts
are read through it); the function is
`ops.banded_attention.banded_attention`."""

from deeplearning4j_tpu_torch import _lazy_getattr

_EXPORTS = {
    "ops.lstm": (
        "fused_lstm", "fused_lstm_available",
    ),
    "ops.attention": (
        "flash_attention",
    ),
    "ops.banded_attention": (
        "banded_decode_attention", "decode_eligible",
    ),
    "ops.fused_update": (
        "adam_update", "nesterov_update",
    ),
}
_LAZY = {n: (f"deeplearning4j_tpu_torch.{m}", n)
         for m, names in _EXPORTS.items() for n in names}


__getattr__ = _lazy_getattr(__name__, _LAZY)

__all__ = list(_LAZY)
