"""Utilities of the PyTorch port: config serde, the flat parameter view,
time sources, device resolution, sampling, the text-generation helpers
serving uses, and profiling (`utils/profiling.py`: the card's peak table,
a train step's flop count, `torch.profiler` traces and
`ProfilerListener`).
"""

from deeplearning4j_tpu_torch import _lazy_getattr

_EXPORTS = {
    "utils.serde": (
        "register_serde", "to_json", "from_json", "config_to_dict",
        "config_from_dict",
    ),
    "utils.pytrees": (
        "flatten_params", "unflatten_params", "param_count", "tree_norm",
    ),
    "utils.timesource": (
        "TimeSource", "SystemClockTimeSource", "NTPTimeSource",
        "TimeSourceProvider",
    ),
    "utils.profiling": (
        "ProfilerListener", "peak_flops", "peak_hbm_bytes",
        "peak_ici_bytes", "step_flops", "trace",
    ),
}
_LAZY = {n: (f"deeplearning4j_tpu_torch.{m}", n)
         for m, names in _EXPORTS.items() for n in names}

__getattr__ = _lazy_getattr(__name__, _LAZY)

__all__ = list(_LAZY)
