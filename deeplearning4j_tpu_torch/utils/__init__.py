"""Utilities of the PyTorch port: config serde, the flat parameter view,
time sources, device resolution, sampling and the text-generation
helpers serving uses.

The profiling names of the JAX package's `utils/__init__.py`
(`ProfilerListener`, `peak_flops`, `peak_hbm_bytes`, `peak_ici_bytes`,
`step_flops`, `trace`) wait for `utils/profiling.py` with an H100 peak
table (ROADMAP A8): each resolves to a stand-in that raises naming A8.
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
}
_LAZY = {n: (f"deeplearning4j_tpu_torch.{m}", n)
         for m, names in _EXPORTS.items() for n in names}

WAITING = {name: "A8" for name in (
    "ProfilerListener", "peak_flops", "peak_hbm_bytes", "peak_ici_bytes",
    "step_flops", "trace")}


def _waiting(name: str, item: str):
    def refuse(*args, **kwargs):
        from deeplearning4j_tpu_torch.models.multilayer import _refuse

        _refuse(f"utils.{name} (profiling)", item)

    refuse.__name__ = name
    refuse.__qualname__ = name
    refuse.__doc__ = f"Not ported yet (ROADMAP.md {item}): raises."
    return refuse


_resolve = _lazy_getattr(__name__, _LAZY)


def __getattr__(name):
    """A name of `_LAZY` resolves at first use (`_lazy_getattr`); a name
    waiting for its ROADMAP item resolves to a function that raises
    naming it."""
    if name in WAITING:
        value = _waiting(name, WAITING[name])
        globals()[name] = value
        return value
    return _resolve(name)

__all__ = list(_LAZY) + list(WAITING)
