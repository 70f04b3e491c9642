"""Optimization of the PyTorch port: schedules, updaters, listeners, the
full-batch solvers and the fit-loop executor (the names of the JAX
package's `optim/__init__.py`)."""

from deeplearning4j_tpu_torch import _lazy_getattr

_EXPORTS = {
    "optim.solvers": (
        "Solver", "backtrack_line_search", "minimize_cg", "minimize_gd",
        "minimize_lbfgs",
    ),
    "optim.executor": (
        "LossTracker", "TrainingExecutor",
    ),
    "optim.updaters": (
        "Updater", "Sgd", "Adam", "AdaMax", "Nadam", "AMSGrad", "Nesterovs",
        "AdaGrad", "AdaDelta", "RmsProp", "NoOp",
    ),
    "optim.schedules": (
        "Schedule", "FixedSchedule", "StepSchedule", "ExponentialSchedule",
        "InverseSchedule", "PolySchedule", "SigmoidSchedule", "MapSchedule",
        "WarmupCosineSchedule",
    ),
}
_LAZY = {n: (f"deeplearning4j_tpu_torch.{m}", n)
         for m, names in _EXPORTS.items() for n in names}


__getattr__ = _lazy_getattr(__name__, _LAZY)

__all__ = list(_LAZY)
