"""Early stopping: configuration, termination conditions, savers, trainer
(port of `deeplearning4j_tpu/earlystopping.py`).

Reference parity: `earlystopping/EarlyStoppingConfiguration.java`,
`trainer/BaseEarlyStoppingTrainer.java:52-87`, `termination/`
(InvalidScoreIterationTerminationCondition = NaN guard,
MaxTimeIterationTerminationCondition, ...), `saver/` (InMemory,
LocalFile).

The trainer runs the net's own train step (`_fit_batch`) batch by batch
and reads each step's loss on the host, since the iteration conditions
inspect every score: one host sync a step. The parallel trainer runs
each batch as one `ParallelWrapper` step.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.optim.updaters import tree_map


# ---------------------------------------------------------------- conditions
class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def terminate(self, iteration: int, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    """Reference: termination/MaxEpochsTerminationCondition."""

    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs without improvement. Reference:
    termination/ScoreImprovementEpochTerminationCondition."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self._best = math.inf
        self._since = 0

    def terminate(self, epoch, score):
        if score < self._best - self.min_improvement:
            self._best = score
            self._since = 0
        else:
            self._since += 1
        return self._since > self.patience


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once score ≤ target. Reference:
    BestScoreEpochTerminationCondition."""

    def __init__(self, target: float):
        self.target = target

    def terminate(self, epoch, score):
        return score <= self.target


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    """Reference: termination/MaxTimeIterationTerminationCondition."""

    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def terminate(self, iteration, score):
        if self._start is None:
            self._start = time.monotonic()
        return (time.monotonic() - self._start) > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort if score exceeds a bound (divergence guard). Reference:
    termination/MaxScoreIterationTerminationCondition."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, iteration, score):
        return score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """NaN/Inf abort. Reference:
    termination/InvalidScoreIterationTerminationCondition."""

    def terminate(self, iteration, score):
        return not np.isfinite(score)


# ---------------------------------------------------------------- savers
class EarlyStoppingModelSaver:
    def save_best(self, net) -> None:
        raise NotImplementedError

    def save_latest(self, net) -> None:
        pass

    def get_best(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    """Reference: saver/InMemoryModelSaver — copies of the params and
    state trees on the net's device; `get_best` builds a new net of the
    same class and configuration holding them."""

    def __init__(self):
        self._net = None
        self._best_params = None
        self._best_state = None

    def save_best(self, net):
        self._net = net
        self._best_params = tree_map(lambda t: t.detach().clone(),
                                     net.params_tree)
        self._best_state = tree_map(lambda t: t.detach().clone(),
                                    net.state_tree)

    def get_best(self):
        net = type(self._net)(self._net.conf, device=self._net.device).init()
        net.params_tree = tree_map(lambda t: t.clone(), self._best_params)
        net.state_tree = tree_map(lambda t: t.clone(), self._best_state)
        return net


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """Reference: saver/LocalFileModelSaver — bestModel.zip /
    latestModel.zip in the JAX package's model-file format
    (`models/serialize.py`); `get_best` loads onto the saved net's
    device."""

    def __init__(self, directory: str):
        self.directory = directory
        self._device = None
        os.makedirs(directory, exist_ok=True)

    def save_best(self, net):
        from deeplearning4j_tpu_torch.models.serialize import save_model

        self._device = net.device
        save_model(net, os.path.join(self.directory, "bestModel.zip"))

    def save_latest(self, net):
        from deeplearning4j_tpu_torch.models.serialize import save_model

        save_model(net, os.path.join(self.directory, "latestModel.zip"))

    def get_best(self):
        from deeplearning4j_tpu_torch.models.serialize import load_model

        return load_model(os.path.join(self.directory, "bestModel.zip"),
                          device=self._device)


# ---------------------------------------------------------------- calculators
class ScoreCalculator:
    def calculate_score(self, net) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Held-out loss. Reference: scorecalc/DataSetLossCalculator."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total, n = 0.0, 0
        for ds in self.iterator:
            total += net.score(ds) * ds.num_examples()
            n += ds.num_examples()
        return total / n if (self.average and n) else total


# ---------------------------------------------------------------- config
@dataclasses.dataclass
class EarlyStoppingConfiguration:
    """Reference: earlystopping/EarlyStoppingConfiguration (Builder)."""

    score_calculator: Optional[ScoreCalculator] = None
    model_saver: EarlyStoppingModelSaver = dataclasses.field(
        default_factory=InMemoryModelSaver)
    epoch_termination_conditions: List[EpochTerminationCondition] = \
        dataclasses.field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = \
        dataclasses.field(default_factory=list)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclasses.dataclass
class EarlyStoppingResult:
    """Reference: earlystopping/EarlyStoppingResult."""

    termination_reason: str
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: Any


class EarlyStoppingTrainer:
    """Fit loop with termination and saving hooks. Reference:
    `trainer/BaseEarlyStoppingTrainer.java:52-87`."""

    def __init__(self, config: EarlyStoppingConfiguration, net,
                 train_iterator):
        self.config = config
        self.net = net
        self.iterator = train_iterator

    def _fit_batch(self, ds) -> float:
        """One train step; its loss read on the host (the iteration
        conditions inspect every score)."""
        return float(self.net._fit_batch(ds))

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        self.net._check_init()
        self.net._start_steps()
        best_score = math.inf
        best_epoch = -1
        scores = {}
        epoch = 0
        reason, details = "MaxEpochs", "no termination condition fired"

        while True:
            terminated = False
            for ds in self.iterator:
                score = self._fit_batch(ds)
                self.net.iteration += 1
                for cond in cfg.iteration_termination_conditions:
                    if cond.terminate(self.net.iteration, score):
                        reason = "IterationTermination"
                        details = (f"{type(cond).__name__} at iteration "
                                   f"{self.net.iteration}")
                        terminated = True
                        break
                if terminated:
                    break
            if terminated:
                break

            if epoch % cfg.evaluate_every_n_epochs == 0:
                if cfg.score_calculator is not None:
                    s = cfg.score_calculator.calculate_score(self.net)
                else:
                    s = (self.net.score_ if self.net.score_ is not None
                         else math.inf)
                scores[epoch] = s
                if s < best_score:
                    best_score = s
                    best_epoch = epoch
                    cfg.model_saver.save_best(self.net)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest(self.net)
                fired = False
                for cond in cfg.epoch_termination_conditions:
                    if cond.terminate(epoch, s):
                        reason = "EpochTermination"
                        details = f"{type(cond).__name__} at epoch {epoch}"
                        fired = True
                        break
                if fired:
                    break
            epoch += 1

        if best_epoch < 0:  # never evaluated — save final state as best
            cfg.model_saver.save_best(self.net)
            best_epoch = epoch
            best_score = self.net.score_ or math.inf

        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            total_epochs=epoch + 1,
            best_model_epoch=best_epoch,
            best_model_score=best_score,
            score_vs_epoch=scores,
            best_model=cfg.model_saver.get_best(),
        )


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping over data-parallel ranks. Reference:
    `parallelism/EarlyStoppingParallelTrainer.java` — early stopping
    wrapped around ParallelWrapper: each batch is one data-parallel step
    (the global batch padded, this rank's rows, the gradients
    all-reduced), with the same termination and saving hooks."""

    def __init__(self, config: EarlyStoppingConfiguration, net,
                 train_iterator, *, mesh=None, param_rules=None):
        super().__init__(config, net, train_iterator)
        from deeplearning4j_tpu_torch.parallel.data_parallel import (
            ParallelWrapper,
        )

        self._pw = ParallelWrapper(net, mesh=mesh, param_rules=param_rules,
                                   prefetch_buffer=0)

    def _fit_batch(self, ds) -> float:
        score = float(self._pw._step(ds))
        self.net._loss_tracker.set(score)
        return score
