"""Early-stopping configuration and result (the port's own copy of
``deeplearning4j_tpu/earlystopping/config.py``).

Reference: ``earlystopping/EarlyStoppingConfiguration.java`` (builder with
epoch/iteration termination conditions, score calculator, model saver,
``evaluateEveryNEpochs``) and ``EarlyStoppingResult.java`` (termination
reason/details, scores per epoch, best model).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class EarlyStoppingConfiguration:
    epoch_termination_conditions: List[Any] = dataclasses.field(
        default_factory=list)
    iteration_termination_conditions: List[Any] = dataclasses.field(
        default_factory=list)
    score_calculator: Optional[Any] = None
    model_saver: Optional[Any] = None
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False

    class Builder:
        def __init__(self):
            self._c = EarlyStoppingConfiguration()

        def epoch_termination_conditions(self, *conds) -> (
                "EarlyStoppingConfiguration.Builder"):
            self._c.epoch_termination_conditions.extend(conds)
            return self

        def iteration_termination_conditions(self, *conds) -> (
                "EarlyStoppingConfiguration.Builder"):
            self._c.iteration_termination_conditions.extend(conds)
            return self

        def score_calculator(self, calc) -> (
                "EarlyStoppingConfiguration.Builder"):
            self._c.score_calculator = calc
            return self

        def model_saver(self, saver) -> "EarlyStoppingConfiguration.Builder":
            self._c.model_saver = saver
            return self

        def evaluate_every_n_epochs(self, n: int) -> (
                "EarlyStoppingConfiguration.Builder"):
            self._c.evaluate_every_n_epochs = int(n)
            return self

        def save_last_model(self, flag: bool = True) -> (
                "EarlyStoppingConfiguration.Builder"):
            self._c.save_last_model = flag
            return self

        def build(self) -> "EarlyStoppingConfiguration":
            return self._c

    @staticmethod
    def builder() -> "EarlyStoppingConfiguration.Builder":
        return EarlyStoppingConfiguration.Builder()


@dataclasses.dataclass
class EarlyStoppingResult:
    """Reference ``EarlyStoppingResult``: why training stopped + best model."""

    termination_reason: str = ""           # EpochTerminationCondition etc.
    termination_details: str = ""
    score_vs_epoch: Dict[int, float] = dataclasses.field(default_factory=dict)
    best_model_epoch: int = -1
    best_model_score: float = float("inf")
    total_epochs: int = 0
    best_model: Optional[Any] = None
