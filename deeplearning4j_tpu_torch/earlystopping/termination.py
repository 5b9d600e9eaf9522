"""Termination conditions (the port's own copy of
``deeplearning4j_tpu/earlystopping/termination.py``; reference
``earlystopping/termination/``)."""

from __future__ import annotations

import time


class MaxEpochsTerminationCondition:
    """Stop after N epochs (reference ``MaxEpochsTerminationCondition``)."""

    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        return epoch + 1 >= self.max_epochs

    def __str__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition:
    """Stop when the score hasn't improved for N epochs (reference
    ``ScoreImprovementEpochTerminationCondition``)."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.max_epochs_without_improvement = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best = float("inf")
        self.since = 0

    def initialize(self) -> None:
        self.best = float("inf")
        self.since = 0

    def terminate(self, epoch: int, score: float) -> bool:
        if score < self.best - self.min_improvement:
            self.best = score
            self.since = 0
            return False
        self.since += 1
        return self.since > self.max_epochs_without_improvement

    def __str__(self):
        return ("ScoreImprovementEpochTerminationCondition("
                f"{self.max_epochs_without_improvement}, "
                f"{self.min_improvement})")


class BestScoreEpochTerminationCondition:
    """Stop once score <= target (reference
    ``BestScoreEpochTerminationCondition``)."""

    def __init__(self, best_expected_score: float):
        self.best_expected_score = best_expected_score

    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        return score <= self.best_expected_score

    def __str__(self):
        return f"BestScoreEpochTerminationCondition({self.best_expected_score})"


class MaxTimeIterationTerminationCondition:
    """Stop after a wall-clock budget (reference
    ``MaxTimeIterationTerminationCondition``)."""

    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def initialize(self) -> None:
        self._start = time.monotonic()

    def terminate(self, iteration: int, score: float) -> bool:
        return (time.monotonic() - self._start) >= self.max_seconds

    def __str__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition:
    """Stop if score exceeds a bound — divergence guard (reference
    ``MaxScoreIterationTerminationCondition``)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def initialize(self) -> None:
        pass

    def terminate(self, iteration: int, score: float) -> bool:
        return score > self.max_score or score != score

    def __str__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"
