"""ROC metrics (the port's own copy of ``deeplearning4j_tpu/eval/roc.py``,
host numpy).

Equivalents of the reference's ``eval/ROC.java`` (296 LoC;
threshold-stepped ROC curve with ``thresholdSteps``, AUC via trapezoidal
integration) and ``eval/ROCMultiClass.java`` (one-vs-all per class).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class ROC:
    """Binary ROC (reference ``eval/ROC.java``).

    ``threshold_steps`` thresholds in [0,1] (the reference's stepped
    accumulation — exact AUC over raw scores is a later-reference feature).
    Labels: (batch,) or (batch, 1) binary, or (batch, 2) one-hot where
    column 1 is the positive class (reference convention).
    """

    def __init__(self, threshold_steps: int = 30):
        if threshold_steps < 1:
            # 0 steps = a single threshold = a degenerate one-point curve
            # whose trapezoid "AUC" is silently 0.5 for ANY scores
            raise ValueError("threshold_steps must be >= 1")
        self.threshold_steps = threshold_steps
        t = np.linspace(0.0, 1.0, threshold_steps + 1)
        self.thresholds = t
        self.tp = np.zeros(threshold_steps + 1, np.int64)
        self.fp = np.zeros(threshold_steps + 1, np.int64)
        self.fn = np.zeros(threshold_steps + 1, np.int64)
        self.tn = np.zeros(threshold_steps + 1, np.int64)

    @staticmethod
    def _positive_scores(labels, predictions) -> Tuple[np.ndarray, np.ndarray]:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 2 and labels.shape[1] == 2:
            y = labels[:, 1]
            p = predictions[:, 1]
        elif labels.ndim == 2 and labels.shape[1] > 2:
            # the reference ROC throws for >2 label columns; silently
            # flattening a multi-class one-hot would fabricate an AUC
            raise ValueError(
                f"ROC is binary; got {labels.shape[1]} label columns — "
                f"use ROCMultiClass")
        else:
            y = labels.reshape(-1)
            p = predictions.reshape(-1)
        return y, p

    def eval(self, labels, predictions) -> None:
        y, p = self._positive_scores(labels, predictions)
        pos = y > 0.5
        for i, t in enumerate(self.thresholds):
            pred_pos = p >= t
            self.tp[i] += int(np.sum(pred_pos & pos))
            self.fp[i] += int(np.sum(pred_pos & ~pos))
            self.fn[i] += int(np.sum(~pred_pos & pos))
            self.tn[i] += int(np.sum(~pred_pos & ~pos))

    def eval_time_series(self, labels, predictions, mask=None) -> None:
        """(batch, time, classes) evaluation with per-step masking
        (reference ``BaseEvaluation.evalTimeSeries``)."""
        from .evaluation import flatten_time_series
        self.eval(*flatten_time_series(labels, predictions, mask))

    def merge(self, other: "ROC") -> "ROC":
        """Fold another ROC's threshold counts into this one (reference
        ``IEvaluation.merge``)."""
        if self.threshold_steps != other.threshold_steps:
            raise ValueError("Cannot merge ROCs with different "
                             "threshold_steps")
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        self.tn += other.tn
        return self

    def get_roc_curve(self) -> List[Tuple[float, float, float]]:
        """[(threshold, fpr, tpr)] (reference ``getResults``)."""
        out = []
        for i, t in enumerate(self.thresholds):
            tpr = self.tp[i] / max(self.tp[i] + self.fn[i], 1)
            fpr = self.fp[i] / max(self.fp[i] + self.tn[i], 1)
            out.append((float(t), float(fpr), float(tpr)))
        return out

    def get_precision_recall_curve(self) -> List[Tuple[float, float, float]]:
        out = []
        for i, t in enumerate(self.thresholds):
            prec = self.tp[i] / max(self.tp[i] + self.fp[i], 1)
            rec = self.tp[i] / max(self.tp[i] + self.fn[i], 1)
            out.append((float(t), float(prec), float(rec)))
        return out

    def calculate_auc(self) -> float:
        """Trapezoidal AUC over the stepped curve (reference
        ``calculateAUC``)."""
        pts = sorted((fpr, tpr) for _, fpr, tpr in self.get_roc_curve())
        xs = np.array([p[0] for p in pts])
        ys = np.array([p[1] for p in pts])
        # ensure curve spans [0,1]
        if xs[0] > 0:
            xs = np.concatenate([[0.0], xs])
            ys = np.concatenate([[0.0], ys])
        if xs[-1] < 1:
            xs = np.concatenate([xs, [1.0]])
            ys = np.concatenate([ys, [1.0]])
        return float(np.trapezoid(ys, xs))


class ROCMultiClass:
    """One-vs-all ROC per class (reference ``eval/ROCMultiClass.java``)."""

    def __init__(self, threshold_steps: int = 30):
        if threshold_steps < 1:
            # fail at the constructor, not mid-training on first eval()
            raise ValueError("threshold_steps must be >= 1")
        self.threshold_steps = threshold_steps
        self.per_class: Dict[int, ROC] = {}

    def eval(self, labels, predictions) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        n_classes = labels.shape[1]
        for c in range(n_classes):
            roc = self.per_class.setdefault(c, ROC(self.threshold_steps))
            roc.eval(labels[:, c], predictions[:, c])

    eval_time_series = ROC.eval_time_series

    def merge(self, other: "ROCMultiClass") -> "ROCMultiClass":
        """Fold per-class counts (reference ``IEvaluation.merge``)."""
        for c, roc in other.per_class.items():
            mine = self.per_class.setdefault(c, ROC(self.threshold_steps))
            mine.merge(roc)
        return self

    def get_roc_curve(self, cls: int):
        return self.per_class[cls].get_roc_curve()

    def calculate_auc(self, cls: int) -> float:
        return self.per_class[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        if not self.per_class:
            return float("nan")
        return float(np.mean([r.calculate_auc()
                              for r in self.per_class.values()]))
