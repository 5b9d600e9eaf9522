"""Classification evaluation: accuracy/precision/recall/F1/confusion matrix
(the port's own copy of ``deeplearning4j_tpu/eval/evaluation.py``, host
numpy, the same metrics and the same ``stats()`` text).

Equivalent of the reference's ``eval/Evaluation.java`` (``eval(realOutcomes,
guesses):191``, ``stats():352``) and ``eval/ConfusionMatrix.java``.  Batches
accumulate into a numpy confusion matrix; the network forward (and, on the
top-1 path of ``MultiLayerNetwork.do_evaluation``, the argmax) stays on the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Prediction:
    """One recorded prediction with its source-record metadata (reference
    ``eval/meta/Prediction.java``) — only populated when ``eval`` is called
    with ``record_meta_data``."""

    actual: int
    predicted: int
    record_meta_data: object


def flatten_time_series(labels, predictions, mask=None):
    """(batch, time, C) arrays → (kept_steps, C), dropping masked steps
    (the shared ``BaseEvaluation.evalTimeSeries`` reshape used by
    Evaluation, ROC and RegressionEvaluation)."""
    labels = np.asarray(labels)
    predictions = np.asarray(predictions)
    L = labels.reshape(-1, labels.shape[-1])
    P = predictions.reshape(-1, predictions.shape[-1])
    if mask is not None:
        keep = np.asarray(mask).reshape(-1) > 0
        L, P = L[keep], P[keep]
    return L, P


class ConfusionMatrix:
    """Counts actual x predicted (reference ``eval/ConfusionMatrix.java``)."""

    def __init__(self, num_classes: int):
        self.matrix = np.zeros((num_classes, num_classes), np.int64)

    def add(self, actual: int, predicted: int, count: int = 1) -> None:
        self.matrix[actual, predicted] += count

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def actual_total(self, actual: int) -> int:
        return int(self.matrix[actual].sum())

    def predicted_total(self, predicted: int) -> int:
        return int(self.matrix[:, predicted].sum())


class Evaluation:
    """Accumulating classification metrics (reference ``eval/Evaluation.java``).

    ``eval(labels, predictions)`` takes one-hot (or probability) labels and
    network output probabilities of shape (batch, n_classes) — or
    (batch, n_classes, time)-free RNN shapes flattened by the caller.
    """

    def __init__(self, num_classes: Optional[int] = None,
                 label_names: Optional[List[str]] = None, top_n: int = 1):
        self.num_classes = num_classes
        self.label_names = label_names
        self.top_n = top_n
        self.confusion: Optional[ConfusionMatrix] = None
        self._top_n_correct = 0
        self._top_n_total = 0
        # (actual, predicted) -> list of metadata, populated only by the
        # evaluate-with-metadata path (reference confusionMatrixMetaData)
        self._meta: Optional[Dict[tuple, list]] = None

    def _ensure(self, n: int) -> None:
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = ConfusionMatrix(self.num_classes)

    def eval(self, labels, predictions, mask=None,
             record_meta_data: Optional[list] = None) -> None:
        """Accumulate a batch.  ``record_meta_data`` (reference
        ``eval(realOutcomes, guesses, recordMetaData):204``): one opaque
        metadata object per example, enabling the ``get_prediction*``
        listings; 2-D batches only."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            if record_meta_data is not None:
                raise ValueError(
                    "record_meta_data applies to (batch, classes) "
                    "evaluation, not time series")
            # RNN (batch, time, classes) -> flatten time-major
            labels, predictions = flatten_time_series(labels, predictions,
                                                      mask)
        # validate before any accumulation: a raised batch must leave the
        # counters untouched so the caller can retry it
        if record_meta_data is not None \
                and len(record_meta_data) != labels.shape[0]:
            raise ValueError(
                f"{len(record_meta_data)} metadata entries for "
                f"{labels.shape[0]} examples")
        self._ensure(labels.shape[-1])
        actual = labels.argmax(-1)
        guess = predictions.argmax(-1)
        np.add.at(self.confusion.matrix, (actual, guess), 1)
        if self.top_n > 1:
            # correct at top-N iff < N probabilities exceed the actual
            # class's probability (reference eval():300)
            p_actual = np.take_along_axis(
                predictions, actual[:, None], axis=-1)
            greater = (predictions > p_actual).sum(-1)
            self._top_n_correct += int((greater < self.top_n).sum())
            self._top_n_total += len(actual)
        if record_meta_data is not None:
            if self._meta is None:
                self._meta = {}
            for a, g, m in zip(actual, guess, record_meta_data):
                self._meta.setdefault((int(a), int(g)), []).append(m)

    def eval_time_series(self, labels, predictions, mask=None) -> None:
        self.eval(labels, predictions, mask)

    def eval_class_indices(self, actual, predicted, num_classes: int) -> None:
        """Accumulate a batch from precomputed class indices — the
        device-side argmax fast path (``do_evaluation`` transfers int32
        class indices instead of full logit matrices).  Only valid for
        top_n == 1: index streams cannot recover top-N membership."""
        if self.top_n > 1:
            raise ValueError(
                "class-index evaluation cannot compute top-N accuracy "
                f"(top_n={self.top_n}); use eval() with full predictions")
        self._ensure(num_classes)
        actual = np.asarray(actual).reshape(-1)
        predicted = np.asarray(predicted).reshape(-1)
        np.add.at(self.confusion.matrix, (actual, predicted), 1)

    def merge(self, other: "Evaluation") -> "Evaluation":
        """Fold another evaluation's counts into this one (reference
        ``IEvaluation.merge`` — the Spark distributed-eval aggregation)."""
        if other.confusion is None:
            return self
        if self.confusion is None:
            self.num_classes = other.num_classes
            self.confusion = ConfusionMatrix(other.num_classes)
        elif self.num_classes != other.num_classes:
            raise ValueError(
                f"Cannot merge evaluations with {self.num_classes} vs "
                f"{other.num_classes} classes")
        if self.top_n != other.top_n:
            raise ValueError(
                f"Cannot merge evaluations with top_n={self.top_n} vs "
                f"top_n={other.top_n}")
        self.confusion.matrix += other.confusion.matrix
        self._top_n_correct += other._top_n_correct
        self._top_n_total += other._top_n_total
        if other._meta:
            if self._meta is None:
                self._meta = {}
            for k, v in other._meta.items():
                self._meta.setdefault(k, []).extend(v)
        return self

    # ---- metrics (reference accuracy()/precision()/recall()/f1()) --------
    def accuracy(self) -> float:
        m = self.confusion.matrix
        total = m.sum()
        return float(np.trace(m) / total) if total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            tp = self.confusion.get_count(cls, cls)
            denom = self.confusion.predicted_total(cls)
            return tp / denom if denom else 0.0
        vals = [self.precision(c) for c in range(self.num_classes)
                if self.confusion.actual_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            tp = self.confusion.get_count(cls, cls)
            denom = self.confusion.actual_total(cls)
            return tp / denom if denom else 0.0
        vals = [self.recall(c) for c in range(self.num_classes)
                if self.confusion.actual_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls: Optional[int] = None) -> float:
        if cls is None:
            vals = [self.false_positive_rate(c)
                    for c in range(self.num_classes)
                    if self.confusion.matrix.sum()
                    - self.confusion.actual_total(c) > 0]
            return float(np.mean(vals)) if vals else 0.0
        fp = self.confusion.predicted_total(cls) - self.confusion.get_count(
            cls, cls)
        negatives = self.confusion.matrix.sum() - self.confusion.actual_total(
            cls)
        return fp / negatives if negatives else 0.0

    def false_negative_rate(self, cls: Optional[int] = None) -> float:
        """fn / (fn + tp), macro-averaged over classes with data when no
        class is given (reference ``falseNegativeRate:571-615``)."""
        if cls is None:
            vals = [self.false_negative_rate(c)
                    for c in range(self.num_classes)
                    if self.confusion.actual_total(c) > 0]
            return float(np.mean(vals)) if vals else 0.0
        denom = self.confusion.actual_total(cls)
        fn = denom - self.confusion.get_count(cls, cls)
        return fn / denom if denom else 0.0

    def false_alarm_rate(self) -> float:
        """(macro FPR + macro FNR) / 2 (reference ``falseAlarmRate:619``)."""
        return (self.false_positive_rate() + self.false_negative_rate()) / 2.0

    def top_n_accuracy(self) -> float:
        """Fraction of examples whose actual class was in the N most
        probable outputs; == accuracy() for top_n=1 (reference
        ``topNAccuracy:674``)."""
        if self.top_n <= 1:
            return self.accuracy()
        return (self._top_n_correct / self._top_n_total
                if self._top_n_total else 0.0)

    # ---- metadata prediction listings (reference :963-1050) --------------
    def get_prediction_errors(self) -> Optional[List[Prediction]]:
        """Misclassified predictions with their record metadata, sorted by
        (actual, predicted); None unless eval ran with record_meta_data."""
        if self._meta is None:
            return None
        return [Prediction(a, g, m)
                for (a, g) in sorted(self._meta)
                if a != g
                for m in self._meta[(a, g)]]

    def get_predictions_by_actual_class(self, actual: int
                                        ) -> Optional[List[Prediction]]:
        if self._meta is None:
            return None
        return [Prediction(a, g, m)
                for (a, g) in sorted(self._meta) if a == actual
                for m in self._meta[(a, g)]]

    def get_predictions_by_predicted_class(self, predicted: int
                                           ) -> Optional[List[Prediction]]:
        if self._meta is None:
            return None
        return [Prediction(a, g, m)
                for (a, g) in sorted(self._meta) if g == predicted
                for m in self._meta[(a, g)]]

    def get_predictions(self, actual: int, predicted: int
                        ) -> Optional[List[Prediction]]:
        if self._meta is None:
            return None
        return [Prediction(actual, predicted, m)
                for m in self._meta.get((actual, predicted), [])]

    def stats(self) -> str:
        """Pretty-printed summary (reference ``stats():352``)."""
        lines = ["", "========================Evaluation Metrics========================",
                 f" # of classes:  {self.num_classes}",
                 f" Accuracy:      {self.accuracy():.4f}",
                 f" Precision:     {self.precision():.4f}",
                 f" Recall:        {self.recall():.4f}",
                 f" F1 Score:      {self.f1():.4f}",
                 *([f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}"]
                   if self.top_n > 1 else []),
                 "", "=========================Confusion Matrix========================="]
        m = self.confusion.matrix
        header = "     " + " ".join(f"{j:5d}" for j in range(self.num_classes))
        lines.append(header)
        for i in range(self.num_classes):
            name = (self.label_names[i] if self.label_names
                    else str(i))
            lines.append(f"{name:>4} " + " ".join(
                f"{m[i, j]:5d}" for j in range(self.num_classes)))
        lines.append("==================================================================")
        return "\n".join(lines)
