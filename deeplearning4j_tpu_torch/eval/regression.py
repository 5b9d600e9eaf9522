"""Regression evaluation (the port's own copy of
``deeplearning4j_tpu/eval/regression.py``, host numpy).

Equivalent of the reference's ``eval/RegressionEvaluation.java``
(259 LoC): per-column MSE, MAE, RMSE, RSE, correlation R, plus R².
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class RegressionEvaluation:
    """Accumulating per-column regression stats (reference
    ``eval/RegressionEvaluation.java``)."""

    def __init__(self, column_names: Optional[List[str]] = None):
        self.column_names = column_names
        self._n = 0
        self._sum_err2 = None     # sum (y - yhat)^2
        self._sum_abs = None      # sum |y - yhat|
        self._sum_y = None
        self._sum_y2 = None
        self._sum_p = None
        self._sum_p2 = None
        self._sum_yp = None

    def eval(self, labels, predictions, mask=None) -> None:
        y = np.asarray(labels, np.float64)
        p = np.asarray(predictions, np.float64)
        if y.ndim == 3:
            from .evaluation import flatten_time_series
            y, p = flatten_time_series(y, p, mask)
        if y.ndim == 1:
            y = y[:, None]
            p = p[:, None]
        if self._sum_err2 is None:
            z = np.zeros(y.shape[1], np.float64)
            (self._sum_err2, self._sum_abs, self._sum_y, self._sum_y2,
             self._sum_p, self._sum_p2, self._sum_yp) = (z.copy() for _ in
                                                         range(7))
        err = y - p
        self._n += y.shape[0]
        self._sum_err2 += np.sum(err * err, axis=0)
        self._sum_abs += np.sum(np.abs(err), axis=0)
        self._sum_y += np.sum(y, axis=0)
        self._sum_y2 += np.sum(y * y, axis=0)
        self._sum_p += np.sum(p, axis=0)
        self._sum_p2 += np.sum(p * p, axis=0)
        self._sum_yp += np.sum(y * p, axis=0)

    def eval_time_series(self, labels, predictions, mask=None) -> None:
        """Alias: ``eval`` already flattens (batch, time, cols) with the
        mask (reference ``BaseEvaluation.evalTimeSeries``)."""
        self.eval(labels, predictions, mask)

    def merge(self, other: "RegressionEvaluation") -> "RegressionEvaluation":
        """Fold another evaluation's sums into this one (reference
        ``IEvaluation.merge``)."""
        if other._sum_err2 is None:
            return self
        if self._sum_err2 is None:
            for name in ("_sum_err2", "_sum_abs", "_sum_y", "_sum_y2",
                         "_sum_p", "_sum_p2", "_sum_yp"):
                setattr(self, name, getattr(other, name).copy())
            self._n = other._n
            self.column_names = self.column_names or other.column_names
            return self
        if self.num_columns() != other.num_columns():
            raise ValueError(
                f"Cannot merge {self.num_columns()}-col with "
                f"{other.num_columns()}-col regression evaluations")
        for name in ("_sum_err2", "_sum_abs", "_sum_y", "_sum_y2",
                     "_sum_p", "_sum_p2", "_sum_yp"):
            setattr(self, name, getattr(self, name) + getattr(other, name))
        self._n += other._n
        return self

    def num_columns(self) -> int:
        return 0 if self._sum_err2 is None else self._sum_err2.size

    def mean_squared_error(self, col: int) -> float:
        return float(self._sum_err2[col] / self._n)

    def mean_absolute_error(self, col: int) -> float:
        return float(self._sum_abs[col] / self._n)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self._sum_err2[col] / self._n))

    def correlation_r2(self, col: int) -> float:
        """Pearson correlation between label and prediction (the reference's
        ``correlationR2`` is the correlation coefficient, naming quirk
        preserved)."""
        n = self._n
        num = n * self._sum_yp[col] - self._sum_y[col] * self._sum_p[col]
        den = (np.sqrt(n * self._sum_y2[col] - self._sum_y[col] ** 2)
               * np.sqrt(n * self._sum_p2[col] - self._sum_p[col] ** 2))
        return float(num / den) if den else float("nan")

    def r_squared(self, col: int) -> float:
        """Coefficient of determination 1 - SS_res/SS_tot."""
        ss_tot = self._sum_y2[col] - self._sum_y[col] ** 2 / self._n
        return float(1.0 - self._sum_err2[col] / ss_tot) if ss_tot else float(
            "nan")

    def relative_squared_error(self, col: int) -> float:
        ss_tot = self._sum_y2[col] - self._sum_y[col] ** 2 / self._n
        return float(self._sum_err2[col] / ss_tot) if ss_tot else float("nan")

    def stats(self) -> str:
        names = (self.column_names
                 or [f"col_{i}" for i in range(self.num_columns())])
        lines = [f"{'Column':<12}{'MSE':>12}{'MAE':>12}{'RMSE':>12}"
                 f"{'RSE':>12}{'R':>8}"]
        for i, name in enumerate(names):
            lines.append(
                f"{name:<12}{self.mean_squared_error(i):>12.5g}"
                f"{self.mean_absolute_error(i):>12.5g}"
                f"{self.root_mean_squared_error(i):>12.5g}"
                f"{self.relative_squared_error(i):>12.5g}"
                f"{self.correlation_r2(i):>8.4f}")
        return "\n".join(lines)
