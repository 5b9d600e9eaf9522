"""Curves dataset iterator (port of ``deeplearning4j_tpu/datasets/
curves.py``).

Equivalent of the reference's
``datasets/iterator/impl/CurvesDataSetIterator.java`` +
``datasets/fetchers/CurvesDataFetcher.java``: the classic 28x28 "curves"
benchmark (random smooth strokes) used for unsupervised pretraining of
autoencoders/RBMs/deep-belief stacks.

The reference downloads a serialized dataset; this build generates the
curves procedurally and deterministically: each example is a random cubic
Bezier stroke rasterized with a soft pen onto a 28x28 canvas.  As in the
reference's usage (autoencoder pretraining), ``labels == features`` — the
reconstruction target."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .dataset import DataSet
from .iterators import ListDataSetIterator

SIZE = 28


def _render_curve(rng: np.random.RandomState) -> np.ndarray:
    """Rasterize one random cubic Bezier stroke with a 2-px soft pen.

    Max of equal-sigma Gaussians == Gaussian of the min squared distance,
    so one exp over the per-pixel nearest sample point suffices."""
    pts = rng.uniform(3, SIZE - 3, (4, 2))
    t = np.linspace(0.0, 1.0, 120)[:, None]
    # cubic Bezier interpolation
    b = ((1 - t) ** 3 * pts[0] + 3 * (1 - t) ** 2 * t * pts[1]
         + 3 * (1 - t) * t ** 2 * pts[2] + t ** 3 * pts[3])
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float64)
    d2 = ((yy[:, :, None] - b[:, 0]) ** 2
          + (xx[:, :, None] - b[:, 1]) ** 2).min(axis=-1)
    img = np.exp(-d2 / (2 * 0.8 ** 2)).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def curves_arrays(num_examples: int = 1000,
                  seed: int = 17) -> Tuple[np.ndarray, np.ndarray]:
    """(features, labels) with labels == features (reconstruction)."""
    rng = np.random.RandomState(seed)
    x = np.empty((num_examples, SIZE * SIZE), np.float32)
    for i in range(num_examples):
        x[i] = _render_curve(rng).ravel()
    return x, x.copy()


class CurvesDataSetIterator(ListDataSetIterator):
    """Reference signature ``CurvesDataSetIterator(batch, numSamples)``:
    flat 784-vector features in [0,1], labels = features."""

    def __init__(self, batch: int, num_samples: int = 1000,
                 shuffle: bool = False, seed: int = 17):
        x, y = curves_arrays(num_samples, seed)
        super().__init__(DataSet(x, y), batch, shuffle, seed)
