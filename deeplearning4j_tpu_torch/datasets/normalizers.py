"""DataSet normalizers (fit/transform/revert preprocessors; the port's own
copy of ``deeplearning4j_tpu/datasets/normalizers.py``, host numpy with the
same accumulation order, and the same ``.npz`` files, so a normalizer saved
by either package loads in the other).

Equivalents of the ND4J normalizer API the reference trains
through (SURVEY.md §2.10 consumed surface): ``NormalizerStandardize``
(zero-mean/unit-variance per feature), ``NormalizerMinMaxScaler``
(range scaling), ``ImagePreProcessingScaler`` (pixel 0..255 → [a,b]) and
the ``VGG16ImagePreProcessor`` mean-subtraction living in
``keras/trained_models.py``.  All implement the ``DataSetPreProcessor``
shape (``preprocess(ds)`` mutating the batch) so they plug into
``DataSetIterator.set_preprocessor`` exactly like the reference's
``iterator.setPreProcessor(normalizer)`` path, and support ``save``/
``load`` round-trips (reference ``NormalizerSerializer``).

Statistics accumulate in one streaming pass over an iterator (per-batch
vectorised sums, not per-example), over all non-feature axes — so 2-D
(batch, features), image (batch, H, W, C... treated as flat features) and
time-series (batch, time, features) inputs all normalise per feature, with
``features_mask`` respected for padded time steps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """Affine decode of a uint8 feature buffer: ``f32 = float32(u8) /
    denom * mult + add``, in that op order, each op rounded to float32 as
    numpy rounds it.  The host readers compute their float32 features
    with exactly this expression, so the on-device decode
    (``nn/ingest.device_decode``) reproduces them bit for bit:

    - the readers' ``u8 / 255``: ``WireFormat(denom=255.0)``;
    - ``ImagePreProcessingScaler`` (``x / max_pixel * (b - a) + a``):
      ``WireFormat(denom=max_pixel, mult=b - a, add=a)``;
    - raw {0, 1} payloads (binarized pixels): the identity default, whose
      three ops are exact on the non-negative values of a u8 cast.
    """

    denom: float = 1.0
    mult: float = 1.0
    add: float = 0.0

    def decode_host(self, u8: np.ndarray) -> np.ndarray:
        """The host (numpy) twin of the device decode."""
        x = np.asarray(u8, np.float32)
        return x / np.float32(self.denom) * np.float32(self.mult) \
            + np.float32(self.add)

    def as_tuple(self):
        return (self.denom, self.mult, self.add)


#: the readers' pixel format: features = u8 / 255
U8_PIXEL = WireFormat(denom=255.0)


def wire_format_of(normalizer) -> Optional[WireFormat]:
    """The WireFormat that reproduces ``normalizer.transform`` on uint8
    input, or None: only the stateless ``ImagePreProcessingScaler`` is an
    affine map of the pixels."""
    if isinstance(normalizer, ImagePreProcessingScaler):
        return WireFormat(denom=normalizer.max_pixel,
                          mult=normalizer.b - normalizer.a,
                          add=normalizer.a)
    return None


def _moments_axes(features: np.ndarray) -> tuple:
    """Axes to reduce: everything except the trailing feature axis for
    rank>=3 (time-series / images keep per-channel stats), or axis 0 for
    2-D design matrices."""
    if features.ndim <= 2:
        return (0,)
    return tuple(range(features.ndim - 1))


class AbstractNormalizer:
    """Shared fit/apply plumbing; subclasses define the statistics."""

    def __init__(self, fit_label: bool = False):
        self._fit_label = fit_label
        self.fitted = False

    def fit_label(self, fit: bool) -> None:
        self._fit_label = fit

    # -- fitting -----------------------------------------------------------

    def fit(self, data) -> "AbstractNormalizer":
        """Fit from a DataSet or a DataSetIterator (one streaming pass)."""
        self._begin()
        if hasattr(data, "reset"):
            data.reset()
            for ds in data:
                self._accumulate(ds)
            data.reset()
        else:
            self._accumulate(data)
        self._finish()
        self.fitted = True
        return self

    def _begin(self) -> None:
        raise NotImplementedError

    def _accumulate(self, ds) -> None:
        raise NotImplementedError

    def _finish(self) -> None:
        raise NotImplementedError

    # -- application -------------------------------------------------------

    def transform(self, features: np.ndarray,
                  mask: Optional[np.ndarray] = None) -> np.ndarray:
        raise NotImplementedError

    def revert_features(self, features: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform_labels(self, labels: np.ndarray) -> np.ndarray:
        raise NotImplementedError("label stats not fitted")

    def revert_labels(self, labels: np.ndarray) -> np.ndarray:
        raise NotImplementedError("label stats not fitted")

    def preprocess(self, ds) -> None:
        """DataSetPreProcessor entry: mutate the batch in place."""
        if not self.fitted:
            raise RuntimeError(f"{type(self).__name__} not fitted")
        ds.features = self.transform(np.asarray(ds.features),
                                     None if ds.features_mask is None
                                     else np.asarray(ds.features_mask))
        if self._fit_label:
            ds.labels = self.transform_labels(np.asarray(ds.labels))

    def revert(self, ds) -> None:
        ds.features = self.revert_features(np.asarray(ds.features))
        if self._fit_label:
            ds.labels = self.revert_labels(np.asarray(ds.labels))

    __call__ = preprocess


class NormalizerStandardize(AbstractNormalizer):
    """Zero-mean / unit-std per feature (ND4J ``NormalizerStandardize``)."""

    def __init__(self, fit_label: bool = False):
        super().__init__(fit_label)
        self.mean = self.std = None
        self.label_mean = self.label_std = None

    def _begin(self) -> None:
        self._sums = {}

    def _acc_one(self, key: str, x: np.ndarray,
                 mask: Optional[np.ndarray]) -> None:
        x = np.asarray(x, np.float64)
        axes = _moments_axes(x)
        if mask is not None and x.ndim >= 3:
            m = np.asarray(mask, np.float64)
            m = m.reshape(m.shape + (1,) * (x.ndim - m.ndim))
            s, sq, n = ((x * m).sum(axes), (x * x * m).sum(axes),
                        float(m.sum()))
        else:
            s, sq = x.sum(axes), (x * x).sum(axes)
            n = float(np.prod([x.shape[a] for a in axes]))
        acc = self._sums.setdefault(key, [0.0, 0.0, 0.0])
        acc[0] += s
        acc[1] += sq
        acc[2] += n

    def _accumulate(self, ds) -> None:
        self._acc_one("f", ds.features, ds.features_mask)
        if self._fit_label:
            self._acc_one("l", ds.labels, ds.labels_mask)

    def _finish(self) -> None:
        def _stats(acc):
            s, sq, n = acc
            mean = s / n
            var = np.maximum(sq / n - mean * mean, 0.0)
            return (mean.astype(np.float32),
                    np.sqrt(var).astype(np.float32))
        self.mean, self.std = _stats(self._sums["f"])
        if self._fit_label:
            self.label_mean, self.label_std = _stats(self._sums["l"])
        del self._sums

    def transform(self, features, mask=None):
        out = (np.asarray(features, np.float32) - self.mean) / \
            np.maximum(self.std, 1e-8)
        if mask is not None and out.ndim >= 3:
            m = np.asarray(mask, np.float32)
            out = out * m.reshape(m.shape + (1,) * (out.ndim - m.ndim))
        return out

    def revert_features(self, features):
        return np.asarray(features, np.float32) * \
            np.maximum(self.std, 1e-8) + self.mean

    def transform_labels(self, labels):
        return (np.asarray(labels, np.float32) - self.label_mean) / \
            np.maximum(self.label_std, 1e-8)

    def revert_labels(self, labels):
        return np.asarray(labels, np.float32) * \
            np.maximum(self.label_std, 1e-8) + self.label_mean

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            np.savez(f, kind="standardize", mean=self.mean, std=self.std,
                 fit_label=self._fit_label,
                 label_mean=(self.label_mean if self.label_mean is not None
                             else np.zeros(0)),
                 label_std=(self.label_std if self.label_std is not None
                            else np.zeros(0)))


class NormalizerMinMaxScaler(AbstractNormalizer):
    """Scale each feature to ``[min_range, max_range]`` (ND4J
    ``NormalizerMinMaxScaler``)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 fit_label: bool = False):
        super().__init__(fit_label)
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.min = self.max = None
        self.label_min = self.label_max = None

    def _begin(self) -> None:
        self._stats = {}

    def _acc_one(self, key: str, x: np.ndarray,
                 mask: Optional[np.ndarray]) -> None:
        x = np.asarray(x, np.float64)
        axes = _moments_axes(x)
        if mask is not None and x.ndim >= 3:
            m = np.asarray(mask, np.float64)
            m = m.reshape(m.shape + (1,) * (x.ndim - m.ndim)) > 0
            lo = np.where(m, x, np.inf).min(axes)
            hi = np.where(m, x, -np.inf).max(axes)
        else:
            lo, hi = x.min(axes), x.max(axes)
        if key in self._stats:
            plo, phi = self._stats[key]
            self._stats[key] = (np.minimum(plo, lo), np.maximum(phi, hi))
        else:
            self._stats[key] = (lo, hi)

    def _accumulate(self, ds) -> None:
        self._acc_one("f", ds.features, ds.features_mask)
        if self._fit_label:
            self._acc_one("l", ds.labels, ds.labels_mask)

    def _finish(self) -> None:
        self.min, self.max = [a.astype(np.float32)
                              for a in self._stats["f"]]
        if self._fit_label:
            self.label_min, self.label_max = [
                a.astype(np.float32) for a in self._stats["l"]]
        del self._stats

    def _scale(self, x, lo, hi):
        span = np.maximum(hi - lo, 1e-8)
        unit = (np.asarray(x, np.float32) - lo) / span
        return unit * (self.max_range - self.min_range) + self.min_range

    def _unscale(self, x, lo, hi):
        span = np.maximum(hi - lo, 1e-8)
        unit = (np.asarray(x, np.float32) - self.min_range) / \
            (self.max_range - self.min_range)
        return unit * span + lo

    def transform(self, features, mask=None):
        out = self._scale(features, self.min, self.max)
        if mask is not None and out.ndim >= 3:
            m = np.asarray(mask, np.float32)
            out = out * m.reshape(m.shape + (1,) * (out.ndim - m.ndim))
        return out

    def revert_features(self, features):
        return self._unscale(features, self.min, self.max)

    def transform_labels(self, labels):
        return self._scale(labels, self.label_min, self.label_max)

    def revert_labels(self, labels):
        return self._unscale(labels, self.label_min, self.label_max)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            np.savez(f, kind="minmax", min=self.min, max=self.max,
                 min_range=self.min_range, max_range=self.max_range,
                 fit_label=self._fit_label,
                 label_min=(self.label_min if self.label_min is not None
                            else np.zeros(0)),
                 label_max=(self.label_max if self.label_max is not None
                            else np.zeros(0)))


class ImagePreProcessingScaler(AbstractNormalizer):
    """Pixel scaler: uint8 0..255 → ``[a, b]`` (ND4J
    ``ImagePreProcessingScaler``).  Stateless — no fit required."""

    def __init__(self, a: float = 0.0, b: float = 1.0, max_bits: int = 8):
        super().__init__(fit_label=False)
        self.a = float(a)
        self.b = float(b)
        self.max_pixel = float(2 ** max_bits - 1)
        self.fitted = True

    def fit(self, data) -> "ImagePreProcessingScaler":
        return self

    def transform(self, features, mask=None):
        x = np.asarray(features, np.float32) / self.max_pixel
        return x * (self.b - self.a) + self.a

    def revert_features(self, features):
        x = (np.asarray(features, np.float32) - self.a) / (self.b - self.a)
        return x * self.max_pixel

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            np.savez(f, kind="image", a=self.a, b=self.b,
                     max_pixel=self.max_pixel)


def load_normalizer(path: str) -> AbstractNormalizer:
    """Restore a saved normalizer (reference ``NormalizerSerializer``)."""
    z = np.load(path, allow_pickle=False)
    kind = str(z["kind"])
    if kind == "standardize":
        n = NormalizerStandardize(fit_label=bool(z["fit_label"]))
        n.mean, n.std = z["mean"], z["std"]
        if n._fit_label:
            n.label_mean, n.label_std = z["label_mean"], z["label_std"]
    elif kind == "minmax":
        n = NormalizerMinMaxScaler(float(z["min_range"]),
                                   float(z["max_range"]),
                                   fit_label=bool(z["fit_label"]))
        n.min, n.max = z["min"], z["max"]
        if n._fit_label:
            n.label_min, n.label_max = z["label_min"], z["label_max"]
    elif kind == "image":
        n = ImagePreProcessingScaler(float(z["a"]), float(z["b"]))
        n.max_pixel = float(z["max_pixel"])
    else:
        raise ValueError(f"unknown normalizer kind {kind!r}")
    n.fitted = True
    return n
