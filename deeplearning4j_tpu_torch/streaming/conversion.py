"""Record -> array conversion SPI (port of
``deeplearning4j_tpu/streaming/conversion.py``; host numpy, the same rows).

The reference's ``dl4j-streaming/.../conversion/`` converts Camel
message bodies (CSV records, serialized writables) into ``INDArray``
rows; these converters turn raw streamed records into (features, labels)
numpy rows for the pipeline's micro-batches."""

from __future__ import annotations

import json
from typing import Any, Optional, Tuple

import numpy as np

from ..datasets.records import _one_hot

Row = Tuple[np.ndarray, Optional[np.ndarray]]


class RecordConverter:
    """Converter SPI: raw record -> (features_row, labels_row | None)."""

    def convert(self, record: Any) -> Row:
        raise NotImplementedError


class CsvRecordConverter(RecordConverter):
    """CSV row -> features (+ optional trailing label column one-hot).

    ``label_index``: column holding an integer class label (``-1`` = last
    column; ``None`` = no label, inference-only records)."""

    def __init__(self, label_index: Optional[int] = -1,
                 num_classes: Optional[int] = None,
                 delimiter: str = ","):
        if label_index is not None and num_classes is None:
            raise ValueError("num_classes required when label_index is set")
        self.label_index = label_index
        self.num_classes = num_classes
        self.delimiter = delimiter

    def convert(self, record: Any) -> Row:
        parts = [p.strip() for p in str(record).split(self.delimiter)]
        if self.label_index is None:
            return np.array([float(p) for p in parts], np.float32), None
        if not -len(parts) <= self.label_index < len(parts):
            raise ValueError(
                f"label_index {self.label_index} out of range for "
                f"{len(parts)}-column record")
        idx = self.label_index % len(parts)
        label = int(float(parts[idx]))
        feats = [float(p) for i, p in enumerate(parts) if i != idx]
        one_hot = _one_hot(np.array([label]), self.num_classes)[0]
        return np.array(feats, np.float32), one_hot


class DictRecordConverter(RecordConverter):
    """JSON/dict records: ``{"features": [...], "label": k}`` (label
    optional).  Strings are ``json.loads``-ed first."""

    def __init__(self, num_classes: Optional[int] = None,
                 features_key: str = "features", label_key: str = "label"):
        self.num_classes = num_classes
        self.features_key = features_key
        self.label_key = label_key

    def convert(self, record: Any) -> Row:
        if isinstance(record, (str, bytes)):
            record = json.loads(record)
        feats = np.asarray(record[self.features_key], np.float32)
        label = record.get(self.label_key)
        if label is None:
            return feats, None
        if self.num_classes is None:
            raise ValueError("num_classes required for labeled records")
        return feats, _one_hot(np.array([int(label)]), self.num_classes)[0]
