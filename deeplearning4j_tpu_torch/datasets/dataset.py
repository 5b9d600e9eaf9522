"""DataSet / MultiDataSet batch containers (port of
``deeplearning4j_tpu/datasets/dataset.py``).

One minibatch: features (batch, ...), one-hot or regression labels
(batch, ...), optional per-timestep masks (batch, time).  Fields hold
numpy arrays or torch tensors; the network moves them to its device.

A batch may carry a uint8 *wire twin* of its features (``attach_wire``):
the same examples in uint8 plus the ``normalizers.WireFormat`` whose
decode reproduces the float32 features bit for bit, so the ingest paths
(``nn/ingest.py``) upload 1 byte a pixel and decode on the device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

ArrayLike = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class DataSet:
    features: ArrayLike
    labels: ArrayLike
    features_mask: Optional[ArrayLike] = None
    labels_mask: Optional[ArrayLike] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def as_tuple(self):
        return (self.features, self.labels, self.features_mask,
                self.labels_mask)

    def split_test_and_train(self, n_train: int
                             ) -> Tuple["DataSet", "DataSet"]:
        def _slice(a, sl):
            return None if a is None else a[sl]
        tr = DataSet(*[_slice(a, slice(0, n_train)) for a in self.as_tuple()])
        te = DataSet(*[_slice(a, slice(n_train, None))
                       for a in self.as_tuple()])
        return tr, te

    def shuffle(self, seed: int = 0) -> "DataSet":
        perm = np.random.RandomState(seed).permutation(self.num_examples())
        return DataSet(*[None if a is None else a[perm]
                         for a in self.as_tuple()])

    def batch_by(self, batch_size: int):
        n = self.num_examples()
        for start in range(0, n, batch_size):
            sl = slice(start, min(start + batch_size, n))
            yield DataSet(*[None if a is None else a[sl]
                            for a in self.as_tuple()])


def attach_wire(ds: DataSet, u8: np.ndarray, fmt) -> DataSet:
    """Attach a uint8 wire twin to ``ds``: ``u8`` holds the examples of
    ``ds.features`` in uint8 and ``fmt`` (a ``normalizers.WireFormat``)
    decodes it to ``ds.features`` bit for bit.  An instance attribute,
    not a field: ``dataclasses.replace`` copies (a preprocessed batch)
    drop it, since preprocessed features no longer match the decode."""
    ds._wire = (np.asarray(u8), fmt)
    return ds


def wire_of(ds) -> Optional[Tuple[np.ndarray, object]]:
    """The ``(uint8 buffer, WireFormat)`` twin a reader attached, or
    None."""
    return getattr(ds, "_wire", None)


def wire_enabled() -> bool:
    """Whether staging may use the uint8 wire: ``DL4J_TPU_WIRE_UINT8=0``
    forces float32 everywhere.  Read at each staging decision."""
    return os.environ.get("DL4J_TPU_WIRE_UINT8", "1") != "0"


@dataclasses.dataclass
class MultiDataSet:
    """Multi-input/multi-output batch (what a ComputationGraph consumes:
    one array per network input and per output, in the configuration's
    ``network_inputs``/``network_outputs`` order)."""

    features: Sequence[ArrayLike]
    labels: Sequence[ArrayLike]
    features_masks: Optional[Sequence[Optional[ArrayLike]]] = None
    labels_masks: Optional[Sequence[Optional[ArrayLike]]] = None

    def num_examples(self) -> int:
        arrs = self.features if len(self.features) else self.labels
        return int(arrs[0].shape[0])
