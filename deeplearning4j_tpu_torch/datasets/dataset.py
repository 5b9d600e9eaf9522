"""DataSet batch container (port of ``DataSet`` from
``deeplearning4j_tpu/datasets/dataset.py``).

One minibatch: features (batch, ...), one-hot or regression labels
(batch, ...), optional per-timestep masks (batch, time).  Fields hold
numpy arrays or torch tensors; the network moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

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
