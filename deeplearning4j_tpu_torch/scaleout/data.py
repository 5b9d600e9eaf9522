"""Export-style file-sharded data path (port of
``deeplearning4j_tpu/scaleout/data.py``): the reference's Export training
approach
(``RDDTrainingApproach.Export``): minibatches are written to shared storage
as files, workers train from path lists (reference
``dl4j-spark/.../data/DataSetExportFunction.java``,
``BatchAndExportDataSetsFunction.java``, ``iterator/
PathSparkDataSetIterator.java``).  On a pod the "shared storage" is any
filesystem every host mounts; each host trains its own path shard.

Format: one ``.npz`` per minibatch (features/labels/masks arrays) — the
analogue of the reference's serialized ``DataSet`` files.  The files are
the JAX package's, byte for byte, so either package reads the other's.
Arrays stay host numpy; a network moves a batch to its device when it
trains on it.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from ..datasets.dataset import DataSet
from ..datasets.iterators import DataSetIterator


class DataSetExportFunction:
    """Write each DataSet to ``dir/prefix_<n>.npz`` (reference
    ``DataSetExportFunction.java``)."""

    def __init__(self, export_dir: str, prefix: str = "dataset"):
        self.export_dir = export_dir
        self.prefix = prefix
        self._count = 0
        os.makedirs(export_dir, exist_ok=True)

    def __call__(self, ds: DataSet) -> str:
        path = os.path.join(self.export_dir,
                            f"{self.prefix}_{self._count}.npz")
        arrays = {"features": np.asarray(ds.features),
                  "labels": np.asarray(ds.labels)}
        if ds.features_mask is not None:
            arrays["features_mask"] = np.asarray(ds.features_mask)
        if ds.labels_mask is not None:
            arrays["labels_mask"] = np.asarray(ds.labels_mask)
        np.savez(path, **arrays)
        self._count += 1
        return path


def partition_evenly(items: List, n: int) -> List[List]:
    """Contiguous near-even partitions (the repartition analogue); never
    returns empty partitions."""
    n = max(1, min(n, len(items)))
    bounds = np.linspace(0, len(items), n + 1).astype(int)
    return [items[bounds[i]:bounds[i + 1]] for i in range(n)
            if bounds[i] < bounds[i + 1]]


def load_dataset(path: str) -> DataSet:
    """Read one exported minibatch."""
    with np.load(path) as z:
        return DataSet(z["features"], z["labels"],
                       z["features_mask"] if "features_mask" in z else None,
                       z["labels_mask"] if "labels_mask" in z else None)


def batch_and_export(data: Iterable[DataSet], export_dir: str,
                     batch_size: Optional[int] = None,
                     prefix: str = "dataset") -> List[str]:
    """Re-batch a stream to ``batch_size`` then export (reference
    ``BatchAndExportDataSetsFunction``: uniform minibatch files regardless
    of incoming partition batch sizes).  ``batch_size=None`` keeps incoming
    batches as-is.  Returns the written paths."""
    export = DataSetExportFunction(export_dir, prefix)
    paths: List[str] = []
    if batch_size is None:
        for ds in data:
            paths.append(export(ds))
        return paths

    def cat(get):
        arrs = [get(p) for p in parts]
        if all(a is None for a in arrs):
            return None
        if any(a is None for a in arrs):
            raise ValueError(
                "Mixed mask presence across DataSets being re-batched; "
                "provide masks on all batches or none")
        return np.concatenate([np.asarray(a) for a in arrs])

    def emit(feats, labs, fm, lm):
        paths.append(export(DataSet(feats, labs, fm, lm)))

    parts: List[DataSet] = []
    have = 0
    for ds in data:
        parts.append(ds)
        have += ds.num_examples()
        while have >= batch_size:
            feats = cat(lambda p: p.features)
            labs = cat(lambda p: p.labels)
            fm = cat(lambda p: p.features_mask)
            lm = cat(lambda p: p.labels_mask)
            emit(feats[:batch_size], labs[:batch_size],
                 None if fm is None else fm[:batch_size],
                 None if lm is None else lm[:batch_size])
            rest = feats.shape[0] - batch_size
            parts = [DataSet(
                feats[batch_size:], labs[batch_size:],
                None if fm is None else fm[batch_size:],
                None if lm is None else lm[batch_size:])] if rest else []
            have = rest
    if have:
        emit(cat(lambda p: p.features), cat(lambda p: p.labels),
             cat(lambda p: p.features_mask), cat(lambda p: p.labels_mask))
    return paths


class PathDataSetIterator(DataSetIterator):
    """Iterate DataSets lazily from exported files (reference
    ``PathSparkDataSetIterator.java``)."""

    def __init__(self, paths: Sequence[str]):
        self.paths = list(paths)
        self._pos = 0

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        return load_dataset(self.paths[0]).num_examples() if self.paths else 0

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if self._pos >= len(self.paths):
            raise StopIteration
        ds = load_dataset(self.paths[self._pos])
        self._pos += 1
        return ds
