"""Data tier of the port: DataSet containers, iterators with async
prefetch, normalizers, and the MNIST and iris readers (port of
``deeplearning4j_tpu/datasets``).  Not ported yet: the record readers,
CIFAR, LFW and curves (ROADMAP A4), and the native prefetch ring (A11).
"""

from .dataset import DataSet, MultiDataSet
from .iris import IrisDataSetIterator, iris_dataset
from .iterators import (AsyncDataSetIterator, DataSetIterator,
                        ExistingDataSetIterator, ListDataSetIterator,
                        MultipleEpochsIterator)
from .mnist import MnistDataSetIterator, mnist_arrays
from .normalizers import (ImagePreProcessingScaler, NormalizerMinMaxScaler,
                          NormalizerStandardize, load_normalizer)

__all__ = [
    "DataSet", "MultiDataSet", "DataSetIterator", "ListDataSetIterator",
    "ExistingDataSetIterator", "MultipleEpochsIterator",
    "AsyncDataSetIterator", "MnistDataSetIterator", "mnist_arrays",
    "IrisDataSetIterator", "iris_dataset", "NormalizerStandardize",
    "NormalizerMinMaxScaler", "ImagePreProcessingScaler", "load_normalizer",
]
