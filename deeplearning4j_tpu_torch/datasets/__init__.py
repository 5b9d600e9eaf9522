"""Data tier of the port: DataSet containers, iterators with async
prefetch, normalizers, the MNIST, iris, CIFAR-10, LFW and curves readers,
and the record-reader ETL (port of ``deeplearning4j_tpu/datasets``).  Not
ported yet: the native prefetch ring and the native decodes of
``native_io.py`` (A11).
"""

from .cifar import CifarDataSetIterator, cifar_arrays
from .curves import CurvesDataSetIterator, curves_arrays
from .dataset import DataSet, MultiDataSet
from .iris import IrisDataSetIterator, iris_dataset
from .iterators import (AsyncDataSetIterator, DataSetIterator,
                        ExistingDataSetIterator, ListDataSetIterator,
                        MultipleEpochsIterator)
from .lfw import LFWDataSetIterator, lfw_arrays
from .mnist import MnistDataSetIterator, mnist_arrays
from .normalizers import (ImagePreProcessingScaler, NormalizerMinMaxScaler,
                          NormalizerStandardize, load_normalizer)
from .records import (AlignmentMode, CollectionRecordReader,
                      CollectionSequenceRecordReader, CSVRecordReader,
                      CSVSequenceRecordReader, RecordReader,
                      RecordReaderDataSetIterator,
                      RecordReaderMultiDataSetIterator, SequenceRecordReader,
                      SequenceRecordReaderDataSetIterator)

__all__ = [
    "DataSet", "MultiDataSet", "DataSetIterator", "ListDataSetIterator",
    "ExistingDataSetIterator", "MultipleEpochsIterator",
    "AsyncDataSetIterator", "MnistDataSetIterator", "mnist_arrays",
    "IrisDataSetIterator", "iris_dataset", "CifarDataSetIterator",
    "cifar_arrays", "LFWDataSetIterator", "lfw_arrays",
    "CurvesDataSetIterator", "curves_arrays", "NormalizerStandardize",
    "NormalizerMinMaxScaler", "ImagePreProcessingScaler", "load_normalizer",
    "RecordReader", "CollectionRecordReader", "CSVRecordReader",
    "SequenceRecordReader", "CollectionSequenceRecordReader",
    "CSVSequenceRecordReader", "RecordReaderDataSetIterator",
    "RecordReaderMultiDataSetIterator",
    "SequenceRecordReaderDataSetIterator", "AlignmentMode",
]
