"""Record readers + the record→DataSet ETL bridge (port of
``deeplearning4j_tpu/datasets/records.py``).

Equivalent of the DataVec bridge the reference trains from:
``datasets/datavec/RecordReaderDataSetIterator.java`` (records → feature
matrix + one-hot/regression labels) and
``datasets/datavec/SequenceRecordReaderDataSetIterator.java`` (paired
feature/label sequence readers, EQUAL_LENGTH / ALIGN_START / ALIGN_END
alignment with masks), plus the minimal reader SPI they consume
(DataVec's ``CSVRecordReader`` / ``CSVSequenceRecordReader`` /
``CollectionRecordReader``).

Host-side ETL; batches come out as numpy DataSets (the port's
``DataSet``/``MultiDataSet``), which the network moves to its device.
Whole-batch assembly is vectorised (one ``np.asarray`` per batch, not per
record), and a reader gives the JAX package's batches and masks.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np

from .dataset import DataSet, MultiDataSet
from .iterators import DataSetIterator

Record = List[Union[float, int, str]]


def _read_csv_records(path: str, skip_num_lines: int,
                      delimiter: str) -> List[Record]:
    with open(path, "r", encoding="utf-8") as f:
        lines = [ln.rstrip("\n") for ln in f]
    return [ln.split(delimiter) for ln in lines[skip_num_lines:] if ln]


# ------------------------------------------------------------------ readers

class RecordReader:
    """Minimal reader SPI (DataVec ``RecordReader``): a resettable stream
    of records, each a list of values."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_record(self) -> Record:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_record()


class CollectionRecordReader(RecordReader):
    """In-memory records (DataVec ``CollectionRecordReader``)."""

    def __init__(self, records: Sequence[Record]):
        self._records = [list(r) for r in records]
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._records)

    def next_record(self) -> Record:
        r = self._records[self._pos]
        self._pos += 1
        return list(r)

    def reset(self) -> None:
        self._pos = 0


class CSVRecordReader(RecordReader):
    """CSV line reader (DataVec ``CSVRecordReader``): ``initialize(path)``
    then stream one record per line, with ``skip_num_lines`` header skip."""

    def __init__(self, skip_num_lines: int = 0, delimiter: str = ","):
        self.skip_num_lines = skip_num_lines
        self.delimiter = delimiter
        self._records: List[Record] = []
        self._pos = 0

    def initialize(self, path: str) -> "CSVRecordReader":
        self._records = _read_csv_records(path, self.skip_num_lines,
                                          self.delimiter)
        self._pos = 0
        return self

    has_next = CollectionRecordReader.has_next
    next_record = CollectionRecordReader.next_record
    reset = CollectionRecordReader.reset


class SequenceRecordReader:
    """Sequence reader SPI (DataVec ``SequenceRecordReader``): a stream of
    sequences, each a list of records (time steps)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_sequence(self) -> List[Record]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class CollectionSequenceRecordReader(SequenceRecordReader):
    """In-memory sequences (DataVec ``CollectionSequenceRecordReader``)."""

    def __init__(self, sequences: Sequence[Sequence[Record]]):
        self._seqs = [[list(r) for r in s] for s in sequences]
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._seqs)

    def next_sequence(self) -> List[Record]:
        s = self._seqs[self._pos]
        self._pos += 1
        return [list(r) for r in s]

    def reset(self) -> None:
        self._pos = 0


class CSVSequenceRecordReader(CollectionSequenceRecordReader):
    """One CSV file per sequence (DataVec ``CSVSequenceRecordReader``);
    ``initialize`` takes a list of file paths or a directory."""

    def __init__(self, skip_num_lines: int = 0, delimiter: str = ","):
        super().__init__([])
        self.skip_num_lines = skip_num_lines
        self.delimiter = delimiter

    def initialize(self, paths: Union[str, Sequence[str]]
                   ) -> "CSVSequenceRecordReader":
        if isinstance(paths, str):
            paths = sorted(
                os.path.join(paths, n) for n in os.listdir(paths)
                if not n.startswith("."))
        self._seqs = [_read_csv_records(p, self.skip_num_lines,
                                        self.delimiter) for p in paths]
        self._pos = 0
        return self


# ------------------------------------------------------- records → DataSet

def _one_hot(values: np.ndarray, num_classes: int) -> np.ndarray:
    idx = values.astype(np.int64)
    if (idx < 0).any() or (idx >= num_classes).any():
        raise ValueError(f"label out of range [0,{num_classes})")
    return np.eye(num_classes, dtype=np.float32)[idx]


def _pad_sequences(steps: List[np.ndarray], T: int, align_end: bool):
    """Variable-length (T_i, dim) matrices → ((n, T, dim), (n, T) mask),
    occupying leading steps (trailing mask) or trailing steps under
    ALIGN_END."""
    n = len(steps)
    arr = np.zeros((n, T, steps[0].shape[1]), np.float32)
    mask = np.zeros((n, T), np.float32)
    for i, s in enumerate(steps):
        off = T - s.shape[0] if align_end else 0
        arr[i, off:off + s.shape[0]] = s
        mask[i, off:off + s.shape[0]] = 1.0
    return arr, mask


class RecordReaderDataSetIterator(DataSetIterator):
    """Records → minibatch DataSets (reference
    ``RecordReaderDataSetIterator.java``).

    ``label_index``: column holding the label (-1 = no labels, features
    only — labels mirror features like the reference's unsupervised path).
    ``num_possible_labels`` one-hots an integer class column;
    ``regression=True`` keeps label columns as real values, with
    ``label_index_to`` for multi-column regression targets (reference
    labelIndexTo).  ``max_num_batches`` truncates the pass.
    """

    def __init__(self, record_reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_possible_labels: int = -1,
                 regression: bool = False, label_index_to: int = -1,
                 max_num_batches: int = -1):
        self.reader = record_reader
        self._batch = batch_size
        self.label_index = label_index
        self.label_index_to = (label_index_to if label_index_to >= 0
                               else label_index)
        self.num_possible_labels = num_possible_labels
        self.regression = regression
        self.max_num_batches = max_num_batches
        self._batch_num = 0
        if not regression and label_index >= 0 and num_possible_labels <= 0:
            raise ValueError("classification needs num_possible_labels")

    def batch(self) -> int:
        return self._batch

    def reset(self) -> None:
        self.reader.reset()
        self._batch_num = 0

    def __next__(self) -> DataSet:
        if (self.max_num_batches >= 0
                and self._batch_num >= self.max_num_batches):
            raise StopIteration
        rows: List[Record] = []
        while self.reader.has_next() and len(rows) < self._batch:
            rows.append(self.reader.next_record())
        if not rows:
            raise StopIteration
        self._batch_num += 1
        mat = np.asarray(rows, dtype=np.float32)
        if self.label_index < 0:
            return self._pre(DataSet(mat, mat))
        li, lt = self.label_index, self.label_index_to
        feat = np.concatenate([mat[:, :li], mat[:, lt + 1:]], axis=1)
        if self.regression:
            labels = mat[:, li:lt + 1]
        else:
            labels = _one_hot(mat[:, li], self.num_possible_labels)
        return self._pre(DataSet(feat, labels))


class AlignmentMode:
    """Sequence alignment modes (reference
    ``SequenceRecordReaderDataSetIterator.AlignmentMode``)."""
    EQUAL_LENGTH = "equal_length"
    ALIGN_START = "align_start"
    ALIGN_END = "align_end"


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Paired feature/label sequence readers → padded+masked time-series
    DataSets (reference ``SequenceRecordReaderDataSetIterator.java``).

    Layout is the package's (batch, time, features) — the reference emits
    (batch, features, time); the recurrent tier here scans over axis 1.
    Under ``ALIGN_START`` shorter sequences occupy leading steps with a
    trailing mask; under ``ALIGN_END`` they occupy trailing steps —
    i.e. labels at the final step stay aligned for seq-classification.
    """

    def __init__(self, features_reader: SequenceRecordReader,
                 labels_reader: Optional[SequenceRecordReader] = None,
                 mini_batch_size: int = 10,
                 num_possible_labels: int = -1,
                 regression: bool = False,
                 alignment_mode: str = AlignmentMode.EQUAL_LENGTH,
                 label_index: int = -1):
        self.features_reader = features_reader
        self.labels_reader = labels_reader
        self._batch = mini_batch_size
        self.num_possible_labels = num_possible_labels
        self.regression = regression
        self.alignment_mode = alignment_mode
        self.label_index = label_index  # single-reader mode
        if labels_reader is None and label_index < 0:
            raise ValueError("need a labels reader or a label_index")

    def batch(self) -> int:
        return self._batch

    def reset(self) -> None:
        self.features_reader.reset()
        if self.labels_reader is not None:
            self.labels_reader.reset()

    def _label_steps(self, seq: List[Record]) -> np.ndarray:
        arr = np.asarray(seq, dtype=np.float32)
        if self.regression:
            return arr
        if arr.shape[1] != 1:
            raise ValueError("classification label records must have one "
                             "column")
        return _one_hot(arr[:, 0], self.num_possible_labels)

    def __next__(self) -> DataSet:
        fseqs, lseqs = [], []
        while (self.features_reader.has_next()
               and len(fseqs) < self._batch):
            fs = self.features_reader.next_sequence()
            if self.labels_reader is not None:
                ls = self.labels_reader.next_sequence()
            else:
                li = self.label_index
                ls = [[r[li]] for r in fs]
                fs = [r[:li] + r[li + 1:] for r in fs]
            fseqs.append(np.asarray(fs, dtype=np.float32))
            lseqs.append(self._label_steps(ls))
        if not fseqs:
            raise StopIteration
        n = len(fseqs)
        flens = [s.shape[0] for s in fseqs]
        llens = [s.shape[0] for s in lseqs]
        if self.alignment_mode == AlignmentMode.EQUAL_LENGTH:
            if len(set(flens)) > 1 or flens != llens:
                raise ValueError(
                    "EQUAL_LENGTH alignment requires equal sequence "
                    f"lengths, got features {flens} labels {llens}")
        T = max(max(flens), max(llens))
        align_end = self.alignment_mode == AlignmentMode.ALIGN_END
        feats, fmask = _pad_sequences(fseqs, T, align_end)
        labels, lmask = _pad_sequences(lseqs, T, align_end)
        if self.alignment_mode == AlignmentMode.EQUAL_LENGTH:
            return self._pre(DataSet(feats, labels))
        return self._pre(DataSet(feats, labels, fmask, lmask))


# ----------------------------------------- multi-reader → MultiDataSet

class _SubsetDetails:
    """One input/output spec (reference
    ``RecordReaderMultiDataSetIterator.SubsetDetails``): the whole reader,
    a [first, last]-inclusive column subset, or a one-hot column."""

    def __init__(self, reader_name: str, entire: bool, one_hot: bool,
                 num_classes: int, col_first: int, col_last: int):
        self.reader_name = reader_name
        self.entire = entire
        self.one_hot = one_hot
        self.num_classes = num_classes
        self.col_first = col_first
        self.col_last = col_last

    def convert(self, mat: np.ndarray) -> np.ndarray:
        """(n, columns) record matrix → (n, dim) array for this subset."""
        if self.entire:
            return mat.astype(np.float32)
        if self.one_hot:
            return _one_hot(mat[:, self.col_first], self.num_classes)
        return mat[:, self.col_first:self.col_last + 1].astype(np.float32)


class RecordReaderMultiDataSetIterator:
    """Multiple named Record/SequenceRecordReaders → MultiDataSet batches
    (reference ``datasets/datavec/RecordReaderMultiDataSetIterator.java``:
    builder at ``:504-620``, per-subset conversion at ``:253-311``).

    Inputs and outputs are column subsets of any registered reader, so one
    CSV can feed several graph inputs and several one-hot outputs at once.
    Sequence readers emit (batch, time, dim) padded arrays with per-subset
    masks under ``ALIGN_START`` / ``ALIGN_END``; record readers emit
    (batch, dim) with no mask.  Built for ``ComputationGraph.fit``.
    """

    class Builder:
        def __init__(self, batch_size: int):
            if batch_size <= 0:
                raise ValueError("batch size must be positive")
            self._batch = batch_size
            self._readers = {}
            self._seq_readers = {}
            self._inputs: List[_SubsetDetails] = []
            self._outputs: List[_SubsetDetails] = []
            self._alignment = AlignmentMode.EQUAL_LENGTH

        def add_reader(self, name: str, reader: RecordReader):
            self._readers[name] = reader
            return self

        def add_sequence_reader(self, name: str, reader: SequenceRecordReader):
            self._seq_readers[name] = reader
            return self

        def sequence_alignment_mode(self, mode: str):
            valid = (AlignmentMode.EQUAL_LENGTH, AlignmentMode.ALIGN_START,
                     AlignmentMode.ALIGN_END)
            if mode not in valid:
                raise ValueError(f"unknown alignment mode {mode!r}; "
                                 f"use one of {valid}")
            self._alignment = mode
            return self

        @staticmethod
        def _subset(name, column_first, column_last):
            if column_first < 0:
                if column_last >= 0:
                    raise ValueError(
                        f"column_last={column_last} given without "
                        f"column_first for reader {name!r}")
                return _SubsetDetails(name, True, False, -1, -1, -1)
            if column_last < 0:
                column_last = column_first      # single-column subset
            if column_last < column_first:
                raise ValueError(
                    f"column_last {column_last} < column_first "
                    f"{column_first} for reader {name!r}")
            return _SubsetDetails(name, False, False, -1, column_first,
                                  column_last)

        def add_input(self, name: str, column_first: int = -1,
                      column_last: int = -1):
            self._inputs.append(self._subset(name, column_first, column_last))
            return self

        def add_input_one_hot(self, name: str, column: int, num_classes: int):
            self._inputs.append(_SubsetDetails(
                name, False, True, num_classes, column, -1))
            return self

        def add_output(self, name: str, column_first: int = -1,
                       column_last: int = -1):
            self._outputs.append(self._subset(name, column_first,
                                              column_last))
            return self

        def add_output_one_hot(self, name: str, column: int,
                               num_classes: int):
            self._outputs.append(_SubsetDetails(
                name, False, True, num_classes, column, -1))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            if not self._readers and not self._seq_readers:
                raise ValueError("no readers registered")
            if not self._inputs and not self._outputs:
                raise ValueError("no inputs/outputs registered")
            dup = set(self._readers) & set(self._seq_readers)
            if dup:
                raise ValueError(
                    f"names registered as both record and sequence "
                    f"readers: {sorted(dup)}")
            known = set(self._readers) | set(self._seq_readers)
            for d in self._inputs + self._outputs:
                if d.reader_name not in known:
                    raise ValueError(
                        f"subset references unknown reader "
                        f"{d.reader_name!r}; registered: {sorted(known)}")
            return RecordReaderMultiDataSetIterator(self)

    def __init__(self, builder: "RecordReaderMultiDataSetIterator.Builder"):
        self._batch = builder._batch
        self._readers = dict(builder._readers)
        self._seq_readers = dict(builder._seq_readers)
        self._inputs = list(builder._inputs)
        self._outputs = list(builder._outputs)
        self._alignment = builder._alignment
        self._preprocessor = None

    # reference MultiDataSetIterator.setPreProcessor
    def set_preprocessor(self, preprocessor) -> None:
        self._preprocessor = preprocessor

    def batch(self) -> int:
        return self._batch

    def reset(self) -> None:
        for r in self._readers.values():
            r.reset()
        for r in self._seq_readers.values():
            r.reset()

    def __iter__(self):
        self.reset()
        return self

    def _next_values(self):
        """Pull up to batch_size examples from every reader; truncate all
        to the minimum count so examples stay row-aligned (reference
        ``minExamples`` logic at ``next(int):...``)."""
        recs = {}
        for name, r in self._readers.items():
            rows = []
            while r.has_next() and len(rows) < self._batch:
                rows.append(r.next_record())
            recs[name] = rows
        seqs = {}
        for name, r in self._seq_readers.items():
            ss = []
            while r.has_next() and len(ss) < self._batch:
                ss.append(r.next_sequence())
            seqs[name] = ss
        counts = [len(v) for v in recs.values()] + \
                 [len(v) for v in seqs.values()]
        n = min(counts)
        if n == 0:
            raise StopIteration
        return ({k: v[:n] for k, v in recs.items()},
                {k: v[:n] for k, v in seqs.items()}, n)

    def _convert_seq(self, details: _SubsetDetails, seq_mats):
        """Per-sequence (T_i, columns) matrices → ((n, T, dim), mask).

        The mask is always an array (all-ones when every sequence is full
        length) so the MultiDataSet's structure is identical across
        batches, as in the JAX package.
        """
        steps = [details.convert(mat) for mat in seq_mats]
        lens = [s.shape[0] for s in steps]
        T = max(lens)
        if self._alignment == AlignmentMode.EQUAL_LENGTH \
                and len(set(lens)) > 1:
            raise ValueError(
                f"EQUAL_LENGTH alignment requires equal sequence lengths, "
                f"got {lens} from reader {details.reader_name!r}")
        return _pad_sequences(
            steps, T, self._alignment == AlignmentMode.ALIGN_END)

    def __next__(self) -> MultiDataSet:
        recs, seqs, n = self._next_values()
        rec_mats = {k: np.asarray(v, dtype=np.float32)
                    for k, v in recs.items()}
        seq_mats = {k: [np.asarray(s, dtype=np.float32) for s in v]
                    for k, v in seqs.items()}

        def convert(details: _SubsetDetails):
            if details.reader_name in rec_mats:
                return details.convert(rec_mats[details.reader_name]), None
            return self._convert_seq(details, seq_mats[details.reader_name])

        feats, fmasks = zip(*[convert(d) for d in self._inputs]) \
            if self._inputs else ((), ())
        labels, lmasks = zip(*[convert(d) for d in self._outputs]) \
            if self._outputs else ((), ())
        # Mask presence depends only on static config (alignment mode +
        # whether any subset reads a sequence reader), never on this
        # batch's lengths, so every batch has the same structure.
        emit = (self._alignment != AlignmentMode.EQUAL_LENGTH
                and any(d.reader_name in self._seq_readers
                        for d in self._inputs + self._outputs))
        mds = MultiDataSet(
            features=list(feats), labels=list(labels),
            features_masks=list(fmasks) if emit else None,
            labels_masks=list(lmasks) if emit else None)
        if self._preprocessor is not None:
            self._preprocessor.preprocess(mds)
        return mds
