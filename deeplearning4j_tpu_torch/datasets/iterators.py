"""DataSet iterators: the contract and the async prefetch (port of
``deeplearning4j_tpu/datasets/iterators.py``).

Equivalents of the reference's ``AsyncDataSetIterator`` (background
prefetch thread, queue of 2), ``ExistingDataSetIterator``,
``MultipleEpochsIterator`` and the ``DataSetIterator`` contract.  The
protocol is Python's (``__iter__``/``__next__``) plus DL4J's ``reset()``/
``batch()``/``total_examples()``.  Batches are host numpy; the network
moves each to its device.

``ListDataSetIterator`` draws the JAX package's ``RandomState`` permutation,
so a seed gives the same batches in the same order in both packages.
``AsyncDataSetIterator`` prefetches on a Python thread only: the native
ring of the JAX package (``native/dataloader.cc``, whose shuffle is not
this one) waits in ROADMAP A11, so ``native`` is always False.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from .dataset import DataSet, attach_wire, wire_of


class DataSetIterator:
    """Base contract (reference ``DataSetIterator``, with its
    ``setPreProcessor``: a ``DataSetPreProcessor`` applied to every batch
    the iterator emits)."""

    _preprocessor = None

    def set_preprocessor(self, preprocessor) -> None:
        self._preprocessor = preprocessor

    def get_preprocessor(self):
        return self._preprocessor

    def _pre(self, ds: DataSet) -> DataSet:
        if self._preprocessor is not None:
            # a shallow copy: the source DataSet may be yielded again on
            # reset or replay, and preprocessing it twice would normalize
            # it twice
            ds = dataclasses.replace(ds)
            self._preprocessor.preprocess(ds)
        return ds

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """Minibatches from an in-memory DataSet (reference
    ``ListDataSetIterator``).  With ``shuffle``, each ``reset()`` draws
    ``RandomState(seed + resets so far).permutation(n)``."""

    def __init__(self, dataset: DataSet, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 0):
        self._ds = dataset
        self._batch = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._order = np.arange(dataset.num_examples())
        self._pos = 0
        self.reset()

    def reset(self) -> None:
        if self._shuffle:
            rng = np.random.RandomState(self._seed + self._epoch)
            self._order = rng.permutation(self._ds.num_examples())
        self._pos = 0
        self._epoch += 1

    def batch(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        return self._ds.num_examples()

    def __next__(self) -> DataSet:
        if self._pos >= self._ds.num_examples():
            raise StopIteration
        idx = self._order[self._pos:self._pos + self._batch]
        self._pos += self._batch

        def _take(a):
            if a is None:
                return None
            # a host tensor (bf16 features) stays a tensor
            return a[idx] if isinstance(a, torch.Tensor) else \
                np.asarray(a)[idx]

        batch = DataSet(*[_take(a) for a in self._ds.as_tuple()])
        wire = wire_of(self._ds)
        if wire is not None:
            # the uint8 twin sliced with the same rows; a preprocessor
            # drops it again in _pre
            attach_wire(batch, wire[0][idx], wire[1])
        return self._pre(batch)


class ExistingDataSetIterator(DataSetIterator):
    """Wrap a plain iterable of DataSets (reference
    ``ExistingDataSetIterator``)."""

    def __init__(self, source: Iterable[DataSet]):
        self._source = source
        self._it: Optional[Iterator[DataSet]] = None

    def reset(self) -> None:
        self._it = iter(self._source)

    def batch(self) -> int:
        return -1

    def __next__(self) -> DataSet:
        if self._it is None:
            self.reset()
        return self._pre(next(self._it))


class MultipleEpochsIterator(DataSetIterator):
    """Replay an underlying iterator N times as one pass (reference
    ``MultipleEpochsIterator``)."""

    def __init__(self, epochs: int, underlying: DataSetIterator):
        self._epochs = epochs
        self._under = underlying
        self._epoch = 0

    def reset(self) -> None:
        self._epoch = 0
        self._under.reset()

    def batch(self) -> int:
        return self._under.batch()

    def __next__(self) -> DataSet:
        try:
            return self._pre(next(self._under))
        except StopIteration:
            self._epoch += 1
            if self._epoch >= self._epochs:
                raise
            self._under.reset()
            return self._pre(next(self._under))


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch with a bounded queue (reference
    ``AsyncDataSetIterator``: capacity 2, daemon thread).  The worker runs
    the underlying iterator and this iterator's preprocessor; an exception
    raised there is raised again in the consumer.  ``reset()`` and
    ``close()`` tell the worker to stop, drain and join it, so a reset
    abandons the rest of the epoch instead of reading it to the end."""

    _END = object()

    def __init__(self, underlying: DataSetIterator, queue_size: int = 2,
                 use_native: Optional[bool] = None):
        if use_native:
            raise NotImplementedError(
                "the native prefetch ring is not ported yet (ROADMAP A11)")
        self._under = underlying
        self._size = queue_size
        self._queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.native = False

    def _worker(self, out: queue.Queue, stop: threading.Event) -> None:
        try:
            while not stop.is_set():
                out.put(self._pre(next(self._under)))
        except StopIteration:
            pass
        except BaseException as e:  # raised again on the consumer thread
            self._error = e
        finally:
            out.put(self._END)

    def _drain(self) -> None:
        """Stop the worker, empty the bounded queue so a blocked ``put``
        returns, then join it.  Timed gets that re-check ``is_alive``: the
        consumer may already have taken the end marker while the worker
        still runs."""
        t = self._thread
        if t is not None:
            self._stop.set()
            while t.is_alive():
                try:
                    self._queue.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
        self._thread = None
        self._queue = queue.Queue(maxsize=self._size)
        self._stop = threading.Event()
        self._error = None

    def reset(self) -> None:
        self._drain()
        self._under.reset()
        self._thread = threading.Thread(
            target=self._worker, args=(self._queue, self._stop), daemon=True)
        self._thread.start()

    def batch(self) -> int:
        return self._under.batch()

    def close(self) -> None:
        """Stop prefetching: drain and join the worker."""
        self._drain()

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if self._thread is None:
            self.reset()
        item = self._queue.get()
        if item is self._END:
            self._queue.put(self._END)   # a later call ends again
            error, self._error = self._error, None
            if error is not None:
                raise error
            raise StopIteration
        return item
