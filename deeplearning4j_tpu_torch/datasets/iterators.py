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
``AsyncDataSetIterator`` prefetches on a Python thread, or, over a plain
shuffled in-memory ``ListDataSetIterator`` (the JAX package's eligibility
rules), on the native ring (``nativeops.NativePrefetcher``, the port's
copy of the JAX package's ``dataloader.cc``): its xorshift shuffle is not
the ``RandomState`` one, and it gives the JAX ring's batches bit for bit.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from .dataset import DataSet, attach_wire, wire_enabled, wire_of


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

    def next_raw(self) -> DataSet:
        """The next batch as the dataset holds its rows, before the
        preprocessor: ``__next__`` is ``_pre(next_raw())``.  The windowed
        ``fit`` draws an affine pixel scaler's uint8 rows this way and
        decodes them on the device (``nn/ingest.wire_source``)."""
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
        return batch

    def __next__(self) -> DataSet:
        return self._pre(self.next_raw())


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
    """Background prefetch with a bounded queue (reference
    ``AsyncDataSetIterator``: capacity 2, daemon thread).

    Over an eligible iterator (an exact ``ListDataSetIterator``, shuffled,
    with host float32 numpy features and labels, no masks, no
    preprocessor, and a batch that divides the rows) the prefetch runs on
    the NATIVE ring (``nativeops.NativePrefetcher``): the per-epoch
    shuffle and the batch gather never touch the GIL.  A dataset with a
    uint8 wire whose rows are a multiple of 4 bytes ships the bytes
    through the float32 ring and gets its wire attached again.
    ``use_native=None`` (the default) and ``True`` take the ring when
    eligible, ``False`` never; anything else runs on the Python thread,
    with the same contract.  The worker there runs the underlying
    iterator and this iterator's preprocessor; an exception raised there
    is raised again in the consumer.  ``reset()`` and ``close()`` tell the
    worker to stop, drain and join it, so a reset abandons the rest of
    the epoch instead of reading it to the end."""

    _END = object()

    def __init__(self, underlying: DataSetIterator, queue_size: int = 2,
                 use_native: Optional[bool] = None):
        self._under = underlying
        self._size = queue_size
        self._queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._native_pf = None
        self._native_left = 0
        self._ring_epoch = 0
        self._ring_wire = None
        self._use_native_req = True if use_native is None else bool(
            use_native)
        self.native = self._use_native_req and self._native_eligible()

    # ------------------------------------------------------------ the ring
    def _native_eligible(self) -> bool:
        from .native_io import native_module
        if native_module() is None:
            return False
        u = self._under
        # exact ListDataSetIterator semantics only: a subclass overriding
        # iteration keeps the Python path, so its override runs
        if not isinstance(u, ListDataSetIterator):
            return False
        if (type(u).__next__ is not ListDataSetIterator.__next__
                or type(u).reset is not ListDataSetIterator.reset):
            return False
        ds = u._ds
        if (ds.features_mask is not None or ds.labels_mask is not None
                or ds.features is None or ds.labels is None):
            return False
        # host float32 only: the ring stores f32 (a tensor, bf16 included,
        # keeps the Python path)
        for a in (ds.features, ds.labels):
            if isinstance(a, torch.Tensor) or \
                    np.asarray(a).dtype != np.float32:
                return False
        if not u._shuffle or u.get_preprocessor() is not None:
            return False
        # the ring drops the tail; it takes over only when there is none
        return ds.num_examples() % u._batch == 0

    def _batches_per_epoch(self) -> int:
        return self._under._ds.num_examples() // self._under._batch

    def _native_next(self) -> DataSet:
        from .native_io import native_module
        if self._native_pf is None:
            u = self._under
            feats_src = np.asarray(u._ds.features, np.float32)
            self._ring_wire = None
            wire = wire_of(u._ds)
            if wire is not None and wire_enabled():
                u8, fmt = wire
                flat = np.ascontiguousarray(u8.reshape(u8.shape[0], -1))
                if flat.shape[1] % 4 == 0:
                    # each uint8 row viewed as D/4 "floats": the ring's
                    # row gathers are dtype-blind, so the permuted rows
                    # view back to the source bytes (4x less ring memory)
                    feats_src = flat.view(np.float32)
                    self._ring_wire = (fmt, u8.shape[1:],
                                       np.asarray(u._ds.features).shape[1:])
            self._native_pf = native_module().NativePrefetcher(
                feats_src, np.asarray(u._ds.labels, np.float32),
                batch=u._batch, capacity=max(2, self._size),
                seed=u._seed + self._ring_epoch)
            if self._native_left <= 0:
                self._native_left = self._batches_per_epoch()
        if self._native_left <= 0:
            raise StopIteration
        self._native_left -= 1
        feats, labels = self._native_pf.next()
        if self._ring_wire is not None:
            fmt, u8_shape, f_shape = self._ring_wire
            u8 = feats.view(np.uint8).reshape((feats.shape[0],) + u8_shape)
            batch = DataSet(
                fmt.decode_host(u8).reshape((feats.shape[0],) + f_shape),
                labels)
            return self._pre(attach_wire(batch, u8, fmt))
        return self._pre(DataSet(feats, labels))

    def _close_ring(self) -> None:
        if self._native_pf is not None:
            self._native_pf.close()
            self._native_pf = None

    # ------------------------------------------------- the Python thread
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
        # eligibility can change between epochs (a preprocessor attached):
        # decide again which path serves the next epoch
        was_native = self.native
        self.native = self._use_native_req and self._native_eligible()
        if was_native and not self.native:
            self._close_ring()
            self._native_left = 0
        if self.native:
            self._drain()
            full = self._batches_per_epoch()
            if self._native_pf is not None and self._native_left not in (
                    0, full):
                # a reset mid-epoch: the ring is mid-permutation, so its
                # leftover batches would straddle two permutations;
                # rebuild it so the new epoch is one clean cover
                self._close_ring()
                self._ring_epoch += 1
            self._native_left = full
            return
        self._drain()
        self._under.reset()
        self._thread = threading.Thread(
            target=self._worker, args=(self._queue, self._stop), daemon=True)
        self._thread.start()

    def batch(self) -> int:
        return self._under.batch()

    def close(self) -> None:
        """Stop prefetching: drain and join the worker, close the ring."""
        self._drain()
        self._close_ring()

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if self.native:
            return self._native_next()
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
