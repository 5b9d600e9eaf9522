"""Shape bucketing for the dynamic-batching inference engine (port of
``deeplearning4j_tpu/serving/bucketing.py``).

A serving path that forwards raw request shapes to the model sees an
unbounded set of (batch, time) shapes under real traffic.  A fixed
*bucket ladder* bounds it: every coalesced batch is zero-padded up to the
nearest ladder entry, so the set of shapes the model ever sees (one
inference callable each, ``MultiLayerNetwork.compile_output``) is small,
known ahead of time and warmable at startup.

Two bucketed axes:

- **batch**: powers of two up to ``max_batch_size`` (the ladder always
  contains ``max_batch_size`` itself, power of two or not).  Batch-axis
  padding rows are inert for row-independent inference; they are sliced
  off before results are returned.
- **time** (optional, for sequence inputs): a configurable ladder of
  timestep counts.  Time padding is trailing, and a features mask marks
  the real steps, so causal and masked layers reproduce the unpadded
  result.

``padding_waste`` quantifies the cost of the ladder: the fraction of
padded elements that carry no real data.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def batch_ladder(max_batch_size: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch_size``, always including the max
    itself: ``batch_ladder(24) == (1, 2, 4, 8, 16, 24)``."""
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    ladder = []
    b = 1
    while b < max_batch_size:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch_size)
    return tuple(ladder)


class BucketPolicy:
    """Maps raw request shapes onto the fixed bucket ladder.

    ``timestep_buckets`` (optional, ascending) enables time bucketing
    for sequence inputs (rank >= 3, layout ``(batch, time, ...)``); a
    request longer than the largest bucket is rejected rather than
    silently truncated.
    """

    def __init__(self, max_batch_size: int = 32,
                 timestep_buckets: Optional[Sequence[int]] = None):
        self.max_batch_size = int(max_batch_size)
        self.batch_buckets = batch_ladder(self.max_batch_size)
        self.timestep_buckets: Tuple[int, ...] = tuple(
            sorted(int(t) for t in (timestep_buckets or ())))
        if any(t < 1 for t in self.timestep_buckets):
            raise ValueError("timestep buckets must be >= 1")

    def describe(self) -> str:
        """Stable one-line identity of the ladder: two engines agree on
        it iff their ladders match."""
        return (f"serving-buckets:b{list(self.batch_buckets)}"
                f":t{list(self.timestep_buckets)}")

    def batch_bucket(self, n_rows: int) -> int:
        """Smallest ladder entry >= ``n_rows``."""
        if n_rows < 1:
            raise ValueError("batch must have at least one row")
        if n_rows > self.max_batch_size:
            raise ValueError(
                f"batch of {n_rows} rows exceeds max_batch_size="
                f"{self.max_batch_size}; split the request")
        for b in self.batch_buckets:
            if b >= n_rows:
                return b
        return self.max_batch_size  # unreachable

    def time_bucket(self, n_steps: int) -> int:
        """Smallest timestep bucket >= ``n_steps`` (identity when time
        bucketing is off — the exact length becomes its own bucket)."""
        if not self.timestep_buckets:
            return int(n_steps)
        for t in self.timestep_buckets:
            if t >= n_steps:
                return t
        raise ValueError(
            f"sequence of {n_steps} steps exceeds the largest timestep "
            f"bucket {self.timestep_buckets[-1]}")

    def bucket_count(self, n_sequence_inputs: int = 0) -> int:
        """Upper bound on distinct bucket shapes (= callables) for one
        trailing feature shape: |batch ladder| x |time ladder| per
        sequence input."""
        n = len(self.batch_buckets)
        if n_sequence_inputs and self.timestep_buckets:
            n *= len(self.timestep_buckets) ** n_sequence_inputs
        return n


def pad_rows(x: np.ndarray, n_rows: int) -> np.ndarray:
    """Zero-pad axis 0 up to ``n_rows`` (no-op when already there)."""
    if x.shape[0] == n_rows:
        return x
    if x.shape[0] > n_rows:
        raise ValueError(f"cannot pad {x.shape[0]} rows down to {n_rows}")
    pad = [(0, n_rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


def pad_time(x: np.ndarray, n_steps: int) -> np.ndarray:
    """Zero-pad axis 1 (time) up to ``n_steps``: trailing, so causal
    recurrences are unaffected even without a mask."""
    if x.ndim < 3:
        raise ValueError("time padding needs rank >= 3 (batch, time, ...)")
    if x.shape[1] == n_steps:
        return x
    if x.shape[1] > n_steps:
        raise ValueError(f"cannot pad {x.shape[1]} steps down to {n_steps}")
    pad = [(0, 0), (0, n_steps - x.shape[1])] + [(0, 0)] * (x.ndim - 2)
    return np.pad(x, pad)


def time_mask(n_real_steps: int, n_steps: int, n_rows: int,
              dtype=np.float32) -> np.ndarray:
    """(rows, steps) mask: 1 for the first ``n_real_steps``, 0 for the
    trailing pad, the shape masked recurrent layers consume."""
    m = np.zeros((n_rows, n_steps), dtype=dtype)
    m[:, :n_real_steps] = 1.0
    return m


def assemble_batch(arrays: Sequence[np.ndarray], batch_bucket: int,
                   time_bucket: Optional[int] = None,
                   mask_dtype=np.float32):
    """Concatenate per-request arrays for ONE model input and pad to the
    bucket shape.

    Returns ``(padded, mask, real_rows, waste)`` where ``mask`` is the
    (bucket_rows, bucket_steps) features mask (``None`` when
    ``time_bucket`` is), ``real_rows`` the unpadded row count, and
    ``waste`` the padded-element fraction carrying no real data.
    """
    real_elems = float(sum(a.size for a in arrays))
    if time_bucket is not None:
        masks = [time_mask(a.shape[1], time_bucket, a.shape[0], mask_dtype)
                 for a in arrays]
        arrays = [pad_time(a, time_bucket) for a in arrays]
        mask = np.concatenate(masks, axis=0) if len(masks) > 1 else masks[0]
    else:
        mask = None
    x = np.concatenate(arrays, axis=0) if len(arrays) > 1 else arrays[0]
    real_rows = x.shape[0]
    x = pad_rows(x, batch_bucket)
    if mask is not None:
        mask = pad_rows(mask, batch_bucket)
    waste = 1.0 - (real_elems / x.size) if x.size else 0.0
    return x, mask, real_rows, waste
