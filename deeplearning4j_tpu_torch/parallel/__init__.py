"""Parallelism tier of the port.

- :mod:`sequence` — ring / Ulysses / ring+flash sequence parallelism over
  a list of time shards, one per device (a device may be named more than
  once, which is how one card runs an n-shard ring).
"""

from .sequence import SequenceParallel  # noqa: F401
