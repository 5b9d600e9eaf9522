"""``device_idle`` (``perfbench/readers.py``) on the cells that report
``stream_samples_per_s``."""

from perfbench.readers import device_idle as read  # noqa: F401
