"""``htod_ms`` (``perfbench/readers.py``) on the cells that report
``stream_samples_per_s``."""

from perfbench.readers import htod_ms as read  # noqa: F401
