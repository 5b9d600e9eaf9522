"""``mfu`` (``perfbench/readers.py``) on the cells that report
``stream_samples_per_s``."""

from perfbench.readers import mfu as read  # noqa: F401
