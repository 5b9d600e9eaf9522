"""``mfu`` (``perfbench/readers.py``) on the cells that report
``train_samples_per_s``."""

from perfbench.readers import mfu as read  # noqa: F401
