"""``other_kernel_ms`` (``perfbench/readers.py``) on the cells that report
``train_samples_per_s``."""

from perfbench.readers import other_kernel_ms as read  # noqa: F401
