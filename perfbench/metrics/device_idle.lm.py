"""``device_idle`` (``perfbench/readers.py``) on the language-model
training cell."""

from perfbench.readers import device_idle as read  # noqa: F401
