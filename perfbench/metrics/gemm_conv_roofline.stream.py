"""``gemm_conv_roofline`` (``perfbench/readers.py``) on the cells that report
``stream_samples_per_s``."""

from perfbench.readers import gemm_conv_roofline as read  # noqa: F401
