"""``other_kernel_ms`` (``perfbench/readers.py``) on the language-model
training cell: device ms a step in every kernel that is not a GEMM, a
grouped expert GEMM or K1-K3 (norms, the convolution's taps, routing and
its permutation, the loss, the updater)."""

from perfbench.readers import other_kernel_ms as read  # noqa: F401
