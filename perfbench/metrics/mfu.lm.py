"""``mfu`` (``perfbench/readers.py``) on the language-model training
cell: three forwards' matrix-product FLOPs a sequence (the experts at
top-k, attention's causal half) at the traced window's rate over the
card's bf16 peak."""

from perfbench.readers import mfu as read  # noqa: F401
