"""deeplearning4j_tpu_torch: the PyTorch/CUDA port of ``deeplearning4j_tpu``.

A second package beside the JAX one, mirroring its module paths.  It
imports ``torch`` and numpy, never ``jax`` and nothing of
``deeplearning4j_tpu``.  The hot kernels (flash attention forward, dK/dV
and dQ backward) are hand-written CUDA for Hopper (``sm_90a``) under
``ops/csrc/``, built with ``nvcc`` at first use into ``build/kernels/``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`.device`); on the CPU every kernel wrapper
uses its plain PyTorch version.
"""

from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"
