"""Fault-tolerant training runtime (port of ``deeplearning4j_tpu/
resilience``):

- :mod:`.checkpoint` — preemption-safe checkpointing: atomic
  temp+fsync+rename zip writes with a per-entry SHA-256 manifest,
  rolling ``keep_last``/``keep_best`` retention, a background writer
  thread, and full fit-resume state (params, updater, layer state, the
  fit generator, epoch/iteration and the step offset in the epoch), so
  kill-and-resume is bit-identical to an uninterrupted run on the
  epoch-cache path;
- :mod:`.faults` — deterministic fault injection (``die_at_step`` /
  ``corrupt_checkpoint`` / ``drop_connection`` / ``slow_worker_ms``)
  behind the ``DL4J_TPU_FAULT_*`` variables.

The JAX package's pod checkpoints (ROADMAP A9) and its kill/resume
harness ``chaos.py`` (A7) are not ported yet.
"""

from . import faults
from .checkpoint import (CheckpointCorruptError, CheckpointManager,
                         ResumeState, as_manager, list_checkpoints, restore,
                         verify_checkpoint)

__all__ = [
    "CheckpointCorruptError", "CheckpointManager", "ResumeState",
    "as_manager", "faults", "list_checkpoints", "restore",
    "verify_checkpoint",
]
