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
  behind the ``DL4J_TPU_FAULT_*`` variables;
- :mod:`.chaos` — the kill/resume parity harness: a training child
  SIGKILLed mid-epoch and resumed, held bitwise against an uninterrupted
  run (``python -m deeplearning4j_tpu_torch.resilience.chaos``).

The JAX package's pod checkpoints (ROADMAP A9) are not ported yet.
"""

from . import chaos, faults
from .checkpoint import (CheckpointCorruptError, CheckpointManager,
                         ResumeState, as_manager, list_checkpoints, restore,
                         verify_checkpoint)

__all__ = [
    "CheckpointCorruptError", "CheckpointManager", "ResumeState",
    "as_manager", "chaos", "faults", "list_checkpoints", "restore",
    "verify_checkpoint",
]
