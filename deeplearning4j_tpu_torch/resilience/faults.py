"""Deterministic fault injection for the fault-tolerance test surface
(port of ``deeplearning4j_tpu/resilience/faults.py``: the same fault
points, the same ``DL4J_TPU_FAULT_*`` variables).

Chaos engineering needs *reproducible* failures: a preemption that lands
at the same training step every run, a checkpoint that is corrupted the
same way, a network drop that severs the same push.  This module is the
single registry of those fault points; production code calls the cheap
``maybe_*``/``*_enabled`` probes at well-defined places and the probes
are no-ops unless a fault was armed via environment variables
(``DL4J_TPU_FAULT_*``, read at import and on :func:`reset`) or
programmatically via :func:`configure` (tests).

Fault points:

``die_at_step``       SIGKILL this process the first time
                      :func:`maybe_die` sees ``step >= die_at_step`` —
                      the preemption simulator (no atexit handlers, no
                      flushing: exactly what a preempted VM looks like).
``corrupt_checkpoint``  a token count; each token makes the checkpoint
                      writer flip a byte in the finalized file — the
                      bit-rot simulator for detection tests.
``drop_connection``   a token count; each token makes a transport client
                      sever its socket after a request is on the wire but
                      before the ack — the retry/idempotency exerciser
                      (the JAX package's param-server client; the port
                      keeps the probe for the transports still to come).
``slow_worker_ms``    sleep this long at each worker loop head — the
                      straggler simulator.  Accepts ``ms`` (every
                      worker) or ``rank:ms`` (only the worker passing
                      that rank to :func:`slow_worker` sleeps — how the
                      scaleout crossover bench slows exactly one of K
                      processes deterministically while every process
                      shares the same environment).

Every injection increments ``fault_injections_total{point=...}`` in the
metrics registry (except ``die_at_step``, whose process is gone before
any scrape).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional

from .. import monitor as _monitor

ENV_PREFIX = "DL4J_TPU_FAULT_"
INJECTIONS_TOTAL = "fault_injections_total"
_HELP = "deterministic fault injections fired, by fault point"

_lock = threading.Lock()


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(ENV_PREFIX + name)
    return None if raw in (None, "") else int(raw)


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(ENV_PREFIX + name)
    return None if raw in (None, "") else float(raw)


def _parse_slow_worker(raw) -> "tuple[Optional[int], float]":
    """``(target_rank, ms)`` from ``ms`` / ``rank:ms`` / ``(rank, ms)``;
    rank ``None`` means every worker straggles."""
    if raw in (None, "", 0, 0.0):
        return None, 0.0
    if isinstance(raw, tuple):
        rank, ms = raw
        return (None if rank is None else int(rank)), float(ms)
    s = str(raw)
    if ":" in s:
        rank_s, ms_s = s.split(":", 1)
        return int(rank_s), float(ms_s)
    return None, float(s)


def _from_env() -> dict:
    rank, ms = _parse_slow_worker(
        os.environ.get(ENV_PREFIX + "SLOW_WORKER_MS"))
    return {
        "die_at_step": _env_int("DIE_AT_STEP"),
        "corrupt_checkpoint": _env_int("CORRUPT_CHECKPOINT") or 0,
        "drop_connection": _env_int("DROP_CONNECTION") or 0,
        "slow_worker_ms": ms,
        "slow_worker_rank": rank,
    }


_spec = _from_env()


def configure(die_at_step: Optional[int] = None,
              corrupt_checkpoint: int = 0,
              drop_connection: int = 0,
              slow_worker_ms=0.0) -> None:
    """Arm fault points programmatically (tests); overrides the env.
    ``slow_worker_ms`` accepts a float (all workers), ``"rank:ms"``, or
    a ``(rank, ms)`` tuple (one targeted worker)."""
    rank, ms = _parse_slow_worker(slow_worker_ms)
    with _lock:
        _spec["die_at_step"] = die_at_step
        _spec["corrupt_checkpoint"] = int(corrupt_checkpoint)
        _spec["drop_connection"] = int(drop_connection)
        _spec["slow_worker_ms"] = ms
        _spec["slow_worker_rank"] = rank


def reset() -> None:
    """Re-read the env (drops any :func:`configure` overrides)."""
    with _lock:
        _spec.clear()
        _spec.update(_from_env())


def spec() -> dict:
    with _lock:
        return dict(_spec)


def _fired(point: str) -> None:
    _monitor.counter(INJECTIONS_TOTAL, _HELP).inc(point=point)


def maybe_die(step: int) -> None:
    """Preemption point: SIGKILL this process once ``step`` reaches the
    armed threshold.  Call sites place this *after* their checkpoint
    hook so the simulated preemption always has the most recent
    checkpoint behind it (matching a real preemption notice arriving
    between steps)."""
    with _lock:
        at = _spec.get("die_at_step")
    if at is not None and step >= at:
        _fired("die_at_step")
        os.kill(os.getpid(), signal.SIGKILL)


def corrupt_checkpoint() -> bool:
    """Consume one corrupt-checkpoint token (checkpoint writer)."""
    with _lock:
        if _spec.get("corrupt_checkpoint", 0) <= 0:
            return False
        _spec["corrupt_checkpoint"] -= 1
    _fired("corrupt_checkpoint")
    return True


def drop_connection() -> bool:
    """Consume one drop-connection token (transport client)."""
    with _lock:
        if _spec.get("drop_connection", 0) <= 0:
            return False
        _spec["drop_connection"] -= 1
    _fired("drop_connection")
    return True


def slow_worker(rank: Optional[int] = None) -> None:
    """Straggler point: sleep ``slow_worker_ms`` if armed.  A targeted
    spec (``rank:ms``) only slows the worker whose ``rank`` matches —
    call sites that know their rank pass it; untargeted specs slow
    every caller regardless."""
    with _lock:
        ms = _spec.get("slow_worker_ms", 0.0)
        target = _spec.get("slow_worker_rank")
    if not ms or ms <= 0:
        return
    if target is not None and rank != target:
        return
    _fired("slow_worker_ms")
    time.sleep(ms / 1000.0)


def corrupt_file(path: str) -> None:
    """Flip one byte in the middle of ``path`` (the bit-rot injector the
    checkpoint writer and tests share — deterministic position so a
    corrupted file is corrupted the same way every run)."""
    size = os.path.getsize(path)
    if size == 0:
        return
    pos = size // 2
    with open(path, "r+b") as fh:
        fh.seek(pos)
        b = fh.read(1)
        fh.seek(pos)
        fh.write(bytes([b[0] ^ 0xFF]))
        fh.flush()
        os.fsync(fh.fileno())
