"""Incident flight recorder: dump the observable state at failure time
(port of ``deeplearning4j_tpu/monitor/flight_recorder.py``: the same
bundle layout, limits and environment knobs).

When something goes wrong at runtime — a divergence abort, an SLO shed,
a serving queue overflow, a corrupt checkpoint — the metrics and spans
that explain it are sitting in in-process ring buffers that die with the
process (or get overwritten by the next thousand requests).
:func:`record_incident` snapshots them to disk as a small **incident
bundle** the moment the event fires, so the post-mortem starts from the
state *at* the incident, not whatever survived until someone curled
``/trace``.

Bundle layout (one directory per incident under :func:`incident_dir`)::

    <ms-since-epoch>_<kind>_<pid>/
        meta.json     # kind, detail, ts, pid/host/argv, env + config
        spans.json    # {"complete": [...], "active": [...]} — the trace
                      # ring incl. still-open spans (the interrupted work)
        metrics.json  # full registry snapshot (incl. exemplars)
        health.json   # training-health state (divergence counters etc.)

The recorder is deliberately boring and safe to call from failure paths:

- **Never raises** — any I/O error returns ``None``.
- **Bounded** — only the newest ``DL4J_TPU_FLIGHT_KEEP`` (default 16)
  bundles are kept; older ones are pruned on each write.
- **Rate-limited** — at most one bundle per ``kind`` per
  ``DL4J_TPU_FLIGHT_MIN_INTERVAL_S`` seconds (default 30), so a shedding
  storm produces one bundle, not ten thousand.
- **Optional** — ``DL4J_TPU_FLIGHT_DISABLE=1`` turns it off entirely.

Wired-in incident kinds: ``divergence`` (health guard),
``slo_shed`` (admission control shed a request), ``queue_full`` (serving
backpressure), ``checkpoint_corrupt`` (manifest verification failure),
``tenant_slo_violation`` (a tenant's windowed p99 over its SLO),
``rollout_rollback`` (a canary rolled back) and ``alert_<rule>`` (an
alert rule started firing).  Anything else may call :func:`record_incident` with its own
kind string.
"""

from __future__ import annotations

import os
import shutil
import socket
import sys
import tempfile
import threading
import time
from typing import Any, Dict, Optional

from . import health as _health
from ..utils.fileio import atomic_write_json
from .metrics import registry
from .tracing import current_context, tracer

ENV_DIR = "DL4J_TPU_FLIGHT_DIR"
ENV_KEEP = "DL4J_TPU_FLIGHT_KEEP"
ENV_MIN_INTERVAL = "DL4J_TPU_FLIGHT_MIN_INTERVAL_S"
ENV_DISABLE = "DL4J_TPU_FLIGHT_DISABLE"

DEFAULT_KEEP = 16
DEFAULT_MIN_INTERVAL_S = 30.0

# Env prefixes worth keeping in meta.json — the knobs that change runtime
# behaviour, not the whole (possibly secret-bearing) environment.
_ENV_PREFIXES = ("DL4J_TPU_", "TORCH_", "PYTORCH_", "CUDA_")

_lock = threading.Lock()
_last_by_kind: Dict[str, float] = {}


def incident_dir() -> str:
    """Where bundles land: ``$DL4J_TPU_FLIGHT_DIR`` or
    ``<tmp>/dl4j_tpu_flight``."""
    return os.environ.get(ENV_DIR) or os.path.join(
        tempfile.gettempdir(), "dl4j_tpu_flight")


def _keep() -> int:
    try:
        return max(1, int(os.environ.get(ENV_KEEP, DEFAULT_KEEP)))
    except ValueError:
        return DEFAULT_KEEP


def _min_interval() -> float:
    try:
        return float(os.environ.get(ENV_MIN_INTERVAL,
                                    DEFAULT_MIN_INTERVAL_S))
    except ValueError:
        return DEFAULT_MIN_INTERVAL_S


def _enabled() -> bool:
    return os.environ.get(ENV_DISABLE, "") not in ("1", "true", "yes")


def reset_rate_limit() -> None:
    """Forget per-kind rate-limit state (tests)."""
    with _lock:
        _last_by_kind.clear()


def _write_json(path: str, obj: Any) -> None:
    # atomic: a bundle is read by humans mid-incident; a torn JSON file
    # during a crash loop would point the post-mortem at the recorder
    atomic_write_json(path, obj, indent=1, default=str)


def _prune(parent: str, keep: int) -> None:
    try:
        names = sorted(n for n in os.listdir(parent)
                       if os.path.isdir(os.path.join(parent, n)))
    except OSError:
        return
    for name in names[:-keep] if len(names) > keep else []:
        shutil.rmtree(os.path.join(parent, name), ignore_errors=True)


def record_incident(kind: str, detail: Optional[Dict[str, Any]] = None,
                    config: Optional[Dict[str, Any]] = None
                    ) -> Optional[str]:
    """Dump an incident bundle; returns its directory path, or ``None``
    when disabled, rate-limited, or on any I/O failure (this runs on
    failure paths — it must never make things worse)."""
    if not _enabled():
        return None
    now = time.monotonic()
    with _lock:
        last = _last_by_kind.get(kind)
        if last is not None and (now - last) < _min_interval():
            return None
        _last_by_kind[kind] = now
    try:
        parent = incident_dir()
        os.makedirs(parent, exist_ok=True)
        wall = time.time()
        bundle = os.path.join(
            parent, f"{int(wall * 1000):013d}_{kind}_{os.getpid()}")
        os.makedirs(bundle, exist_ok=True)

        ctx = current_context()
        meta = {
            "kind": kind,
            "detail": detail or {},
            "ts": wall,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "argv": list(sys.argv),
            "python": sys.version.split()[0],
            "trace_id": f"{ctx.trace_id:032x}" if ctx else None,
            "env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith(_ENV_PREFIXES)},
            "config": config or {},
        }
        _write_json(os.path.join(bundle, "meta.json"), meta)
        t = tracer()
        _write_json(os.path.join(bundle, "spans.json"),
                    {"complete": t.events(), "active": t.active_spans()})
        _write_json(os.path.join(bundle, "metrics.json"),
                    registry().snapshot())
        _write_json(os.path.join(bundle, "health.json"),
                    _health.snapshot())
        _prune(parent, _keep())
        registry().counter(
            "flight_recorder_incidents_total",
            "incident bundles written by the flight recorder").inc(
                kind=kind)
        return bundle
    except Exception:
        return None
