"""Runtime telemetry of the port (port of ``deeplearning4j_tpu/monitor``):
a process-global registry of counters, gauges and histograms with trace
exemplars (:mod:`.metrics`), W3C-propagated trace spans in a ring buffer
(:mod:`.tracing`), the incident flight recorder (:mod:`.flight_recorder`),
the declarative alert engine (:mod:`.alerts`), the device-side training
health layer with its ``train_health_*`` series and divergence guard
(:mod:`.health`), the lock factory of the threaded subsystems
(:mod:`.locks`), and the host phase attribution of the training loop
(:func:`observe_phase`, :func:`phase_breakdown`), the compile watch
(:mod:`.jit_watch`: bucket callables, step-graph captures, decode growth
and the kernel library, counted per signature) that feeds
``phase_breakdown``'s compile fields, and the step-time attributor
(:mod:`.attribution`: per-step wall-time decomposition and EWMA + MAD
slow-step detection, ticked by the alert engine).  Call sites resolve
metrics by name through :func:`registry` at call time.

The dispatch sanitizer (``analyze/sanitizer.py``) is reached through
:func:`sanitize_scenario` and :func:`sanitize_end_warmup`, null unless
``DL4J_TPU_SANITIZE=1``; :func:`system_metrics_persistable` posts a
snapshot of all of this into a ``StatsStorageRouter`` so the dashboard's
overview picks it up unchanged.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

from . import health
from .health import (TrainingDivergedError, disable as disable_health,
                     enable as enable_health, enabled as health_enabled,
                     snapshot as health_snapshot)
from . import flight_recorder
from .flight_recorder import incident_dir, record_incident
from . import alerts
from .alerts import (AlertEngine, Rule, default_rules,
                     status as alert_status)
from . import attribution
from .attribution import StepAttributor, breakdown as wall_breakdown
from . import jit_watch
from .jit_watch import WatchedCall
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, registry
from .tracing import (TraceContext, Tracer, attach, current_context,
                      current_trace_hex, detach, new_trace_id,
                      parse_traceparent, span, tracer)

__all__ = [
    "AlertEngine", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Rule", "StepAttributor", "TraceContext", "Tracer",
    "TrainingDivergedError", "WatchedCall", "alert_status", "alerts",
    "attach", "attribution", "counter", "current_context",
    "current_trace_hex", "default_rules", "detach", "disable_health",
    "enable_health", "flight_recorder", "gauge", "health",
    "health_enabled", "health_snapshot", "histogram", "incident_dir",
    "new_trace_id", "observe_phase", "parse_traceparent",
    "phase_breakdown", "post_system_metrics", "prometheus_text",
    "record_incident", "registry", "reset", "sanitize_end_warmup",
    "sanitize_scenario", "snapshot", "span", "system_metrics_persistable",
    "trace_chrome_json", "trace_jsonl", "jit_watch", "tracer",
    "wall_breakdown"]


def _sanitizer_mod():
    """The port's dispatch sanitizer when armed, else ``None``."""
    from ..analyze import sanitizer as _san
    return _san if _san.enabled() else None


def sanitize_scenario(name: str, units: int = 1, extra: int = 0):
    """Bracket one unit of dispatch-budgeted work (one epoch-cache fit
    group, one serving session step) for the dispatch sanitizer; a null
    context unless ``DL4J_TPU_SANITIZE=1``."""
    san = _sanitizer_mod()
    if san is None:
        return contextlib.nullcontext()
    return san.scenario(name, units=units, extra=extra)


def sanitize_end_warmup() -> None:
    """Tell the armed sanitizer warmup is over: from here on any
    recompile is a contract violation."""
    san = _sanitizer_mod()
    if san is not None:
        san.end_warmup()

# host wall-clock phases of one training loop: "data" = host batch prep
# and transfer, "step" = the train step's dispatch, "listener" = the
# listener callbacks (with the device syncs they force)
_PHASE_HELP = {
    "data": "host data prep + transfer staging per dispatch (ms)",
    "step": "train-step dispatch per iteration (ms)",
    "listener": "host listener callbacks per iteration (ms)",
}


def counter(name: str, help: str = "") -> Counter:
    return registry().counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return registry().gauge(name, help)


def histogram(name: str, help: str = "") -> Histogram:
    return registry().histogram(name, help)


def observe_phase(phase: str, seconds: float, **labels) -> None:
    """Record ``seconds`` of host wall-clock against a training phase
    (``data`` / ``step`` / ``listener``) as a ``phase_<name>_ms``
    histogram observation."""
    registry().histogram(f"phase_{phase}_ms",
                         _PHASE_HELP.get(phase, "")).observe(
        seconds * 1e3, **labels)


def snapshot() -> Dict:
    """Point-in-time copy of every metric; feed it back to
    :func:`phase_breakdown` to get the deltas over a region."""
    return registry().snapshot()


def phase_breakdown(since: Optional[Dict] = None) -> Dict:
    """Per-phase host wall-clock (ms) and compile counts, optionally as a
    delta against an earlier :func:`snapshot`: ``{"data_ms", "step_ms",
    "listener_ms", "compile_ms", "recompiles", "steps"}``."""
    snap = registry().snapshot()

    def _sums(name: str, field: str) -> float:
        total = 0.0
        for key, val in snap.get(name, {}).get("values", {}).items():
            prev = 0.0
            if since is not None:
                prev_val = since.get(name, {}).get("values", {}).get(key)
                if isinstance(prev_val, dict):
                    prev = float(prev_val.get(field, 0.0))
                elif prev_val is not None:
                    prev = float(prev_val)
            total += (float(val.get(field, 0.0))
                      if isinstance(val, dict) else float(val)) - prev
        return total

    return {
        "data_ms": round(_sums("phase_data_ms", "sum"), 3),
        "step_ms": round(_sums("phase_step_ms", "sum"), 3),
        "listener_ms": round(_sums("phase_listener_ms", "sum"), 3),
        "compile_ms": round(_sums("jit_compile_ms", "sum"), 3),
        "recompiles": int(_sums("jit_compiles_total", "sum")),
        "steps": int(_sums("phase_step_ms", "count")),
    }


def prometheus_text() -> str:
    """Prometheus text exposition of every registered metric (the
    ``GET /metrics`` body)."""
    return registry().prometheus_text()


def trace_jsonl(trace_id=None, name=None, limit=None) -> str:
    """One Chrome trace event per line (wrap the lines in ``[...]`` to
    load them in Perfetto or chrome://tracing), filtered by trace id,
    name prefix and a keep-newest limit."""
    return tracer().to_jsonl(trace_id=trace_id, name=name, limit=limit)


def trace_chrome_json(trace_id=None, name=None, limit=None) -> str:
    """A ready-to-load JSON array of Chrome trace events."""
    return tracer().to_chrome_json(trace_id=trace_id, name=name,
                                   limit=limit)


def system_metrics_persistable(model, session_id: str,
                               worker_id: str = "monitor_0"):
    """A stats record carrying the monitor snapshot, shaped so that the
    dashboard's overview renders it unchanged (the ``TYPE_ID`` and the
    ``iteration``/``score``/``memory_rss_mb`` keys ``StatsListener``
    posts), with the whole registry snapshot and the phase breakdown
    under ``monitor``: the JAX package's record, key for key."""
    import resource

    from ..ui.stats_listener import TYPE_ID
    from ..ui.storage import Persistable

    data = {
        "report_type": "update",
        "iteration": int(getattr(model, "iteration", 0)),
        "epoch": int(getattr(model, "epoch", 0)),
        "score": float(model.score()),
        "memory_rss_mb":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        "monitor": {
            "phases": phase_breakdown(),
            "metrics": snapshot(),
        },
    }
    return Persistable(session_id, TYPE_ID, worker_id, time.time(), data)


def post_system_metrics(router, model, session_id: str,
                        worker_id: str = "monitor_0") -> None:
    """Post a :func:`system_metrics_persistable` into a
    ``StatsStorageRouter`` (the second export sink next to ``/metrics``)."""
    router.put_update(system_metrics_persistable(model, session_id,
                                                 worker_id))


def reset() -> None:
    """Clear every metric and trace event, return the health layer to its
    env-configured default state, forget the flight recorder's rate
    limits and drop the global alert engine (test isolation)."""
    registry().clear()
    tracer().clear()
    health.reset()
    flight_recorder.reset_rate_limit()
    alerts.reset()
