"""Runtime telemetry of the port (port of ``deeplearning4j_tpu/monitor``):
a process-global registry of counters, gauges and histograms with trace
exemplars (:mod:`.metrics`), W3C-propagated trace spans in a ring buffer
(:mod:`.tracing`), the incident flight recorder (:mod:`.flight_recorder`),
the declarative alert engine (:mod:`.alerts`), the device-side training
health layer with its ``train_health_*`` series and divergence guard
(:mod:`.health`), the lock factory of the threaded subsystems
(:mod:`.locks`), and the host phase attribution of the training loop
(:func:`observe_phase`, :func:`phase_breakdown`).  Call sites resolve
metrics by name through :func:`registry` at call time.  The JAX package's
compile watch and step-time attributor are not ported yet (ROADMAP A11),
so ``phase_breakdown``'s compile fields stay 0.
"""

from __future__ import annotations

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
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, registry
from .tracing import (TraceContext, Tracer, attach, current_context,
                      current_trace_hex, detach, new_trace_id,
                      parse_traceparent, span, tracer)

__all__ = [
    "AlertEngine", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Rule", "TraceContext", "Tracer", "TrainingDivergedError",
    "alert_status", "alerts", "attach", "counter", "current_context",
    "current_trace_hex", "default_rules", "detach", "disable_health",
    "enable_health", "flight_recorder", "gauge", "health",
    "health_enabled", "health_snapshot", "histogram", "incident_dir",
    "new_trace_id", "observe_phase", "parse_traceparent",
    "phase_breakdown", "prometheus_text", "record_incident", "registry",
    "reset", "snapshot", "span", "trace_chrome_json", "trace_jsonl",
    "tracer"]

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


def reset() -> None:
    """Clear every metric and trace event, return the health layer to its
    env-configured default state, forget the flight recorder's rate
    limits and drop the global alert engine (test isolation)."""
    registry().clear()
    tracer().clear()
    health.reset()
    flight_recorder.reset_rate_limit()
    alerts.reset()
