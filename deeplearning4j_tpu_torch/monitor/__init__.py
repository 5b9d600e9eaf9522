"""Runtime telemetry of the port (port of the metrics and health parts of
``deeplearning4j_tpu/monitor``): a process-global registry of counters,
gauges and histograms (:mod:`.metrics`), the device-side training health
layer with its ``train_health_*`` series and divergence guard
(:mod:`.health`), and the lock factory of the threaded subsystems
(:mod:`.locks`).  Call sites resolve metrics by name through
:func:`registry` at call time.  Tracing, alerts, the flight recorder and
the compile watch of the JAX package are not ported yet.
"""

from __future__ import annotations

from . import health
from .health import TrainingDivergedError
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, registry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "TrainingDivergedError", "counter", "gauge", "health",
           "histogram", "registry", "reset"]


def counter(name: str, help: str = "") -> Counter:
    return registry().counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return registry().gauge(name, help)


def histogram(name: str, help: str = "") -> Histogram:
    return registry().histogram(name, help)


def reset() -> None:
    """Clear every metric and the health layer's overrides and state."""
    registry().clear()
    health.reset()
