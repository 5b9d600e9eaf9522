"""Runtime telemetry of the port (port of the metrics part of
``deeplearning4j_tpu/monitor``): a process-global registry of counters,
gauges and histograms (:mod:`.metrics`) and the lock factory of the
threaded subsystems (:mod:`.locks`).  Call sites resolve metrics by name
through :func:`registry` at call time.  Tracing, health, alerts and the
compile watch of the JAX package are not ported yet.
"""

from __future__ import annotations

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, registry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "counter",
           "gauge", "histogram", "registry"]


def counter(name: str, help: str = "") -> Counter:
    return registry().counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return registry().gauge(name, help)


def histogram(name: str, help: str = "") -> Histogram:
    return registry().histogram(name, help)
