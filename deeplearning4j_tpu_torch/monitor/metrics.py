"""Process-global metrics registry: counters, gauges, histograms (port of
``deeplearning4j_tpu/monitor/metrics.py``).

Every metric is named, optionally labelled, and cheap to update: a
counter ``inc`` is a dict lookup and a float add under a lock; a
histogram ``observe`` also appends to a bounded reservoir used for
p50/p95/p99/p999.  The registry resolves get-or-create by name, so call
sites never hold stale handles across :meth:`MetricsRegistry.clear`.

Two read paths:

- :meth:`MetricsRegistry.snapshot`: a nested plain-dict copy, for tests
  and reports;
- :meth:`MetricsRegistry.prometheus_text`: the text exposition format
  (histograms render as summaries, quantile series plus ``_sum`` and
  ``_count``, and classic cumulative ``_bucket`` series carrying
  OpenMetrics *exemplars*: the trace id of a recent observation that
  landed in that bucket).

Exemplars are captured automatically: when :meth:`Histogram.observe` runs
under an active trace context (:mod:`.tracing`), the ambient trace id is
recorded against the bucket the value falls in (the last
``EXEMPLARS_PER_BUCKET`` per bucket); callers crossing a thread boundary
pass ``exemplar="<32-hex trace id>"`` explicitly.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .tracing import current_context as _current_trace_context

RESERVOIR_SIZE = 2048

# Log-decade (1 / 2.5 / 5) bucket ladder for the classic histogram
# series.  Units are whatever the histogram observes (the latency
# histograms observe milliseconds); the +Inf bucket is implicit.
BUCKET_BOUNDS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)
EXEMPLARS_PER_BUCKET = 4

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    """``{a="x",b="y"}`` with Prometheus escaping, or ``""`` if unlabelled."""
    if not key:
        return ""
    parts = []
    for name, value in key:
        value = value.replace("\\", "\\\\").replace('"', '\\"')
        value = value.replace("\n", "\\n")
        parts.append(f'{name}="{value}"')
    return "{" + ",".join(parts) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def _merge_help(self, help: str) -> None:
        if help and not self.help:
            self.help = help


class _Valued(_Metric):
    """One float per label set: what counters and gauges share."""

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def snapshot(self) -> Dict:
        with self._lock:
            values = {_label_str(k): v for k, v in self._values.items()}
        return {"kind": self.kind, "help": self.help, "values": values}

    def prometheus_lines(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}".rstrip(),
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted(self._values.items())
        if not items:
            items = [((), 0.0)]
        for key, val in items:
            lines.append(f"{self.name}{_label_str(key)} {_fmt(val)}")
        return lines


class Counter(_Valued):
    """Monotonically increasing value, optionally per label set."""

    kind = "counter"


class Gauge(_Valued):
    """Point-in-time value that can go up or down."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class _HistogramSeries:
    __slots__ = ("count", "sum", "min", "max", "reservoir", "buckets",
                 "exemplars")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.reservoir = deque(maxlen=RESERVOIR_SIZE)
        self.buckets = [0] * (len(BUCKET_BOUNDS) + 1)
        # bucket index -> deque of (trace_id hex, value, unix ts)
        self.exemplars: Dict[int, deque] = {}

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        self.reservoir.append(value)
        idx = bisect.bisect_left(BUCKET_BOUNDS, value)
        self.buckets[idx] += 1
        if exemplar:
            dq = self.exemplars.get(idx)
            if dq is None:
                dq = self.exemplars[idx] = deque(
                    maxlen=EXEMPLARS_PER_BUCKET)
            dq.append((exemplar, value, time.time()))

    @staticmethod
    def _quantile(q: float, res: List[float]) -> float:
        if not res:
            return 0.0
        idx = min(len(res) - 1, max(0, int(round(q * (len(res) - 1)))))
        return res[idx]

    def stats(self) -> Dict:
        res = sorted(self.reservoir)
        out = {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self._quantile(0.50, res),
            "p95": self._quantile(0.95, res),
            "p99": self._quantile(0.99, res),
            "p999": self._quantile(0.999, res),
            # exact lifetime tallies over BUCKET_BOUNDS (+Inf last); the
            # reservoir percentiles above are recency-biased
            "buckets": list(self.buckets),
        }
        if self.exemplars:
            out["exemplars"] = {
                _le_str(idx): [{"trace_id": t, "value": v, "ts": ts}
                               for t, v, ts in dq]
                for idx, dq in sorted(self.exemplars.items())}
        return out


class Histogram(_Metric):
    """Distribution of observations; percentiles come from a bounded
    reservoir of the most recent ``RESERVOIR_SIZE`` samples while
    ``count``/``sum`` are exact over the metric's lifetime."""

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._series: Dict[LabelKey, _HistogramSeries] = {}

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels) -> None:
        """Record ``value``.  ``exemplar`` is a 32-hex trace id to pin to
        the bucket this value lands in; when omitted, the ambient trace
        context of the calling thread (if any) supplies it."""
        if exemplar is None:
            ctx = _current_trace_context()
            if ctx is not None:
                exemplar = f"{ctx.trace_id:032x}"
        key = _label_key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistogramSeries()
            series.observe(float(value), exemplar)

    def stats(self, **labels) -> Dict:
        with self._lock:
            series = self._series.get(_label_key(labels))
            return (series or _HistogramSeries()).stats()

    def snapshot(self) -> Dict:
        with self._lock:
            values = {_label_str(k): s.stats()
                      for k, s in self._series.items()}
        return {"kind": self.kind, "help": self.help, "values": values}

    def prometheus_lines(self) -> List[str]:
        # summary form (quantile series + _sum/_count) plus classic
        # cumulative _bucket series
        lines = [f"# HELP {self.name} {self.help}".rstrip(),
                 f"# TYPE {self.name} summary"]
        with self._lock:
            items = sorted(
                ((k, s.stats(), {i: list(dq) for i, dq in
                                 s.exemplars.items()})
                 for k, s in self._series.items()), key=lambda t: t[0])
        for key, st, exemplars in items:
            for q, field in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99"),
                             (0.999, "p999")):
                qkey = key + (("quantile", str(q)),)
                lines.append(f"{self.name}{_label_str(qkey)} "
                             f"{_fmt(st[field])}")
            cum = 0
            for idx, n in enumerate(st["buckets"]):
                cum += n
                bkey = key + (("le", _le_str(idx)),)
                line = f"{self.name}_bucket{_label_str(bkey)} {cum}"
                dq = exemplars.get(idx)
                if dq:
                    trace_id, val, ts = dq[-1]
                    line += (f' # {{trace_id="{trace_id}"}} '
                             f"{_fmt(val)} {ts:.3f}")
                lines.append(line)
            lines.append(f"{self.name}_sum{_label_str(key)} "
                         f"{_fmt(st['sum'])}")
            lines.append(f"{self.name}_count{_label_str(key)} "
                         f"{_fmt(st['count'])}")
        return lines


def _le_str(bucket_idx: int) -> str:
    """The ``le`` label value for a bucket index (``"+Inf"`` for the
    overflow bucket)."""
    if bucket_idx >= len(BUCKET_BOUNDS):
        return "+Inf"
    return _fmt(BUCKET_BOUNDS[bucket_idx])


def _fmt(v: float) -> str:
    # NaN/Inf gauges are legal (a diverged loss IS NaN); the Prometheus
    # text format spells them NaN / +Inf / -Inf
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Name -> metric map with get-or-create semantics."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(name, help)
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{metric.kind}, requested {cls.kind}")
            else:
                metric._merge_help(help)
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, help)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict:
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(metrics)}

    def prometheus_text(self) -> str:
        with self._lock:
            metrics = [m for _, m in sorted(self._metrics.items())]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.prometheus_lines())
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry."""
    return _REGISTRY
