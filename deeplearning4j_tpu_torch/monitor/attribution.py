"""Per-step wall-time attribution + slow-step anomaly detection (port of
``deeplearning4j_tpu/monitor/attribution.py``).

"Why was step N slow" as a machine answer.  The training loop already
measures where host wall-clock goes — the ``phase_*_ms`` histograms
(data staging / jitted-step dispatch / listener callbacks), the
param-server's ``server_lock_wait_seconds`` (no such series in the
port yet: it stays 0), the checkpoint writer's ``checkpoint_write_ms``
and the compile watch's ``jit_compile_ms`` (:mod:`.jit_watch`) —
but nothing combined them into a per-step decomposition or watched the
trend.  This module does both:

- :func:`breakdown` reconstructs the per-component decomposition of
  wall time between two registry snapshots and names the dominant
  component.
- :class:`StepAttributor` is the trend watcher: each :meth:`~
  StepAttributor.tick` (driven by the alert engine's evaluation thread,
  or called directly) diffs the registry against the previous tick,
  computes the mean per-step milliseconds of the interval, and checks
  it against a robust EWMA + MAD band.  An interval whose per-step time
  exceeds ``ewma + k * 1.4826 * MAD`` is a *slow-step anomaly*: it
  increments ``train_step_anomalies_total{component=<dominant>}`` and
  captures a ``slow_step`` flight-recorder bundle naming the dominant
  component and the full decomposition.  The baseline only absorbs
  non-anomalous intervals, so a genuine regression keeps reporting
  instead of normalizing itself away.

MAD (median absolute deviation, scaled by 1.4826 to estimate sigma
under normality) is used instead of a standard deviation so one
straggler interval cannot inflate the band and mask the next one.
"""

from __future__ import annotations

import logging
import statistics
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .metrics import registry

logger = logging.getLogger("deeplearning4j_tpu_torch")

ANOMALIES_TOTAL = "train_step_anomalies_total"

# component -> (metric, stats field, ms-per-unit scale)
COMPONENTS: Dict[str, Tuple[str, str, float]] = {
    "data": ("phase_data_ms", "sum", 1.0),
    "dispatch": ("phase_step_ms", "sum", 1.0),
    "listener": ("phase_listener_ms", "sum", 1.0),
    "lock_wait": ("server_lock_wait_seconds", "sum", 1e3),
    "checkpoint_write": ("checkpoint_write_ms", "sum", 1.0),
    "compile": ("jit_compile_ms", "sum", 1.0),
}

_STEP_METRIC = "phase_step_ms"


def _field_sum(snap: Dict, metric: str, field: str) -> float:
    total = 0.0
    for val in snap.get(metric, {}).get("values", {}).values():
        if isinstance(val, dict):
            total += float(val.get(field, 0.0))
        else:
            total += float(val)
    return total


def _components(snap: Dict) -> Dict[str, float]:
    return {name: _field_sum(snap, metric, field) * scale
            for name, (metric, field, scale) in COMPONENTS.items()}


def _steps(snap: Dict) -> int:
    return int(_field_sum(snap, _STEP_METRIC, "count"))


def breakdown(since: Optional[Dict] = None,
              snap: Optional[Dict] = None) -> Dict[str, Any]:
    """Wall-time decomposition (ms per component) since an earlier
    snapshot (or over the registry's lifetime), plus the per-step view
    and the dominant component."""
    if snap is None:
        snap = registry().snapshot()
    now_ms = _components(snap)
    now_steps = _steps(snap)
    if since is not None:
        base_ms = _components(since)
        components = {k: max(0.0, now_ms[k] - base_ms[k])
                      for k in COMPONENTS}
        steps = max(0, now_steps - _steps(since))
    else:
        components = dict(now_ms)
        steps = now_steps
    total = sum(components.values())
    dominant = max(components, key=lambda k: components[k]) \
        if total > 0 else None
    return {
        "components_ms": {k: round(v, 3) for k, v in components.items()},
        "total_ms": round(total, 3),
        "steps": steps,
        "per_step_ms": round(total / steps, 3) if steps else 0.0,
        "dominant": dominant,
    }


class StepAttributor:
    """EWMA+MAD slow-step detector over registry deltas.

    Single-consumer by design: the alert engine's evaluation pass is
    the one caller of :meth:`tick` in production (tests drive it
    directly), so no internal locking is needed beyond the registry's
    own."""

    def __init__(self, k: float = 4.0, alpha: float = 0.3,
                 warmup_ticks: int = 5, history: int = 64,
                 min_band_ms: float = 1.0):
        self.k = float(k)
        self.alpha = float(alpha)
        self.warmup_ticks = max(1, int(warmup_ticks))
        self.min_band_ms = float(min_band_ms)
        self._ewma: Optional[float] = None
        self._history: deque = deque(maxlen=max(8, int(history)))
        self._last_snap: Optional[Dict] = None
        self.anomalies = 0
        self.last: Optional[Dict[str, Any]] = None

    def _threshold(self) -> Optional[float]:
        if self._ewma is None or len(self._history) < self.warmup_ticks:
            return None
        med = statistics.median(self._history)
        mad = statistics.median(abs(x - med) for x in self._history)
        band = max(self.k * 1.4826 * mad, self.min_band_ms,
                   0.25 * self._ewma)
        return self._ewma + band

    def tick(self, now: Optional[float] = None
             ) -> Optional[Dict[str, Any]]:
        """Diff the registry against the previous tick.  Returns the
        interval's attribution record (``None`` when no step ran), with
        ``anomaly=True`` when the interval breached the band."""
        if now is None:
            now = time.time()
        snap = registry().snapshot()
        prev, self._last_snap = self._last_snap, snap
        if prev is None:
            return None
        bd = breakdown(since=prev, snap=snap)
        if bd["steps"] <= 0:
            return None
        per_step = bd["total_ms"] / bd["steps"]
        threshold = self._threshold()
        anomaly = threshold is not None and per_step > threshold
        record = dict(bd, ts=now, per_step_ms=round(per_step, 3),
                      ewma_ms=(round(self._ewma, 3)
                               if self._ewma is not None else None),
                      threshold_ms=(round(threshold, 3)
                                    if threshold is not None else None),
                      anomaly=anomaly)
        if anomaly:
            self.anomalies += 1
            dominant = bd["dominant"] or "unknown"
            registry().counter(
                ANOMALIES_TOTAL,
                "slow-step anomalies flagged by the EWMA+MAD "
                "attributor, by dominant wall-time component").inc(
                    component=dominant)
            logger.warning(
                "slow-step anomaly: %.1f ms/step (threshold %.1f), "
                "dominant component %s", per_step, threshold, dominant)
            from . import flight_recorder as _flight
            bundle = _flight.record_incident("slow_step", record)
            if bundle is not None:
                record["bundle"] = bundle
        else:
            # only clean intervals feed the baseline: a sustained
            # regression must keep reporting, not normalize itself away
            self._ewma = (per_step if self._ewma is None
                          else self.alpha * per_step
                          + (1.0 - self.alpha) * self._ewma)
            self._history.append(per_step)
        self.last = record
        return record

    def reset(self) -> None:
        self._ewma = None
        self._history.clear()
        self._last_snap = None
        self.anomalies = 0
        self.last = None
