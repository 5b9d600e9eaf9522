"""In-process alert engine: declarative rules over the metrics registry
(port of ``deeplearning4j_tpu/monitor/alerts.py``: the same rules, kinds,
hysteresis and transitions).

The repo emits rich telemetry (metrics, spans, flight bundles, the
sanitizer) but until now nothing *watched* it — a diverged run or a
burned serving SLO was only discovered when a human read a dashboard.
This module closes the loop: a small set of declarative rules is
evaluated periodically over :meth:`MetricsRegistry.snapshot` by a
background thread (or deterministically via
:meth:`AlertEngine.evaluate_once` in tests and ``chip_smoke.py``),
with hysteresis so a single noisy sample cannot flap an alert.

Rule kinds (the ``kind`` field):

``threshold``
    Compare an instantaneous value against a bound.  ``metric`` names a
    counter/gauge (its value) or a histogram (pick a stat via ``field``,
    e.g. ``"p99"``).  With ``labels=None`` every series is checked and
    the *worst* one decides.
``increase``
    The summed delta of a (cumulative) counter over the trailing
    ``window_s`` seconds must stay below ``threshold``.  Deltas come
    from the engine's own sample ring; before the ring covers the
    window, the oldest sample is used (and on the very first evaluation
    the delta is taken from zero, so a pre-seeded burst still fires
    within one interval).
``burn_rate``
    Google-SRE multi-window multi-rate SLO burn over a latency
    histogram.  A *bad event* is an observation above ``slo_ms``
    (counted exactly from the histogram's cumulative bucket ladder —
    see ``stats()["buckets"]``).  For each ``(window_s, factor)`` in
    ``windows`` the observed burn rate is
    ``bad_fraction / (1 - objective)``; the rule breaches only when
    EVERY window exceeds its factor (the short window gives fast
    detection, the long window suppresses blips).
``absence``
    Staleness.  With ``timestamp_gauge=True`` the metric's value is a
    unix timestamp (e.g. ``train_health_last_dispatch_ts``) and the
    rule breaches when ``now - value > stale_after_s``.  Otherwise the
    rule breaches when a previously-seen metric disappears from the
    snapshot, or none of its series changed for ``stale_after_s``
    (evaluated only once the engine itself has been watching at least
    that long, so startup is never "stale").

Hysteresis: a rule must breach ``for_intervals`` consecutive
evaluations to transition to ``firing`` (intermediate state
``pending``), and must then be clean for ``clear_intervals``
consecutive evaluations to return to ``ok`` — both directions damped,
so a metric oscillating around the bound cannot flap.

Every state transition increments
``alert_transitions_total{rule,state}``; the per-rule
``alerts_firing{rule}`` gauge tracks the current state (1 = firing).
A transition *into* firing captures a flight-recorder bundle
(kind ``alert_<rule>``) carrying the full metric snapshot, the span
ring with trace exemplars, and the rule's verdict — the post-mortem
starts at the moment of detection.  ``deploy/rollout.py`` consults
:func:`gating_alerts` as an extra canary gate.

Three default rules read series that the port emits only once the
matching JAX tools are ported (ROADMAP A11): ``sanitizer_violation``
(``sanitizer_violations_total``), ``lockgraph_cycle``
(``lockgraph_cycles_total``) and ``slow_step_anomalies``
(``train_step_anomalies_total``, the step-time attributor's).  They are
kept and stay quiet until then.  For the same reason an engine has no
step-time attributor unless one is passed.

The evaluation cadence of the background thread is
``DL4J_TPU_ALERT_INTERVAL_S`` (default 5 s).
"""

from __future__ import annotations

import bisect
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .locks import make_lock
from .metrics import (BUCKET_BOUNDS, _label_key, _label_str, registry)

logger = logging.getLogger("deeplearning4j_tpu_torch")

ENV_INTERVAL = "DL4J_TPU_ALERT_INTERVAL_S"
DEFAULT_INTERVAL_S = 5.0

OK = "ok"
PENDING = "pending"
FIRING = "firing"

KINDS = ("threshold", "increase", "burn_rate", "absence")
_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

FIRING_GAUGE = "alerts_firing"
TRANSITIONS_TOTAL = "alert_transitions_total"
EVALUATIONS_TOTAL = "alert_evaluations_total"

# How many evaluation snapshots the windowed rules can look back over.
_RING_CAPACITY = 720


class Rule:
    """One declarative alert rule (see the module docstring for the
    per-kind semantics).  Rules are plain data: everything the engine
    needs to evaluate, gate, and explain the alert."""

    def __init__(self, name: str, kind: str, metric: str, *,
                 labels: Optional[Dict[str, str]] = None,
                 field: str = "value",
                 op: str = ">",
                 threshold: float = 0.0,
                 window_s: float = 60.0,
                 slo_ms: float = 50.0,
                 objective: float = 0.99,
                 windows: Optional[Sequence[Tuple[float, float]]] = None,
                 min_events: int = 1,
                 stale_after_s: float = 120.0,
                 timestamp_gauge: bool = False,
                 for_intervals: int = 1,
                 clear_intervals: int = 2,
                 severity: str = "page",
                 gate_deploy: bool = False,
                 description: str = ""):
        if kind not in KINDS:
            raise ValueError(f"unknown rule kind {kind!r}; one of {KINDS}")
        if op not in _OPS:
            raise ValueError(f"unknown comparator {op!r}; one of "
                             f"{tuple(_OPS)}")
        if not (0.0 < objective < 1.0):
            raise ValueError("objective must be in (0, 1)")
        self.name = str(name)
        self.kind = kind
        self.metric = str(metric)
        self.labels = dict(labels) if labels else None
        self.field = field
        self.op = op
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.slo_ms = float(slo_ms)
        self.objective = float(objective)
        self.windows = [(float(w), float(f))
                        for w, f in (windows or ((60.0, 14.4),
                                                 (300.0, 6.0)))]
        self.min_events = max(1, int(min_events))
        self.stale_after_s = float(stale_after_s)
        self.timestamp_gauge = bool(timestamp_gauge)
        self.for_intervals = max(1, int(for_intervals))
        self.clear_intervals = max(1, int(clear_intervals))
        self.severity = str(severity)
        self.gate_deploy = bool(gate_deploy)
        self.description = str(description)

    def spec(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name, "kind": self.kind, "metric": self.metric,
            "severity": self.severity, "gate_deploy": self.gate_deploy,
            "for_intervals": self.for_intervals,
            "clear_intervals": self.clear_intervals,
            "description": self.description,
        }
        if self.labels:
            out["labels"] = dict(self.labels)
        if self.kind == "threshold":
            out.update(field=self.field, op=self.op,
                       threshold=self.threshold)
        elif self.kind == "increase":
            out.update(op=self.op, threshold=self.threshold,
                       window_s=self.window_s)
        elif self.kind == "burn_rate":
            out.update(slo_ms=self.slo_ms, objective=self.objective,
                       windows=list(self.windows),
                       min_events=self.min_events)
        else:
            out.update(stale_after_s=self.stale_after_s,
                       timestamp_gauge=self.timestamp_gauge)
        return out


class _RuleState:
    __slots__ = ("state", "since", "breach_streak", "clear_streak",
                 "last_value", "last_reason", "last_bundle",
                 "transitions", "seen_metric")

    def __init__(self):
        self.state = OK
        self.since: Optional[float] = None
        self.breach_streak = 0
        self.clear_streak = 0
        self.last_value: Optional[float] = None
        self.last_reason = ""
        self.last_bundle: Optional[str] = None
        self.transitions = 0
        self.seen_metric = False


def _series(snap: Dict, metric: str,
            labels: Optional[Dict[str, str]]) -> List[Tuple[str, Any]]:
    """The (label_str, value) series of ``metric`` this rule matches:
    one exact series when ``labels`` is given, else all of them."""
    values = snap.get(metric, {}).get("values", {})
    if labels is not None:
        key = _label_str(_label_key(labels))
        return [(key, values[key])] if key in values else []
    return list(values.items())


def _numeric(value: Any, field: str) -> Optional[float]:
    if isinstance(value, dict):
        v = value.get("count" if field == "value" else field)
        return None if v is None else float(v)
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def _bad_good(value: Any, slo_ms: float) -> Tuple[float, float]:
    """(total, bad) event counts of one histogram series, from the
    cumulative bucket ladder: bad = observations above ``slo_ms``."""
    if not isinstance(value, dict):
        return 0.0, 0.0
    total = float(value.get("count", 0.0))
    buckets = value.get("buckets")
    if not buckets:
        return total, 0.0
    good_idx = bisect.bisect_right(BUCKET_BOUNDS, slo_ms)
    good = float(sum(buckets[:good_idx]))
    return total, max(0.0, total - good)


class AlertEngine:
    """Evaluates rules over registry snapshots; optionally in a
    background daemon thread.  All evaluation is serialized under one
    lock, so :meth:`evaluate_once` from a test and the thread never
    interleave; metric publication and bundle capture happen after the
    lock is released."""

    def __init__(self, rules: Optional[Sequence[Rule]] = None,
                 interval_s: Optional[float] = None,
                 attributor=None):
        rules = list(rules) if rules is not None else default_rules()
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self.rules: List[Rule] = rules
        if interval_s is None:
            try:
                interval_s = float(os.environ.get(ENV_INTERVAL,
                                                  DEFAULT_INTERVAL_S))
            except ValueError:
                interval_s = DEFAULT_INTERVAL_S
        self.interval_s = max(0.05, float(interval_s))
        # an object with ``tick(now=)`` run after each pass (the JAX
        # package's step-time attributor; none by default here)
        self.attributor = attributor
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in rules}
        self._ring: deque = deque(maxlen=_RING_CAPACITY)
        self._windowed_metrics = sorted(
            {r.metric for r in rules if r.kind in ("increase",
                                                   "burn_rate",
                                                   "absence")})
        self._first_eval_ts: Optional[float] = None
        self._lock = make_lock("monitor.alerts")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ window math
    def _at_or_before(self, ts: float) -> Optional[Tuple[float, Dict]]:
        """The newest ring sample not newer than ``ts`` (else the oldest
        sample, so a short ring still yields the widest delta it can)."""
        best = None
        for sample in self._ring:
            if sample[0] <= ts:
                best = sample
            else:
                break
        if best is None and self._ring:
            best = self._ring[0]
        return best

    def _delta_counter(self, rule: Rule, snap: Dict, now: float,
                       window_s: float) -> float:
        prev_values: Dict[str, Any] = {}
        prev = self._at_or_before(now - window_s)
        if prev is not None:
            prev_values = prev[1].get(rule.metric, {}).get("values", {})
        total = 0.0
        for key, val in _series(snap, rule.metric, rule.labels):
            cur = _numeric(val, "value")
            if cur is None:
                continue
            before = _numeric(prev_values.get(key, 0.0), "value") or 0.0
            total += max(0.0, cur - before)
        return total

    def _burn(self, rule: Rule, snap: Dict, now: float,
              window_s: float) -> Tuple[float, float]:
        """(observed_burn, total_events) over one window.  With
        ``labels`` pinned this is that one series' burn; with
        ``labels=None`` every series burns independently and the worst
        series clearing ``min_events`` decides — a per-tenant (or
        per-version) fan-out must page on its worst member, not on an
        aggregate a big healthy tenant can dilute."""
        prev_values: Dict[str, Any] = {}
        prev = self._at_or_before(now - window_s)
        if prev is not None:
            prev_values = prev[1].get(rule.metric, {}).get("values", {})
        worst_burn = 0.0
        worst_total = 0.0
        agg_total = 0.0
        for key, val in _series(snap, rule.metric, rule.labels):
            t1, b1 = _bad_good(val, rule.slo_ms)
            t0, b0 = _bad_good(prev_values.get(key), rule.slo_ms)
            total = max(0.0, t1 - t0)
            bad = max(0.0, b1 - b0)
            agg_total += total
            if total < rule.min_events:
                continue
            burn = (bad / total) / (1.0 - rule.objective)
            if burn >= worst_burn:
                worst_burn, worst_total = burn, total
        if worst_total >= rule.min_events:
            return worst_burn, worst_total
        return 0.0, agg_total

    # ------------------------------------------------------------- evaluation
    def _check(self, rule: Rule, snap: Dict, now: float,
               state: _RuleState) -> Tuple[bool, Optional[float], str]:
        """(breached, value, reason) for one rule against one snapshot."""
        series = _series(snap, rule.metric, rule.labels)
        if series:
            state.seen_metric = True
        if rule.kind == "threshold":
            cmp = _OPS[rule.op]
            worst: Optional[float] = None
            for _, val in series:
                v = _numeric(val, rule.field)
                if v is None:
                    continue
                if worst is None or cmp(v, worst):
                    worst = v
            if worst is None:
                return False, None, "no data"
            if cmp(worst, rule.threshold):
                return True, worst, (
                    f"{rule.metric}[{rule.field}] {worst:g} "
                    f"{rule.op} {rule.threshold:g}")
            return False, worst, ""
        if rule.kind == "increase":
            delta = self._delta_counter(rule, snap, now, rule.window_s)
            if _OPS[rule.op](delta, rule.threshold):
                return True, delta, (
                    f"{rule.metric} +{delta:g} over "
                    f"{rule.window_s:g}s {rule.op} {rule.threshold:g}")
            return False, delta, ""
        if rule.kind == "burn_rate":
            burns = []
            for window_s, factor in rule.windows:
                burn, total = self._burn(rule, snap, now, window_s)
                burns.append((window_s, factor, burn, total))
            if all(burn >= factor and total >= rule.min_events
                   for _, factor, burn, total in burns):
                detail = ", ".join(
                    f"{burn:.1f}x over {w:g}s (>= {f:g}x)"
                    for w, f, burn, _ in burns)
                return True, burns[0][2], (
                    f"{rule.metric} burning error budget "
                    f"(slo {rule.slo_ms:g} ms, objective "
                    f"{rule.objective:g}): {detail}")
            return False, burns[0][2] if burns else None, ""
        # absence / staleness
        if rule.timestamp_gauge:
            newest: Optional[float] = None
            for _, val in series:
                v = _numeric(val, "value")
                if v is not None and (newest is None or v > newest):
                    newest = v
            if newest is None:
                return False, None, "no data"
            age = now - newest
            if age > rule.stale_after_s:
                return True, age, (
                    f"{rule.metric} is {age:.1f}s old "
                    f"(stale after {rule.stale_after_s:g}s)")
            return False, age, ""
        if not state.seen_metric:
            return False, None, "no data"
        if not series:
            return True, None, f"{rule.metric} disappeared from the registry"
        covered = (self._first_eval_ts is not None
                   and now - self._first_eval_ts >= rule.stale_after_s)
        if not covered:
            return False, None, ""
        prev = self._at_or_before(now - rule.stale_after_s)
        if prev is None:
            return False, None, ""
        prev_values = prev[1].get(rule.metric, {}).get("values", {})
        for key, val in series:
            if _numeric(val, "count") != _numeric(
                    prev_values.get(key), "count") \
                    or _numeric(val, "value") != _numeric(
                        prev_values.get(key), "value"):
                return False, None, ""
        return True, None, (
            f"no series of {rule.metric} changed in the last "
            f"{rule.stale_after_s:g}s")

    def evaluate_once(self, now: Optional[float] = None
                      ) -> List[Dict[str, Any]]:
        """One full evaluation pass: snapshot the registry, update the
        sample ring, run every rule through its hysteresis state
        machine, then publish transition metrics and capture bundles for
        rules that just started firing.  Returns the per-rule status
        list (same shape as :meth:`status`'s ``rules``)."""
        if now is None:
            now = time.time()
        snap = registry().snapshot()
        transitions: List[Tuple[Rule, str, str, _RuleState]] = []
        with self._lock:
            if self._first_eval_ts is None:
                self._first_eval_ts = now
            for rule in self.rules:
                state = self._states[rule.name]
                breached, value, reason = self._check(rule, snap, now,
                                                      state)
                state.last_value = value
                if breached:
                    state.breach_streak += 1
                    state.clear_streak = 0
                    state.last_reason = reason
                    if state.state != FIRING:
                        if state.breach_streak >= rule.for_intervals:
                            transitions.append((rule, state.state,
                                                FIRING, state))
                            state.state = FIRING
                            state.since = now
                        elif state.state == OK:
                            transitions.append((rule, OK, PENDING,
                                                state))
                            state.state = PENDING
                            state.since = now
                else:
                    state.breach_streak = 0
                    state.clear_streak += 1
                    if state.state == PENDING or (
                            state.state == FIRING
                            and state.clear_streak
                            >= rule.clear_intervals):
                        transitions.append((rule, state.state, OK,
                                            state))
                        state.state = OK
                        state.since = now
                        state.last_reason = ""
            # keep only the metrics windowed rules read: the ring holds
            # up to _RING_CAPACITY of these per process
            pruned = {m: snap[m] for m in self._windowed_metrics
                      if m in snap}
            self._ring.append((now, pruned))
        self._publish(transitions, snap)
        if self.attributor is not None:
            try:
                self.attributor.tick(now=now)
            except Exception:
                logger.exception("step attributor tick failed")
        # statuses are read after publication so a transition-into-firing
        # already carries its bundle path
        with self._lock:
            return self._status_locked()

    def _publish(self, transitions, snap) -> None:
        reg = registry()
        reg.counter(EVALUATIONS_TOTAL,
                    "alert-engine evaluation passes").inc()
        gauge = reg.gauge(FIRING_GAUGE,
                          "1 while the alert rule is firing, else 0")
        with self._lock:
            states = {r.name: self._states[r.name].state
                      for r in self.rules}
        for name, state in states.items():
            gauge.set(1.0 if state == FIRING else 0.0, rule=name)
        for rule, old, new, state in transitions:
            state.transitions += 1
            reg.counter(
                TRANSITIONS_TOTAL,
                "alert rule state transitions, by entered state").inc(
                    rule=rule.name, state=new)
            if new == FIRING:
                logger.warning("alert %s FIRING: %s", rule.name,
                               state.last_reason)
                from . import flight_recorder as _flight
                bundle = _flight.record_incident(
                    f"alert_{rule.name}", dict(
                        rule.spec(), reason=state.last_reason,
                        value=state.last_value,
                        previous_state=old))
                if bundle is not None:
                    state.last_bundle = bundle
            elif old == FIRING:
                logger.info("alert %s resolved", rule.name)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "AlertEngine":
        """Start the background evaluation thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="dl4j-alerts", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception:
                # the watcher must never die of a malformed snapshot
                logger.exception("alert evaluation pass failed")

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    @property
    def running(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    # ---------------------------------------------------------- introspection
    def _status_locked(self) -> List[Dict[str, Any]]:
        out = []
        for rule in self.rules:
            s = self._states[rule.name]
            out.append(dict(rule.spec(), state=s.state, since=s.since,
                            breach_streak=s.breach_streak,
                            value=s.last_value, reason=s.last_reason,
                            bundle=s.last_bundle,
                            transitions=s.transitions))
        return out

    def status(self) -> Dict[str, Any]:
        """The ``GET /alerts`` body: engine config + per-rule state."""
        with self._lock:
            rules = self._status_locked()
        return {
            "running": self.running,
            "interval_s": self.interval_s,
            "firing": [r["name"] for r in rules if r["state"] == FIRING],
            "rules": rules,
        }

    def firing(self, gate_only: bool = False) -> List[str]:
        """Names of currently-firing rules (optionally only the ones
        marked ``gate_deploy`` — what the canary gate consumes)."""
        with self._lock:
            return [r.name for r in self.rules
                    if self._states[r.name].state == FIRING
                    and (r.gate_deploy or not gate_only)]


def default_rules() -> List[Rule]:
    """The standing rule set, one per failure domain the runtime
    already instruments."""
    return [
        Rule("train_divergence", "threshold", "train_health_state",
             op=">=", threshold=1.0, for_intervals=1, clear_intervals=2,
             severity="page", gate_deploy=True,
             description="training health guard marked the process "
                         "diverged (sticky until health reset)"),
        Rule("train_dispatch_stall", "absence",
             "train_health_last_dispatch_ts", timestamp_gauge=True,
             stale_after_s=300.0, for_intervals=2, clear_intervals=1,
             severity="ticket",
             description="no train-step dispatch for 5 minutes after "
                         "training started"),
        Rule("serving_slo_burn", "burn_rate",
             "serving_version_latency_ms", slo_ms=50.0, objective=0.99,
             windows=((60.0, 14.4), (300.0, 6.0)), min_events=20,
             for_intervals=1, clear_intervals=3, severity="page",
             gate_deploy=True,
             description="serving latency is burning the 99% <=50ms "
                         "error budget on both the fast and slow "
                         "windows"),
        Rule("serving_shed_storm", "increase", "serving_shed_total",
             op=">=", threshold=5.0, window_s=60.0, for_intervals=1,
             clear_intervals=2, severity="page", gate_deploy=True,
             description="SLO admission control shed 5+ requests "
                         "within a minute"),
        Rule("serving_queue_saturation", "increase",
             "serving_rejected_total", op=">=", threshold=5.0,
             window_s=60.0, for_intervals=1, clear_intervals=2,
             severity="ticket",
             description="the bounded serving queue rejected 5+ "
                         "requests within a minute"),
        Rule("checkpoint_corruption", "increase",
             "checkpoint_corrupt_skipped_total", op=">=", threshold=1.0,
             window_s=600.0, for_intervals=1, clear_intervals=2,
             severity="page", gate_deploy=True,
             description="a checkpoint failed manifest verification"),
        Rule("sanitizer_violation", "increase",
             "sanitizer_violations_total", op=">=", threshold=1.0,
             window_s=600.0, for_intervals=1, clear_intervals=2,
             severity="ticket",
             description="the runtime dispatch sanitizer recorded a "
                         "contract violation"),
        Rule("lockgraph_cycle", "increase", "lockgraph_cycles_total",
             op=">=", threshold=1.0, window_s=600.0, for_intervals=1,
             clear_intervals=2, severity="page",
             description="the lock-order watcher observed a deadlock-"
                         "hazard cycle"),
        Rule("slow_step_anomalies", "increase",
             "train_step_anomalies_total", op=">=", threshold=3.0,
             window_s=120.0, for_intervals=1, clear_intervals=2,
             severity="ticket",
             description="the step-time attributor flagged 3+ slow-"
                         "step anomalies within 2 minutes"),
        # labels=None on a tenant-labelled histogram: the worst tenant
        # series decides, so one noisy tenant burning its budget pages
        # even while the aggregate latency looks fine
        Rule("tenant_slo_burn", "burn_rate",
             "serving_tenant_latency_ms", slo_ms=50.0, objective=0.99,
             windows=((60.0, 14.4), (300.0, 6.0)), min_events=20,
             for_intervals=1, clear_intervals=3, severity="page",
             gate_deploy=True,
             description="some tenant's serving latency is burning its "
                         "99% error budget on both the fast and slow "
                         "windows"),
        Rule("tenant_unfairness", "threshold",
             "serving_tenant_unfairness", op=">", threshold=1.5,
             for_intervals=2, clear_intervals=2, severity="page",
             description="cross-tenant unfairness: a victim tenant's "
                         "p99 inflated over 1.5x its unloaded baseline "
                         "while an over-share tenant goes unshed"),
    ]


def fleet_rules(slo_p99_ms: float = 100.0,
                queue_high: float = 32.0) -> List[Rule]:
    """The serving fleet's elastic-scaling triggers, evaluated by the
    router's own private engine (never the process-global one — a
    scale signal must not trip a co-resident trainer's deploy gate).

    Scale OUT when either pressure signal holds: the router-observed
    windowed p99 breaches the SLO, or the summed worker queue depth
    exceeds ``queue_high``.  Scale IN only after a long quiet stretch
    (p99 comfortably under a quarter of the SLO), so the fleet never
    flaps around the threshold."""
    return [
        Rule("fleet_scale_out_p99", "threshold", "fleet_router_p99_ms",
             op=">", threshold=float(slo_p99_ms), for_intervals=2,
             clear_intervals=2, severity="ticket",
             description="fleet windowed p99 over the SLO: add a "
                         "worker"),
        Rule("fleet_scale_out_queue", "threshold", "fleet_queue_depth",
             op=">", threshold=float(queue_high), for_intervals=2,
             clear_intervals=2, severity="ticket",
             description="summed fleet worker queue depth over the "
                         "high-water mark: add a worker"),
        Rule("fleet_scale_in", "threshold", "fleet_router_p99_ms",
             op="<", threshold=float(slo_p99_ms) / 4.0,
             for_intervals=8, clear_intervals=1, severity="ticket",
             description="fleet p99 far under the SLO for a sustained "
                         "window: drain a worker"),
        # the router watches per-tenant posture in observe-only mode;
        # this fires when a victim tenant's p99 inflates while the
        # over-share tenant crosses the front door unshed
        Rule("tenant_unfairness", "threshold",
             "serving_tenant_unfairness", op=">", threshold=1.5,
             for_intervals=2, clear_intervals=2, severity="page",
             description="cross-tenant unfairness at the fleet front "
                         "door: victim p99 inflated over 1.5x its "
                         "unloaded baseline while an over-share tenant "
                         "goes unshed"),
    ]


_GLOBAL_LOCK = threading.Lock()
_ENGINE: Optional[AlertEngine] = None


def engine(rules: Optional[Sequence[Rule]] = None,
           interval_s: Optional[float] = None) -> AlertEngine:
    """The process-global engine, created on first use (with
    :func:`default_rules` unless ``rules`` is given).  The creator's
    arguments win; later calls return the existing engine unchanged."""
    global _ENGINE
    with _GLOBAL_LOCK:
        if _ENGINE is None:
            _ENGINE = AlertEngine(rules=rules, interval_s=interval_s)
        return _ENGINE


def get_engine() -> Optional[AlertEngine]:
    """The global engine if one exists — never creates one (the deploy
    gate and ``GET /alerts`` must not conjure a watcher as a side
    effect of being read)."""
    with _GLOBAL_LOCK:
        return _ENGINE


def gating_alerts() -> List[str]:
    """Names of firing ``gate_deploy`` rules of the global engine
    (empty when no engine exists) — the rollout controller's extra
    canary gate."""
    eng = get_engine()
    return eng.firing(gate_only=True) if eng is not None else []


def status() -> Dict[str, Any]:
    """The ``GET /alerts`` body; a stub when no engine exists."""
    eng = get_engine()
    if eng is None:
        return {"running": False, "interval_s": None, "firing": [],
                "rules": []}
    return eng.status()


def reset() -> None:
    """Stop and drop the global engine (test / bench isolation)."""
    global _ENGINE
    with _GLOBAL_LOCK:
        eng, _ENGINE = _ENGINE, None
    if eng is not None:
        eng.stop()
