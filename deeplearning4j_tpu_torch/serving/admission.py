"""SLO-aware admission control: shed load at a p99 latency target (port
of ``deeplearning4j_tpu/serving/admission.py``; pure Python, the same
decisions for the same observations, arrivals and clock).

Without admission the only overload response is ``QueueFull``, a
*capacity* signal that fires long after latency has collapsed: a bounded
queue of 128
requests in front of a 5 ms batcher already carries ~0.6 s of tail
latency before the first rejection.  Production serving (the TF-Serving
load-shedding recipe) admits on the *latency* signal instead: when the
observed p99 crosses the SLO, excess load is shed immediately with a
distinct status, so admitted requests keep meeting the target and
clients get an actionable "overloaded, not full" response.

``SloAdmissionController`` keeps a sliding time window of the same
request latencies that feed the ``serving_request_latency_ms``
histogram (one deque append per completed request) and sheds while the
window p99 exceeds ``slo_p99_ms``.  Window semantics — not the
histogram's lifetime reservoir — are what make shedding self-healing:
once shed load drains and in-flight requests complete under target,
old observations age out of the window and admission reopens.  The
p99 is recomputed at most every ``refresh_s`` (the admission check on
the submit hot path is otherwise a single float compare).

``min_samples`` guards cold starts: with fewer observations in the
window than that, everything is admitted (no latency evidence means no
grounds to shed).

Multi-tenant fairness
---------------------

Every request carries a tenant id (``DEFAULT_TENANT`` when absent), and
the controller keeps the same sliding machinery *per tenant* — latency
window, admitted/shed arrival times, an optional per-tenant SLO, and a
provisioned ``share`` weight — on top of the global window.  The shed
decision is then weighted instead of indiscriminate:

- While the **global** p99 is within the SLO, a tenant is only shed
  when its *own* windowed p99 breaches its *own* (tighter) SLO.
- While the global p99 is breached, the **offender's excess is shed
  first**: a tenant over both its *admitted*-rate share and its
  *offered*-rate share (admits + sheds, each against ``share`` / sum
  of active shares) is an offender and is shed.  A tenant within its
  shares keeps being admitted as long as some OTHER tenant's offered
  rate is over share — the victim test is offered-based on purpose,
  because an offender being 100% shed has an admitted share of zero,
  and an admitted-based test would then declare "nobody over share"
  and shed the victims as collateral (the tenants still being served
  necessarily split 100% of admitted traffic, so one of them is
  always over an admitted-share-only test).  Only when no tenant is
  over its offered share (a correlated slowdown, not a noisy
  neighbour) does the controller fall back to the original
  shed-everyone behaviour.
- An identified offender carries a **penalty hold-down** for
  ``penalty_s`` (default 4x the window): it keeps being shed while it
  stays over its offered share, even after the global p99 recovers.
  Without it the control loop is bang-bang: shedding drains the
  latency window, the "breached" evidence evaporates, and a bursty
  offender gulps straight back in at full rate — transiently
  co-queueing with the victims it was shed to protect — until enough
  fresh latency samples re-arm the breach.  The hold-down bridges the
  evidence gap; it releases early the moment the offender backs off
  under its share (or goes idle), and only engages when the offered
  excess is substantial (past a small margin), so near-share jitter
  between well-behaved tenants never triggers it.

The decision rule is deterministic — pure window state, no sampling —
so a seeded overload replays identically (tests rely on this).

``fair=False`` restores the global (tenant-blind) behaviour; ``enforce=False``
puts the controller in observe-only mode (it accounts windows, rates,
and baselines but never sheds) — the fleet router uses that mode to
*watch* per-tenant posture for the cross-tenant unfairness alert
without double-shedding in front of its workers' own controllers.

Per-tenant label cardinality on /metrics is bounded: tenant ids beyond
``DL4J_TPU_TENANT_MAX_LABELS`` distinct values collapse to the
``other`` label (configured tenants always keep their own label), so
an id-per-user client cannot blow up the registry.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Optional

#: tenant every request without an explicit tenant id belongs to;
#: overridable via ``DL4J_TPU_TENANT_DEFAULT``
DEFAULT_TENANT = os.environ.get("DL4J_TPU_TENANT_DEFAULT", "public")

#: the collapse label unknown tenant ids map to past the cardinality cap
OVERFLOW_TENANT = "other"

#: distinct tenant labels admitted to /metrics before collapsing to
#: ``other`` (configured tenants are always labelled)
ENV_MAX_LABELS = "DL4J_TPU_TENANT_MAX_LABELS"
DEFAULT_MAX_LABELS = 8

#: offered-share excess an offender must exceed before the penalty
#: hold-down engages — near-share jitter between well-behaved tenants
#: (two equal tenants wobbling around 0.5/0.5) must never latch one
#: of them into a penalty
PENALTY_MARGIN = 0.05


def _max_labels() -> int:
    try:
        return max(1, int(os.environ.get(ENV_MAX_LABELS,
                                         DEFAULT_MAX_LABELS)))
    except ValueError:
        return DEFAULT_MAX_LABELS


_SEEN_LOCK = threading.Lock()
_SEEN: set = set()


def normalize_tenant(tenant, known=()) -> str:
    """Map a request's tenant id to its metric/admission label.

    ``None``/empty/non-string ids fall back to :data:`DEFAULT_TENANT`;
    ids in ``known`` (the controller's configured tenants) always keep
    their label; other ids keep theirs until the process has seen
    ``DL4J_TPU_TENANT_MAX_LABELS`` distinct ones, then collapse to
    :data:`OVERFLOW_TENANT` so label cardinality stays bounded.
    """
    if not isinstance(tenant, str) or not tenant:
        return DEFAULT_TENANT
    tenant = tenant.strip()
    if not tenant:
        return DEFAULT_TENANT
    if tenant == DEFAULT_TENANT or tenant in known:
        return tenant
    cap = _max_labels()
    with _SEEN_LOCK:
        if tenant in _SEEN:
            return tenant
        if len(_SEEN) < cap:
            _SEEN.add(tenant)
            return tenant
    return OVERFLOW_TENANT


def reset_tenant_labels() -> None:
    """Forget the seen-tenant set (test isolation)."""
    with _SEEN_LOCK:
        _SEEN.clear()


def _p_index(n: int, q: float) -> int:
    """Index of the q-quantile in a sorted list of n values, matching
    the original window-p99 rounding (ceil of q*(n-1))."""
    return min(n - 1, int(q * (n - 1) + 0.999999))


class _TenantState:
    """One tenant's sliding windows: latencies, admit/shed decision
    times, cached quantiles, and the unloaded-p99 baseline (the minimum
    windowed p99 ever computed for it — what 'p99 inflation' is
    measured against)."""

    __slots__ = ("name", "slo_p99_ms", "share", "configured", "lat",
                 "admits", "sheds", "cached_p50", "cached_p99",
                 "cached_at", "baseline_p99", "penalty_until")

    def __init__(self, name: str, slo_p99_ms: Optional[float] = None,
                 share: float = 1.0, configured: bool = False):
        self.name = name
        self.slo_p99_ms = (float(slo_p99_ms) if slo_p99_ms else None)
        self.share = float(share)
        self.configured = configured
        self.lat: deque = deque()      # (t_monotonic, latency_ms)
        self.admits: deque = deque()   # admit decision times
        self.sheds: deque = deque()    # shed decision times
        self.cached_p50: Optional[float] = None
        self.cached_p99: Optional[float] = None
        self.cached_at = float("-inf")
        self.baseline_p99: Optional[float] = None
        self.penalty_until = 0.0       # offender hold-down deadline


class SloAdmissionController:
    """Shed-decision oracle for one engine's latency SLO, with
    per-tenant windows, per-tenant SLOs, and weighted fair shedding."""

    def __init__(self, slo_p99_ms: float, *, window_s: float = 5.0,
                 min_samples: int = 30, refresh_s: float = 0.05,
                 tenants: Optional[Dict[str, dict]] = None,
                 fair: bool = True, enforce: bool = True,
                 penalty_s: Optional[float] = None):
        if slo_p99_ms <= 0:
            raise ValueError("slo_p99_ms must be > 0")
        self.slo_p99_ms = float(slo_p99_ms)
        self.window_s = float(window_s)
        self.penalty_s = (float(penalty_s) if penalty_s is not None
                          else 4.0 * self.window_s)
        self.min_samples = int(min_samples)
        self.tenant_min_samples = max(5, self.min_samples // 3)
        self.refresh_s = float(refresh_s)
        self.fair = bool(fair)
        self.enforce = bool(enforce)
        self._lat: "deque" = deque()     # (t_monotonic, latency_ms)
        self._lock = threading.Lock()
        self._cached_p99: Optional[float] = None
        self._cached_at = float("-inf")
        self._cached_rates: Dict[str, dict] = {}
        self._rates_at = float("-inf")
        self._tenants: Dict[str, _TenantState] = {}
        for name, spec in (tenants or {}).items():
            self.configure_tenant(name, **dict(spec))

    # ------------------------------------------------------------ tenants
    def configure_tenant(self, name: str, *,
                         slo_p99_ms: Optional[float] = None,
                         share: float = 1.0) -> None:
        """Declare a tenant up front: its own p99 SLO (``None`` =
        inherit the global one) and its provisioned ``share`` weight
        (fraction of admitted traffic = share / sum of active shares).
        Configured tenants always keep their own /metrics label."""
        if share <= 0:
            raise ValueError("share must be > 0")
        with self._lock:
            st = self._tenants.get(name)
            if st is None:
                st = self._tenants[name] = _TenantState(name)
            st.slo_p99_ms = float(slo_p99_ms) if slo_p99_ms else None
            st.share = float(share)
            st.configured = True

    def tenant_names(self):
        """Configured tenant names (for label normalization)."""
        with self._lock:
            return tuple(n for n, s in self._tenants.items()
                         if s.configured)

    def normalize(self, tenant) -> str:
        """:func:`normalize_tenant` against this controller's
        configured tenants."""
        return normalize_tenant(tenant, known=self.tenant_names())

    def _tenant_locked(self, name: str) -> _TenantState:
        st = self._tenants.get(name)
        if st is None:
            st = self._tenants[name] = _TenantState(name)
        return st

    # ------------------------------------------------------------ observe
    def observe(self, latency_ms: float,
                tenant: str = DEFAULT_TENANT,
                now: Optional[float] = None) -> None:
        """Record one completed request's end-to-end latency (the same
        value the ``serving_request_latency_ms`` histogram sees) under
        its tenant.  ``now`` overrides the clock for deterministic
        tests."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            self._lat.append((now, float(latency_ms)))
            self._prune_locked(now)
            st = self._tenant_locked(tenant)
            st.lat.append((now, float(latency_ms)))
            self._prune_deque(st.lat, now)

    def _prune_locked(self, now: float) -> None:
        self._prune_deque(self._lat, now)

    def _prune_deque(self, dq: deque, now: float) -> None:
        horizon = now - self.window_s
        while dq and (dq[0][0] if isinstance(dq[0], tuple)
                      else dq[0]) < horizon:
            dq.popleft()

    # ---------------------------------------------------------- quantiles
    def _global_p99_locked(self, now: float) -> Optional[float]:
        if now - self._cached_at < self.refresh_s:
            return self._cached_p99
        self._prune_locked(now)
        if len(self._lat) < self.min_samples:
            p99 = None
        else:
            values = sorted(v for _, v in self._lat)
            p99 = values[_p_index(len(values), 0.99)]
        self._cached_p99 = p99
        self._cached_at = now
        return p99

    def window_p99(self, now: Optional[float] = None) -> Optional[float]:
        """p99 over the sliding window, or None with too few samples.
        Cached for ``refresh_s`` so submit-path checks stay O(1)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            return self._global_p99_locked(now)

    def _tenant_quantiles_locked(self, st: _TenantState, now: float
                                 ) -> None:
        """Refresh one tenant's cached (p50, p99) and fold the p99 into
        its unloaded baseline (the minimum windowed p99 ever seen)."""
        if now - st.cached_at < self.refresh_s:
            return
        self._prune_deque(st.lat, now)
        if len(st.lat) < self.tenant_min_samples:
            st.cached_p50 = st.cached_p99 = None
        else:
            values = sorted(v for _, v in st.lat)
            st.cached_p50 = values[_p_index(len(values), 0.50)]
            st.cached_p99 = values[_p_index(len(values), 0.99)]
            if (st.baseline_p99 is None
                    or st.cached_p99 < st.baseline_p99):
                st.baseline_p99 = st.cached_p99
        st.cached_at = now

    def tenant_p99(self, tenant: str,
                   now: Optional[float] = None) -> Optional[float]:
        """One tenant's windowed p99 (None with too few samples)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            st = self._tenant_locked(tenant)
            self._tenant_quantiles_locked(st, now)
            return st.cached_p99

    def tenant_slow_threshold_ms(self, tenant: str,
                                 now: Optional[float] = None
                                 ) -> Optional[float]:
        """The tenant's windowed p90 — the slowest-decile cut above
        which requests get trace exemplars pinned to their histogram
        bucket (None with too few samples)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            st = self._tenant_locked(tenant)
            self._prune_deque(st.lat, now)
            if len(st.lat) < self.tenant_min_samples:
                return None
            values = sorted(v for _, v in st.lat)
            return values[_p_index(len(values), 0.90)]

    # -------------------------------------------------------------- rates
    def _rates_locked(self, now: float,
                      fresh: bool = False) -> Dict[str, dict]:
        """Per-tenant admitted counts, rate fractions, and provisioned
        share fractions over the window.  Active = any admit/shed
        decision in the window; shares renormalize over active tenants
        (work-conserving: an idle tenant reserves nothing).  Cached
        for ``refresh_s`` like the global p99 — a shed storm makes a
        per-decision O(window) recompute the hot path's biggest cost.
        Introspection (scoreboard, unfairness, offender) passes
        ``fresh=True``: it runs off the hot path and must not report
        decision counts ``refresh_s`` stale."""
        if not fresh and now - self._rates_at < self.refresh_s:
            return self._cached_rates
        active: Dict[str, _TenantState] = {}
        total_admits = 0
        total_offered = 0
        for name, st in self._tenants.items():
            self._prune_deque(st.admits, now)
            self._prune_deque(st.sheds, now)
            if st.admits or st.sheds:
                active[name] = st
                total_admits += len(st.admits)
                total_offered += len(st.admits) + len(st.sheds)
        share_sum = sum(st.share for st in active.values()) or 1.0
        out = {}
        for name, st in active.items():
            frac = (len(st.admits) / total_admits if total_admits
                    else 0.0)
            offered = len(st.admits) + len(st.sheds)
            ofrac = (offered / total_offered if total_offered else 0.0)
            prov = st.share / share_sum
            out[name] = {"admitted": len(st.admits),
                         "shed": len(st.sheds),
                         "admitted_fraction": frac,
                         "offered_fraction": ofrac,
                         "provisioned_fraction": prov,
                         "excess": frac - prov,
                         "offered_excess": ofrac - prov}
        self._cached_rates = out
        self._rates_at = now
        return out

    def offender(self, now: Optional[float] = None) -> Optional[str]:
        """The tenant whose admitted rate most exceeds its provisioned
        share of admitted traffic (None when every active tenant is
        within its share)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            rates = self._rates_locked(now, fresh=True)
        worst, worst_excess = None, 0.0
        for name, r in rates.items():
            if r["excess"] > worst_excess:
                worst, worst_excess = name, r["excess"]
        return worst

    # ----------------------------------------------------------- decision
    def should_shed(self, tenant: str = DEFAULT_TENANT,
                    now: Optional[float] = None) -> Optional[float]:
        """The observed p99 evidence when this tenant's request must be
        shed (reported back to the client), else None (admit).

        Also the accounting point: every decision lands in the tenant's
        admit/shed window, which is what the rate fractions — and hence
        offender determination — are computed from.
        """
        if now is None:
            now = time.monotonic()
        with self._lock:
            st = self._tenant_locked(tenant)
            observed = self._decide_locked(st, now)
            if observed is not None and self.enforce:
                st.sheds.append(now)
                return observed
            st.admits.append(now)
            return None

    def account(self, tenant: str, shed: bool,
                now: Optional[float] = None) -> None:
        """Record an externally-decided admit/shed outcome into the
        tenant's decision window — the fleet router's observe path:
        its *workers* decide (their own enforcing controllers), the
        router only accounts the outcomes so offender/unfairness
        evidence exists at the fleet level."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            st = self._tenant_locked(tenant)
            (st.sheds if shed else st.admits).append(now)

    def _decide_locked(self, st: _TenantState,
                       now: float) -> Optional[float]:
        global_p99 = self._global_p99_locked(now)
        breached = (global_p99 is not None
                    and global_p99 > self.slo_p99_ms)
        if self.fair and now < st.penalty_until:
            # offender hold-down: shedding drains the latency window,
            # so "breached" evaporates while the offender still floods
            # — without the hold-down a bursty offender gulps back in
            # at full rate every time the evidence resets.  The shed
            # decisions themselves keep the offered-rate window warm,
            # so the release test below stays meaningful.
            mine = self._rates_locked(now).get(st.name)
            if mine is not None and mine["offered_excess"] > 0.0:
                if breached:
                    st.penalty_until = now + self.penalty_s
                return (global_p99 if global_p99 is not None
                        else self.slo_p99_ms)
            st.penalty_until = 0.0     # backed off / idle: release
        if not breached:
            # global target holds: only a tenant breaching its OWN
            # (tighter) SLO is shed
            if st.slo_p99_ms is not None:
                self._tenant_quantiles_locked(st, now)
                if (st.cached_p99 is not None
                        and st.cached_p99 > st.slo_p99_ms):
                    return st.cached_p99
            return None
        if not self.fair:
            return global_p99
        rates = self._rates_locked(now)
        mine = rates.get(st.name)
        if (mine is not None and mine["excess"] > 0.0
                and mine["offered_excess"] > 0.0):
            # over BOTH shares: an offender.  The offered-share guard
            # matters when another offender is fully shed — the tenants
            # still being served then split 100% of admitted traffic
            # and would trip an admitted-share-only test as collateral.
            if mine["offered_excess"] > PENALTY_MARGIN:
                st.penalty_until = now + self.penalty_s
            return global_p99
        if any(name != st.name and r["offered_excess"] > 0.0
               for name, r in rates.items()):
            # someone ELSE is the noisy neighbour (offered rate over
            # share — NOT admitted rate, which a fully-shed offender
            # drives to zero): this tenant's traffic stays admitted
            return None
        return global_p99                  # correlated overload: fall
        #                                    back to shed-everyone

    # ----------------------------------------------------------- fairness
    def unfairness(self, now: Optional[float] = None) -> dict:
        """Cross-tenant unfairness evidence: while the global p99 is
        breached and some tenant is over its provisioned share yet
        completely *unshed* in the window, the worst victim-tenant p99
        inflation over its unloaded baseline.  ``ratio`` is 0.0 when
        admission is doing its job (offender being shed, or nobody
        over share, or no victim evidence)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            global_p99 = self._global_p99_locked(now)
            breached = (global_p99 is not None
                        and global_p99 > self.slo_p99_ms)
            rates = self._rates_locked(now, fresh=True)
            unshed_offender = None
            worst_excess = 0.0
            for name, r in rates.items():
                if (r["offered_excess"] > worst_excess
                        and r["shed"] == 0):
                    unshed_offender = name
                    worst_excess = r["offered_excess"]
            ratio, victim = 0.0, None
            if breached and unshed_offender is not None:
                for name, st in self._tenants.items():
                    if name == unshed_offender:
                        continue
                    self._tenant_quantiles_locked(st, now)
                    if (st.cached_p99 is None or not st.baseline_p99):
                        continue
                    r = st.cached_p99 / st.baseline_p99
                    if r > ratio:
                        ratio, victim = r, name
            return {"ratio": round(ratio, 3), "victim": victim,
                    "offender": unshed_offender,
                    "global_p99_ms": global_p99, "breached": breached}

    # -------------------------------------------------------- introspection
    def tenant_snapshot(self, now: Optional[float] = None
                        ) -> Dict[str, dict]:
        """Per-tenant SLO posture: windowed p50/p99 vs the tenant's
        target, decision counts and rate fractions over the window, and
        the unloaded baseline — the ``GET /tenants`` scoreboard rows."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            rates = self._rates_locked(now, fresh=True)
            out = {}
            for name, st in self._tenants.items():
                self._tenant_quantiles_locked(st, now)
                slo = (st.slo_p99_ms if st.slo_p99_ms is not None
                       else self.slo_p99_ms)
                r = rates.get(name, {})
                admitted = r.get("admitted", 0)
                shed = r.get("shed", 0)
                out[name] = {
                    "slo_p99_ms": slo,
                    "share": st.share,
                    "configured": st.configured,
                    "window_p50_ms": st.cached_p50,
                    "window_p99_ms": st.cached_p99,
                    "baseline_p99_ms": st.baseline_p99,
                    "inflation_x": (
                        round(st.cached_p99 / st.baseline_p99, 3)
                        if st.cached_p99 and st.baseline_p99 else None),
                    "slo_ok": (st.cached_p99 is None
                               or st.cached_p99 <= slo),
                    "window_admitted": admitted,
                    "window_shed": shed,
                    "shed_rate": (round(shed / (admitted + shed), 4)
                                  if admitted + shed else 0.0),
                    "admitted_fraction": r.get("admitted_fraction"),
                    "offered_fraction": r.get("offered_fraction"),
                    "provisioned_fraction": r.get(
                        "provisioned_fraction"),
                    "over_share": bool(
                        r.get("offered_excess", 0.0) > 0.0),
                    "penalized": bool(now < st.penalty_until),
                }
            return out

    def snapshot(self) -> dict:
        # window_p99() recomputes past refresh_s — the stale-cache bug
        # was reading _cached_p99 straight, which froze /metrics and
        # stats() at whatever the last *admission check* computed
        p99 = self.window_p99()
        with self._lock:
            n = len(self._lat)
            tenants = sorted(self._tenants)
        return {"slo_p99_ms": self.slo_p99_ms,
                "window_s": self.window_s,
                "window_samples": n,
                "window_p99_ms": p99,
                "fair": self.fair,
                "enforce": self.enforce,
                "tenants": tenants}


def publish_tenant_telemetry(controller: SloAdmissionController,
                             name: str) -> dict:
    """Publish one engine's per-tenant posture onto the process metric
    registry: the ``serving_tenant_p99_ms`` / ``serving_tenant_shed_rate``
    scoreboard gauges and the ``serving_tenant_unfairness`` ratio the
    cross-tenant alert rule thresholds on.  When a tenant's windowed
    p99 breaches its SLO, a ``tenant_slo_violation`` flight-recorder
    bundle captures the full scoreboard (rate-limited by the recorder's
    own per-kind cooldown).  Returns the tenant snapshot it published.
    """
    from .. import monitor as _monitor
    snap = controller.tenant_snapshot()
    unfair = controller.unfairness()
    p99_g = _monitor.gauge(
        "serving_tenant_p99_ms",
        "windowed p99 latency per tenant (admission window)")
    shed_g = _monitor.gauge(
        "serving_tenant_shed_rate",
        "shed fraction of tenant decisions over the admission window")
    for tenant, row in snap.items():
        if row["window_p99_ms"] is not None:
            p99_g.set(row["window_p99_ms"], engine=name, tenant=tenant)
        shed_g.set(row["shed_rate"], engine=name, tenant=tenant)
    _monitor.gauge(
        "serving_tenant_unfairness",
        "worst victim-tenant p99 inflation over its unloaded baseline "
        "while an over-share tenant goes unshed (0 = fair)").set(
        unfair["ratio"], engine=name)
    for tenant, row in snap.items():
        if not row["slo_ok"]:
            _monitor.record_incident("tenant_slo_violation", {
                "engine": name, "tenant": tenant,
                "window_p99_ms": row["window_p99_ms"],
                "slo_p99_ms": row["slo_p99_ms"],
                "unfairness": unfair,
                "scoreboard": snap,
            })
            break
    return snap
