"""Canary rollout control: page version N+1 in alongside N, measure,
then promote or auto-roll-back (port of
``deeplearning4j_tpu/deploy/rollout.py``); and :class:`FleetCanary`, the
same ramp over a serving fleet's per-worker route fractions
(``serving/fleet.py``).

The state machine::

    IDLE --push()--> CANARY --promote()--> IDLE   (new active version)
                        \\---rollback()--> IDLE   (active unchanged,
                                                   rollout_rollback
                                                   bundle dropped)

``push`` loads a **verified** snapshot from the
:class:`~deeplearning4j_tpu_torch.deploy.store.VersionedWeightStore`
(corruption raises before any weights reach the engine), rebuilds the
host tree in the model's own layout (``tree_from_flat``), stages it into
the :class:`~deeplearning4j_tpu_torch.serving.engine.InferenceEngine`
alongside the active tree, and routes a configurable canary fraction of
live traffic to it.  Staging makes NO bucket callable (they take weights
as call operands), and ``push`` asserts that
(``serving_bucket_compiles_total`` must not move).

``evaluate`` gates the canary on controller-driven probe traffic
(explicit ``version=`` predicts over a held eval set) plus the
per-version latency windows the engine already exports:

- **quality**: canary accuracy must not drop more than
  ``accuracy_drop_tol`` below active (when labels are provided);
  otherwise prediction agreement with the active version must reach
  ``min_agreement``;
- **latency**: canary windowed p99 must stay within ``max_p99_ratio``
  of active p99 (``serving_version_latency_ms``);
- **alerts**: no gate-marked alert rule (``monitor/alerts.py``, e.g.
  training divergence, serving SLO burn, checkpoint corruption) may be
  firing on the process-global engine.

On pass, ``promote`` is the engine's atomic pointer flip (old tree
released to the pager, sessions stay pinned).  On fail, ``rollback``
reverts routing, drops the canary tree and leaves a flight-recorder
bundle tagged ``rollout_rollback`` for the post-mortem.  ``step()``
is the poll-loop unit: push when the store has something newer,
decide when a canary is in flight (what a sidecar thread drives).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .. import monitor as _monitor
from ..monitor.locks import make_lock
from .store import VersionedWeightStore, tree_from_flat

IDLE = "idle"
CANARY = "canary"


class RolloutError(RuntimeError):
    """Control-plane misuse (push while a canary is in flight, promote
    with none staged, ...): refused, never a swap."""


def _predict_all(engine, features: np.ndarray,
                 version: int) -> np.ndarray:
    """Probe the whole eval set through one version, split into
    engine-sized requests (each also feeds the per-version latency
    window the p99 gate reads)."""
    step = max(1, engine._policy.max_batch_size)
    outs = [np.asarray(engine.predict(features[i:i + step],
                                      version=version))
            for i in range(0, len(features), step)]
    return np.concatenate(outs, axis=0)


def _serving_compiles(model: str) -> float:
    snap = _monitor.snapshot().get("serving_bucket_compiles_total", {})
    total = 0.0
    for labels, v in snap.get("values", {}).items():
        if f'engine="{model}"' in labels or labels == "":
            total += v
    return total


class RolloutController:
    """Drives one model's zero-downtime deployments from a weight store.

    >>> ctl = RolloutController(registry, "mnist", store,
    ...                         canary_fraction=0.2,
    ...                         eval_features=Xe, eval_labels=ye)
    >>> ctl.step()     # pushes when the store has a newer version
    >>> ctl.step()     # evaluates the canary -> promote or rollback
    """

    def __init__(self, registry, model: str, store: VersionedWeightStore,
                 *, canary_fraction: float = 0.2,
                 eval_features=None, eval_labels=None,
                 min_agreement: float = 0.98,
                 accuracy_drop_tol: float = 0.02,
                 max_p99_ratio: float = 3.0,
                 min_probe_rounds: int = 3):
        self.registry = registry
        self.model = str(model)
        self.store = store
        self.canary_fraction = float(canary_fraction)
        self.eval_features = (None if eval_features is None
                              else np.asarray(eval_features))
        self.eval_labels = (None if eval_labels is None
                            else np.asarray(eval_labels))
        self.min_agreement = float(min_agreement)
        self.accuracy_drop_tol = float(accuracy_drop_tol)
        self.max_p99_ratio = float(max_p99_ratio)
        self.min_probe_rounds = max(1, int(min_probe_rounds))
        self.state = IDLE
        self.history: List[Dict[str, Any]] = []
        self.last_bundle: Optional[str] = None
        self.quarantined: set = set()
        self._probe_rounds = 0
        self._lock = make_lock("deploy.rollout", rlock=True)
        eng = registry.get(self.model)
        _monitor.gauge("deploy_version",
                       "active served weight version").set(
            eng.active_version, model=self.model)

    # ------------------------------------------------------------ engine
    def _engine(self):
        # route through the registry so a paged-out model pages back in
        return self.registry._touch(self.model)

    # ----------------------------------------------------------- actions
    def push(self, version: Optional[int] = None) -> int:
        """Stage store ``version`` (default: newest) as the canary.

        Verifies the snapshot (SHA-256 manifest — corruption raises
        :class:`~deeplearning4j_tpu_torch.deploy.store.
        WeightStoreCorruptError` with no engine change), asserts the
        zero-recompile invariant, and starts routing the canary
        fraction.  Returns the staged version."""
        with self._lock:
            if self.state == CANARY:
                raise RolloutError(
                    f"a canary (v{self._engine().canary_version}) is "
                    "already in flight; promote or rollback first")
            if version is None:
                version = self.store.latest()
            if version is None:
                raise RolloutError("weight store is empty")
            if int(version) in self.quarantined:
                raise RolloutError(
                    f"store version {version} was rolled back; publish "
                    "a newer version instead of re-pushing it")
            engine = self._engine()
            if int(version) <= engine.active_version:
                raise RolloutError(
                    f"store version {version} is not newer than the "
                    f"active version {engine.active_version}")
            snap = self.store.load(int(version))      # verified or raises
            tree = tree_from_flat(engine._model, snap.flat)
            compiles0 = _serving_compiles(self.model)
            v = engine.stage_weights(tree, version=snap.version)
            engine.set_canary(v, self.canary_fraction)
            engine.ensure_resident()   # page the canary tree in NOW
            compiles1 = _serving_compiles(self.model)
            if compiles1 != compiles0:
                # staging must never compile: weights are operands
                engine.rollback()
                raise RolloutError(
                    f"staging v{v} triggered {compiles1 - compiles0:g} "
                    "bucket compiles — weight tree is not "
                    "operand-compatible with the serving executables")
            self.state = CANARY
            self._probe_rounds = 0
            self.history.append({"action": "push", "version": v,
                                 "step": snap.step, "source": snap.source,
                                 "ts": time.time()})
            return v

    def probe(self) -> Optional[Dict[str, Any]]:
        """One probe round: send the eval set through BOTH versions
        (explicit ``version=`` routing) and return the comparison —
        feeds the latency windows and the quality gate."""
        with self._lock:
            engine = self._engine()
            cv = engine.canary_version
            if cv is None or self.eval_features is None:
                return None
            av = engine.active_version
        xa = self.eval_features
        out_a = _predict_all(engine, xa, av)
        out_c = _predict_all(engine, xa, cv)
        pred_a = np.argmax(out_a, axis=-1)
        pred_c = np.argmax(out_c, axis=-1)
        res: Dict[str, Any] = {
            "active_version": av, "canary_version": cv,
            "agreement": float(np.mean(pred_a == pred_c)),
        }
        if self.eval_labels is not None:
            y = self.eval_labels
            y = np.argmax(y, axis=-1) if y.ndim > 1 else y
            res["active_acc"] = float(np.mean(pred_a == y))
            res["canary_acc"] = float(np.mean(pred_c == y))
        with self._lock:
            self._probe_rounds += 1
        return res

    def evaluate(self) -> Dict[str, Any]:
        """Run one probe round and compute the gate verdict
        (``{"pass": bool, "reasons": [...], ...}``)."""
        res = self.probe() or {}
        engine = self._engine()
        cv, av = engine.canary_version, engine.active_version
        if cv is None:
            raise RolloutError("no canary in flight")
        reasons: List[str] = []
        ok = True
        if "canary_acc" in res:
            if res["canary_acc"] < res["active_acc"] \
                    - self.accuracy_drop_tol:
                ok = False
                reasons.append(
                    f"canary accuracy {res['canary_acc']:.3f} drops >"
                    f"{self.accuracy_drop_tol:.3f} below active "
                    f"{res['active_acc']:.3f}")
        elif "agreement" in res:
            if res["agreement"] < self.min_agreement:
                ok = False
                reasons.append(
                    f"agreement {res['agreement']:.3f} < "
                    f"{self.min_agreement:.3f}")
        hist = _monitor.histogram(
            "serving_version_latency_ms",
            "request latency per served weight version")
        sa = hist.stats(model=self.model, version=str(av))
        sc = hist.stats(model=self.model, version=str(cv))
        if sa["count"] >= 20 and sc["count"] >= 20 and sa["p99"] > 0:
            ratio = sc["p99"] / sa["p99"]
            res["p99_ratio"] = round(ratio, 3)
            if ratio > self.max_p99_ratio:
                ok = False
                reasons.append(
                    f"canary p99 {sc['p99']:.1f} ms is {ratio:.2f}x "
                    f"active p99 {sa['p99']:.1f} ms "
                    f"(limit {self.max_p99_ratio}x)")
        # extra canary gate: never promote while a gate-marked alert
        # (divergence, SLO burn, shed storm, checkpoint corruption) is
        # firing — the incident may well be the canary's fault, and a
        # promote would make it the only version left to roll back to
        firing = _monitor.alerts.gating_alerts()
        if firing:
            ok = False
            reasons.append("alert(s) firing: " + ", ".join(firing))
            res["alerts_firing"] = firing
        res["pass"] = ok
        res["reasons"] = reasons
        return res

    def promote(self) -> int:
        """Atomic pointer flip to the canary version."""
        with self._lock:
            engine = self._engine()
            cv = engine.canary_version
            if cv is None:
                raise RolloutError("no canary in flight to promote")
            v = engine.promote(cv)
            self.state = IDLE
            self._probe_rounds = 0
            _monitor.counter("deploy_promotions_total",
                             "canary versions promoted to active").inc(
                model=self.model)
            self.history.append({"action": "promote", "version": v,
                                 "ts": time.time()})
            return v

    def rollback(self, reason: str = "manual") -> Optional[int]:
        """Revert routing to 100% active, drop the canary tree, and
        leave a ``rollout_rollback`` flight-recorder bundle.  The
        rolled-back version is quarantined: ``step()`` will not re-push
        it (the engine's monotonic stage guard would refuse anyway) —
        the fix ships as a NEWER store version."""
        with self._lock:
            engine = self._engine()
            cv = engine.rollback()
            if cv is not None:
                self.quarantined.add(cv)
            self.state = IDLE
            self._probe_rounds = 0
            _monitor.counter("deploy_rollbacks_total",
                             "canary versions auto/manually rolled "
                             "back").inc(model=self.model)
            self.last_bundle = _monitor.record_incident(
                "rollout_rollback", {
                    "model": self.model,
                    "rolled_back_version": cv,
                    "active_version": engine.active_version,
                    "reason": reason,
                })
            self.history.append({"action": "rollback", "version": cv,
                                 "reason": reason, "ts": time.time()})
            return cv

    # ---------------------------------------------------------- poll loop
    def step(self) -> str:
        """One control-loop tick.  IDLE: push if the store holds a
        version newer than active.  CANARY: probe; once
        ``min_probe_rounds`` rounds have accumulated, evaluate and
        promote or auto-rollback.  Returns the action taken
        (``"push"``/``"probe"``/``"promote"``/``"rollback"``/
        ``"noop"``)."""
        with self._lock:
            if self.state == IDLE:
                head = self.store.latest()
                if head is not None \
                        and head > self._engine().active_version \
                        and head not in self.quarantined:
                    self.push(head)
                    return "push"
                return "noop"
            # CANARY
            if self._probe_rounds < self.min_probe_rounds - 1:
                self.probe()
                return "probe"
            verdict = self.evaluate()
            if verdict["pass"]:
                self.promote()
                return "promote"
            self.rollback(reason="; ".join(verdict["reasons"])
                          or "gate failed")
            return "rollback"

    # ------------------------------------------------------ introspection
    def status(self) -> Dict[str, Any]:
        engine = self.registry.get(self.model)
        return {
            "model": self.model,
            "state": self.state,
            "active_version": engine.active_version,
            "canary_version": engine.canary_version,
            "canary_fraction": engine.canary_fraction,
            "store_head": self.store.latest(),
            "store_dir": self.store.directory,
            "probe_rounds": self._probe_rounds,
            "gates": {
                "min_agreement": self.min_agreement,
                "accuracy_drop_tol": self.accuracy_drop_tol,
                "max_p99_ratio": self.max_p99_ratio,
                "min_probe_rounds": self.min_probe_rounds,
            },
            "last_bundle": self.last_bundle,
            "quarantined": sorted(self.quarantined),
            "history": self.history[-10:],
        }


class FleetCanary:
    """Per-worker route-fraction canary: the fleet-level generalization
    of the engine's in-process ``canary_fraction``.

    One worker — typically freshly respawned so it warmed the newest
    store version — starts at a small fraction of the router's
    sessionless traffic and ramps through ``schedule`` one ``step()``
    at a time, as long as the worker stays healthy and the router's
    windowed p99 stays under ``max_p99_ms``.  Any breach drops the
    worker back to ``fallback_fraction`` and pins the canary ABORTED
    (a new ``FleetCanary`` restarts the ramp).  Session traffic is
    untouched: affinity is a correctness contract, not a dial.
    """

    RAMPING, DONE, ABORTED = "ramping", "done", "aborted"

    def __init__(self, router, worker: str,
                 schedule=(0.05, 0.25, 0.5, 1.0),
                 max_p99_ms: Optional[float] = None,
                 fallback_fraction: float = 0.0):
        if not schedule:
            raise ValueError("schedule must not be empty")
        self.router = router
        self.worker = str(worker)
        self.schedule = tuple(float(f) for f in schedule)
        self.max_p99_ms = max_p99_ms
        self.fallback_fraction = float(fallback_fraction)
        self.state = self.RAMPING
        self._idx = -1
        self.history: List[Dict[str, Any]] = []

    def _healthy(self) -> bool:
        view = {w["name"]: w for w in self.router.status()["workers"]}
        return bool(view.get(self.worker, {}).get("healthy"))

    def step(self) -> str:
        """One ramp tick: ``"ramp"`` (advanced one schedule notch),
        ``"done"`` (full fraction reached), or ``"abort"`` (health or
        p99 breach — fraction dropped to the fallback)."""
        if self.state == self.ABORTED:
            return "abort"
        p99 = self.router.window_p99_ms()
        breach = (not self._healthy()
                  or (self.max_p99_ms is not None and p99 is not None
                      and p99 > self.max_p99_ms))
        if breach:
            self.state = self.ABORTED
            self.router.set_route_fraction(self.worker,
                                           self.fallback_fraction)
            _monitor.counter(
                "fleet_canary_aborts_total",
                "fleet route-fraction canaries rolled back").inc(
                worker=self.worker)
            self.history.append({"action": "abort", "p99_ms": p99})
            return "abort"
        if self._idx + 1 >= len(self.schedule):
            self.state = self.DONE
            return "done"
        self._idx += 1
        fraction = self.schedule[self._idx]
        self.router.set_route_fraction(self.worker, fraction)
        self.history.append({"action": "ramp", "fraction": fraction,
                             "p99_ms": p99})
        return "ramp"

    def status(self) -> Dict[str, Any]:
        return {"worker": self.worker, "state": self.state,
                "fraction": (self.schedule[self._idx]
                             if 0 <= self._idx < len(self.schedule)
                             else None),
                "schedule": list(self.schedule),
                "max_p99_ms": self.max_p99_ms,
                "history": self.history[-10:]}
