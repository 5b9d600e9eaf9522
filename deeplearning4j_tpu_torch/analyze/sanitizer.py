"""Runtime dispatch sanitizer (port of ``tools/analyze/sanitizer.py``,
reporting into the port's own metrics registry and flight recorder).

Armed by ``DL4J_TPU_SANITIZE=1``, it enforces at runtime two contracts
the port's performance work depends on:

- **zero recompiles after warmup**: once the program calls
  :func:`end_warmup` (the warm-up loop done, the serving engine primed),
  a dispatch that builds a NEW signature of a function that already had
  one is a violation: shape churn turned "built once" into
  build-per-step.
- **dispatch-count ceilings per scenario**: :func:`scenario` brackets one
  logical unit of work (one epoch-cache fit group, one serving session
  step) and counts the dispatches inside it against the per-scenario
  budget of ``budgets.json`` beside this file (ceiling = ``units *
  max_dispatches_per_unit + extra``).  The FIRST occurrence of each
  scenario name is warmup: recorded, not enforced.

What one dispatch is in the port (the JAX package's unit is one
``watched_jit`` call): one ``dispatch(...)`` of the epoch-cache fit (on
the card a replay of the captured step per train step inside it), one
model step of ``SessionCache.step`` and one decode-ring growth.  Each
reports through ``monitor.jit_watch`` (:func:`record_dispatch`), whose
per-signature builds say whether the dispatch built (``compiled``) and
whether it built a further signature of the same function
(``recompile``): the captured CUDA graph of a cached train step, the
growth function of a cache length.  Eager steps build nothing.

Violations increment ``sanitizer_violations_total{kind=...}`` (plus the
per-kind counters), drop a ``sanitizer_violation`` flight-recorder
bundle, and, under ``DL4J_TPU_SANITIZE_STRICT=1``, raise
:class:`SanitizerViolation` at the detection site.

Difference from the JAX package: there is no donation audit.  Torch has
no buffer donation, so ``record_donation``,
``sanitizer_donation_misses_total`` and ``DL4J_TPU_SANITIZE_DONATION``
have no counterpart.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

ENV_FLAG = "DL4J_TPU_SANITIZE"
ENV_STRICT = "DL4J_TPU_SANITIZE_STRICT"
ENV_BUDGETS = "DL4J_TPU_SANITIZE_BUDGETS"

_TRUE = ("1", "true", "yes")

DEFAULT_BUDGETS_PATH = os.path.join(os.path.dirname(__file__),
                                    "budgets.json")

VIOLATIONS_TOTAL = "sanitizer_violations_total"
RECOMPILES_TOTAL = "sanitizer_recompiles_after_warmup_total"
BUDGET_EXCEEDED_TOTAL = "sanitizer_dispatch_budget_exceeded_total"


class SanitizerViolation(RuntimeError):
    """A dispatch-discipline contract was broken under strict mode."""


def enabled() -> bool:
    """Whether the sanitizer is armed (``DL4J_TPU_SANITIZE=1``)."""
    return os.environ.get(ENV_FLAG, "") in _TRUE


def strict() -> bool:
    return os.environ.get(ENV_STRICT, "") in _TRUE


def _metrics():
    """The port's monitor package (imported at call time: ``monitor``
    imports this module)."""
    from .. import monitor as _monitor
    return _monitor


def _flight(kind: str, detail: dict) -> None:
    from ..monitor import record_incident
    record_incident(kind, detail)


def load_budgets(path: Optional[str] = None) -> Dict[str, dict]:
    """Per-scenario budgets: ``{name: {"max_dispatches_per_unit": n}}``.
    ``DL4J_TPU_SANITIZE_BUDGETS`` overrides the packaged file."""
    path = path or os.environ.get(ENV_BUDGETS) or DEFAULT_BUDGETS_PATH
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return {}
    return {k: v for k, v in data.items()
            if isinstance(v, dict) and not k.startswith("_")}


class _Scenario:
    __slots__ = ("name", "units", "extra", "dispatches")

    def __init__(self, name: str, units: int, extra: int):
        self.name = name
        self.units = max(1, int(units))
        self.extra = max(0, int(extra))
        self.dispatches = 0


class Sanitizer:
    """Process-global violation collector (see module doc)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._warmup_over = False
        self._seen_scenarios: Dict[str, int] = {}
        self._violations: List[dict] = []
        self._enforced: Dict[str, dict] = {}
        self._budgets: Optional[Dict[str, dict]] = None

    # ------------------------------------------------------------ state
    def budgets(self) -> Dict[str, dict]:
        with self._mu:
            if self._budgets is None:
                self._budgets = load_budgets()
            return self._budgets

    def end_warmup(self) -> None:
        """From here on, any recompile is a violation."""
        with self._mu:
            self._warmup_over = True

    def warmed_up(self) -> bool:
        with self._mu:
            return self._warmup_over

    def violations(self) -> List[dict]:
        with self._mu:
            return list(self._violations)

    def violation_count(self) -> int:
        with self._mu:
            return len(self._violations)

    def enforced(self) -> Dict[str, dict]:
        """Per budgeted scenario, over its enforced occurrences (all but
        the first): ``{"occurrences", "dispatches", "ceilings"}``, the
        dispatches counted and the sum of their ceilings."""
        with self._mu:
            return {k: dict(v) for k, v in self._enforced.items()}

    def reset(self) -> None:
        with self._mu:
            self._warmup_over = False
            self._seen_scenarios.clear()
            self._violations.clear()
            self._enforced.clear()
            self._budgets = None

    def _stack(self) -> List[_Scenario]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # -------------------------------------------------------- recording
    def record_dispatch(self, fn: str, compiled: bool,
                        recompile: bool) -> None:
        """Every dispatch lands here when armed (see the module doc)."""
        for scen in self._stack():
            scen.dispatches += 1
        if recompile and self.warmed_up():
            _metrics().counter(
                RECOMPILES_TOTAL,
                "recompiles observed after sanitize_end_warmup "
                "(each one is shape/static-arg churn)").inc(fn=fn)
            self._violate("recompile_after_warmup", {
                "fn": fn,
                "hint": "a new signature reached an already-built "
                        "function after warmup; see the jit/compile "
                        "trace span for the signature",
            })

    # -------------------------------------------------------- scenarios
    def scenario(self, name: str, units: int = 1, extra: int = 0):
        """Context manager bracketing one unit of budgeted work."""
        return _ScenarioContext(self, name, units, extra)

    def _enter(self, scen: _Scenario) -> None:
        self._stack().append(scen)

    def _exit(self, scen: _Scenario) -> None:
        stack = self._stack()
        if scen in stack:
            stack.remove(scen)
        with self._mu:
            occurrence = self._seen_scenarios.get(scen.name, 0)
            self._seen_scenarios[scen.name] = occurrence + 1
        budget = self.budgets().get(scen.name)
        if budget is None or occurrence == 0:
            return          # unbudgeted, or warmup occurrence
        per_unit = int(budget.get("max_dispatches_per_unit", 0))
        if per_unit <= 0:
            return
        ceiling = scen.units * per_unit + scen.extra
        with self._mu:
            tally = self._enforced.setdefault(
                scen.name, {"occurrences": 0, "dispatches": 0,
                            "ceilings": 0})
            tally["occurrences"] += 1
            tally["dispatches"] += scen.dispatches
            tally["ceilings"] += ceiling
        if scen.dispatches > ceiling:
            _metrics().counter(
                BUDGET_EXCEEDED_TOTAL,
                "scenarios whose dispatch count exceeded the "
                "budgets.json ceiling").inc(scenario=scen.name)
            self._violate("dispatch_budget", {
                "scenario": scen.name, "dispatches": scen.dispatches,
                "ceiling": ceiling, "units": scen.units,
                "extra": scen.extra,
                "hint": "more dispatches than the declared "
                        "contract (e.g. one dispatch per fused epoch "
                        "group) — a fused path degraded to per-step "
                        "dispatch",
            })

    # -------------------------------------------------------- violations
    def _violate(self, kind: str, detail: dict) -> None:
        entry = dict(detail, kind=kind)
        with self._mu:
            self._violations.append(entry)
        _metrics().counter(
            VIOLATIONS_TOTAL,
            "sanitizer contract violations by kind").inc(kind=kind)
        _flight("sanitizer_violation", entry)
        if strict():
            raise SanitizerViolation(f"{kind}: {detail}")


class _ScenarioContext:
    __slots__ = ("_san", "_scen")

    def __init__(self, san: Sanitizer, name: str, units: int,
                 extra: int):
        self._san = san
        self._scen = _Scenario(name, units, extra)

    def __enter__(self) -> _Scenario:
        self._san._enter(self._scen)
        return self._scen

    def __exit__(self, exc_type, exc, tb) -> None:
        # budget enforcement only on the clean path: an exception mid-
        # scenario already surfaces louder than a budget count would
        if exc_type is None:
            self._san._exit(self._scen)
        else:
            stack = self._san._stack()
            if self._scen in stack:
                stack.remove(self._scen)


_SANITIZER = Sanitizer()


def state() -> Sanitizer:
    return _SANITIZER


def end_warmup() -> None:
    _SANITIZER.end_warmup()


def scenario(name: str, units: int = 1, extra: int = 0):
    return _SANITIZER.scenario(name, units=units, extra=extra)


def record_dispatch(fn: str, compiled: bool, recompile: bool) -> None:
    _SANITIZER.record_dispatch(fn, compiled, recompile)


def violations() -> List[dict]:
    return _SANITIZER.violations()


def violation_count() -> int:
    return _SANITIZER.violation_count()


def reset() -> None:
    _SANITIZER.reset()
