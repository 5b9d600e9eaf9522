"""Runtime lock-order race detector: instrumented locks and a cycle check
(port of ``tools/analyze/lockgraph.py``, reporting into the port's own
metrics registry and flight recorder).

The port's threaded tiers (serving, scaleout, streaming, deploy,
resilience) build their locks through ``monitor.locks.make_lock`` with a
stable dotted site name.  Deadlock hazards there are ORDER bugs: thread 1
takes A then B while thread 2 takes B then A.  This module proves the
ordering discipline at runtime:

- :func:`instrumented_lock` wraps ``threading.Lock``/``RLock`` with
  per-thread **held-lock tracking**.  Acquiring B while holding A adds
  the directed edge ``A -> B`` to a process-global graph keyed by the
  lock's *site name* (e.g. ``"serving.engine.placed"``), not the
  instance: lock-order discipline is a property of code sites.
- Every new edge runs a DFS **cycle check**; a cycle is a deadlock
  hazard (two threads interleaving the cycle's edges can deadlock even
  if this run got lucky).  Detection increments
  ``lockgraph_cycles_total``, records the cycle path, and dumps a
  ``lock_cycle`` flight-recorder bundle for the post-mortem.
- **Long holds** (release more than ``DL4J_TPU_LOCK_HOLD_MS``, default
  200 ms, after acquire) and **blocked acquires under a held lock**
  (waiting more than the same threshold for B while holding A) are
  counted per lock name on ``lockgraph_long_holds_total`` /
  ``lockgraph_blocked_acquires_total``; ``lockgraph_edges`` gauges the
  distinct edges seen.

Opt-in and zero-overhead off: ``make_lock`` returns a plain
``threading.Lock`` unless ``DL4J_TPU_LOCK_DEBUG=1``, and decides when the
lock is built, so the flag must be set before the objects whose locks it
should watch are made.  Reentrant acquires of one RLock instance do not
create self-edges (reentrancy is not an ordering hazard); nesting two
*different* instances under one name is ignored for ordering (same-site
shards, e.g. per-chunk locks, are acquired sequentially by design and a
name-level self-edge would be unfalsifiable).

Test surface: :func:`graph` -> :class:`LockGraph` with ``edges()``,
``cycles()``, ``assert_acyclic()``, ``snapshot()``, ``reset()``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

ENV_FLAG = "DL4J_TPU_LOCK_DEBUG"
ENV_HOLD_MS = "DL4J_TPU_LOCK_HOLD_MS"
DEFAULT_HOLD_MS = 200.0

_TRUE = ("1", "true", "yes")


def enabled() -> bool:
    """Whether lock instrumentation is armed (``DL4J_TPU_LOCK_DEBUG=1``)."""
    return os.environ.get(ENV_FLAG, "") in _TRUE


def hold_threshold_s() -> float:
    """Long-hold / blocked-acquire threshold in seconds."""
    try:
        return float(os.environ.get(ENV_HOLD_MS, DEFAULT_HOLD_MS)) / 1e3
    except ValueError:
        return DEFAULT_HOLD_MS / 1e3


def _metrics():
    """The port's monitor package (imported at call time: ``monitor``
    imports this module through ``monitor.locks``)."""
    from .. import monitor as _monitor
    return _monitor


def _flight(kind: str, detail: dict) -> None:
    from ..monitor import record_incident
    record_incident(kind, detail)


class LockGraph:
    """Process-global lock-acquisition-order graph (see module doc)."""

    def __init__(self) -> None:
        # the graph's own mutex is a plain lock, never instrumented —
        # instrumenting it would recurse
        self._mu = threading.Lock()
        self._edges: Dict[Tuple[str, str], int] = {}
        self._adj: Dict[str, set] = {}
        self._cycles: List[Tuple[str, ...]] = []
        self._cycle_keys: set = set()
        self._tls = threading.local()

    # ------------------------------------------------------- thread state
    def _held(self) -> List[dict]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    # ---------------------------------------------------------- recording
    def on_acquired(self, name: str, instance: int, wait_s: float) -> None:
        held = self._held()
        for entry in held:
            if entry["instance"] == instance:
                entry["depth"] += 1      # RLock reentry: no new node
                return
        mon = _metrics()
        if wait_s > hold_threshold_s() and held:
            mon.counter(
                "lockgraph_blocked_acquires_total",
                "lock acquires that blocked past the hold threshold "
                "while the thread already held another lock").inc(
                lock=name)
        new_edges = []
        with self._mu:
            for entry in held:
                a = entry["name"]
                if a == name:
                    continue             # same-site shards: not an order
                key = (a, name)
                if key not in self._edges:
                    new_edges.append(key)
                    self._adj.setdefault(a, set()).add(name)
                self._edges[key] = self._edges.get(key, 0) + 1
            cycles = [self._find_cycle_locked(a, b)
                      for a, b in new_edges]
        held.append({"name": name, "instance": instance,
                     "depth": 1, "t0": time.perf_counter()})
        if new_edges:
            mon.gauge("lockgraph_edges",
                      "distinct lock-order edges observed").set(
                len(self._edges))
        for cyc in cycles:
            if cyc is not None:
                self._report_cycle(cyc)

    def on_released(self, instance: int) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            entry = held[i]
            if entry["instance"] == instance:
                entry["depth"] -= 1
                if entry["depth"] == 0:
                    held.pop(i)
                    held_s = time.perf_counter() - entry["t0"]
                    if held_s > hold_threshold_s():
                        _metrics().counter(
                            "lockgraph_long_holds_total",
                            "lock holds longer than the hold "
                            "threshold").inc(lock=entry["name"])
                return

    # ------------------------------------------------------ cycle finding
    def _find_cycle_locked(self, a: str,
                           b: str) -> Optional[Tuple[str, ...]]:
        """A new edge ``a -> b`` closes a cycle iff ``b`` reaches ``a``;
        returns the cycle path ``(a, b, ..., a)`` or ``None``.  Caller
        holds ``_mu``."""
        path = self._dfs_path(b, a, frozenset((b,)))
        if path is None:
            return None
        return (a,) + path

    def _dfs_path(self, src: str, dst: str,
                  seen: frozenset) -> Optional[Tuple[str, ...]]:
        if src == dst:
            return (src,)
        for nxt in self._adj.get(src, ()):
            if nxt in seen:
                continue
            sub = self._dfs_path(nxt, dst, seen | {nxt})
            if sub is not None:
                return (src,) + sub
        return None

    def _report_cycle(self, cycle: Tuple[str, ...]) -> None:
        # canonical key: rotation-invariant so A->B->A and B->A->B
        # report once
        body = cycle[:-1]
        k = min(range(len(body)), key=lambda i: body[i:] + body[:i])
        key = body[k:] + body[:k]
        with self._mu:
            if key in self._cycle_keys:
                return
            self._cycle_keys.add(key)
            self._cycles.append(cycle)
        _metrics().counter(
            "lockgraph_cycles_total",
            "lock-order cycles (deadlock hazards) detected").inc()
        _flight("lock_cycle", {
            "cycle": " -> ".join(cycle),
            "edges": {f"{a} -> {b}": n
                      for (a, b), n in self.edges().items()},
        })

    # ------------------------------------------------------------ reading
    def edges(self) -> Dict[Tuple[str, str], int]:
        with self._mu:
            return dict(self._edges)

    def cycles(self) -> List[Tuple[str, ...]]:
        with self._mu:
            return list(self._cycles)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "edges": {f"{a} -> {b}": n
                          for (a, b), n in sorted(self._edges.items())},
                "cycles": [" -> ".join(c) for c in self._cycles],
            }

    def assert_acyclic(self) -> None:
        """Raise ``AssertionError`` naming every detected cycle (the
        regression-test gate)."""
        cycles = self.cycles()
        if cycles:
            raise AssertionError(
                "lock-order cycles detected: "
                + "; ".join(" -> ".join(c) for c in cycles))

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._adj.clear()
            self._cycles.clear()
            self._cycle_keys.clear()
        # per-thread held stacks are left alone: live threads still hold
        # what they hold; tests reset between quiescent phases


_GRAPH = LockGraph()


def graph() -> LockGraph:
    return _GRAPH


def reset() -> None:
    _GRAPH.reset()


class InstrumentedLock:
    """``threading.Lock``/``RLock`` wrapper feeding the global
    :class:`LockGraph`.  Duck-types the full lock surface (``acquire`` /
    ``release`` / context manager / ``locked``) so it drops into every
    constructor-swap site unchanged."""

    __slots__ = ("_inner", "_name")

    def __init__(self, name: str, rlock: bool = False):
        self._inner = threading.RLock() if rlock else threading.Lock()
        self._name = str(name)

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        t0 = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _GRAPH.on_acquired(self._name, id(self),
                               time.perf_counter() - t0)
        return ok

    def release(self) -> None:
        self._inner.release()
        _GRAPH.on_released(id(self))

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        if locked is not None:
            return locked()
        # RLock has no locked(); probe without blocking
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self._name!r} {self._inner!r}>"


def instrumented_lock(name: str, rlock: bool = False) -> InstrumentedLock:
    """An instrumented lock registered under ``name`` (dotted site name,
    e.g. ``"streaming.broker.state"``)."""
    return InstrumentedLock(name, rlock=rlock)
