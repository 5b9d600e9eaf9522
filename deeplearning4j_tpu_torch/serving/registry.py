"""Multi-model multiplexing with LRU weight paging under a device memory
budget (port of ``deeplearning4j_tpu/serving/registry.py``).

One serving process, N named models: the TensorFlow-Serving shape (one
server multiplexing many models with batching and load shedding).  The
constraint that makes this non-trivial on an accelerator is device
memory: N models' weights rarely fit resident at once, and a naive
server either runs out of memory at load time or pins one model forever.

Each registered model wraps an :class:`InferenceEngine` whose placed
device weights can be dropped (``release_device_buffers``) and placed
again (``ensure_resident``) without invalidating its bucket callables
(weights are call operands, not baked constants).
The registry keeps an ``OrderedDict`` of entries in recency order; a
request for a paged-out model triggers page-in, evicting
least-recently-used residents until the placed bytes fit
``hbm_budget_bytes``.

Page-in cost is a device copy of the weights (plus first-touch bucket
callables, which ``warmup()`` front-loads); page-out is dropping Python
references: in-flight batches hold their own, so eviction never corrupts
a running dispatch, and the caching allocator gets the memory back once
they are done.  int8-quantized engines (``quantize="int8"``) cost ~4x fewer
resident bytes, so the same budget holds correspondingly more models —
the economics the accuracy gate in ``tests/test_serving_registry.py``
buys.

Telemetry: ``serving_model_residency{model=}`` (1/0),
``serving_model_evictions_total{model=}``,
``serving_model_pageins_total{model=}`` and
``serving_registry_resident_bytes``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional

from .. import monitor as _monitor
from ..monitor.locks import make_lock
from .engine import InferenceEngine, ServingError


class UnknownModel(ServingError, KeyError):
    """Request for a model name this registry does not host."""


class _Entry:
    __slots__ = ("engine", "pinned")

    def __init__(self, engine: InferenceEngine, pinned: bool):
        self.engine = engine
        self.pinned = pinned


class ModelRegistry:
    """N named models behind one process, paged LRU under an HBM budget.

    >>> reg = ModelRegistry(hbm_budget_bytes=256 << 20)
    >>> reg.register("mnist", mlp_engine)
    >>> reg.register("chat", rnn_engine)
    >>> y = reg.predict("mnist", x)                  # pages in if needed
    >>> y = reg.predict("chat", x_t, session="s-1")  # session routing
    >>> reg.stop_all()

    ``hbm_budget_bytes=None`` disables paging (everything stays
    resident).  A single model larger than the budget still serves —
    it pages in alone with everything else evicted (the budget is a
    target, not a hard cap, because refusing to serve is worse).
    """

    def __init__(self, hbm_budget_bytes: Optional[int] = None):
        if hbm_budget_bytes is not None and hbm_budget_bytes <= 0:
            raise ValueError("hbm_budget_bytes must be positive or None")
        self._budget = hbm_budget_bytes
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._lock = make_lock("serving.registry", rlock=True)

    # ----------------------------------------------------------- hosting
    def register(self, name: str, engine: InferenceEngine, *,
                 pinned: bool = False, start: bool = True,
                 warmup_shape=None) -> InferenceEngine:
        """Host ``engine`` under ``name``.  ``pinned=True`` exempts it
        from eviction (latency-critical tenants).  ``warmup_shape``
        front-loads every bucket compile at registration time so first
        traffic never traces."""
        name = str(name)
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            if start:
                engine.start()
            if warmup_shape is not None:
                engine.warmup(warmup_shape)
            self._entries[name] = _Entry(engine, bool(pinned))
            # registration counts as use: page it in under the budget
            self._page_in_locked(name)
        return engine

    def unregister(self, name: str, *, stop: bool = True) -> None:
        with self._lock:
            entry = self._entries.pop(str(name), None)
        if entry is None:
            raise UnknownModel(name)
        if stop:
            entry.engine.stop()
        entry.engine.release_device_buffers()
        self._set_residency(name, False)

    def get(self, name: str) -> InferenceEngine:
        """The engine for ``name`` (no paging side effects)."""
        with self._lock:
            entry = self._entries.get(str(name))
        if entry is None:
            raise UnknownModel(name)
        return entry.engine

    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def __contains__(self, name) -> bool:
        with self._lock:
            return str(name) in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ----------------------------------------------------------- serving
    def predict(self, name: str, features, *,
                session: Optional[str] = None,
                timeout: Optional[float] = None, block: bool = True,
                version: Optional[int] = None,
                tenant: Optional[str] = None):
        """Route one request to ``name``, paging its weights in first.

        With ``session=``, routes through the engine's device-resident
        session cache (one timestep dispatch); otherwise through the
        dynamic batcher.  ``version=`` pins the request to a staged
        weight version (the rollout controller's probe path).
        ``tenant=`` attributes the request for fair admission and
        per-tenant telemetry.  Raises :class:`UnknownModel` /
        ``QueueFull`` / ``SloShed`` per the usual contracts.
        """
        engine = self._touch(name)
        if session is not None:
            return engine.predict_session(session, features,
                                          tenant=tenant)
        return engine.predict(features, timeout=timeout, block=block,
                              version=version, tenant=tenant)

    # --------------------------------------------------------- deployment
    def swap_weights(self, name: str, params, *,
                     net_state=None, version: Optional[int] = None) -> int:
        """Hot-swap ``name``'s served weights (stage + atomic promote,
        zero recompile — executables take weights as call operands).
        Pages the model in first so the swap lands on device under the
        budget.  Returns the new active version.  The canaried path is
        :class:`~deeplearning4j_tpu_torch.deploy.rollout.RolloutController`,
        which drives ``stage_weights``/``set_canary``/``promote``/
        ``rollback`` on the engine directly."""
        engine = self._touch(name)
        v = engine.swap_weights(params, net_state=net_state,
                                version=version)
        with self._lock:
            # a staged/retired tree changes the model's byte footprint;
            # re-run the budget so accounting stays truthful
            self._page_in_locked(str(name))
        return v

    def _touch(self, name: str) -> InferenceEngine:
        """LRU-touch ``name`` and guarantee its weights are resident."""
        with self._lock:
            entry = self._entries.get(str(name))
            if entry is None:
                raise UnknownModel(name)
            self._entries.move_to_end(str(name))
            self._page_in_locked(str(name))
            return entry.engine

    # ------------------------------------------------------------- paging
    def _page_in_locked(self, name: str) -> None:
        entry = self._entries[name]
        engine = entry.engine
        if self._budget is not None:
            need = engine.model_bytes() * (0 if engine.is_resident()
                                           else 1)
            if need:
                self._evict_until_locked(self._budget - need,
                                         keep=name)
        if not engine.is_resident():
            engine.ensure_resident()
            _monitor.counter(
                "serving_model_pageins_total",
                "model weight sets paged onto device").inc(model=name)
        self._set_residency(name, True)
        self._observe_bytes_locked()

    def _evict_until_locked(self, budget: int, keep: str) -> None:
        """Evict least-recently-used unpinned residents until resident
        bytes fit ``budget`` (which may be negative for an oversized
        page-in: then everything evictable goes)."""
        for name, entry in list(self._entries.items()):  # LRU order
            if self._resident_bytes_locked() <= budget:
                return
            if name == keep or entry.pinned:
                continue
            if entry.engine.is_resident():
                entry.engine.release_device_buffers()
                _monitor.counter(
                    "serving_model_evictions_total",
                    "model weight sets paged off device (LRU)").inc(
                    model=name)
                self._set_residency(name, False)

    def _resident_bytes_locked(self) -> int:
        return sum(e.engine.resident_bytes()
                   for e in self._entries.values())

    def _set_residency(self, name: str, resident: bool) -> None:
        _monitor.gauge("serving_model_residency",
                       "1 when the model's weights are on device").set(
            1 if resident else 0, model=name)

    def _observe_bytes_locked(self) -> None:
        _monitor.gauge(
            "serving_registry_resident_bytes",
            "device bytes held by registry-resident model weights").set(
            self._resident_bytes_locked())

    # ------------------------------------------------------- introspection
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes_locked()

    def stats(self) -> dict:
        """Per-model hosting view."""
        with self._lock:
            models = {}
            for name, entry in self._entries.items():
                eng = entry.engine
                es = eng.stats()
                models[name] = {
                    "resident": eng.is_resident(),
                    "pinned": entry.pinned,
                    "model_bytes": eng.model_bytes(),
                    "resident_bytes": eng.resident_bytes(),
                    "quantize": es["quantize"],
                    "queue_depth": es["queue_depth"],
                    "slo_p99_ms": eng.slo_p99_ms,
                    "version": es["active_version"],
                    "canary_version": es["canary_version"],
                    "canary_fraction": es["canary_fraction"],
                    "versions": es["versions"],
                }
            return {
                "hbm_budget_bytes": self._budget,
                "resident_bytes": self._resident_bytes_locked(),
                "models": models,
            }

    # ----------------------------------------------------------- lifecycle
    def stop_all(self) -> None:
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            e.engine.stop()
