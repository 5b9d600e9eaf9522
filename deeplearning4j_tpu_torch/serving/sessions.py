"""Device-resident per-session state for streaming inference (port of
``deeplearning4j_tpu/serving/sessions.py``), for a ``MultiLayerNetwork``
or a ``ComputationGraph``.

``SessionCache`` lifts the network's explicit-carry step to N concurrent
sessions: each session id owns a **state tree** (the per-layer carries)
that stays on the network's device between requests, so a streaming
request runs only its own timesteps, never the prefix again.  The state
tree is whatever the carry contract says it is (a list by layer for a
``MultiLayerNetwork``, a dict by recurrent vertex for a
``ComputationGraph``, whose requests carry one array per network input
and get one output per network output):

- **RNN carries** step through ``rnn_stateless_step``;
- **KV-cache rings** (``CausalSelfAttention``: (batch, heads, cache_len,
  head_dim) K/V tensors and an integer cursor) step through
  ``decode_step``, with a host-tracked position driving a powers-of-two
  **cache-len bucket ladder**: a session that outgrows its ring hops to
  the next bucket through ``grow_decode_carries``.  The host never reads
  a device cursor; position accounting is host arithmetic.

Eviction (both counted in ``serving_session_evictions_total``):

- **TTL**: sessions idle longer than ``ttl_s`` are dropped on the next
  cache operation; dropping a decode session frees its KV ring, visible
  in the ``serving_session_state_bytes`` gauge;
- **capacity**: at ``max_sessions`` the least-recently-used session is
  dropped first.

Thread safety: the cache map has its own lock; each session serializes
its steps on a per-session lock (state is a chain: two concurrent steps
of one session would fork it) while distinct sessions step concurrently.

Version pinning: a session's state tree is a function of the weights that
produced it, so advancing old state with new weights after a swap would
chain two models' dynamics.  Each session records the engine's active
weight version at creation (``version_fn``) and every later step resolves
that same version's weights (``weights_fn``; ``None`` means the network's
live weights) until the session ends or its TTL expires; the engine keeps
a retired version's tree while any session pins it
(:meth:`SessionCache.pinned_versions`).  ``serving_session_version_pinned``
gauges how many live sessions are pinned behind the active version.

Error contract: a batch-size or state-structure mismatch raises
:class:`SessionStateError` naming the offending leaf path, and only
raises: the stored state is untouched (the step never writes into the
carries it is given), so :meth:`SessionCache.clear` or a matching
request fully recovers the session slot.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .. import monitor as _monitor
from ..monitor.locks import make_lock
from .bucketing import batch_ladder


class SessionError(RuntimeError):
    """Session-path failures (unknown or expired ids are NOT errors: a new
    state tree is initialized; batch or structure mismatches, unsupported
    models and overlong decode sessions are)."""


class SessionStateError(SessionError):
    """A request is incompatible with a session's stored state tree (a
    batch-size change mid-session, or a state structure the model no
    longer produces).  ``leaf_path`` names the first offending leaf, in
    the JAX package's ``keystr`` form (``[0][0]`` for the first leaf of
    layer 0's carry).  The stored state is left untouched: ``clear()`` the
    session, or send a matching request, to recover."""

    def __init__(self, message: str, leaf_path: Optional[str] = None):
        super().__init__(message)
        self.leaf_path = leaf_path


# --------------------------------------------------------- state trees
def _leaves_with_path(tree, path: str = ""):
    """(path, leaf) pairs of a nested list/tuple/dict tree (the carries),
    depth first, dict keys sorted as ``jax.tree_util`` walks them, paths
    in its ``keystr`` form (``[0][1]``, ``['lstm'][0]``); an empty
    container has no leaves."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaves_with_path(child, f"{path}[{i}]")
    else:
        yield path, tree


def _structure(tree):
    """The shape of a tree without its leaves: container types, lengths
    and keys (what a JAX treedef compares)."""
    if isinstance(tree, dict):
        return dict, tuple((k, _structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return type(tree), tuple(_structure(c) for c in tree)
    return None


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    # a host int (the ring cursor): an int32 scalar in the JAX package
    return 4


def _tree_nbytes(tree) -> int:
    return sum(_leaf_nbytes(leaf) for _, leaf in _leaves_with_path(tree))


def host_array(out: torch.Tensor) -> np.ndarray:
    """A network output on the host, fp32 where the compute was below it
    (the fp32-logits contract makes that the case only for the pure-bf16
    policy's non-head outputs)."""
    if out.dtype in (torch.bfloat16, torch.float16):
        out = out.float()
    return out.detach().cpu().numpy()


class _Session:
    __slots__ = ("carries", "batch", "last_used", "lock", "steps",
                 "version", "position", "capacity", "state_bytes")

    def __init__(self, carries, batch: int, version: Optional[int] = None,
                 capacity: int = 0):
        self.carries = carries
        self.batch = batch
        self.last_used = time.monotonic()
        self.lock = make_lock("serving.session")
        self.steps = 0
        self.version = version
        self.position = 0          # tokens already decoded (host-side)
        self.capacity = capacity   # current KV ring bucket (0 = RNN)
        self.state_bytes = _tree_nbytes(carries)


class SessionCache:
    """Per-session device-resident state trees for one network.

    >>> cache = SessionCache(net, ttl_s=300.0, max_sessions=1024)
    >>> y0 = cache.step("sess-1", x_t0)     # one timestep
    >>> y1 = cache.step("sess-1", x_t1)     # state stayed on the device
    >>> cache.clear("sess-1")               # end of conversation

    For networks with KV-cache rings (``net.has_kv_ring()``) the step runs
    ``decode_step`` and ring capacity follows a powers-of-two bucket
    ladder up to the layers' ``cache_len``; a session decoding past the
    top of the ladder raises :class:`SessionError`.

    ``step_fn`` overrides the network's step (the int8 engine passes its
    quantized decode): the signature of the container's step
    (``(carries, x, **kw)``, or ``(carries, *xs, **kw)`` for a graph),
    returning ``(out, new_carries)``.
    """

    def __init__(self, model, *, ttl_s: float = 300.0,
                 max_sessions: int = 1024, name: str = "default",
                 version_fn=None, weights_fn=None, step_fn=None):
        from ..nn.computation_graph import ComputationGraph
        model.init()
        model._require_carry_support("SessionCache")
        self._model = model
        self._is_graph = isinstance(model, ComputationGraph)
        self._ttl_s = float(ttl_s)
        self._max_sessions = int(max_sessions)
        if self._max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        self._name = str(name)
        self._sessions: "OrderedDict[str, _Session]" = OrderedDict()
        self._lock = make_lock("serving.sessions.cache")
        # engine hooks: version_fn() is the engine's weight version at
        # session creation; weights_fn(v) resolves that version's
        # (params, net_state) (None = the network's live weights)
        self._version_fn = version_fn
        self._weights_fn = weights_fn
        self._step_fn = step_fn
        # decode tier: KV-ring models step through decode_step and ladder
        # their ring capacity
        self._decode = bool(model.has_kv_ring())
        self._cache_ladder = (batch_ladder(model.max_cache_len())
                              if self._decode else ())

    # ------------------------------------------------------------- metrics
    # Refreshed when the session SET changes (create/evict/clear), not per
    # step: nothing they publish moves while an existing session steps (a
    # ring grow defers its state_bytes delta to the next set change;
    # ``state_bytes()`` is always live).
    def _observe_active(self) -> None:
        _monitor.gauge("serving_sessions_active",
                       "live device-resident serving sessions").set(
            len(self._sessions), model=self._name)
        _monitor.gauge(
            "serving_session_state_bytes",
            "device bytes held by live session state trees "
            "(RNN carries + KV-cache rings)").set(
            sum(s.state_bytes for s in self._sessions.values()),
            model=self._name)
        if self._version_fn is not None:
            active = self._version_fn()
            pinned = sum(1 for s in self._sessions.values()
                         if s.version is not None and s.version != active)
            _monitor.gauge(
                "serving_session_version_pinned",
                "live sessions pinned to a non-active weight version"
            ).set(pinned, model=self._name)

    def refresh_gauges(self) -> None:
        """Re-publish the session gauges outside a set change: the pinned
        count moves when the engine's active version flips (``promote``,
        ``swap_weights``), not when the session set does."""
        with self._lock:
            self._observe_active()

    def _count_eviction(self, reason: str) -> None:
        _monitor.counter("serving_session_evictions_total",
                         "sessions evicted from the device cache").inc(
            model=self._name, reason=reason)

    # ------------------------------------------------------- state checks
    def _check_state(self, session_id: str, sess: _Session,
                     batch: int) -> None:
        """Raise :class:`SessionStateError` naming the first
        batch-carrying leaf when the stored state cannot serve a request
        of ``batch`` rows."""
        if sess.batch == batch:
            return
        path = next((p for p, leaf in _leaves_with_path(sess.carries)
                     if len(getattr(leaf, "shape", ())) >= 1
                     and leaf.shape[0] == sess.batch), None)
        raise SessionStateError(
            f"session {session_id!r} holds state for batch size "
            f"{sess.batch} (first batch-carrying leaf: "
            f"{path or '<none>'}), got {batch}; clear() the session "
            "between unrelated sequences", leaf_path=path)

    def _check_structure(self, session_id: str, sess: _Session) -> None:
        """A stored tree that no longer matches the model's state
        structure fails with the offending path, not a raw error from the
        step."""
        want_tree = (self._model._init_carries(sess.batch)
                     if not sess.capacity
                     else self._model._init_carries(
                         sess.batch, cache_len=sess.capacity))
        if _structure(sess.carries) == _structure(want_tree):
            return
        got_paths = [p for p, _ in _leaves_with_path(sess.carries)]
        want_paths = [p for p, _ in _leaves_with_path(
            self._model._init_carries(sess.batch))]
        odd = next((p for p in got_paths if p not in want_paths),
                   next((p for p in want_paths if p not in got_paths),
                        "<structure>"))
        raise SessionStateError(
            f"session {session_id!r} state tree does not match the "
            f"model's carry structure (offending leaf: {odd}); clear() "
            "the session", leaf_path=odd)

    # ------------------------------------------------------------ stepping
    def step(self, session_id: str, features, dtype=None):
        """Advance ``session_id`` by the given timesteps and return the
        output for exactly those steps, as host numpy.

        2-D input ``(batch, features)`` is one timestep and returns
        ``(batch, n_out)``; 3-D ``(batch, time, features)`` advances by a
        chunk and returns ``(batch, time, n_out)``.  A graph takes a list
        or tuple with one array per network input and returns a list when
        it has several outputs.  Unknown session ids start from zero
        state.  A batch-size change mid-session raises
        :class:`SessionStateError` naming the offending leaf (reference
        ``rnnTimeStep`` semantics); call :meth:`clear` between unrelated
        sequences."""
        feats = (tuple(features) if self._is_graph
                 and isinstance(features, (list, tuple)) else (features,))
        xs = tuple(np.asarray(f, dtype=dtype) for f in feats)
        batch = int(xs[0].shape[0])
        squeeze = xs[0].ndim == 2
        if squeeze:   # (batch, feat) = one timestep
            xs = tuple(x[:, None, :] if x.ndim == 2 else x for x in xs)
        steps = int(xs[0].shape[1])
        sess = self._acquire(session_id, batch, steps)
        with sess.lock:
            self._check_state(session_id, sess, batch)
            kw = {}
            if self._weights_fn is not None and sess.version is not None:
                w = self._weights_fn(sess.version)
                if w is not None:
                    kw = {"params": w[0], "net_state": w[1]}
            grow_to = (self._bucket_for(session_id, sess, steps)
                       if self._decode else 0)
            carries = sess.carries
            if grow_to:
                try:
                    carries = self._model.grow_decode_carries(carries,
                                                              grow_to)
                except Exception:
                    # same typed-error contract as the step itself
                    self._check_structure(session_id, sess)
                    raise
            out, new_carries = self._dispatch(session_id, sess, carries,
                                              xs, kw)
            # the session moves only once its step has succeeded
            if grow_to:
                sess.capacity = grow_to
                sess.state_bytes = _tree_nbytes(new_carries)
            sess.carries = new_carries
            sess.position += steps
            sess.steps += 1
            sess.last_used = time.monotonic()
        _monitor.counter("serving_session_steps_total",
                         "session steps served").inc(model=self._name)
        outs = [host_array(o) for o in
                (out if isinstance(out, list) else [out])]
        if squeeze:
            outs = [o[:, -1] if o.ndim == 3 else o for o in outs]
        return outs if isinstance(out, list) else outs[0]

    def _dispatch(self, session_id: str, sess: _Session, carries, xs, kw):
        """One step of the session's state tree: ``(out, new_carries)``,
        ``out`` a list for a graph with several outputs."""
        model = self._model
        step = self._step_fn or (model.decode_step if self._decode
                                 else model.rnn_stateless_step)
        try:
            if not self._is_graph:
                return step(carries, xs[0], **kw)
            outs, new = step(carries, *xs, **kw)
        except SessionError:
            raise
        except Exception:
            # a state tree the step cannot consume: diagnose against the
            # model's carry structure first (a mismatch raises the typed
            # error naming the leaf), else re-raise the original
            self._check_structure(session_id, sess)
            raise
        return (outs[0] if len(outs) == 1 else outs), new

    def _bucket_for(self, session_id: str, sess: _Session,
                    steps: int) -> int:
        """The ladder bucket this chunk needs, or 0 when the current ring
        already fits.  Raises past the top of the ladder."""
        need = sess.position + steps
        if need <= sess.capacity:
            return 0
        for cap in self._cache_ladder:
            if cap >= need and cap > sess.capacity:
                return cap
        raise SessionError(
            f"session {session_id!r} has decoded {sess.position} tokens; "
            f"{steps} more would exceed the model's cache_len "
            f"{self._cache_ladder[-1] if self._cache_ladder else 0}; "
            "clear() the session or raise the layer's cache_len")

    def _acquire(self, session_id: str, batch: int,
                 steps: int = 1) -> _Session:
        now = time.monotonic()
        with self._lock:
            changed = self._sweep_locked(now)
            sess = self._sessions.get(session_id)
            if sess is None:
                changed = True
                while len(self._sessions) >= self._max_sessions:
                    self._sessions.popitem(last=False)   # LRU out
                    self._count_eviction("capacity")
                capacity = 0
                if self._decode:
                    capacity = next((cap for cap in self._cache_ladder
                                     if cap >= steps), self._cache_ladder[0])
                    carries = self._model._init_carries(
                        batch, cache_len=capacity)
                else:
                    carries = self._model._init_carries(batch)
                version = (self._version_fn()
                           if self._version_fn is not None else None)
                sess = self._sessions[session_id] = _Session(
                    carries, batch, version, capacity)
            else:
                self._sessions.move_to_end(session_id)   # LRU touch
            if changed:
                self._observe_active()
            return sess

    def _sweep_locked(self, now: float) -> bool:
        if self._ttl_s <= 0:
            return False
        dead = [sid for sid, s in self._sessions.items()
                if now - s.last_used > self._ttl_s]
        for sid in dead:
            del self._sessions[sid]
            self._count_eviction("ttl")
        return bool(dead)

    # ---------------------------------------------------------- management
    def clear(self, session_id: str) -> bool:
        """Drop one session's device state (end of conversation): the
        documented recovery from :class:`SessionStateError`."""
        with self._lock:
            gone = self._sessions.pop(session_id, None) is not None
            self._observe_active()
        return gone

    def clear_all(self) -> None:
        with self._lock:
            self._sessions.clear()
            self._observe_active()

    def pinned_versions(self):
        """Weight versions pinned by at least one live session: what the
        engine consults before discarding a retired tree."""
        with self._lock:
            return {s.version for s in self._sessions.values()
                    if s.version is not None}

    def session_version(self, session_id: str) -> Optional[int]:
        """The weight version ``session_id`` is pinned to (None for unknown
        sessions or a cache without versions)."""
        with self._lock:
            sess = self._sessions.get(session_id)
            return None if sess is None else sess.version

    def get_carries(self, session_id: str):
        """The session's state tree (device tensors), or None."""
        with self._lock:
            sess = self._sessions.get(session_id)
            return None if sess is None else sess.carries

    def session_position(self, session_id: str) -> int:
        """Tokens decoded so far (host-tracked; 0 for unknown ids)."""
        with self._lock:
            sess = self._sessions.get(session_id)
            return 0 if sess is None else sess.position

    def session_capacity(self, session_id: str) -> int:
        """Current KV ring bucket (0 for RNN sessions and unknown ids)."""
        with self._lock:
            sess = self._sessions.get(session_id)
            return 0 if sess is None else sess.capacity

    def state_bytes(self) -> int:
        """Device bytes held by every live session's state tree: what TTL
        eviction frees."""
        with self._lock:
            return sum(s.state_bytes for s in self._sessions.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def stats(self) -> dict:
        with self._lock:
            now = time.monotonic()
            return {
                "sessions": len(self._sessions),
                "max_sessions": self._max_sessions,
                "ttl_s": self._ttl_s,
                "decode": self._decode,
                "state_bytes": sum(s.state_bytes
                                   for s in self._sessions.values()),
                "oldest_idle_s": round(
                    max((now - s.last_used for s in
                         self._sessions.values()), default=0.0), 3),
                "total_steps": sum(s.steps
                                   for s in self._sessions.values()),
                "pinned_versions": sorted(
                    {s.version for s in self._sessions.values()
                     if s.version is not None}),
            }
