"""Dynamic-batching inference engine: coalesce concurrent ``predict()``
calls into bucket-shaped batches (port of the core of
``deeplearning4j_tpu/serving/engine.py``).

Throughput on the card comes from batch parallelism, but requests arrive
one at a time.  The engine does the standard fix end to end:

1. ``predict()`` enqueues the request into a **bounded** queue and blocks
   on a future (queue full: callers block or get ``QueueFull``, with a
   ``retry_after_s`` from the queue's drain rate).
2. A batcher thread coalesces compatible requests under a
   ``(max_batch_size, max_latency_ms)`` policy: the first request opens a
   window; the batch closes when it would overflow the ladder, when a
   request of another shape arrives (it seeds the next batch, so order
   stays first come first served), or when the window expires.
3. The coalesced rows are zero-padded up to a fixed **bucket ladder**
   (powers-of-two batch sizes, optional timestep buckets with a features
   mask; ``serving.bucketing``), so the network only ever sees a small
   fixed set of shapes.
4. One inference callable per bucket (``compile_output``), made by
   ``warmup()``.  Each worker holds its own copy of the weights on its
   device (default: one worker on the network's own device).
5. Each batch's output is copied to the host once, unpadded in rows and
   time, and routed back to the per-request futures.

``predict_session`` streams through the engine's :class:`SessionCache`
(RNN carries or KV-cache rings kept on the device, one step per request);
``warmup_decode`` runs the decode step once at every (batch bucket,
chunk, cache_len) shape.

Metrics (``monitor`` registry): ``serving_queue_depth``,
``serving_requests_total``, ``serving_rejected_total``,
``serving_batches_total``, ``serving_batch_ms``,
``serving_batch_fill_ratio``, ``serving_padding_waste_ratio``,
``serving_request_latency_ms`` (p50/p95/p99/p999 per model),
``serving_bucket_compiles_total`` and ``serving_bucket_executables``.

A ``ComputationGraph`` serves as well: a request is a list or tuple with
one array per network input (rows must agree), the bucket signature is
one entry per input, and the answer is one array per network output (a
list when there are several).  Time is unpadded only when exactly one
input is a sequence.

Not ported yet: SLO admission and tenants, int8 weights, the native
backend, weight versions (staging, canary, promote, rollback), paging,
trace spans and incidents.  The engine serves weight version 0, the
network's weights as first placed on each worker.
"""

from __future__ import annotations

import itertools
import math
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import monitor as _monitor
from ..monitor.locks import make_lock
from .bucketing import BucketPolicy, assemble_batch, batch_ladder
from .sessions import SessionCache, host_array


class ServingError(RuntimeError):
    """Base class for serving-path failures."""


class QueueFull(ServingError):
    """Raised by non-blocking submits when the request queue is at
    capacity (the backpressure signal).  ``retry_after_s`` carries the
    wait derived from the queue's drain rate."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class _Request:
    __slots__ = ("arrays", "n_rows", "sig", "t_enqueue", "future")

    def __init__(self, arrays, sig):
        self.arrays = arrays
        self.n_rows = int(arrays[0].shape[0])
        self.sig = sig
        self.t_enqueue = time.perf_counter()
        self.future: Future = Future()


class _BatchJob:
    __slots__ = ("requests", "sig", "rows")

    def __init__(self, requests, sig, rows):
        self.requests = requests
        self.sig = sig
        self.rows = rows


def _host_dtype(name: str) -> np.dtype:
    # numpy has no bfloat16: bf16 networks take f32 host arrays and cast
    # on the device
    return np.dtype(np.float32 if name == "bfloat16" else name)


class InferenceEngine:
    """Concurrent dynamic-batching front end for a trained
    ``MultiLayerNetwork`` or ``ComputationGraph``.

    >>> engine = InferenceEngine(net, max_batch_size=32,
    ...                          max_latency_ms=2.0).start()
    >>> engine.warmup((4,))              # one callable per batch bucket
    >>> y = engine.predict(x)            # thread-safe, blocks on result
    >>> engine.stop()

    ``max_batch_size`` trades per-request latency for throughput;
    ``max_latency_ms`` bounds the coalescing wait; ``queue_capacity``
    bounds admitted-but-unserved requests; ``timestep_buckets`` enables
    sequence padding; ``devices`` (default: the network's device) places
    one copy of the weights per device, each served by its own worker;
    ``session_ttl_s``/``max_sessions`` configure the session cache behind
    :meth:`predict_session`.  Host inputs take the network's dtype (fp32
    for a bf16 network: numpy has no bfloat16).
    """

    def __init__(self, model, *, max_batch_size: int = 32,
                 max_latency_ms: float = 5.0, queue_capacity: int = 128,
                 timestep_buckets: Optional[Sequence[int]] = None,
                 devices=None, name: str = "default",
                 session_ttl_s: float = 300.0,
                 max_sessions: int = 1024):
        from ..nn.computation_graph import ComputationGraph
        model.init()
        self._model = model
        self._is_graph = isinstance(model, ComputationGraph)
        self._n_inputs = (len(model.conf.network_inputs)
                          if self._is_graph else 1)
        # the JAX package's compile-counter prefix: "cg." or "mln."
        self._prefix = "cg" if self._is_graph else "mln"
        self._policy = BucketPolicy(max_batch_size, timestep_buckets)
        self._max_latency_s = float(max_latency_ms) / 1000.0
        self._name = str(name)
        self._dtype = _host_dtype(model.conf.conf.dtype)
        self._devices = ([torch.device(d) for d in devices] if devices
                         else [model.device])
        self._queue: "queue.Queue" = queue.Queue(maxsize=int(queue_capacity))
        self._dispatch_q: "queue.Queue" = queue.Queue(
            maxsize=2 * len(self._devices))
        self._compiled: dict = {}        # (worker_idx, bucket_key) -> fn
        # weight versions: 0, the network's own weights (placed copies per
        # worker; None = live weights for sessions), is the only one until
        # staging further versions is ported
        self._weights: dict = {0: None}
        self._active_version = 0
        self._placed: dict = {}          # worker_idx -> placed weights
        self._placed_lock = make_lock("serving.engine.placed")
        self._compile_lock = make_lock("serving.engine.compile")
        self._running = False
        self._threads: List[threading.Thread] = []
        self._sessions = None
        self._session_opts = {"ttl_s": float(session_ttl_s),
                              "max_sessions": int(max_sessions)}
        self._session_lock = make_lock("serving.engine.session")
        self._decode_warmed: set = set()
        # completion timestamps for the queue drain rate (retry_after_s)
        self._done_times: "deque" = deque(maxlen=512)

    # ----------------------------------------------------------- identity
    @property
    def name(self) -> str:
        return self._name

    @property
    def active_version(self) -> int:
        return self._active_version

    # ------------------------------------------------------------ metrics
    def _observe_queue_depth(self):
        _monitor.gauge("serving_queue_depth",
                       "admitted requests waiting to be batched").set(
            self._queue.qsize(), engine=self._name)

    def _observe_latency(self, latency_ms: float) -> None:
        _monitor.histogram(
            "serving_request_latency_ms",
            "end-to-end request latency (enqueue -> result), per model"
        ).observe(latency_ms, model=self._name)
        self._done_times.append(time.monotonic())

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "InferenceEngine":
        """Spawn the batcher and worker threads (idempotent)."""
        if self._running:
            return self
        self._running = True
        self._threads = [threading.Thread(
            target=self._batcher_loop,
            name=f"serving-batcher-{self._name}", daemon=True)]
        for i in range(len(self._devices)):
            self._threads.append(threading.Thread(
                target=self._worker_loop, args=(i,),
                name=f"serving-worker-{self._name}-{i}", daemon=True))
        for t in self._threads:
            t.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop batching, drain in-flight work, fail still-queued requests
        with ``ServingError``."""
        if not self._running and not self._threads:
            return
        self._running = False
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        self._threads = []
        for q in (self._queue, self._dispatch_q):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                reqs = (item.requests if isinstance(item, _BatchJob)
                        else [item])
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(
                            ServingError("engine stopped"))
        self._observe_queue_depth()

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------- drain rate
    def drain_rate(self) -> float:
        """Completed requests per second over the recent completion window
        (0.0 with no evidence)."""
        done = list(self._done_times)
        if len(done) < 2:
            return 0.0
        span = done[-1] - done[0]
        if span <= 0:
            return 0.0
        return (len(done) - 1) / span

    @staticmethod
    def _retry_after(depth: int, rate: float) -> float:
        """Queue depth over drain rate, clamped to [1, 60] s."""
        depth = max(1, int(depth))
        if rate <= 0:
            return 1.0
        return float(min(60.0, max(1.0, math.ceil(depth / rate))))

    def retry_after_s(self) -> float:
        """Suggested client wait before retrying a rejected request."""
        rate = self.drain_rate()
        return self._retry_after(self._queue.qsize(), rate)

    # ------------------------------------------------------------- submit
    def predict(self, features, timeout: Optional[float] = None,
                block: bool = True):
        """Blocking inference: enqueue, coalesce, return this request's
        rows as host numpy (thread-safe; the engine batches concurrent
        callers).  A graph takes one array per network input (a list or
        tuple) and answers one per network output.  ``block=False``
        rejects with ``QueueFull`` instead of waiting for queue space."""
        return self.predict_async(features, block=block).result(timeout)

    def predict_async(self, features, block: bool = True,
                      timeout: Optional[float] = None) -> Future:
        """Enqueue and return a ``Future``.  With ``block=False`` (or a
        ``timeout``) a full queue raises ``QueueFull`` instead of
        blocking."""
        if not self._running:
            raise ServingError("engine not started (call start())")
        arrays = self._canonicalize(features)
        req = _Request(arrays, self._signature(arrays))
        try:
            self._queue.put(req, block=block, timeout=timeout)
        except queue.Full:
            # Retry-After inputs snapshotted after put() released the
            # queue's internals
            rate = self.drain_rate()
            depth = self._queue.qsize()
            _monitor.counter("serving_rejected_total",
                             "requests rejected at queue capacity").inc(
                engine=self._name)
            raise QueueFull(
                f"serving queue at capacity ({self._queue.maxsize}); "
                "retry or raise queue_capacity",
                self._retry_after(depth, rate)) from None
        _monitor.counter("serving_requests_total",
                         "requests admitted to the serving queue").inc(
            engine=self._name)
        self._observe_queue_depth()
        return req.future

    # ------------------------------------------------------------ sessions
    @property
    def sessions(self) -> SessionCache:
        """The engine's :class:`SessionCache` (created on first use;
        raises for models without carry support)."""
        with self._session_lock:
            if self._sessions is None:
                self._sessions = SessionCache(
                    self._model, name=self._name,
                    version_fn=lambda: self._active_version,
                    weights_fn=self._weights.get, **self._session_opts)
            return self._sessions

    def predict_session(self, session_id: str, features):
        """Streaming inference: advance ``session_id``'s device-resident
        state (RNN carries, or KV-cache rings for decode models) by the
        given timesteps and return the output as host numpy.  Not queued
        or coalesced: session state is a chain, so each session serializes
        its own steps while distinct sessions run concurrently."""
        if not self._running:
            raise ServingError("engine not started (call start())")
        t0 = time.perf_counter()
        out = self.sessions.step(session_id, features, dtype=self._dtype)
        _monitor.counter("serving_requests_total",
                         "requests admitted to the serving queue").inc(
            engine=self._name)
        self._observe_latency((time.perf_counter() - t0) * 1000.0)
        return out

    # ------------------------------------------------------------- warmup
    def _example_shapes(self, example_shape):
        """One example shape per network input: a graph may pass a tuple
        of shapes."""
        if self._is_graph and isinstance(example_shape, (list, tuple)) \
                and example_shape and isinstance(example_shape[0],
                                                 (list, tuple)):
            shapes = [tuple(s) for s in example_shape]
        else:
            shapes = [tuple(example_shape)]
        if len(shapes) != self._n_inputs:
            raise ValueError(f"expected {self._n_inputs} example shapes, "
                             f"got {len(shapes)}")
        return shapes

    def warmup(self, example_shape) -> int:
        """Make every bucket callable on every worker.  ``example_shape``
        is ONE example's feature shape (no batch axis), e.g. ``(784,)``
        or ``(T, n_in)``, or a tuple of such shapes for a multi-input
        graph; with timestep bucketing, axis 0 of a sequence shape is
        replaced by each ladder entry.  Returns the number of callables
        made."""
        per_input = []
        for shp in self._example_shapes(example_shape):
            if self._policy.timestep_buckets and len(shp) >= 2:
                per_input.append([("seq", shp[1:], tb)
                                  for tb in self._policy.timestep_buckets])
            else:
                per_input.append([("dense", shp, None)])
        return sum(self._ensure_executable(widx, (combo, bb))
                   for combo in itertools.product(*per_input)
                   for bb in self._policy.batch_buckets
                   for widx in range(len(self._devices)))

    def warmup_decode(self, example_shape, chunk_lens=(1,)) -> int:
        """Run the decode step once at every (batch bucket, chunk,
        cache_len) shape, and the grow to the next cache-len bucket, so
        that no session step meets a shape for the first time.
        ``example_shape`` is ONE token's feature shape, e.g. ``(n_in,)``
        (a tuple of shapes for a multi-input graph); ``chunk_lens`` are
        the chunk lengths to warm (``(1,)``: pure autoregressive decode).
        Returns the number of shapes run for the first time (0 on a
        second call); each is counted in ``serving_decode_warmups_total``
        under ``fn="cg.decode_step"`` or ``"mln.decode_step"``."""
        model = self._model
        if not model.has_kv_ring():
            raise ServingError(
                "warmup_decode requires a model with KV-ring "
                "(causal_attention) layers")
        shapes = self._example_shapes(example_shape)
        ladder = batch_ladder(model.max_cache_len())
        n = 0
        for bb in self._policy.batch_buckets:
            for t in (int(t) for t in chunk_lens):
                xs = [np.zeros((bb, t) + shp, self._dtype) for shp in shapes]
                for i, cap in enumerate(ladder):
                    if t > cap or (bb, t, cap) in self._decode_warmed:
                        continue
                    carries = model._init_carries(bb, cache_len=cap)
                    model.decode_step(carries, *xs)
                    if i + 1 < len(ladder):
                        model.grow_decode_carries(carries, ladder[i + 1])
                    self._decode_warmed.add((bb, t, cap))
                    n += 1
        _monitor.counter(
            "serving_decode_warmups_total",
            "decode step shapes run for the first time by warmup_decode"
        ).inc(n, engine=self._name, fn=self._prefix + ".decode_step")
        return n

    # ------------------------------------------------------- introspection
    def stats(self) -> dict:
        d = {
            "running": self._running,
            "queue_depth": self._queue.qsize(),
            "queue_capacity": self._queue.maxsize,
            "executables": len(self._compiled),
            "workers": len(self._devices),
            "devices": [str(d) for d in self._devices],
            "batch_buckets": list(self._policy.batch_buckets),
            "timestep_buckets": list(self._policy.timestep_buckets),
            "drain_rate_rps": round(self.drain_rate(), 2),
            "active_version": self._active_version,
        }
        if self._sessions is not None:
            d["sessions"] = self._sessions.stats()
        return d

    def bucket_keys(self):
        """Warmed (signature, batch_bucket) keys (all workers)."""
        return sorted({k for (_, k) in self._compiled})

    # ------------------------------------------------------------ internals
    def _canonicalize(self, features) -> Tuple[np.ndarray, ...]:
        if self._is_graph and isinstance(features, (list, tuple)):
            arrays = tuple(np.asarray(f, dtype=self._dtype)
                           for f in features)
        else:
            arrays = (np.asarray(features, dtype=self._dtype),)
        if len(arrays) != self._n_inputs:
            raise ValueError(f"model expects {self._n_inputs} inputs, "
                             f"got {len(arrays)}")
        for a in arrays:
            if a.ndim < 2:
                raise ValueError(
                    f"features must include a batch axis: shape {a.shape}")
        rows = {a.shape[0] for a in arrays}
        if len(rows) != 1:
            raise ValueError(f"inputs disagree on batch size: {rows}")
        n = rows.pop()
        if n < 1:
            raise ValueError("empty batch")
        if n > self._policy.max_batch_size:
            raise ValueError(
                f"request of {n} rows exceeds max_batch_size="
                f"{self._policy.max_batch_size}; split the request")
        return arrays

    def _signature(self, arrays) -> Tuple:
        sig = []
        for a in arrays:
            if self._policy.timestep_buckets and a.ndim >= 3:
                # validates length <= largest bucket too
                tb = self._policy.time_bucket(a.shape[1])
                sig.append(("seq", tuple(a.shape[2:]), tb))
            else:
                sig.append(("dense", tuple(a.shape[1:]), None))
        return tuple(sig)

    def _placed_params(self, widx: int):
        """The worker's own copy of the weights (made on first use): a
        copy, so that a later ``fit`` of the network does not change what
        the bucket callables serve."""
        with self._placed_lock:
            placed = self._placed.get(widx)
            if placed is None:
                dev, model = self._devices[widx], self._model
                placed = tuple(
                    model._trees([(key, {k: v.detach().to(dev, copy=True)
                                         for k, v in tree.items()})
                                  for key, tree in model._items(trees)])
                    for trees in (model.params, model.net_state))
                self._placed[widx] = placed
            return placed

    def _ensure_executable(self, widx: int, key) -> bool:
        """Make the bucket callable for (worker, key) if missing.  Returns
        True when one was made."""
        if (widx, key) in self._compiled:
            return False
        with self._compile_lock:
            if (widx, key) in self._compiled:
                return False
            sig, bb = key
            params, state = self._placed_params(widx)
            shapes = [(bb, tb) + trailing if kind == "seq"
                      else (bb,) + trailing for kind, trailing, tb in sig]
            masks = [(bb, tb) if kind == "seq" else None
                     for kind, _, tb in sig]
            if self._is_graph:
                fn = self._model.compile_output(
                    shapes, mask_shapes=(masks if any(masks) else None),
                    params=params, net_state=state)
            else:
                fn = self._model.compile_output(
                    shapes[0], mask_shape=masks[0], params=params,
                    net_state=state)
            self._compiled[(widx, key)] = fn
            _monitor.counter(
                "serving_bucket_compiles_total",
                "bucket inference callables made").inc(engine=self._name)
            _monitor.gauge(
                "serving_bucket_executables",
                "live bucket inference callables").set(
                len(self._compiled), engine=self._name)
            return True

    def _batcher_loop(self):
        pending = None
        while True:
            if pending is not None:
                req, pending = pending, None
            else:
                try:
                    req = self._queue.get(timeout=0.05)
                except queue.Empty:
                    if not self._running:
                        return
                    continue
                self._observe_queue_depth()
            batch, rows = [req], req.n_rows
            deadline = time.perf_counter() + self._max_latency_s
            while rows < self._policy.max_batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                self._observe_queue_depth()
                if (nxt.sig != req.sig
                        or rows + nxt.n_rows
                        > self._policy.max_batch_size):
                    pending = nxt  # seeds the next batch (FIFO-fair)
                    break
                batch.append(nxt)
                rows += nxt.n_rows
            job = _BatchJob(batch, req.sig, rows)
            while True:  # backpressure: wait for a worker slot
                try:
                    self._dispatch_q.put(job, timeout=0.05)
                    break
                except queue.Full:
                    if not self._running:
                        for r in batch:
                            if not r.future.done():
                                r.future.set_exception(
                                    ServingError("engine stopped"))
                        return

    def _worker_loop(self, widx: int):
        while True:
            try:
                job = self._dispatch_q.get(timeout=0.05)
            except queue.Empty:
                if not self._running:
                    return
                continue
            try:
                self._run_batch(widx, job)
            except Exception as exc:  # route failures to the callers
                for r in job.requests:
                    if not r.future.done():
                        r.future.set_exception(exc)

    def _run_batch(self, widx: int, job: _BatchJob):
        bb = self._policy.batch_bucket(job.rows)
        feats, masks, wastes = [], [], []
        for i, (kind, _trailing, tb) in enumerate(job.sig):
            x, m, _, waste = assemble_batch(
                [r.arrays[i] for r in job.requests], bb,
                tb if kind == "seq" else None, mask_dtype=self._dtype)
            feats.append(x)
            masks.append(m)
            wastes.append(waste)
        key = (job.sig, bb)
        self._ensure_executable(widx, key)
        t0 = time.perf_counter()
        params, state = self._placed_params(widx)
        fn = self._compiled[(widx, key)]
        if self._is_graph:
            outs = fn(params, state, tuple(feats),
                      tuple(masks) if any(m is not None for m in masks)
                      else None)
        else:
            outs = [fn(params, state, feats[0], masks[0])]
        # one copy to the host per output per batch; requests get slices
        outs = [host_array(o) for o in outs]
        now = time.perf_counter()
        _monitor.histogram("serving_batch_ms",
                           "device dispatch wall time per batch").observe(
            (now - t0) * 1000.0, engine=self._name)
        _monitor.counter("serving_batches_total",
                         "coalesced batches dispatched").inc(
            engine=self._name)
        _monitor.histogram(
            "serving_batch_fill_ratio",
            "real rows / bucket rows per dispatched batch, per model"
        ).observe(job.rows / bb, model=self._name)
        _monitor.histogram(
            "serving_padding_waste_ratio",
            "padded elements carrying no real data, per batch, per model"
        ).observe(float(np.mean(wastes)), model=self._name)
        # time-unpad is only unambiguous with a single sequence input
        # (seq-to-seq outputs carry its time axis at the bucket length)
        seq_inputs = [i for i, (kind, _, _) in enumerate(job.sig)
                      if kind == "seq"]
        seq_i = seq_inputs[0] if len(seq_inputs) == 1 else None
        tb = job.sig[seq_i][2] if seq_i is not None else None
        off = 0
        for r in job.requests:
            sl = [o[off:off + r.n_rows] for o in outs]
            if seq_i is not None:
                t_real = r.arrays[seq_i].shape[1]
                if t_real < tb:
                    sl = [o[:, :t_real]
                          if o.ndim >= 3 and o.shape[1] == tb else o
                          for o in sl]
            r.future.set_result(sl[0] if len(sl) == 1 else sl)
            self._observe_latency((now - r.t_enqueue) * 1000.0)
            off += r.n_rows
