"""Dynamic-batching inference engine: coalesce concurrent ``predict()``
calls into bucket-shaped batches (port of
``deeplearning4j_tpu/serving/engine.py``).

Throughput on the card comes from batch parallelism, but requests arrive
one at a time.  The engine does the standard fix end to end:

1. ``predict()`` enqueues the request into a **bounded** queue and blocks
   on a future (queue full: callers block or get ``QueueFull``, with a
   ``retry_after_s`` from the queue's drain rate, and a ``queue_full``
   flight-recorder incident).
2. A batcher thread coalesces compatible requests under a
   ``(max_batch_size, max_latency_ms)`` policy: the first request opens a
   window; the batch closes when it would overflow the ladder, when a
   request of another shape or weight version arrives (it seeds the next
   batch, so order stays first come first served), or when the window
   expires.
3. The coalesced rows are zero-padded up to a fixed **bucket ladder**
   (powers-of-two batch sizes, optional timestep buckets with a features
   mask; ``serving.bucketing``), so the network only ever sees a small
   fixed set of shapes.
4. One inference callable per bucket (``compile_output``), made by
   ``warmup()``.  Each worker holds its own copy of the weights on its
   device (default: one worker on the network's own device).
5. Each batch's output is copied to the host once, unpadded in rows and
   time, and routed back to the per-request futures.

Serving v2 (as in the JAX package):

- **SLO admission** (``slo_p99_ms=``, ``tenants=``, ``admission=``):
  requests are shed with :class:`SloShed` while the windowed p99 exceeds
  the target, per tenant and weighted by share
  (``serving.admission``); each shed counts in ``serving_shed_total`` and
  records an ``slo_shed`` incident.
- **int8 weights** (``quantize="int8"``): the resident tree is per-tensor
  affine uint8 (``serving.quantize``), decoded inside each bucket call;
  the decode step of a KV-ring network goes to the session cache as its
  ``step_fn``.
- **Paging** (``release_device_buffers`` / ``ensure_resident``): the
  per-worker placed weights can be dropped and placed again; bucket
  callables survive, because weights are call operands.  This is what
  ``serving.registry.ModelRegistry`` drives under a device byte budget.
  Every thread of the engine queues its work, copies included, on the
  device's default stream, so a page-in on a caller's thread is ordered
  with the worker's batches.
- **Weight versions**: the engine holds N versioned weight trees against
  one set of bucket callables.  ``stage_weights`` registers version N+1
  beside N, ``set_canary`` routes a deterministic fraction of requests to
  it (a batch never mixes versions), ``promote`` is an atomic pointer
  flip and ``rollback`` drops the canary; none of them makes a callable
  (``serving_bucket_compiles_total`` does not move).  Sessions opened
  before a swap stay pinned to the version they started on.
- **Tracing**: each request carries a trace id and span id from submit
  time; a batch records one ``serve/request`` span per request with its
  ``queue_wait``/``batch_assembly``/``dispatch`` segments and one
  ``serve/batch`` span linking them (``monitor.tracing``).

``predict_session`` streams through the engine's :class:`SessionCache`
(RNN carries or KV-cache rings kept on the device, one step per request);
``warmup_decode`` runs the decode step once at every (batch bucket,
chunk, cache_len) shape.

Metrics (``monitor`` registry): ``serving_queue_depth``,
``serving_requests_total``, ``serving_rejected_total``,
``serving_shed_total``, ``serving_batches_total``, ``serving_batch_ms``,
``serving_batch_fill_ratio``, ``serving_padding_waste_ratio``,
``serving_request_latency_ms`` (p50/p95/p99/p999 per model, with trace
exemplars), ``serving_version_latency_ms``, ``serving_tenant_latency_ms``,
the ``serving_tenant_*`` counters, ``serving_bucket_compiles_total``,
``serving_bucket_executables``, ``deploy_swap_seconds``,
``deploy_version`` and ``deploy_canary_fraction``.

A ``ComputationGraph`` serves as well: a request is a list or tuple with
one array per network input (rows must agree), the bucket signature is
one entry per input, and the answer is one array per network output (a
list when there are several).  Time is unpadded only when exactly one
input is a sequence.

Not ported: the JAX package's native (C++ PJRT) backend.
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
from .admission import (DEFAULT_TENANT, SloAdmissionController,
                        normalize_tenant, publish_tenant_telemetry)
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


class SloShed(ServingError):
    """Raised when admission control sheds the request: the engine's
    observed p99 latency exceeds its SLO target.  Distinct from
    :class:`QueueFull`: the queue may have room, but admitting more load
    would break the latency target for everyone already admitted.
    ``tenant`` is the (normalized) tenant whose request was shed."""

    def __init__(self, msg: str, slo_p99_ms: float,
                 observed_p99_ms: float, tenant: str = DEFAULT_TENANT):
        super().__init__(msg)
        self.slo_p99_ms = float(slo_p99_ms)
        self.observed_p99_ms = float(observed_p99_ms)
        self.tenant = str(tenant)


class _Request:
    __slots__ = ("arrays", "n_rows", "sig", "version", "tenant",
                 "t_enqueue", "t_wall", "t_dequeue", "ctx", "trace_id",
                 "span_id", "future")

    def __init__(self, arrays, sig, version: int = 0,
                 tenant: str = DEFAULT_TENANT):
        self.arrays = arrays
        self.n_rows = int(arrays[0].shape[0])
        self.sig = sig
        self.version = version
        self.tenant = tenant
        self.t_enqueue = time.perf_counter()
        self.t_wall = time.time()
        self.t_dequeue = self.t_enqueue
        # trace identity is fixed at submit time on the caller's thread:
        # the request span parents under the caller's ambient context, and
        # its id is allocated here so the batch span can link it
        self.ctx = _monitor.current_context()
        self.trace_id = (self.ctx.trace_id if self.ctx is not None
                         else _monitor.new_trace_id())
        self.span_id = _monitor.tracer().next_span_id()
        self.future: Future = Future()


class _BatchJob:
    __slots__ = ("requests", "sig", "rows", "version")

    def __init__(self, requests, sig, rows, version):
        self.requests = requests
        self.sig = sig
        self.rows = rows
        self.version = version


def _host_dtype(name: str) -> np.dtype:
    # numpy has no bfloat16: bf16 networks take f32 host arrays and cast
    # on the device
    return np.dtype(np.float32 if name == "bfloat16" else name)


def _copy_tree(tree, device):
    """A copy of a weight tree (the per-layer dicts of either container)
    with every leaf on ``device``: a copy, so that a later ``fit`` of the
    network, or a change of the caller's tree, does not reach it."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    return torch.as_tensor(np.asarray(tree)).to(device)


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
    ``slo_p99_ms`` (with ``tenants``, or a configured ``admission``
    controller) enables SLO-aware shedding; ``quantize="int8"`` serves
    affine-quantized uint8 weights; ``session_ttl_s``/``max_sessions``
    configure the session cache behind :meth:`predict_session`.  Host
    inputs take the network's dtype (fp32 for a bf16 network: numpy has
    no bfloat16).
    """

    def __init__(self, model, *, max_batch_size: int = 32,
                 max_latency_ms: float = 5.0, queue_capacity: int = 128,
                 timestep_buckets: Optional[Sequence[int]] = None,
                 devices=None, name: str = "default",
                 slo_p99_ms: Optional[float] = None,
                 tenants: Optional[dict] = None,
                 admission: Optional[SloAdmissionController] = None,
                 quantize: Optional[str] = None,
                 session_ttl_s: float = 300.0,
                 max_sessions: int = 1024):
        from ..nn.computation_graph import ComputationGraph
        from . import quantize as _quant
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
        if quantize not in (None, "int8"):
            raise ValueError("quantize must be None or 'int8'")
        self._quantize = quantize
        self._qparams = self._qspecs = self._qdecode = None
        if quantize == "int8":
            qparams, self._qspecs = _quant.quantize_tree(model.params)
            # the engine's own copy stays on the host: only placed copies
            # hold device memory, so a page-out frees all of it
            self._qparams = _copy_tree(qparams, "cpu")
            if model.has_kv_ring():
                self._qdecode = _quant.quantized_decode(model, self._qspecs)
        self._devices = ([torch.device(d) for d in devices] if devices
                         else [model.device])
        self._queue: "queue.Queue" = queue.Queue(maxsize=int(queue_capacity))
        self._dispatch_q: "queue.Queue" = queue.Queue(
            maxsize=2 * len(self._devices))
        self._compiled: dict = {}        # (worker_idx, bucket_key) -> fn
        # Versioned weights: version -> (params, net_state).  The sentinel
        # None means "the network's own live weights" (version 0 at
        # construction); staged versions hold explicit trees.  Bucket
        # callables take weights as operands, so _placed caches device
        # copies per (worker, version) against one set of callables.
        self._weights: dict = {0: None}
        self._active_version = 0
        self._canary_version: Optional[int] = None
        self._canary_fraction = 0.0
        self._max_version_seen = 0
        self._session_pins: dict = {}    # retired version -> device tree
        self._route_counter = itertools.count()
        self._placed: dict = {}          # (worker_idx, version) -> placed
        self._placed_lock = make_lock("serving.engine.placed")
        self._compile_lock = make_lock("serving.engine.compile")
        self._running = False
        self._threads: List[threading.Thread] = []
        if admission is not None:
            # a configured controller (observe-only mode, custom windows)
            # overrides the slo_p99_ms shorthand
            self._admission: Optional[SloAdmissionController] = admission
        else:
            self._admission = (
                SloAdmissionController(slo_p99_ms, tenants=tenants)
                if slo_p99_ms else None)
        # rate limit of the per-tenant gauge publication
        self._tenant_pub_at = float("-inf")
        self._sessions = None
        self._session_opts = {"ttl_s": float(session_ttl_s),
                              "max_sessions": int(max_sessions)}
        self._session_lock = make_lock("serving.engine.session")
        self._decode_warmed: set = set()
        # completion timestamps for the queue drain rate (retry_after_s)
        self._done_times: "deque" = deque(maxlen=512)
        self._model_bytes = _quant.tree_nbytes(
            (self._qparams if quantize else model.params, model.net_state))

    # ----------------------------------------------------------- identity
    @property
    def name(self) -> str:
        return self._name

    @property
    def slo_p99_ms(self) -> Optional[float]:
        return self._admission.slo_p99_ms if self._admission else None

    # ------------------------------------------------------------ metrics
    def _observe_queue_depth(self):
        _monitor.gauge("serving_queue_depth",
                       "admitted requests waiting to be batched").set(
            self._queue.qsize(), engine=self._name)

    def _observe_latency(self, latency_ms: float,
                         trace_hex: Optional[str] = None,
                         version: Optional[int] = None,
                         tenant: str = DEFAULT_TENANT) -> None:
        _monitor.histogram(
            "serving_request_latency_ms",
            "end-to-end request latency (enqueue -> result), per model"
        ).observe(latency_ms, exemplar=trace_hex, model=self._name)
        if version is not None:
            # a separate series, so the rollout controller can window p99
            # per weight version without perturbing the SLO signal
            _monitor.histogram(
                "serving_version_latency_ms",
                "request latency per served weight version").observe(
                latency_ms, model=self._name, version=str(version))
        # per-tenant series: exemplars only for the tenant's slowest
        # decile (windowed p90 cut), pointing at the requests that drag
        # that tenant's tail
        slow_ms = (self._admission.tenant_slow_threshold_ms(tenant)
                   if self._admission is not None else None)
        _monitor.histogram(
            "serving_tenant_latency_ms",
            "end-to-end request latency per tenant; exemplars pin the "
            "tenant's slowest-decile requests").observe(
            latency_ms,
            exemplar=(trace_hex or "") if (
                slow_ms is not None and latency_ms >= slow_ms) else "",
            model=self._name, tenant=tenant)
        if self._admission is not None:
            self._admission.observe(latency_ms, tenant=tenant)
            self._maybe_publish_tenants()
        self._done_times.append(time.monotonic())

    def _maybe_publish_tenants(self) -> None:
        """Refresh the per-tenant gauges at most once per admission
        refresh interval (the completion path stays O(1))."""
        now = time.monotonic()
        interval = max(0.1, 2.0 * self._admission.refresh_s)
        if now - self._tenant_pub_at < interval:
            return
        self._tenant_pub_at = now
        publish_tenant_telemetry(self._admission, self._name)

    def _tenant(self, tenant) -> str:
        """A request's tenant id normalized against the configured
        tenants (bounded label cardinality; see ``serving.admission``)."""
        if self._admission is not None:
            return self._admission.normalize(tenant)
        return normalize_tenant(tenant)

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

    # ---------------------------------------------------------- admission
    def _admit_or_shed(self, tenant=None) -> str:
        """Run the (per-tenant, fair) admission decision; returns the
        normalized tenant label, raises :class:`SloShed` on shed."""
        tenant = self._tenant(tenant)
        _monitor.counter(
            "serving_tenant_requests_total",
            "requests arriving at admission, per tenant").inc(
            engine=self._name, tenant=tenant)
        observed = (self._admission.should_shed(tenant)
                    if self._admission is not None else None)
        if observed is not None:
            _monitor.counter(
                "serving_shed_total",
                "requests shed by SLO admission control "
                "(p99 over target)").inc(engine=self._name)
            _monitor.counter(
                "serving_tenant_shed_total",
                "requests shed by SLO admission control, per tenant"
            ).inc(engine=self._name, tenant=tenant)
            _monitor.record_incident("slo_shed", {
                "engine": self._name,
                "tenant": tenant,
                "observed_p99_ms": float(observed),
                "slo_p99_ms": float(self._admission.slo_p99_ms),
            })
            raise SloShed(
                f"shedding tenant {tenant!r}: observed p99 "
                f"{observed:.1f} ms exceeds the "
                f"{self._admission.slo_p99_ms:.1f} ms SLO; retry with "
                "backoff", self._admission.slo_p99_ms, observed,
                tenant=tenant)
        _monitor.counter(
            "serving_tenant_admitted_total",
            "requests admitted past SLO admission, per tenant").inc(
            engine=self._name, tenant=tenant)
        return tenant

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
                block: bool = True, version: Optional[int] = None,
                tenant: Optional[str] = None):
        """Blocking inference: enqueue, coalesce, return this request's
        rows as host numpy (thread-safe; the engine batches concurrent
        callers).  A graph takes one array per network input (a list or
        tuple) and answers one per network output.  ``block=False``
        rejects with ``QueueFull`` instead of waiting for queue space.
        ``version=`` pins the request to a staged weight version (the
        rollout controller's probe path); by default the request goes to
        the active version or the canary, by the canary fraction.
        ``tenant=`` attributes the request to a tenant for fair admission
        and per-tenant telemetry (default: the public tenant)."""
        return self.predict_async(features, block=block, version=version,
                                  tenant=tenant).result(timeout)

    def predict_async(self, features, block: bool = True,
                      timeout: Optional[float] = None,
                      version: Optional[int] = None,
                      tenant: Optional[str] = None) -> Future:
        """Enqueue and return a ``Future``.  With ``block=False`` (or a
        ``timeout``) a full queue raises ``QueueFull`` instead of
        blocking; with an SLO configured, overload sheds with
        :class:`SloShed` whatever the queue's room."""
        if not self._running:
            raise ServingError("engine not started (call start())")
        tenant = self._admit_or_shed(tenant)
        arrays = self._canonicalize(features)
        req = _Request(arrays, self._signature(arrays),
                       self._route_version(version), tenant)
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
            _monitor.record_incident("queue_full", {
                "engine": self._name,
                "queue_capacity": self._queue.maxsize,
            })
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
                step_fn = None
                if self._qdecode is not None:
                    # int8 engines step sessions through the quantized
                    # decode over worker 0's placed uint8 tree (a hot swap
                    # is refused under int8, so it is version 0's)
                    qd = self._qdecode

                    def step_fn(carries, *feats, **_kw):
                        qp, ns = self._placed_params(0, 0)
                        return qd(qp, ns, carries,
                                  feats if self._is_graph else feats[0])
                self._sessions = SessionCache(
                    self._model, name=self._name,
                    version_fn=lambda: self._active_version,
                    weights_fn=self._weights_for_version,
                    step_fn=step_fn, **self._session_opts)
            return self._sessions

    def predict_session(self, session_id: str, features,
                        tenant: Optional[str] = None):
        """Streaming inference: advance ``session_id``'s device-resident
        state (RNN carries, or KV-cache rings for decode models) by the
        given timesteps and return the output as host numpy.  Subject to
        the same SLO admission as ``predict``; not queued or coalesced:
        session state is a chain, so each session serializes its own steps
        while distinct sessions run concurrently."""
        if not self._running:
            raise ServingError("engine not started (call start())")
        tenant = self._admit_or_shed(tenant)
        t0 = time.perf_counter()
        out = self.sessions.step(session_id, features, dtype=self._dtype)
        _monitor.counter("serving_requests_total",
                         "requests admitted to the serving queue").inc(
            engine=self._name)
        self._observe_latency((time.perf_counter() - t0) * 1000.0,
                              _monitor.current_trace_hex(), tenant=tenant)
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
        under ``fn="cg.decode_step"`` or ``"mln.decode_step"`` (the
        ``_int8`` step of an int8 engine)."""
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
                    if self._qdecode is not None:
                        qp, ns = self._placed_params(0, 0)
                        self._qdecode(qp, ns, carries,
                                      tuple(xs) if self._is_graph else xs[0])
                    else:
                        model.decode_step(carries, *xs)
                    if i + 1 < len(ladder):
                        model.grow_decode_carries(carries, ladder[i + 1])
                    self._decode_warmed.add((bb, t, cap))
                    n += 1
        fn = self._prefix + (".decode_step_int8" if self._qdecode is not None
                             else ".decode_step")
        _monitor.counter(
            "serving_decode_warmups_total",
            "decode step shapes run for the first time by warmup_decode"
        ).inc(n, engine=self._name, fn=fn)
        return n

    # ------------------------------------------------------------- paging
    def model_bytes(self) -> int:
        """Device bytes ONE worker's resident copy of this model costs
        (params + state; the uint8 tree when ``quantize="int8"``), times
        the number of live weight versions (a staged canary doubles the
        footprint until promote or rollback drops one tree): the registry
        pager's accounting unit."""
        return self._model_bytes * max(1, len(self._weights))

    def resident_bytes(self) -> int:
        """Currently placed device bytes across workers and versions (0
        when paged out)."""
        with self._placed_lock:
            return self._model_bytes * len(self._placed)

    def is_resident(self) -> bool:
        return self.resident_bytes() > 0

    def ensure_resident(self) -> int:
        """Page this model's weights onto every worker device (no-op when
        already there), every live version, so that a staged canary
        survives a page-out and page-in.  Returns resident bytes."""
        for widx in range(len(self._devices)):
            for v in list(self._weights):
                self._placed_params(widx, v)
        return self.resident_bytes()

    def release_device_buffers(self) -> int:
        """Drop every worker's placed weights, all versions (the pager's
        evict primitive).  Bucket callables survive: they take the
        weights as call operands, so the next ``ensure_resident`` (or a
        request's lazy placement) reuses them.  The device memory returns
        to the caching allocator once in-flight batches, which hold their
        own references, are done.  Returns bytes released."""
        with self._placed_lock:
            freed = self._model_bytes * len(self._placed)
            self._placed = {}
            return freed

    # ---------------------------------------------------------- deployment
    @property
    def active_version(self) -> int:
        return self._active_version

    @property
    def canary_version(self) -> Optional[int]:
        return self._canary_version

    @property
    def canary_fraction(self) -> float:
        return self._canary_fraction

    def versions(self) -> List[int]:
        """Servable weight versions currently staged (active, canary and
        staged), ascending."""
        return sorted(self._weights)

    def _require_swappable(self) -> None:
        if self._quantize:
            raise ServingError(
                "weight hot-swap requires quantize=None: an int8 engine "
                "holds per-tensor decode specs of its own weights, so new "
                "weights would need to be quantized again; deploy the f32 "
                "engine and quantize offline instead")

    def stage_weights(self, params, net_state=None,
                      version: Optional[int] = None) -> int:
        """Register a weight tree (the network's per-layer dicts, tensors
        or numpy) as a servable version BESIDE the active one (no routing
        change, no callable made, no placement until traffic or
        ``ensure_resident`` touches it).  ``version=None`` allocates the
        next monotonic version.  Returns the version."""
        self._require_swappable()
        with self._placed_lock:
            if version is None:
                version = self._max_version_seen + 1
            version = int(version)
            if version <= self._max_version_seen:
                raise ValueError(
                    f"version {version} is not newer than "
                    f"{self._max_version_seen}; versions are monotonic")
            state = (net_state if net_state is not None
                     else self._model.net_state)
            self._weights[version] = (params, state)
            self._max_version_seen = version
        return version

    def set_canary(self, version: int, fraction: float = 0.1) -> None:
        """Route ``fraction`` of unpinned predict traffic to ``version``
        (a deterministic counter split, so tests and canary windows are
        exact, not stochastic)."""
        fraction = min(1.0, max(0.0, float(fraction)))
        with self._placed_lock:
            if version not in self._weights:
                raise ValueError(
                    f"unknown weight version {version}; staged: "
                    f"{sorted(self._weights)}")
            if version == self._active_version:
                raise ValueError(f"version {version} is already active")
            self._canary_version = int(version)
            self._canary_fraction = fraction
        _monitor.gauge(
            "deploy_canary_fraction",
            "fraction of predict traffic routed to the canary").set(
            fraction, model=self._name)

    def promote(self, version: Optional[int] = None) -> int:
        """Atomic pointer flip: make ``version`` (default: the canary) the
        active weights, retire the old active tree (kept only while live
        sessions pin it) and clear the canary.  The swap's wall time
        exports as ``deploy_swap_seconds``."""
        t0 = time.perf_counter()
        self._require_swappable()
        with self._placed_lock:
            if version is None:
                version = self._canary_version
            if version is None or version not in self._weights:
                raise ValueError(
                    f"cannot promote version {version}; staged: "
                    f"{sorted(self._weights)}")
            version = int(version)
            old = self._active_version
            self._active_version = version
            if self._canary_version == version:
                self._canary_version = None
                self._canary_fraction = 0.0
            if old != version and old in self._weights:
                self._retire_locked(old)
            self._purge_unpinned_locked()
        # place the new active tree now, so that the first request after
        # the swap pays no host-to-device copy
        for widx in range(len(self._devices)):
            self._placed_params(widx, version)
        _monitor.histogram(
            "deploy_swap_seconds",
            "wall time of a weight promote (pointer flip + placement)"
        ).observe(time.perf_counter() - t0, model=self._name)
        # the flip changes which live sessions count as pinned
        sessions = self._sessions
        if sessions is not None:
            sessions.refresh_gauges()
        _monitor.gauge(
            "deploy_version",
            "active served weight version").set(version, model=self._name)
        _monitor.gauge(
            "deploy_canary_fraction",
            "fraction of predict traffic routed to the canary").set(
            0.0, model=self._name)
        return version

    def rollback(self) -> Optional[int]:
        """Drop the canary: routing reverts to 100% active and the canary
        tree is discarded (kept only while sessions pin it).  Returns the
        dropped version (None when no canary was set)."""
        with self._placed_lock:
            cv = self._canary_version
            self._canary_version = None
            self._canary_fraction = 0.0
            if cv is not None and cv in self._weights \
                    and cv != self._active_version:
                self._retire_locked(cv)
            self._purge_unpinned_locked()
        _monitor.gauge(
            "deploy_canary_fraction",
            "fraction of predict traffic routed to the canary").set(
            0.0, model=self._name)
        return cv

    def swap_weights(self, params, net_state=None,
                     version: Optional[int] = None) -> int:
        """Stage and promote in one call: serve ``params`` as the active
        weights at once (no callable made: weights are operands).  The
        canary path is ``stage_weights`` + ``set_canary`` +
        ``promote``/``rollback``."""
        v = self.stage_weights(params, net_state=net_state, version=version)
        return self.promote(v)

    def warm_from_store(self, store, version: Optional[int] = None
                        ) -> Optional[int]:
        """Serve the weights of a :class:`~deeplearning4j_tpu_torch.deploy.
        store.VersionedWeightStore` snapshot (default: the latest), making
        the store the source of truth for what a fresh engine serves.
        The store's monotonic stamp becomes the active version when it is
        newer than anything staged; an empty store is a no-op.  Returns
        the store version now active, or None."""
        from ..deploy.store import tree_from_flat
        if version is None:
            version = store.latest()
        if version is None:
            return None
        snap = store.load(int(version))
        params = tree_from_flat(self._model, snap.flat)
        if snap.version > self._max_version_seen:
            self.swap_weights(params, version=snap.version)
        else:
            self.swap_weights(params)
        return snap.version

    def _retire_locked(self, version: int) -> None:
        """Drop ``version`` from the servable set; while a live session is
        pinned to it, its weights stay in ``_session_pins`` (worker 0's
        device copy; a snapshot of the live weights for the sentinel)."""
        if version in self._session_pinned_versions():
            self._session_pins[version] = self._place_locked(0, version)
        del self._weights[version]
        for key in [k for k in self._placed if k[1] == version]:
            del self._placed[key]

    def _purge_unpinned_locked(self) -> None:
        if not self._session_pins:
            return
        pinned = self._session_pinned_versions()
        for v in list(self._session_pins):
            if v not in pinned:
                del self._session_pins[v]

    def _session_pinned_versions(self):
        s = self._sessions
        return s.pinned_versions() if s is not None else set()

    def _route_version(self, version: Optional[int] = None) -> int:
        if version is not None:
            v = int(version)
            if v not in self._weights:
                raise ValueError(
                    f"unknown weight version {v}; staged: "
                    f"{sorted(self._weights)}")
            return v
        cv, frac = self._canary_version, self._canary_fraction
        if cv is not None and frac > 0.0:
            # deterministic evenly interleaved split (no burst of
            # canary-only traffic): request i goes to the canary when the
            # running quota floor(i * frac) ticks up
            i = next(self._route_counter)
            if int((i + 1) * frac) > int(i * frac):
                return cv
        return self._active_version

    def _host_weights(self, version: int):
        """The weights of ``version`` as registered: the uint8 tree of an
        int8 engine, the network's live weights for the sentinel, else
        the staged tree."""
        tree = self._weights[version]
        if tree is None:
            return (self._qparams if self._quantize
                    else self._model.params, self._model.net_state)
        return tree

    def _weights_for_version(self, version: int):
        """Device weights of a session pinned to ``version`` (None means
        "the network's live weights": the initial sentinel, or a version
        whose tree is gone)."""
        if version in self._weights:
            if self._weights[version] is None:
                return None
            return self._placed_params(0, version)
        return self._session_pins.get(version)

    # ------------------------------------------------------- introspection
    def stats(self) -> dict:
        d = {
            "running": self._running,
            "queue_depth": self._queue.qsize(),
            "queue_capacity": self._queue.maxsize,
            "executables": len(self._compiled),
            "workers": len(self._devices),
            "devices": [str(d) for d in self._devices],
            "quantize": self._quantize,
            "batch_buckets": list(self._policy.batch_buckets),
            "timestep_buckets": list(self._policy.timestep_buckets),
            "model_bytes": self.model_bytes(),
            "resident_bytes": self.resident_bytes(),
            "drain_rate_rps": round(self.drain_rate(), 2),
            "active_version": self._active_version,
            "canary_version": self._canary_version,
            "canary_fraction": self._canary_fraction,
            "versions": sorted(self._weights),
        }
        if self._admission is not None:
            d["admission"] = self._admission.snapshot()
            d["tenants"] = self._admission.tenant_snapshot()
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

    def _place_locked(self, widx: int, version: int):
        """Worker ``widx``'s device copy of ``version`` (made on first
        use; the caller holds ``_placed_lock``)."""
        placed = self._placed.get((widx, version))
        if placed is None:
            placed = _copy_tree(self._host_weights(version),
                                self._devices[widx])
            self._placed[(widx, version)] = placed
        return placed

    def _placed_params(self, widx: int, version: Optional[int] = None):
        """Worker ``widx``'s own copy of ``version``'s weights (default:
        the active version), placed on first use."""
        with self._placed_lock:
            if version is None or version not in self._weights:
                # the version was promoted away or rolled back between
                # enqueue and dispatch: serve the active tree (where the
                # request would go if resubmitted) rather than fail it
                version = self._active_version
            return self._place_locked(widx, version)

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
            if self._quantize:
                # decode + forward: the bucket callable over the uint8
                # tree (``serving.quantize.quantized_output``)
                from .quantize import quantized_output
                fn = quantized_output(self._model, self._qspecs, bucket=fn)
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
                req.t_dequeue = time.perf_counter()
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
                nxt.t_dequeue = time.perf_counter()
                self._observe_queue_depth()
                if (nxt.sig != req.sig
                        or nxt.version != req.version
                        or rows + nxt.n_rows
                        > self._policy.max_batch_size):
                    pending = nxt  # seeds the next batch (FIFO-fair)
                    break
                batch.append(nxt)
                rows += nxt.n_rows
            job = _BatchJob(batch, req.sig, rows, req.version)
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
        params, state = self._placed_params(widx, job.version)
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
        self._record_batch_spans(job, t0, now)
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
            self._observe_latency((now - r.t_enqueue) * 1000.0,
                                  f"{r.trace_id:032x}",
                                  version=job.version, tenant=r.tenant)
            off += r.n_rows

    def _record_batch_spans(self, job: _BatchJob, t_exec0: float,
                            t_done: float) -> None:
        """Reconstruct the request-level causality as trace spans: one
        ``serve/request`` span per member (parented under the context
        captured at submit time), with ``queue_wait`` /
        ``batch_assembly`` / ``dispatch`` child segments, plus one
        ``serve/batch`` span that *links* every coalesced request span
        (batch-to-request causality is N:1, not parent and child)."""
        tr = _monitor.tracer()
        wall_now = time.time()

        def wall(t_perf: float) -> float:
            return wall_now - (time.perf_counter() - t_perf)

        for r in job.requests:
            parent = r.ctx.span_id if r.ctx is not None else None
            tr.record_span(
                "serve/request", trace_id=r.trace_id, span_id=r.span_id,
                parent_id=parent, ts=r.t_wall,
                dur_ms=(t_done - r.t_enqueue) * 1e3,
                model=self._name, rows=r.n_rows)
            for seg, seg_t0, seg_t1 in (
                    ("serve/queue_wait", r.t_enqueue, r.t_dequeue),
                    ("serve/batch_assembly", r.t_dequeue, t_exec0),
                    ("serve/dispatch", t_exec0, t_done)):
                tr.record_span(
                    seg, trace_id=r.trace_id, parent_id=r.span_id,
                    ts=wall(seg_t0),
                    dur_ms=max(0.0, (seg_t1 - seg_t0) * 1e3))
        lead = job.requests[0]
        tr.record_span(
            "serve/batch", trace_id=lead.trace_id,
            ts=wall(lead.t_dequeue),
            dur_ms=max(0.0, (t_done - lead.t_dequeue) * 1e3),
            links=[r.span_id for r in job.requests],
            model=self._name, rows=job.rows,
            n_requests=len(job.requests))
