"""Asynchronous parameter-server data parallelism (port of
``deeplearning4j_tpu/scaleout/param_server.py``).

Reference: ``deeplearning4j-scaleout/deeplearning4j-scaleout-parallelwrapper/
.../parallelism/ParameterServerParallelWrapper.java`` (workers train
replicas and exchange parameters through ND4J's Aeron-based parameter
server — UDP media driver, native C++/Java; server node at ``:161``,
per-worker clients at ``:215-216``) and the ``nd4j-parameter-server``
update/subscribe model.

Synchronous data parallelism is ``parallel/parallel_wrapper.py``; the
*asynchronous* path — staleness-tolerant Hogwild-style updates, the reason
the reference runs a parameter server at all — keeps the Aeron push/pull
surface with two transports:

- :class:`ParameterServer` — the in-process store (threads sharing the
  per-chunk locks).
- :class:`TcpParameterServer` / :class:`TcpParameterServerClient` — the
  cross-process transport: a socket server owning the store, clients in
  other OS processes (or hosts) pushing deltas and pulling snapshots over
  a length-prefixed binary protocol.  This is the media-driver role; run
  one standalone with ``python -m deeplearning4j_tpu_torch.scaleout.
  param_server --serve --dim N --port P``.

The store is host numpy (float64), in the media driver's role, and the
wire is the JAX package's byte for byte: a port client talks to a JAX
server and a JAX client to the port's.  The replicas of
:class:`ParameterServerParallelWrapper` train on their network's device
(the card by default): each pull is one host-to-device copy of the flat
vector into the replica, each push one device-to-host copy out of it, as
the reference's design has it.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import random
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import monitor as _monitor
from ..datasets.dataset import DataSet
from ..monitor.locks import make_lock
from ..resilience import faults as _faults
from . import compression as _compression


#: default lock-shard / wire-chunk size (elements of the flat vector)
DEFAULT_CHUNK_SIZE = 65536

_LOCK_WAIT_HELP = ("seconds spent waiting on a parameter-chunk lock "
                   "(per-chunk shard contention)")


class ParameterServer:
    """Thread-safe parameter store with asynchronous delta application
    (the in-process stand-in for the reference's Aeron server).

    ``pull()`` returns a snapshot of the current flat parameters;
    ``push(delta)`` applies a worker's parameter delta scaled by
    ``update_scale`` (1/num_workers by default — concurrent full deltas
    would otherwise apply the same learning signal num_workers times).

    Locking is **sharded per chunk** of ``chunk_size`` elements: pushes
    touching disjoint chunks apply concurrently instead of serializing
    on one global lock, and every acquire records its wait on the
    ``server_lock_wait_seconds`` histogram so the contention win is
    measurable.  Consequently a ``pull()`` racing a ``push()`` may
    observe some chunks pre- and some post-update — exactly the
    staleness Hogwild training tolerates by design (each chunk is
    individually consistent; a quiescent server always reads clean).
    ``push_chunk``/``commit_push`` expose the chunk granularity to the
    streaming TCP front-end, which applies chunk records as they arrive
    off the socket instead of buffering whole messages.
    """

    def __init__(self, initial_params: np.ndarray,
                 update_scale: float = 1.0,
                 chunk_size: Optional[int] = None):
        self._params = np.array(initial_params, np.float64)
        self._flat = self._params.reshape(-1)
        self.update_scale = float(update_scale)
        self.chunk_size = int(chunk_size or DEFAULT_CHUNK_SIZE)
        self.bounds = _compression.chunk_bounds(self._flat.size,
                                                self.chunk_size)
        self._locks = [make_lock("scaleout.server.chunk")
                       for _ in self.bounds]
        self._meta = make_lock("scaleout.server.meta")
        self.pushes = 0
        self.version = 0

    @property
    def num_chunks(self) -> int:
        return len(self.bounds)

    @property
    def dim(self) -> int:
        return self._flat.size

    def _acquire(self, i: int) -> None:
        lock = self._locks[i]
        t0 = time.perf_counter()
        lock.acquire()
        _monitor.histogram("server_lock_wait_seconds",
                           _LOCK_WAIT_HELP).observe(
            time.perf_counter() - t0)

    def pull(self) -> np.ndarray:
        out = np.empty_like(self._flat)
        for i, (s, e) in enumerate(self.bounds):
            self._acquire(i)
            try:
                out[s:e] = self._flat[s:e]
            finally:
                self._locks[i].release()
        return out.reshape(self._params.shape)

    def pull_chunk(self, i: int) -> np.ndarray:
        s, e = self.bounds[i]
        self._acquire(i)
        try:
            return self._flat[s:e].copy()
        finally:
            self._locks[i].release()

    def push(self, delta: np.ndarray) -> int:
        d = np.asarray(delta, np.float64)
        if d.shape != self._params.shape:
            raise ValueError(
                f"delta shape {d.shape} != param shape "
                f"{self._params.shape} (a size-1 delta would silently "
                "broadcast-corrupt every parameter)")
        flat = d.reshape(-1)
        for i, (s, e) in enumerate(self.bounds):
            self._acquire(i)
            try:
                self._flat[s:e] += self.update_scale * flat[s:e]
            finally:
                self._locks[i].release()
        return self.commit_push()

    def push_chunk(self, i: int, values: np.ndarray) -> None:
        """Apply one chunk of a delta under that chunk's lock only (the
        streaming front-end's unit of application; call
        :meth:`commit_push` once per logical push after its last
        chunk)."""
        s, e = self.bounds[i]
        v = np.asarray(values, np.float64)
        if v.shape != (e - s,):
            raise ValueError(
                f"chunk {i} carries {v.shape} values, shard holds "
                f"{(e - s,)}")
        self._acquire(i)
        try:
            self._flat[s:e] += self.update_scale * v
        finally:
            self._locks[i].release()

    def commit_push(self) -> int:
        """Count one completed logical push; bumps the server version
        workers use for staleness-bounded pulls.  Returns the new
        version."""
        with self._meta:
            self.pushes += 1
            self.version += 1
            return self.version


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


# Wire v2 (hardened): every request is a self-delimiting frame
#   op(1) ‖ u64 req_id ‖ u64 payload_len ‖ payload
# and every response is
#   status(1: K ok / E rejected) ‖ u64 payload_len ‖ payload
# so both sides always know exactly how many bytes the peer owes them —
# a peer dying mid-message leaves a short read (ConnectionError), never
# a desynchronized stream.  ``req_id`` makes pushes idempotent: a client
# that times out after the server applied its delta retries with the
# SAME id and the server acks without re-applying.
_HEADER = struct.Struct(">cQQ")
_RESP_HEADER = struct.Struct(">cQ")


def _read_req_header(conn: socket.socket):
    """One request header ``(op, req_id, payload_len)``, or ``None`` on
    clean EOF at a frame boundary (mid-frame EOF raises ConnectionError
    — the caller counts it).  The payload is left on the socket so
    chunked ops can apply it as it streams in."""
    first = conn.recv(1)
    if not first:
        return None
    return _HEADER.unpack(first + _recv_exact(conn, _HEADER.size - 1))


def _read_frame(conn: socket.socket):
    """One fully-buffered request frame (non-streaming ops)."""
    head = _read_req_header(conn)
    if head is None:
        return None
    op, req_id, n = head
    payload = _recv_exact(conn, n) if n else b""
    return op, req_id, payload


def _send_frame(conn: socket.socket, op: bytes, req_id: int,
                payload: bytes = b"") -> None:
    conn.sendall(_HEADER.pack(op, req_id, len(payload)) + payload)


def _send_response(conn: socket.socket, status: bytes,
                   payload: bytes = b"") -> None:
    conn.sendall(_RESP_HEADER.pack(status, len(payload)) + payload)


def _read_response(conn: socket.socket) -> Tuple[bytes, bytes]:
    status, n = _RESP_HEADER.unpack(_recv_exact(conn, _RESP_HEADER.size))
    return status, (_recv_exact(conn, n) if n else b"")


class TcpParameterServer:
    """Socket front-end over a :class:`ParameterServer` — the
    cross-process transport (reference: the embedded Aeron MediaDriver +
    ``ParameterServerNode``, ``ParameterServerParallelWrapper.java:161``).

    Wire v2 — see the frame helpers above.  Request ops:
    ``P`` (pull: reply payload = f64 param bytes), ``U`` (push delta:
    idempotent on ``req_id``), ``S`` (stats: u64 push count), ``T``
    (trace context: payload = W3C ``traceparent``; the NEXT op on this
    connection records its server-side span under that context, so a
    worker's push stitches into the worker's distributed trace across
    the process boundary), ``D`` (trace dump: reply payload = JSON
    ``{"pid", "events"}`` of this process's span ring — how a test or
    ``tools/trace_view.py`` merges server-side spans into one timeline),
    ``Q`` (close).  A client dying mid-frame costs its own connection
    only (counted in ``param_server_client_disconnects_total``); the
    server and every other connection keep serving.

    Compressed wire (``compression.py``) — negotiated per
    connection; clients that skip it keep the raw ops above, so old and
    new clients interoperate:

    - ``C`` capability byte -> reply ``codec_id(1) ‖ u32 chunk_size``
      (most-compressed common codec; chunk geometry MUST match the
      store's lock shards).
    - ``Z`` compressed push: payload = chunk records ``u32 idx ‖ u32
      len ‖ enc``, **applied as they stream off the socket** (per-chunk
      lock, per-``(req_id, chunk)`` dedup — a retry after a mid-stream
      death re-sends every record and only the missing chunks apply).
      Reply = ``u64 version`` so the worker tracks staleness for free.
    - ``G`` coded pull: reply ``u64 version ‖ chunk records`` encoded
      with the dense variant of the negotiated codec.
    - ``V`` version probe: reply ``u64 version``.
    """

    #: remembered (req_id, chunk) keys for idempotent retries (FIFO).
    #: Chunked pushes consume one entry per chunk, so the window is
    #: sized well above DEDUP_PUSHES x typical chunk counts.
    DEDUP_WINDOW = 65536

    #: codecs this server accepts (capability mask for ``C``)
    CAPABILITIES = _compression.CAP_ALL

    def __init__(self, server: ParameterServer, host: str = "127.0.0.1",
                 port: int = 0):
        self.server = server
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._lock = make_lock("scaleout.tcp.dedup")
        # keys: (req_id, -1) for whole raw pushes, (req_id, chunk_idx)
        # for streamed chunk records
        self._seen: "collections.OrderedDict[Tuple[int, int], None]" = \
            collections.OrderedDict()
        self._first_push_ts: Optional[float] = None
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._accept.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            with self._lock:
                # prune finished handlers so a long-lived server doesn't
                # grow a dead-Thread list without bound
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
                self._conns = [c for c in self._conns if c.fileno() >= 0]
                self._conns.append(conn)

    def _push_once(self, req_id: int, delta: np.ndarray) -> None:
        """Apply a push exactly once per ``req_id``: a retried frame
        whose first attempt already landed is acked without re-applying
        (the id is recorded AFTER the apply and BEFORE the ack, so a
        crash between apply and ack is covered by the retry's dedup
        lookup, never by double-application)."""
        with self._lock:
            if (req_id, -1) in self._seen:
                _monitor.counter(
                    "param_server_duplicate_pushes_total",
                    "retried pushes deduplicated by request id").inc()
                return
            # check+apply+mark under one lock: a retry racing its own
            # first attempt on another handler thread must not
            # double-apply
            self.server.push(delta)
            self._seen[(req_id, -1)] = None
            self._trim_seen()
        self._note_push()

    def _trim_seen(self) -> None:
        while len(self._seen) > self.DEDUP_WINDOW:
            self._seen.popitem(last=False)

    def _apply_chunk_once(self, req_id: int, chunk_idx: int,
                          values: np.ndarray) -> bool:
        """Apply one streamed chunk record exactly once per
        ``(req_id, chunk)``; returns whether it applied (False = a
        retry's duplicate).  The chunk lock itself lives in the store —
        this dedup lock is held only for the membership check, so
        records for disjoint chunks apply concurrently."""
        with self._lock:
            if (req_id, chunk_idx) in self._seen:
                _monitor.counter(
                    "param_server_duplicate_pushes_total",
                    "retried pushes deduplicated by request id").inc()
                return False
            self._seen[(req_id, chunk_idx)] = None
            self._trim_seen()
        self.server.push_chunk(chunk_idx, values)
        return True

    def _note_push(self) -> None:
        """Refresh the push-throughput gauge (pushes/sec since the
        first push this server saw)."""
        now = time.perf_counter()
        if self._first_push_ts is None:
            self._first_push_ts = now
        elapsed = now - self._first_push_ts
        if elapsed > 0:
            _monitor.gauge(
                "scaleout_pushes_per_sec",
                "parameter-server push throughput since first push").set(
                self.server.pushes / elapsed)

    @staticmethod
    def _wire(direction: str, codec_id: int, nbytes: int) -> None:
        _monitor.counter(
            "scaleout_wire_bytes_total",
            "parameter-server wire bytes by direction and codec").inc(
            nbytes, dir=direction,
            codec=_compression.CODEC_NAMES.get(codec_id, "?"))

    _OP_NAMES = {b"P": "pull", b"U": "push", b"S": "stats",
                 b"Z": "push", b"G": "pull", b"C": "negotiate",
                 b"V": "version"}

    def _stream_push(self, conn: socket.socket, req_id: int,
                     nbytes: int, codec: Optional[int]) -> bytes:
        """Consume one ``Z`` payload **chunk record by chunk record**,
        applying each to its lock shard as soon as it is off the socket
        — no full-message buffering, so a large delta starts landing
        while its tail is still in flight.  Returns the response payload
        (``u64 version``); raises ValueError after draining the stream
        on semantic errors so the connection stays frame-synchronized."""
        consumed = 0
        applied = 0
        error: Optional[str] = None
        while consumed < nbytes:
            head = _recv_exact(conn, _compression._RECORD_HEAD.size)
            idx, enc_len = _compression._RECORD_HEAD.unpack(head)
            enc = _recv_exact(conn, enc_len) if enc_len else b""
            consumed += _compression._RECORD_HEAD.size + enc_len
            if error is not None:
                continue            # drain the rest, stay synchronized
            if codec is None:
                error = "compressed push before codec negotiation"
                continue
            try:
                if idx >= self.server.num_chunks:
                    raise ValueError(
                        f"chunk index {idx} out of range "
                        f"({self.server.num_chunks} chunks)")
                s, e = self.server.bounds[idx]
                values = _compression.decode_chunk(codec, enc, e - s)
                if self._apply_chunk_once(req_id, idx, values):
                    applied += 1
            except ValueError as exc:
                error = str(exc)
        if error is not None:
            raise ValueError(error)
        if applied:
            version = self.server.commit_push()
            self._note_push()
        else:
            # full-duplicate retry: the logical push already counted
            version = self.server.version
        return struct.pack(">Q", version)

    def _coded_pull(self, codec: int) -> bytes:
        """``u64 version ‖ chunk records`` — each chunk copied under its
        own shard lock (a concurrent push may land between chunks; that
        is the Hogwild staleness contract, same as the sharded
        :meth:`ParameterServer.pull`)."""
        version = self.server.version
        dense = _compression.dense_codec(codec)
        records = [(i, _compression.encode_chunk(
            dense, self.server.pull_chunk(i)))
            for i in range(self.server.num_chunks)]
        return struct.pack(">Q", version) + _compression.pack_records(
            records)

    def _serve_conn(self, conn: socket.socket) -> None:
        pending_ctx = None  # set by a T frame, consumed by the next op
        codec: Optional[int] = None        # negotiated by C
        last_pull_version = 0              # staleness accounting
        try:
            with conn:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                while True:
                    head = _read_req_header(conn)
                    if head is None:
                        return
                    op, req_id, nbytes = head
                    if op == b"Z":
                        # streaming op: payload applied as it arrives
                        ctx, pending_ctx = pending_ctx, None
                        self._wire("in", codec
                                   if codec is not None else -1,
                                   nbytes + _HEADER.size)
                        with _monitor.tracer().span(
                                "param_server/push", ctx=ctx,
                                nbytes=nbytes,
                                codec=_compression.CODEC_NAMES.get(
                                    codec, "?")):
                            try:
                                body = self._stream_push(
                                    conn, req_id, nbytes, codec)
                            except ValueError as exc:
                                _send_response(conn, b"E",
                                               str(exc).encode("utf-8"))
                                continue
                            _monitor.gauge(
                                "scaleout_staleness",
                                "server versions since this worker's "
                                "last pull, sampled at each push").set(
                                self.server.version - last_pull_version)
                            self._wire("out", codec, len(body)
                                       + _RESP_HEADER.size)
                            _send_response(conn, b"K", body)
                        continue
                    payload = _recv_exact(conn, nbytes) if nbytes else b""
                    if op == b"Q":
                        return
                    if op == b"T":
                        pending_ctx = _monitor.parse_traceparent(
                            payload.decode("utf-8", "replace"))
                        _send_response(conn, b"K")
                        continue
                    if op == b"D":
                        _send_response(conn, b"K", json.dumps({
                            "pid": os.getpid(),
                            "events": _monitor.tracer().events(),
                        }, default=str).encode("utf-8"))
                        continue
                    if op == b"C":
                        chosen = _compression.negotiate(
                            self.CAPABILITIES,
                            payload[0] if payload else 0)
                        if chosen is None:
                            _send_response(conn, b"E",
                                           b"no common codec")
                            continue
                        codec = chosen
                        _send_response(conn, b"K", bytes([chosen])
                                       + struct.pack(
                                           ">I", self.server.chunk_size))
                        continue
                    ctx, pending_ctx = pending_ctx, None
                    with _monitor.tracer().span(
                            "param_server/"
                            + self._OP_NAMES.get(op, "unknown"),
                            ctx=ctx, nbytes=nbytes):
                        if op == b"P":
                            body = self.server.pull().tobytes()
                            self._wire("in", 0, _HEADER.size)
                            self._wire("out", 0,
                                       len(body) + _RESP_HEADER.size)
                            last_pull_version = self.server.version
                            _send_response(conn, b"K", body)
                        elif op == b"U":
                            self._wire("in", 0,
                                       nbytes + _HEADER.size)
                            delta = np.frombuffer(payload, np.float64)
                            try:
                                self._push_once(req_id, delta)
                            except ValueError as exc:
                                _send_response(conn, b"E",
                                               str(exc).encode("utf-8"))
                                continue
                            _monitor.gauge(
                                "scaleout_staleness",
                                "server versions since this worker's "
                                "last pull, sampled at each push").set(
                                self.server.version - last_pull_version)
                            _send_response(conn, b"K")
                        elif op == b"G":
                            if codec is None:
                                _send_response(
                                    conn, b"E",
                                    b"coded pull before codec "
                                    b"negotiation")
                                continue
                            body = self._coded_pull(codec)
                            self._wire("in", codec, _HEADER.size)
                            self._wire(
                                "out", _compression.dense_codec(codec),
                                len(body) + _RESP_HEADER.size)
                            last_pull_version, = struct.unpack(
                                ">Q", body[:8])
                            _send_response(conn, b"K", body)
                        elif op == b"V":
                            _send_response(conn, b"K", struct.pack(
                                ">Q", self.server.version))
                        elif op == b"S":
                            _send_response(conn, b"K", struct.pack(
                                ">Q", self.server.pushes))
                        else:
                            _send_response(conn, b"E",
                                           f"unknown op {op!r}".encode())
                            return
        except (ConnectionError, OSError):
            # a worker died mid-message (SIGKILL, network partition):
            # its connection is torn down, the store and every other
            # connection are untouched
            _monitor.counter(
                "param_server_client_disconnects_total",
                "connections lost mid-message (worker death)").inc()
            return

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            # wake clients blocked in recv with EOF instead of leaving
            # them to their own socket timeout
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass


class TcpParameterServerClient:
    """Push/pull client over TCP — duck-typed to :class:`ParameterServer`
    so :class:`ParameterServerParallelWrapper` workers use either
    transport interchangeably (reference ``ParameterServerClient``,
    ``ParameterServerParallelWrapper.java:215-216``).  One client per
    worker thread; a socket is not shared.

    Hardened (wire v2): connections are lazy and re-established on
    failure (bounded by ``max_retries``), requests retry with
    exponential backoff + jitter, and pushes carry a stable ``req_id``
    so a retry after a lost ack is deduplicated server-side instead of
    double-applied.  ``E`` responses (semantic rejection, e.g. a
    dimension mismatch) raise ``ValueError`` immediately — they are
    deterministic and never retried.

    Compressed wire: pass ``codec`` (``"f32"``, ``"int8"``, ``"topk8"``
    or ``"auto"``) to negotiate a delta codec per connection
    (re-negotiated transparently after a reconnect) and use
    :meth:`push_delta` / :meth:`pull_coded` instead of the raw
    :meth:`push` / :meth:`pull`.  Lossy codecs carry an
    :class:`~.compression.ErrorFeedback` residual on this client; push
    acks return the server version so :meth:`staleness` is free —
    workers pull only when it exceeds their bound."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 max_retries: int = 5, backoff_base: float = 0.05,
                 backoff_max: float = 2.0,
                 codec: Optional[str] = None,
                 topk_fraction: float = 0.1):
        self._address = (host, port)
        self._timeout = float(timeout)
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self._conn: Optional[socket.socket] = None
        self._ever_connected = False
        # two locks, never nested the other way around: the io lock
        # serializes whole wire round trips (taken inside _request
        # only); the state lock covers residual/version mutation and is
        # never held across socket I/O
        self._io_lock = make_lock("scaleout.client.io")
        self._lock = make_lock("scaleout.client.state")
        rng = random.Random()
        self._jitter = rng.uniform
        # unique-per-client id stream; the random base keeps ids from
        # different clients (and client restarts) disjoint in the
        # server's dedup window
        self._req_ids = itertools.count(rng.getrandbits(64))
        self._cap_mask = _compression.capability_mask(codec)
        self.topk_fraction = float(topk_fraction)
        self.codec_id: Optional[int] = None    # set by negotiation
        self.chunk_size: Optional[int] = None  # server's shard geometry
        self._conn_negotiated = False          # per-connection state
        self._ef: Optional[_compression.ErrorFeedback] = None
        self.server_version = 0   # latest version seen in any ack
        self.local_version = 0    # version our params correspond to

    def _ensure_conn(self) -> socket.socket:
        if self._conn is None:
            self._conn = socket.create_connection(
                self._address, timeout=self._timeout)
            self._conn.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
            if self._ever_connected:
                _monitor.counter(
                    "param_server_reconnects_total",
                    "client TCP reconnects after a failure").inc()
            self._ever_connected = True
        return self._conn

    def _drop_conn(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None
        self._conn_negotiated = False

    def _negotiate_on_conn(self, conn: socket.socket) -> None:
        """``C`` exchange on the current socket (codec state is
        per-connection, so a reconnect re-negotiates before the retried
        frame goes out)."""
        _send_frame(conn, b"C", 0, bytes([self._cap_mask]))
        status, body = _read_response(conn)
        if status != b"K":
            raise ValueError(body.decode("utf-8", "replace")
                             or "codec negotiation rejected")
        chosen = body[0]
        (chunk_size,) = struct.unpack(">I", body[1:5])
        if self.codec_id is not None and chosen != self.codec_id:
            # a server restart with different capabilities mid-run
            # would silently corrupt the error-feedback residual
            raise ValueError(
                f"server renegotiated codec "
                f"{_compression.CODEC_NAMES.get(chosen)} != established "
                f"{_compression.CODEC_NAMES.get(self.codec_id)}")
        self.codec_id = chosen
        self.chunk_size = chunk_size
        self._conn_negotiated = True

    def _request(self, op: bytes, payload: bytes, req_id: int,
                 ctx=None, coded: bool = False) -> bytes:
        """One framed request with bounded retry, serialized on the io
        lock.  Transport failures anywhere in the round trip tear the
        socket down and retry the SAME frame (same ``req_id`` — the
        server dedups pushes whose first attempt landed).  With ``ctx``
        (a :class:`~..monitor.TraceContext`) a ``T`` frame precedes the
        request inside each attempt, so the server-side span lands in
        the caller's trace even across a reconnect.  ``coded`` requests
        are preceded by a ``C`` negotiation on any not-yet-negotiated
        connection."""
        with self._io_lock:
            # the socket IS the shared state here: one connection carries one round trip at a time, and the retry/backoff loop must be exclusive so interleaved frames from another thread cannot corrupt request/response pairing; one client per worker thread keeps this uncontended
            return self._request_locked(op, payload, req_id, ctx, coded)

    def _request_locked(self, op: bytes, payload: bytes, req_id: int,
                        ctx, coded: bool) -> bytes:
        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            try:
                conn = self._ensure_conn()
                if coded and not self._conn_negotiated:
                    if self._cap_mask is None:
                        raise ValueError(
                            "this client was built without a codec: "
                            "pass codec= to use push_delta/pull_coded")
                    self._negotiate_on_conn(conn)
                if ctx is not None:
                    _send_frame(conn, b"T", req_id,
                                ctx.traceparent().encode("utf-8"))
                    status, _body = _read_response(conn)
                    if status != b"K":
                        raise ConnectionError(
                            f"bad T response status {status!r}")
                _send_frame(conn, op, req_id, payload)
                if op in (b"U", b"Z") and _faults.drop_connection():
                    # fault point: the request is on the wire (the
                    # server may apply it) but the ack never arrives
                    self._drop_conn()
                    raise ConnectionError(
                        "fault-injected connection drop")
                status, body = _read_response(conn)
                if status == b"E":
                    raise ValueError(body.decode("utf-8", "replace")
                                     or "server rejected request")
                if status != b"K":
                    raise ConnectionError(
                        f"bad response status {status!r}")
                return body
            except (ConnectionError, OSError) as exc:
                last = exc
                self._drop_conn()
                if attempt >= self.max_retries:
                    break
                _monitor.counter(
                    "param_server_retries_total",
                    "request retries after transport failures").inc()
                delay = min(self.backoff_max,
                            self.backoff_base * (2.0 ** attempt))
                time.sleep(delay * self._jitter(0.5, 1.0))
        raise ConnectionError(
            f"parameter server at {self._address[0]}:{self._address[1]} "
            f"unreachable after {self.max_retries + 1} attempts: "
            f"{last}") from last

    def pull(self) -> np.ndarray:
        with _monitor.span("param_server_client/pull"):
            body = self._request(b"P", b"", next(self._req_ids),
                                 ctx=_monitor.current_context())
        return np.frombuffer(body, np.float64).copy()

    def push(self, delta: np.ndarray) -> None:
        data = np.asarray(delta, np.float64).tobytes()
        with _monitor.span("param_server_client/push",
                           nbytes=len(data)):
            self._request(b"U", data, next(self._req_ids),
                          ctx=_monitor.current_context())

    # -- compressed/coded surface ---------------------------------------

    def _ensure_negotiated(self) -> None:
        """Resolve codec + chunk geometry before building a coded
        payload (a cheap ``V`` probe triggers the ``C`` preamble)."""
        if self.codec_id is None or self.chunk_size is None:
            body = self._request(b"V", b"", next(self._req_ids),
                                 coded=True)
            with self._lock:
                (self.server_version,) = struct.unpack(">Q", body)

    def push_delta(self, delta: np.ndarray) -> int:
        """Compressed, error-fed push.  Encodes ``delta + residual``
        under the negotiated codec, streams it as chunk records, and
        returns the server version from the ack (feeding
        :meth:`staleness`).  The payload is encoded ONCE per logical
        push — a transport retry re-sends identical bytes, so the
        server's per-chunk dedup and this client's residual stay
        consistent under at-least-once delivery."""
        flat = np.asarray(delta, np.float64).reshape(-1)
        self._ensure_negotiated()
        with self._lock:
            # residual mutation only — the wire round trip happens
            # outside so a slow server never stalls other state readers
            if self._ef is None or self._ef.residual.size != flat.size:
                self._ef = _compression.ErrorFeedback(
                    flat.size, self.codec_id, self.chunk_size,
                    self.topk_fraction)
            payload = _compression.pack_records(self._ef.encode(flat))
        with _monitor.span(
                "param_server_client/push",
                nbytes=len(payload),
                codec=_compression.CODEC_NAMES[self.codec_id]):
            body = self._request(b"Z", payload,
                                 next(self._req_ids),
                                 ctx=_monitor.current_context(),
                                 coded=True)
        with self._lock:
            (self.server_version,) = struct.unpack(">Q", body)
            version = self.server_version
        self._wire_client("out", self.codec_id, len(payload))
        return version

    def pull_coded(self) -> np.ndarray:
        """Full parameter snapshot under the dense variant of the
        negotiated codec; synchronizes :meth:`staleness` to zero."""
        self._ensure_negotiated()
        with _monitor.span(
                "param_server_client/pull",
                codec=_compression.CODEC_NAMES[self.codec_id]):
            body = self._request(b"G", b"", next(self._req_ids),
                                 ctx=_monitor.current_context(),
                                 coded=True)
        (version,) = struct.unpack(">Q", body[:8])
        dense = _compression.dense_codec(self.codec_id)
        bounds = None
        if self.chunk_size:
            # total dim is whatever the records cover; bounds are
            # rebuilt once the payload names the last chunk
            records = _compression.unpack_records(body[8:])
            dim = 0
            for idx, enc in records:
                if dense == _compression.CODEC_F32:
                    dim += len(enc) // 4
                else:
                    dim += len(enc) - 8   # int8: 8-byte affine head
            bounds = _compression.chunk_bounds(dim, self.chunk_size)
        params = _compression.decode_dense(dense, body[8:], bounds)
        with self._lock:
            self.server_version = self.local_version = version
        self._wire_client("in", dense, len(body))
        return params

    def staleness(self) -> int:
        """Server versions elapsed since this client's last coded pull
        (updated for free by every push ack)."""
        return self.server_version - self.local_version

    def version(self) -> int:
        """The server's current version counter (``V`` probe)."""
        body = self._request(b"V", b"", next(self._req_ids),
                             coded=self._cap_mask is not None)
        (v,) = struct.unpack(">Q", body)
        with self._lock:
            self.server_version = v
        return v

    @staticmethod
    def _wire_client(direction: str, codec_id: int, nbytes: int) -> None:
        _monitor.counter(
            "scaleout_wire_bytes_total",
            "parameter-server wire bytes by direction and codec").inc(
            nbytes, dir=direction,
            codec=_compression.CODEC_NAMES.get(codec_id, "?"))

    def dump_trace(self) -> Dict:
        """The server process's span ring: ``{"pid": int, "events":
        [...]}`` — merge with the local tracer's events to render one
        cross-process timeline."""
        body = self._request(b"D", b"", next(self._req_ids))
        return json.loads(body.decode("utf-8"))

    @property
    def pushes(self) -> int:
        body = self._request(b"S", b"", next(self._req_ids))
        (n,) = struct.unpack(">Q", body)
        return n

    def close(self) -> None:
        if self._conn is not None:
            try:
                _send_frame(self._conn, b"Q", 0)
            except OSError:
                pass
            self._drop_conn()

    def __enter__(self) -> "TcpParameterServerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ParameterServerParallelWrapper:
    """Asynchronous multi-replica trainer over a :class:`ParameterServer`
    (reference ``ParameterServerParallelWrapper``).

    Each worker owns a full model replica; per fit round it pulls the
    server's parameters, trains ``batches_per_push`` minibatches locally
    (the network's eager step on its device), and pushes its parameter
    delta.  Updates are
    staleness-tolerant: no barrier between workers.
    """

    def __init__(self, model, num_workers: int = 2,
                 batches_per_push: int = 1,
                 update_scale: Optional[float] = None,
                 server_address: Optional[tuple] = None,
                 codec: Optional[str] = None,
                 staleness_bound: int = 0):
        """``server_address=(host, port)`` switches workers to the TCP
        transport against an external server process (reference: Aeron
        clients against a remote ParameterServerNode); default is the
        in-process store.  In TCP mode the SERVER owns ``update_scale``
        (``--update-scale`` on its command line) — passing it here would
        be silently ignored, so it raises instead.  ``codec`` (TCP mode
        only) switches workers to the compressed wire; with
        ``staleness_bound > 0`` they keep training on their local
        replica and re-pull only once the push-ack version says they
        are more than ``staleness_bound`` versions stale."""
        self.model = model.init() if hasattr(model, "init") else model
        self.num_workers = int(num_workers)
        self.batches_per_push = int(batches_per_push)
        self._address = server_address
        self.codec = codec
        self.staleness_bound = int(staleness_bound)
        if server_address is None:
            if codec is not None:
                raise ValueError("codec applies to the TCP transport; "
                                 "the in-process store has no wire")
            scale = (1.0 / self.num_workers if update_scale is None
                     else update_scale)
            self.server = ParameterServer(self.model.get_flat_params(),
                                          scale)
        else:
            if update_scale is not None:
                raise ValueError(
                    "update_scale is server-side in TCP mode: launch the "
                    "server with --update-scale instead")
            self.server = TcpParameterServerClient(*server_address,
                                                   codec=codec)
        self._replicas = [self.model.clone()
                          for _ in range(self.num_workers)]
        self._errors: List[BaseException] = []

    def close(self) -> None:
        """Release the transport (the TCP client socket; no-op for the
        in-process store)."""
        if self._address is not None and self.server is not None:
            self.server.close()
            self.server = None

    def __enter__(self) -> "ParameterServerParallelWrapper":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _make_worker_client(self):
        """Each worker needs its own transport endpoint (sockets are not
        shared across threads; the in-process store is)."""
        if self._address is None:
            return self.server
        return TcpParameterServerClient(*self._address, codec=self.codec)

    def _worker(self, rank: int, replica,
                batches: List[DataSet]) -> None:
        server = None
        coded = self._address is not None and self.codec is not None
        try:
            server = self._make_worker_client()
            i = 0
            local = None    # coded path: staleness-bounded local params
            while i < len(batches):
                _faults.slow_worker(rank)   # straggler fault point
                #                             (no-op unless DL4J_TPU_
                #                             FAULT_SLOW_WORKER_MS armed;
                #                             rank:ms targets one worker)
                if coded:
                    if local is None or (server.staleness()
                                         > self.staleness_bound):
                        local = server.pull_coded()
                    start = local
                else:
                    start = server.pull()
                replica.set_flat_params(start)
                for _ in range(self.batches_per_push):
                    if i >= len(batches):
                        break
                    replica._fit_batch(batches[i])
                    i += 1
                delta = replica.get_flat_params() - start
                if coded:
                    server.push_delta(delta)
                    local = start + delta   # keep training locally until
                    #                         the staleness bound trips
                else:
                    server.push(delta)
        except BaseException as e:  # surfaced after join
            self._errors.append(e)
        finally:
            if server is not None and server is not self.server:
                server.close()

    def fit(self, iterator, epochs: int = 1):
        """Split each epoch's batches round-robin across workers and train
        asynchronously; the consolidated server parameters land back in
        ``self.model``."""
        self._errors = []  # a past failed fit must not poison this one
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            batches = list(iterator) if not isinstance(iterator, list) \
                else iterator
            shards: List[List[DataSet]] = [[] for _ in
                                           range(self.num_workers)]
            for i, b in enumerate(batches):
                shards[i % self.num_workers].append(b)
            threads = [threading.Thread(target=self._worker,
                                        args=(rank, r, s), daemon=True)
                       for rank, (r, s) in enumerate(
                           zip(self._replicas, shards)) if s]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if self._errors:
                raise self._errors[0]
        self.model.set_flat_params(self.server.pull())
        return self.model


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone parameter-server process (the MediaDriver+node role):
    ``python -m deeplearning4j_tpu_torch.scaleout.param_server --serve --dim N
    [--port P] [--init params.npy] [--update-scale S]``.  Prints one JSON
    line ``{"host":..., "port":...}`` on stdout when ready."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true", required=True)
    ap.add_argument("--dim", type=int, default=None)
    ap.add_argument("--init", type=str, default=None,
                    help=".npy with initial flat params (overrides --dim)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--update-scale", type=float, default=1.0)
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="lock-shard / wire-chunk size in elements")
    args = ap.parse_args(argv)

    if args.init:
        init = np.load(args.init)
    elif args.dim is not None:
        init = np.zeros(args.dim, np.float64)
    else:
        ap.error("--dim or --init required")
    store = ParameterServer(init, update_scale=args.update_scale,
                            chunk_size=args.chunk_size)
    srv = TcpParameterServer(store, host=args.host, port=args.port)
    print(json.dumps({"host": srv.host, "port": srv.port}), flush=True)
    try:
        threading.Event().wait()  # serve until killed
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
