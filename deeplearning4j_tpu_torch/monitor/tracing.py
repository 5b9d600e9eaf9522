"""Distributed tracing: W3C-propagated trace contexts in a ring buffer
(port of ``deeplearning4j_tpu/monitor/tracing.py``; pure Python, the same
ids, events and exports).

``span("fit/epoch")`` is a context manager; finished spans land in a
bounded thread-safe ring buffer with parent/child nesting (per-thread
parent stack), per-span wall time, and arbitrary JSON-able attributes.
Beyond single-process nesting, three mechanisms make the traces
*distributed*:

- **Identity.** Every span belongs to a 128-bit ``trace_id`` and has a
  64-bit span id whose top bits are salted with the recording pid, so
  span ids from two OS processes never alias when their dumps are
  merged.  The low 40 bits are a plain per-process counter, so ids stay
  deterministic within one process (test-friendly).
- **Context.** :class:`TraceContext` is the (trace_id, span_id, flags)
  triple.  It serializes to/from the W3C ``traceparent`` header
  (``00-<32 hex>-<16 hex>-<2 hex>``) via :meth:`TraceContext.traceparent`
  and :func:`parse_traceparent`, and can be explicitly attached to the
  current thread (:func:`attach` / :func:`detach`) so causality survives
  queue and thread handoffs: a span opened with no enclosing local span
  parents under the attached remote context instead of starting a fresh
  trace.
- **Links.** A span may carry ``links=[span_id, ...]`` — causal
  references to spans that are not its parent (e.g. a serving batch span
  linking the N request spans it coalesced).

The dump format is the Chrome trace-event format, one complete event
(``"ph": "X"``) per span — ``to_jsonl()`` emits one event per line and
``to_chrome_json()`` the ready-to-load JSON array (Perfetto /
chrome://tracing).  Still-open spans are visible via
:meth:`Tracer.active_spans` so an incident dump (see
:mod:`.flight_recorder`) shows what was in flight at the moment of
death.

Overhead budget: one ``perf_counter`` pair, a dict build and a deque
append per span — sub-10 µs, safe to put around per-iteration work (the
per-phase *histograms* in :mod:`.metrics` are the per-iteration hot-path
surface; spans mark the structural regions: requests, batches, epochs,
dispatch windows, compiles, parallel rounds).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Union

DEFAULT_CAPACITY = 4096

# Span ids are 64-bit: [24 bits of pid salt | 40 bits of counter].
_SPAN_COUNTER_BITS = 40
_SPAN_COUNTER_MASK = (1 << _SPAN_COUNTER_BITS) - 1
_PID_SALT_MASK = 0xFFFFFF

_TRACEPARENT_VERSION = "00"


def new_trace_id() -> int:
    """A fresh random 128-bit trace id (never 0 — 0 is invalid per W3C)."""
    while True:
        tid = int.from_bytes(os.urandom(16), "big")
        if tid:
            return tid


def _trace_hex(trace_id: Union[int, str]) -> str:
    """Normalize a trace id (int or hex string) to 32 lowercase hex."""
    if isinstance(trace_id, int):
        return f"{trace_id:032x}"
    return trace_id.lower().zfill(32)


class TraceContext:
    """An immutable (trace_id, span_id, flags) propagation triple."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: int, span_id: int, flags: int = 1):
        self.trace_id = int(trace_id)
        self.span_id = int(span_id)
        self.flags = int(flags)

    def traceparent(self) -> str:
        """The W3C ``traceparent`` header value for this context."""
        return (f"{_TRACEPARENT_VERSION}-{self.trace_id:032x}"
                f"-{self.span_id:016x}-{self.flags:02x}")

    def child(self, span_id: int) -> "TraceContext":
        """Same trace, new active span (what a server hands downstream)."""
        return TraceContext(self.trace_id, span_id, self.flags)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id)

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id))

    def __repr__(self) -> str:
        return f"TraceContext({self.traceparent()!r})"


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """Decode a W3C ``traceparent`` header; ``None`` on anything invalid
    (malformed, wrong field widths, the all-zero trace/span ids, version
    ``ff``).  Lenient on unknown future versions per the spec."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_hex, span_hex, flags_hex = parts[0], parts[1], \
        parts[2], parts[3]
    if len(version) != 2 or len(trace_hex) != 32 or len(span_hex) != 16 \
            or len(flags_hex) != 2 or version.lower() == "ff":
        return None
    try:
        trace_id = int(trace_hex, 16)
        span_id = int(span_hex, 16)
        flags = int(flags_hex, 16)
    except ValueError:
        return None
    if trace_id == 0 or span_id == 0:
        return None
    return TraceContext(trace_id, span_id, flags)


class Tracer:
    """Bounded ring buffer of finished spans + per-thread nesting stack
    + per-thread attached remote contexts + open-span registry."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._buf = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._active: Dict[int, Dict] = {}
        self._dropped = 0

    def _append(self, event: Dict, pop_active: Optional[int] = None
                ) -> None:
        """Ring append + silent-eviction accounting.  The deque evicts
        its oldest span on overflow with no signal; counting the drops
        makes a truncated ``/trace`` timeline detectable."""
        with self._lock:
            if pop_active is not None:
                self._active.pop(pop_active, None)
            dropped = (self._buf.maxlen is not None
                       and len(self._buf) == self._buf.maxlen)
            if dropped:
                self._dropped += 1
            self._buf.append(event)
        if dropped:
            # lazy: metrics.py imports this module at load time
            from .metrics import registry as _registry
            try:
                _registry().counter(
                    "trace_spans_dropped_total",
                    "finished spans evicted unexported from the tracer "
                    "ring buffer").inc()
            except Exception:
                pass

    def dropped_count(self) -> int:
        """Finished spans evicted from the ring since the last
        :meth:`clear` — nonzero means :meth:`events` is a truncated
        view of what actually ran."""
        with self._lock:
            return self._dropped

    # ---------------------------------------------------------------- ids
    def next_span_id(self) -> int:
        """A fresh pid-salted 64-bit span id: the top 24 bits carry the
        recording pid so ids from different OS processes never collide
        in a merged trace; the low 40 bits are a deterministic
        per-process counter.  The pid is read per call, so ids stay
        correct across ``fork()``."""
        salt = (os.getpid() & _PID_SALT_MASK) << _SPAN_COUNTER_BITS
        return salt | (next(self._ids) & _SPAN_COUNTER_MASK)

    # ------------------------------------------------------------ context
    def _ctx_stack(self) -> list:
        stk = getattr(self._local, "ctx", None)
        if stk is None:
            stk = self._local.ctx = []
        return stk

    def attach(self, ctx: TraceContext) -> TraceContext:
        """Make ``ctx`` the ambient parent for spans opened on this
        thread with no enclosing local span.  Returns a token to pass to
        :meth:`detach` (the context itself)."""
        self._ctx_stack().append(ctx)
        return ctx

    def detach(self, token: TraceContext) -> None:
        """Undo an :meth:`attach`; removes the innermost matching
        attachment (no-op if already detached)."""
        stk = self._ctx_stack()
        for i in range(len(stk) - 1, -1, -1):
            if stk[i] is token or stk[i] == token:
                del stk[i]
                return

    def current_context(self) -> Optional[TraceContext]:
        """The context a child span (or an outgoing RPC) should parent
        under: the innermost open local span if any, else the innermost
        attached remote context, else ``None``."""
        stack = getattr(self._local, "stack", None)
        if stack:
            span_id, trace_id = stack[-1]
            return TraceContext(trace_id, span_id)
        ctxs = getattr(self._local, "ctx", None)
        if ctxs:
            return ctxs[-1]
        return None

    # ------------------------------------------------------------ recording
    @contextmanager
    def span(self, name: str, ctx: Optional[TraceContext] = None,
             links: Optional[Iterable[int]] = None, **attrs):
        """Time a region.  Nested calls on the same thread record their
        enclosing span's id as ``parent``; with no enclosing span the
        explicit ``ctx`` (or the attached thread context) supplies both
        the parent span id and the trace id, otherwise a fresh trace
        starts here."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent_ctx = ctx
        if parent_ctx is None and stack:
            pspan, ptrace = stack[-1]
            parent_ctx = TraceContext(ptrace, pspan)
        if parent_ctx is None:
            ctxs = getattr(self._local, "ctx", None)
            if ctxs:
                parent_ctx = ctxs[-1]
        trace_id = parent_ctx.trace_id if parent_ctx else new_trace_id()
        parent = parent_ctx.span_id if parent_ctx else None
        span_id = self.next_span_id()
        stack.append((span_id, trace_id))
        wall = time.time()
        open_ev = {
            "id": span_id,
            "parent": parent,
            "name": name,
            "trace": _trace_hex(trace_id),
            "ts": wall,
            "pid": os.getpid(),
            "thread": threading.get_ident(),
        }
        with self._lock:
            self._active[span_id] = open_ev
        t0 = time.perf_counter()
        try:
            yield span_id
        finally:
            dur_ms = (time.perf_counter() - t0) * 1e3
            stack.pop()
            event = dict(open_ev, dur_ms=round(dur_ms, 6))
            if links:
                event["links"] = [int(l) for l in links]
            if attrs:
                event["attrs"] = attrs
            self._append(event, pop_active=span_id)

    def record_span(self, name: str, *, trace_id: Union[int, str],
                    ts: float, dur_ms: float,
                    parent_id: Optional[int] = None,
                    span_id: Optional[int] = None,
                    links: Optional[Iterable[int]] = None,
                    **attrs) -> int:
        """Record a fully-specified span after the fact (for causality
        reconstructed from timestamps, e.g. queue-wait segments measured
        across a thread handoff).  Returns the span id."""
        if span_id is None:
            span_id = self.next_span_id()
        event = {
            "id": int(span_id),
            "parent": int(parent_id) if parent_id is not None else None,
            "name": name,
            "trace": _trace_hex(trace_id),
            "ts": float(ts),
            "dur_ms": round(float(dur_ms), 6),
            "pid": os.getpid(),
            "thread": threading.get_ident(),
        }
        if links:
            event["links"] = [int(l) for l in links]
        if attrs:
            event["attrs"] = attrs
        self._append(event)
        return int(span_id)

    # -------------------------------------------------------------- reading
    @staticmethod
    def _filter(evs: List[Dict], trace_id: Optional[Union[int, str]],
                name: Optional[str], limit: Optional[int]) -> List[Dict]:
        if trace_id is not None:
            want = _trace_hex(trace_id)
            evs = [e for e in evs if e.get("trace") == want]
        if name:
            evs = [e for e in evs if e.get("name", "").startswith(name)]
        if limit is not None and limit >= 0:
            evs = evs[-limit:]
        return evs

    def events(self, trace_id: Optional[Union[int, str]] = None,
               name: Optional[str] = None,
               limit: Optional[int] = None) -> List[Dict]:
        """Finished spans, oldest first, optionally filtered by trace id,
        name prefix, and a keep-newest ``limit``."""
        with self._lock:
            evs = list(self._buf)
        return self._filter(evs, trace_id, name, limit)

    def active_spans(self) -> List[Dict]:
        """Snapshots of still-open spans (no ``dur_ms`` yet) — what was
        in flight; the flight recorder dumps these next to the finished
        ring so an abort shows the interrupted work."""
        with self._lock:
            return [dict(ev) for ev in self._active.values()]

    def chrome_events(self, trace_id: Optional[Union[int, str]] = None,
                      name: Optional[str] = None,
                      limit: Optional[int] = None) -> List[Dict]:
        """Spans as Chrome trace-event objects (``ph: "X"``, µs units).
        Each event keeps its recording pid, so merged multi-process
        dumps separate into process tracks."""
        own_pid = os.getpid()
        out = []
        for e in self.events(trace_id, name, limit):
            args = dict(e.get("attrs") or {},
                        span_id=e["id"], parent=e["parent"],
                        trace_id=e.get("trace"))
            if e.get("links"):
                args["links"] = e["links"]
            out.append({
                "name": e["name"],
                "ph": "X",
                "ts": round(e["ts"] * 1e6, 1),
                "dur": round(e["dur_ms"] * 1e3, 1),
                "pid": e.get("pid", own_pid),
                "tid": e["thread"],
                "args": args,
            })
        return out

    def to_jsonl(self, trace_id: Optional[Union[int, str]] = None,
                 name: Optional[str] = None,
                 limit: Optional[int] = None) -> str:
        """One Chrome trace event per line (``[`` + ``",".join(lines)`` +
        ``]`` is a loadable Chrome/Perfetto trace)."""
        return "\n".join(json.dumps(ev, default=str)
                         for ev in self.chrome_events(trace_id, name, limit))

    def to_chrome_json(self, trace_id: Optional[Union[int, str]] = None,
                       name: Optional[str] = None,
                       limit: Optional[int] = None) -> str:
        """The ready-to-load form: a JSON array of Chrome trace events."""
        return json.dumps(self.chrome_events(trace_id, name, limit),
                          default=str)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._active.clear()
            self._dropped = 0


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-global tracer."""
    return _TRACER


def span(name: str, ctx: Optional[TraceContext] = None,
         links: Optional[Iterable[int]] = None, **attrs):
    """Convenience: ``with monitor.span("fit/epoch", epoch=3): ...``"""
    return _TRACER.span(name, ctx=ctx, links=links, **attrs)


def attach(ctx: TraceContext) -> TraceContext:
    """Attach a remote context to the current thread (see
    :meth:`Tracer.attach`)."""
    return _TRACER.attach(ctx)


def detach(token: TraceContext) -> None:
    """Detach a previously attached context."""
    _TRACER.detach(token)


def current_context() -> Optional[TraceContext]:
    """The ambient context on this thread (innermost open span, else the
    attached remote context, else ``None``)."""
    return _TRACER.current_context()


def current_trace_hex() -> Optional[str]:
    """The ambient trace id as the 32-hex exemplar form histograms pin
    to buckets (``None`` outside any trace) — what callers observing a
    latency on the request thread pass as the explicit ``exemplar=``
    when the observation must not silently lose its trace link across
    a later thread handoff."""
    ctx = _TRACER.current_context()
    return f"{ctx.trace_id:032x}" if ctx is not None else None
