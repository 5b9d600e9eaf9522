"""Broker-protocol streaming tier: append-log topics, partitions,
offsets, consumer groups (port of ``deeplearning4j_tpu/streaming/broker.py``:
the same wire, partitioning, files, group protocol and counters, so a
producer, consumer or broker of either package talks to the other's and
a ``log_dir`` written by one reopens in the other).

Equivalent of the reference's Kafka edge
(``dl4j-streaming/src/main/java/org/deeplearning4j/streaming/pipeline/spark/SparkStreamingPipeline.java``
consumes Kafka topics; its tests stand up an embedded broker in
``streaming/embedded/EmbeddedKafkaCluster.java``).  The reference gets
replayable, resumable ingestion from Kafka's protocol semantics —
that is what this module provides over the repo's stdlib TCP plumbing
(same length-prefixed framing family as ``scaleout/param_server.py``):

- **Topics & partitions**: each (topic, partition) is an append-only
  record log; a record's offset is its index in that log.
- **Produce/fetch**: producers append (round-robin or key-hashed
  partitioning); fetches are offset-addressed and repeatable — the log
  is never mutated, so any consumer can replay from any offset.
- **Consumer groups**: members join a group, the broker assigns
  partitions round-robin over the sorted membership, and bumps a
  generation counter on every membership change (join/leave/session
  expiry).  A stale-generation heartbeat tells the consumer to rejoin
  — the rebalance protocol.
- **Committed offsets**: per (group, topic, partition), stored on the
  broker; a restarted consumer resumes exactly at the last commit —
  at-least-once delivery with commit-after-process, the same contract
  the reference's pipeline has.
- **Persistence** (optional ``log_dir``): partition logs are JSONL
  append files and group offsets a rewritten JSON snapshot, so the
  broker itself survives restart.

Run standalone (the embedded-broker / media-driver role):
``python -m deeplearning4j_tpu_torch.streaming.broker --port 0`` prints
the bound port on stdout.  ``close()`` joins the accept thread and every
connection's handler thread.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import socketserver
import struct
import threading
import time
import uuid
import zlib
from typing import Dict, List, Optional, Tuple

from .. import monitor as _monitor
from ..monitor.locks import make_lock
from ..utils.fileio import atomic_write_json
from .sources import RecordSource

_MAGIC_LEN = struct.Struct(">I")

#: default in-memory bound per (topic, partition); override per broker
#: with ``max_records_per_partition=`` or fleet-wide with the env var
DEFAULT_MAX_RECORDS = int(os.environ.get(
    "DL4J_TPU_BROKER_MAX_RECORDS", "65536"))


def _send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode("utf-8")
    sock.sendall(_MAGIC_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> dict:
    (n,) = _MAGIC_LEN.unpack(_recv_exact(sock, 4))
    return json.loads(_recv_exact(sock, n).decode("utf-8"))


def _roundtrip(sock: socket.socket, req: dict) -> dict:
    """One request/response pair; callers serialize per-socket."""
    _send_msg(sock, req)
    return _recv_msg(sock)


# --------------------------------------------------------------- broker


class _Group:
    """Consumer-group state: members, generation, assignment."""

    def __init__(self) -> None:
        self.members: Dict[str, Tuple[Tuple[str, ...], float]] = {}
        self.generation = 0
        self.assignment: Dict[str, List[Tuple[str, int]]] = {}


class StreamBroker:
    """Append-log broker (see module docstring).  Thread-safe; serves
    the TCP protocol via a ``ThreadingTCPServer``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 log_dir: Optional[str] = None,
                 session_timeout: float = 10.0,
                 max_records_per_partition: Optional[int] = None):
        self._lock = make_lock("streaming.broker.state", rlock=True)
        # (topic, partition) -> list of str records
        self._logs: Dict[Tuple[str, int], List[str]] = {}
        # (topic, partition) -> logical offset of the first retained
        # record: the in-memory log is a bounded WINDOW over the logical
        # append stream.  Offsets stay monotonic; records older than the
        # window are shed (load shedding — a slow consumer re-reads them
        # from the persisted JSONL or takes the loss, it cannot OOM the
        # broker for everyone else).
        self._base: Dict[Tuple[str, int], int] = {}
        self.max_records_per_partition = (
            DEFAULT_MAX_RECORDS if max_records_per_partition is None
            else int(max_records_per_partition))
        self._partitions: Dict[str, int] = {}
        self._rr: Dict[str, int] = {}          # producer round-robin cursor
        # group -> topic -> partition -> committed offset
        self._offsets: Dict[str, Dict[str, Dict[int, int]]] = {}
        self._groups: Dict[str, _Group] = {}
        self._log_dir = log_dir
        self.session_timeout = session_timeout
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._reload()

        outer = self
        # live connections: (handler thread, socket), closed and joined
        # by close()
        self._conns: Dict[int, Tuple[threading.Thread, socket.socket]] = {}
        self._conns_lock = threading.Lock()

        class _Handler(socketserver.BaseRequestHandler):
            def setup(self) -> None:
                with outer._conns_lock:
                    outer._conns[id(self)] = (threading.current_thread(),
                                              self.request)

            def handle(self) -> None:
                try:
                    while True:
                        req = _recv_msg(self.request)
                        _send_msg(self.request, outer._dispatch(req))
                except (ConnectionError, OSError):
                    pass

            def finish(self) -> None:
                with outer._conns_lock:
                    outer._conns.pop(id(self), None)

        self._server = socketserver.ThreadingTCPServer((host, port),
                                                       _Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    # ---- persistence ----------------------------------------------------
    def _part_path(self, topic: str, part: int) -> str:
        return os.path.join(self._log_dir, f"{topic}-{part}.jsonl")

    def _offsets_path(self) -> str:
        return os.path.join(self._log_dir, "_group_offsets.json")

    def _reload(self) -> None:
        for name in os.listdir(self._log_dir):
            if name.endswith(".jsonl"):
                stem = name[:-6]
                topic, _, part = stem.rpartition("-")
                with open(os.path.join(self._log_dir, name)) as fh:
                    recs = [json.loads(line) for line in fh if line.strip()]
                cap = self.max_records_per_partition
                if cap and len(recs) > cap:
                    # reload only the bounded tail window; offsets stay
                    # logical (base = how much of the stream is on disk
                    # only)
                    self._base[(topic, int(part))] = len(recs) - cap
                    recs = recs[-cap:]
                self._logs[(topic, int(part))] = recs
                self._partitions[topic] = max(
                    self._partitions.get(topic, 0), int(part) + 1)
        if os.path.exists(self._offsets_path()):
            with open(self._offsets_path()) as fh:
                raw = json.load(fh)
            self._offsets = {
                g: {t: {int(p): o for p, o in parts.items()}
                    for t, parts in topics.items()}
                for g, topics in raw.items()}

    def _persist_records(self, topic: str, part: int,
                         records: List[str]) -> None:
        if not self._log_dir:
            return
        with open(self._part_path(topic, part), "a") as fh:
            for r in records:
                fh.write(json.dumps(r) + "\n")

    def _persist_offsets(self) -> None:
        if not self._log_dir:
            return
        # atomic+fsync: committed offsets are the broker's recovery
        # truth — a torn snapshot would rewind or skip every group
        atomic_write_json(self._offsets_path(), self._offsets)

    # ---- topic / log ops ------------------------------------------------
    def create_topic(self, topic: str, partitions: int = 1) -> None:
        with self._lock:
            if topic in self._partitions:
                if self._partitions[topic] != partitions:
                    raise ValueError(
                        f"topic {topic!r} exists with "
                        f"{self._partitions[topic]} partitions")
                return
            self._partitions[topic] = partitions
            for p in range(partitions):
                self._logs.setdefault((topic, p), [])

    def _ensure_topic(self, topic: str) -> int:
        if topic not in self._partitions:
            self.create_topic(topic, 1)
        return self._partitions[topic]

    def produce(self, topic: str, records: List[str],
                partition: Optional[int] = None,
                key: Optional[str] = None) -> Tuple[int, int]:
        """Append records to one partition (explicit, key-hashed, or
        round-robin); returns (partition, base_offset)."""
        with self._lock:
            n = self._ensure_topic(topic)
            if partition is None:
                if key is not None:
                    partition = zlib.crc32(key.encode("utf-8")) % n
                else:
                    partition = self._rr.get(topic, 0) % n
                    self._rr[topic] = partition + 1
            if not 0 <= partition < n:
                raise ValueError(f"partition {partition} out of range "
                                 f"(topic {topic!r} has {n})")
            log = self._logs[(topic, partition)]
            first = self._base.get((topic, partition), 0)
            base = first + len(log)
            log.extend(records)
            self._persist_records(topic, partition, records)
            cap = self.max_records_per_partition
            if cap and len(log) > cap:
                drop = len(log) - cap
                del log[:drop]
                self._base[(topic, partition)] = first + drop
                _monitor.counter(
                    "broker_records_dropped_total",
                    "records shed from bounded partition windows").inc(
                    drop, topic=topic)
            return partition, base

    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int = 256) -> Tuple[List[str], int, int]:
        """Records from logical ``offset`` (repeatable within the
        retained window; an offset already shed from the bounded
        in-memory log is clamped forward to the window start);
        returns (records, next_offset, end_offset)."""
        with self._lock:
            log = self._logs.get((topic, partition), [])
            first = self._base.get((topic, partition), 0)
            start = max(int(offset), first)
            out = log[start - first:start - first + max_records]
            return out, start + len(out), first + len(log)

    def end_offsets(self, topic: str) -> Dict[int, int]:
        with self._lock:
            n = self._ensure_topic(topic)
            return {p: self._base.get((topic, p), 0)
                    + len(self._logs.get((topic, p), []))
                    for p in range(n)}

    # ---- committed offsets ----------------------------------------------
    def commit(self, group: str, offsets: Dict[str, Dict[int, int]],
               member: Optional[str] = None,
               generation: Optional[int] = None) -> bool:
        """Commit offsets.  When ``member``/``generation`` are given
        (group consumers always send them), the commit is FENCED the
        way Kafka fences zombie commits: a member that expired or holds
        a stale generation gets ``False`` (the wire layer returns
        ``rebalance``) and nothing is written — otherwise a consumer
        whose partitions were reassigned could regress the group's
        committed offset with its stale positions."""
        with self._lock:
            if member is not None:
                g = self._groups.get(group)
                if g is None or member not in g.members:
                    return False
                if generation is not None and \
                        generation != g.generation:
                    return False
            store = self._offsets.setdefault(group, {})
            for topic, parts in offsets.items():
                tstore = store.setdefault(topic, {})
                for p, off in parts.items():
                    tstore[int(p)] = int(off)
            self._persist_offsets()
            return True

    def committed(self, group: str, topic: str) -> Dict[int, int]:
        with self._lock:
            return dict(self._offsets.get(group, {}).get(topic, {}))

    # ---- consumer groups ------------------------------------------------
    def _expire_members(self, group: _Group) -> bool:
        now = time.time()
        dead = [m for m, (_, beat) in group.members.items()
                if now - beat > self.session_timeout]
        for m in dead:
            del group.members[m]
        return bool(dead)

    def _rebalance(self, group: _Group) -> None:
        """Round-robin all subscribed partitions over sorted members —
        deterministic, so every member computes-or-learns the same
        view for a generation."""
        group.generation += 1
        members = sorted(group.members)
        group.assignment = {m: [] for m in members}
        if not members:
            return
        topics = sorted({t for subs, _ in group.members.values()
                         for t in subs})
        i = 0
        for topic in topics:
            for p in range(self._ensure_topic(topic)):
                # assign only to members subscribed to this topic
                subscribed = [m for m in members
                              if topic in group.members[m][0]]
                if not subscribed:
                    continue
                m = subscribed[i % len(subscribed)]
                group.assignment[m].append((topic, p))
                i += 1

    def join_group(self, group_id: str, member: str,
                   topics: List[str]) -> dict:
        with self._lock:
            group = self._groups.setdefault(group_id, _Group())
            self._expire_members(group)
            group.members[member] = (tuple(topics), time.time())
            self._rebalance(group)
            return {"generation": group.generation,
                    "assignment": group.assignment[member]}

    def leave_group(self, group_id: str, member: str) -> None:
        with self._lock:
            group = self._groups.get(group_id)
            if group and member in group.members:
                del group.members[member]
                self._rebalance(group)

    def heartbeat(self, group_id: str, member: str,
                  generation: int) -> dict:
        with self._lock:
            group = self._groups.get(group_id)
            if group is None or member not in group.members:
                return {"rebalance": True}
            subs, _ = group.members[member]
            group.members[member] = (subs, time.time())
            if self._expire_members(group):
                self._rebalance(group)
            if generation != group.generation:
                return {"rebalance": True}
            return {"ok": True}

    # ---- protocol dispatch ----------------------------------------------
    def _dispatch(self, req: dict) -> dict:
        # An optional ``_traceparent`` key (W3C header value, injected by
        # _BrokerConnection.call when the caller runs under a trace)
        # stitches this broker-side span into the producer/consumer's
        # distributed trace across the process boundary.
        ctx = _monitor.parse_traceparent(req.pop("_traceparent", None))
        with _monitor.tracer().span(
                "broker/" + str(req.get("op", "unknown")), ctx=ctx):
            return self._dispatch_op(req)

    def _dispatch_op(self, req: dict) -> dict:
        try:
            op = req["op"]
            if op == "create_topic":
                self.create_topic(req["topic"], req.get("partitions", 1))
                return {"ok": True}
            if op == "produce":
                part, base = self.produce(req["topic"], req["records"],
                                          req.get("partition"),
                                          req.get("key"))
                return {"ok": True, "partition": part, "base_offset": base}
            if op == "fetch":
                recs, nxt, end = self.fetch(req["topic"], req["partition"],
                                            req["offset"],
                                            req.get("max", 256))
                return {"ok": True, "records": recs, "next_offset": nxt,
                        "end_offset": end}
            if op == "end_offsets":
                return {"ok": True, "ends": self.end_offsets(req["topic"])}
            if op == "commit":
                ok = self.commit(req["group"], req["offsets"],
                                 req.get("member"),
                                 req.get("generation"))
                return {"ok": True} if ok else {"ok": False,
                                                "rebalance": True}
            if op == "committed":
                return {"ok": True,
                        "offsets": self.committed(req["group"],
                                                  req["topic"])}
            if op == "join":
                out = self.join_group(req["group"], req["member"],
                                      req["topics"])
                out["ok"] = True
                return out
            if op == "leave":
                self.leave_group(req["group"], req["member"])
                return {"ok": True}
            if op == "heartbeat":
                return self.heartbeat(req["group"], req["member"],
                                      req["generation"])
            return {"error": f"unknown op {op!r}"}
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    def close(self, timeout: float = 5.0) -> None:
        """Stop serving: shut the listener down, close every open
        connection and join the accept thread and the handler threads
        (each within ``timeout`` seconds)."""
        self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns.values())
        for _, sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for thread, _ in conns:
            thread.join(timeout)
        self._thread.join(timeout)


# --------------------------------------------------------------- clients


class _BrokerConnection:
    """One blocking request/response TCP connection, with per-call lock."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._lock = make_lock("streaming.conn")

    def call(self, req: dict) -> dict:
        ctx = _monitor.current_context()
        if ctx is not None:
            req = dict(req, _traceparent=ctx.traceparent())
        with self._lock:
            # dl4j-lint: disable=R3 the socket IS the shared state: this lock exists solely to keep one request/response pair exclusive on the wire; there is no other state behind it to narrow the lock to
            resp = _roundtrip(self._sock, req)
        if "error" in resp:
            raise RuntimeError(f"broker error: {resp['error']}")
        return resp

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class StreamProducer:
    """Producer client: appends records to a topic, partitioned
    explicitly, by key hash, or round-robin."""

    def __init__(self, host: str, port: int):
        self._conn = _BrokerConnection(host, port)

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        self._conn.call({"op": "create_topic", "topic": topic,
                         "partitions": partitions})

    def produce(self, topic: str, records: List[str],
                partition: Optional[int] = None,
                key: Optional[str] = None) -> Tuple[int, int]:
        resp = self._conn.call({"op": "produce", "topic": topic,
                                "records": list(records),
                                "partition": partition, "key": key})
        return resp["partition"], resp["base_offset"]

    def close(self) -> None:
        self._conn.close()


class StreamConsumer:
    """Group consumer: joins a consumer group, polls its assigned
    partitions starting from the group's committed offsets, and commits
    processed positions (at-least-once with commit-after-process).

    A consumer restarted with the same ``group`` resumes exactly at the
    last committed offsets; a second live member triggers a rebalance
    that splits partitions between them.
    """

    def __init__(self, host: str, port: int, group: str,
                 topics: List[str], member_id: Optional[str] = None,
                 heartbeat_interval: float = 2.0):
        self._conn = _BrokerConnection(host, port)
        self.group = group
        self.topics = list(topics)
        self.member_id = member_id or f"c-{uuid.uuid4().hex[:12]}"
        self._heartbeat_interval = heartbeat_interval
        self._generation = -1
        self._assignment: List[Tuple[str, int]] = []
        self._positions: Dict[Tuple[str, int], int] = {}
        self._last_beat = 0.0
        self._join()

    # ---- group membership ----------------------------------------------
    def _join(self) -> None:
        resp = self._conn.call({"op": "join", "group": self.group,
                                "member": self.member_id,
                                "topics": self.topics})
        self._generation = resp["generation"]
        self._assignment = [tuple(a) for a in resp["assignment"]]
        self._last_beat = time.time()
        self._positions = {}
        for topic in {t for t, _ in self._assignment}:
            committed = self._conn.call(
                {"op": "committed", "group": self.group,
                 "topic": topic})["offsets"]
            for t, p in self._assignment:
                if t == topic:
                    self._positions[(t, p)] = int(committed.get(str(p),
                                                  committed.get(p, 0)))

    def _maybe_heartbeat(self) -> None:
        if time.time() - self._last_beat < self._heartbeat_interval:
            return
        resp = self._conn.call({"op": "heartbeat", "group": self.group,
                                "member": self.member_id,
                                "generation": self._generation})
        self._last_beat = time.time()
        if resp.get("rebalance"):
            self._join()

    @property
    def assignment(self) -> List[Tuple[str, int]]:
        return list(self._assignment)

    @property
    def generation(self) -> int:
        """Group generation this member last joined under (bumps on
        every rebalance — the fencing token)."""
        return self._generation

    # ---- consumption ----------------------------------------------------
    def poll(self, max_records: int = 256,
             timeout: float = 0.0) -> List[Tuple[str, int, int, str]]:
        """Up to ``max_records`` as (topic, partition, offset, record),
        round-robin over assigned partitions; blocks up to ``timeout``
        waiting for the first record."""
        deadline = time.time() + timeout
        while True:
            self._maybe_heartbeat()
            out: List[Tuple[str, int, int, str]] = []
            for (t, p) in self._assignment:
                if len(out) >= max_records:
                    break
                pos = self._positions[(t, p)]
                resp = self._conn.call(
                    {"op": "fetch", "topic": t, "partition": p,
                     "offset": pos, "max": max_records - len(out)})
                for i, rec in enumerate(resp["records"]):
                    out.append((t, p, pos + i, rec))
                self._positions[(t, p)] = resp["next_offset"]
            if out or time.time() >= deadline:
                return out
            time.sleep(0.02)

    def commit(self) -> None:
        """Commit current positions (everything handed out by poll)."""
        offsets: Dict[str, Dict[int, int]] = {}
        for (t, p), off in self._positions.items():
            offsets.setdefault(t, {})[p] = off
        self.commit_offsets(offsets)

    def commit_offsets(self,
                       offsets: Dict[str, Dict[int, int]]) -> bool:
        """Commit explicit (topic -> partition -> next offset) marks —
        for callers that track processed positions themselves (e.g.
        :class:`BrokerRecordSource` commits only what its pipeline has
        actually processed, not what poll() has fetched ahead).

        Commits carry this member's id + generation so the broker can
        FENCE them: after a rebalance took our partitions away, the
        broker answers ``rebalance``, the commit is dropped (the new
        owner's offsets stand — at-least-once, never a regression) and
        we rejoin.  Returns whether the commit was accepted."""
        merged: Dict[str, Dict[int, int]] = {}
        for t, parts in offsets.items():
            for p, off in parts.items():
                cur = merged.setdefault(t, {})
                cur[p] = max(cur.get(p, 0), int(off))
        if not merged:
            return True
        resp = self._conn.call({"op": "commit", "group": self.group,
                                "offsets": merged,
                                "member": self.member_id,
                                "generation": self._generation})
        if resp.get("rebalance"):
            self._join()
            return False
        return True

    def committed(self, topic: str) -> Dict[int, int]:
        resp = self._conn.call({"op": "committed", "group": self.group,
                                "topic": topic})
        return {int(p): int(o) for p, o in resp["offsets"].items()}

    def seek(self, topic: str, partition: int, offset: int) -> None:
        self._positions[(topic, partition)] = offset

    def close(self, leave: bool = True) -> None:
        if leave:
            try:
                self._conn.call({"op": "leave", "group": self.group,
                                 "member": self.member_id})
            except (RuntimeError, ConnectionError, OSError):
                pass
        self._conn.close()


class BrokerRecordSource(RecordSource):
    """Adapter: a :class:`StreamConsumer` as a
    :class:`~deeplearning4j_tpu_torch.streaming.sources.RecordSource`, so
    :class:`~deeplearning4j_tpu_torch.streaming.pipeline.StreamingPipeline`
    trains straight off broker topics with resumable offsets — the
    reference's Kafka -> Spark Streaming -> fit path.

    Offsets commit when the pipeline reports a processed micro-batch
    (``on_batch_processed``), i.e. commit-after-process: a consumer
    killed mid-batch replays that batch on restart (at-least-once), and
    one killed between batches resumes with no loss or duplication.
    """

    def __init__(self, consumer: StreamConsumer, fetch_size: int = 64):
        self.consumer = consumer
        self._fetch_size = fetch_size
        self._buffer: List[Tuple[str, int, int, str]] = []
        # (topic, partition) -> next offset of the records HANDED OUT
        # (poll() may fetch ahead into _buffer; those are not delivered)
        self._delivered: Dict[Tuple[str, int], int] = {}
        self._generation = consumer.generation
        self.closed = False

    def _sync_generation(self) -> None:
        """A rebalance may have moved partitions to another member:
        fetched-ahead records and delivered marks for the old
        assignment are stale — drop them (the new owner replays from
        the committed offset; at-least-once)."""
        if self.consumer.generation != self._generation:
            self._generation = self.consumer.generation
            self._buffer = []
            self._delivered = {}

    def poll(self, timeout: Optional[float] = None):
        self._sync_generation()
        if not self._buffer:
            self._buffer = self.consumer.poll(
                max_records=self._fetch_size, timeout=timeout or 0.0)
            if self.consumer.generation != self._generation:
                # the poll's heartbeat rejoined, and the poll then
                # fetched under the new generation from the committed
                # offsets: keep those records, drop only the stale
                # delivered marks.  (The JAX source drops the records
                # too while the consumer's positions stay past them, so
                # they are not delivered until the next rejoin.)
                self._generation = self.consumer.generation
                self._delivered = {}
            if not self._buffer:
                return None
        t, p, off, rec = self._buffer.pop(0)
        self._delivered[(t, p)] = off + 1
        return rec

    def on_batch_processed(self) -> None:
        """Pipeline hook after each successfully processed micro-batch:
        commit exactly the delivered prefix.  Records fetched ahead into
        the buffer are NOT committed, so a kill between batches resumes
        with no loss; a kill mid-batch replays that batch
        (at-least-once, the reference pipeline's contract)."""
        offsets: Dict[str, Dict[int, int]] = {}
        for (t, p), off in self._delivered.items():
            offsets.setdefault(t, {})[p] = off
        if offsets:
            self.consumer.commit_offsets(offsets)

    def close(self) -> None:
        super().close()
        self.consumer.close()


# --------------------------------------------------------------- CLI


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Standalone append-log stream broker")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--log-dir", default=None)
    parser.add_argument("--session-timeout", type=float, default=10.0)
    args = parser.parse_args(argv)
    broker = StreamBroker(args.host, args.port, log_dir=args.log_dir,
                          session_timeout=args.session_timeout)
    print(json.dumps({"host": broker.host, "port": broker.port}),
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        broker.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
