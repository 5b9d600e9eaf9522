"""StatsStorage: pub/sub persistence for training statistics (port of
``deeplearning4j_tpu/ui/storage.py``; the sqlite schema is the same, so a
file written by either package reads in the other).

Equivalent of the reference's
``deeplearning4j-core/src/main/java/org/deeplearning4j/api/storage/
StatsStorage.java`` (query API: listSessionIDs / getLatestUpdate /
getAllUpdatesAfter...), ``StatsStorageRouter.java`` (write-side:
putStaticInfo / putUpdate), and the impls ``InMemoryStatsStorage`` and the
sqlite-backed ``J7FileStatsStorage``
(``deeplearning4j-ui-parent/deeplearning4j-ui-model/.../storage/``).

Records are :class:`Persistable` — (session, type, worker, timestamp) keyed
JSON dicts, the serialization-agnostic analogue of the reference's
``Persistable`` byte-array contract.  Storage implementations are
thread-safe: the training thread posts while the UI server thread queries.
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Persistable:
    """One stored record (reference ``api/storage/Persistable.java``)."""

    session_id: str
    type_id: str
    worker_id: str
    timestamp: float
    data: Dict

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "Persistable":
        return Persistable(**json.loads(s))


@dataclasses.dataclass
class StatsStorageEvent:
    """Pub/sub notification (reference ``StatsStorageEvent`` /
    ``StatsStorageListener.EventType``)."""

    event_type: str          # new_session | post_static | post_update
    record: Persistable


class StatsStorageRouter:
    """Write-side contract (reference ``StatsStorageRouter.java``): anything
    a listener can post stats into — a storage, or a remote HTTP router."""

    def put_static_info(self, record: Persistable) -> None:
        raise NotImplementedError

    def put_update(self, record: Persistable) -> None:
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Read/query + pub/sub side (reference ``StatsStorage.java``)."""

    # ---- queries ---------------------------------------------------------
    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def list_type_ids(self, session_id: str) -> List[str]:
        raise NotImplementedError

    def list_worker_ids(self, session_id: str,
                        type_id: Optional[str] = None) -> List[str]:
        raise NotImplementedError

    def get_static_info(self, session_id: str, type_id: str,
                        worker_id: str) -> Optional[Persistable]:
        raise NotImplementedError

    def get_all_updates(self, session_id: str, type_id: str,
                        worker_id: str) -> List[Persistable]:
        raise NotImplementedError

    def get_all_updates_after(self, session_id: str, type_id: str,
                              worker_id: str,
                              timestamp: float) -> List[Persistable]:
        return [r for r in self.get_all_updates(session_id, type_id,
                                                worker_id)
                if r.timestamp > timestamp]

    def get_latest_update(self, session_id: str, type_id: str,
                          worker_id: str) -> Optional[Persistable]:
        updates = self.get_all_updates(session_id, type_id, worker_id)
        return updates[-1] if updates else None

    def num_update_records(self, session_id: str) -> int:
        raise NotImplementedError

    # ---- pub/sub ---------------------------------------------------------
    def register_listener(
            self, callback: Callable[[StatsStorageEvent], None]) -> None:
        self._listeners.append(callback)

    def _notify(self, event_type: str, record: Persistable) -> None:
        for cb in list(getattr(self, "_listeners", [])):
            cb(StatsStorageEvent(event_type, record))

    def close(self) -> None:
        pass


class InMemoryStatsStorage(StatsStorage):
    """Dict-backed storage (reference ``InMemoryStatsStorage``)."""

    def __init__(self):
        self._static: Dict[Tuple[str, str, str], Persistable] = {}
        self._updates: Dict[Tuple[str, str, str], List[Persistable]] = {}
        self._listeners: List[Callable] = []
        self._lock = threading.Lock()

    def put_static_info(self, record: Persistable) -> None:
        key = (record.session_id, record.type_id, record.worker_id)
        with self._lock:
            is_new = not any(s == record.session_id
                             for s, _, _ in self._static)
            self._static[key] = record
        if is_new:
            self._notify("new_session", record)
        self._notify("post_static", record)

    def put_update(self, record: Persistable) -> None:
        key = (record.session_id, record.type_id, record.worker_id)
        with self._lock:
            self._updates.setdefault(key, []).append(record)
        self._notify("post_update", record)

    def list_session_ids(self) -> List[str]:
        with self._lock:
            return sorted({k[0] for k in self._static}
                          | {k[0] for k in self._updates})

    def list_type_ids(self, session_id: str) -> List[str]:
        with self._lock:
            return sorted({k[1] for k in (*self._static, *self._updates)
                           if k[0] == session_id})

    def list_worker_ids(self, session_id: str,
                        type_id: Optional[str] = None) -> List[str]:
        with self._lock:
            return sorted({k[2] for k in (*self._static, *self._updates)
                           if k[0] == session_id
                           and (type_id is None or k[1] == type_id)})

    def get_static_info(self, session_id: str, type_id: str,
                        worker_id: str) -> Optional[Persistable]:
        with self._lock:
            return self._static.get((session_id, type_id, worker_id))

    def get_all_updates(self, session_id: str, type_id: str,
                        worker_id: str) -> List[Persistable]:
        with self._lock:
            return list(self._updates.get((session_id, type_id, worker_id),
                                          []))

    def num_update_records(self, session_id: str) -> int:
        with self._lock:
            return sum(len(v) for k, v in self._updates.items()
                       if k[0] == session_id)


class FileStatsStorage(StatsStorage):
    """Sqlite-file storage (reference ``J7FileStatsStorage`` — also sqlite).

    One file holds static-info and update tables; safe to reopen from
    another process (the remote-UI pattern: training posts, dashboard
    reads)."""

    def __init__(self, path: str):
        self.path = path
        self._listeners: List[Callable] = []
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS static_info ("
                "session_id TEXT, type_id TEXT, worker_id TEXT, "
                "timestamp REAL, data TEXT, "
                "PRIMARY KEY (session_id, type_id, worker_id))")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS updates ("
                "session_id TEXT, type_id TEXT, worker_id TEXT, "
                "timestamp REAL, data TEXT)")
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_updates ON updates "
                "(session_id, type_id, worker_id, timestamp)")
            self._conn.commit()

    def put_static_info(self, record: Persistable) -> None:
        with self._lock:
            known = self._conn.execute(
                "SELECT 1 FROM static_info WHERE session_id=? LIMIT 1",
                (record.session_id,)).fetchone()
            self._conn.execute(
                "INSERT OR REPLACE INTO static_info VALUES (?,?,?,?,?)",
                (record.session_id, record.type_id, record.worker_id,
                 record.timestamp, json.dumps(record.data)))
            self._conn.commit()
        if not known:
            self._notify("new_session", record)
        self._notify("post_static", record)

    def put_update(self, record: Persistable) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO updates VALUES (?,?,?,?,?)",
                (record.session_id, record.type_id, record.worker_id,
                 record.timestamp, json.dumps(record.data)))
            self._conn.commit()
        self._notify("post_update", record)

    def _rows(self, sql: str, args=()) -> List:
        with self._lock:
            return self._conn.execute(sql, args).fetchall()

    def list_session_ids(self) -> List[str]:
        rows = self._rows("SELECT DISTINCT session_id FROM static_info "
                          "UNION SELECT DISTINCT session_id FROM updates")
        return sorted(r[0] for r in rows)

    def list_type_ids(self, session_id: str) -> List[str]:
        rows = self._rows(
            "SELECT DISTINCT type_id FROM static_info WHERE session_id=? "
            "UNION SELECT DISTINCT type_id FROM updates WHERE session_id=?",
            (session_id, session_id))
        return sorted(r[0] for r in rows)

    def list_worker_ids(self, session_id: str,
                        type_id: Optional[str] = None) -> List[str]:
        if type_id is None:
            rows = self._rows(
                "SELECT DISTINCT worker_id FROM static_info WHERE "
                "session_id=? UNION SELECT DISTINCT worker_id FROM updates "
                "WHERE session_id=?", (session_id, session_id))
        else:
            rows = self._rows(
                "SELECT DISTINCT worker_id FROM static_info WHERE "
                "session_id=? AND type_id=? UNION SELECT DISTINCT worker_id "
                "FROM updates WHERE session_id=? AND type_id=?",
                (session_id, type_id, session_id, type_id))
        return sorted(r[0] for r in rows)

    def get_static_info(self, session_id: str, type_id: str,
                        worker_id: str) -> Optional[Persistable]:
        rows = self._rows(
            "SELECT timestamp, data FROM static_info WHERE session_id=? "
            "AND type_id=? AND worker_id=?",
            (session_id, type_id, worker_id))
        if not rows:
            return None
        ts, data = rows[0]
        return Persistable(session_id, type_id, worker_id, ts,
                           json.loads(data))

    def get_all_updates(self, session_id: str, type_id: str,
                        worker_id: str) -> List[Persistable]:
        rows = self._rows(
            "SELECT timestamp, data FROM updates WHERE session_id=? AND "
            "type_id=? AND worker_id=? ORDER BY timestamp",
            (session_id, type_id, worker_id))
        return [Persistable(session_id, type_id, worker_id, ts,
                            json.loads(data)) for ts, data in rows]

    def num_update_records(self, session_id: str) -> int:
        rows = self._rows(
            "SELECT COUNT(*) FROM updates WHERE session_id=?", (session_id,))
        return int(rows[0][0])

    def close(self) -> None:
        with self._lock:
            self._conn.close()
