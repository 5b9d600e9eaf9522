"""Record sources for the streaming pipeline (port of
``deeplearning4j_tpu/streaming/sources.py``; stdlib, localhost).

The reference consumes records from Kafka topics via Camel routes
(``dl4j-streaming/.../kafka/``); these sources play the same role over
stdlib transports.  Contract: ``poll(timeout)`` returns the next raw
record (str/bytes/dict) or ``None``; ``close()`` releases resources; a
source signals end-of-stream by returning ``None`` after ``closed`` is
set (an unbounded stream just keeps returning records)."""

from __future__ import annotations

import os
import queue
import socket
import socketserver
import threading
from typing import Iterable, Optional


class RecordSource:
    """Source SPI."""

    closed: bool = False

    def poll(self, timeout: Optional[float] = None):
        raise NotImplementedError

    def close(self) -> None:
        self.closed = True


class InMemoryRecordSource(RecordSource):
    """Bounded in-process queue (the embedded-broker stand-in)."""

    def __init__(self, capacity: int = 1024):
        self._queue: "queue.Queue" = queue.Queue(maxsize=capacity)
        self.closed = False

    def offer(self, record, timeout: Optional[float] = None) -> None:
        self._queue.put(record, timeout=timeout)

    def offer_all(self, records: Iterable) -> None:
        for r in records:
            self.offer(r)

    def poll(self, timeout: Optional[float] = None):
        try:
            if timeout is None:
                return self._queue.get_nowait()
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None


class FileTailRecordSource(RecordSource):
    """Follow a growing text file, one record per line (the Camel
    file-endpoint role).  Starts at the beginning (``from_start=True``)
    or at the current end."""

    def __init__(self, path: str, from_start: bool = True,
                 poll_interval: float = 0.05):
        self.path = path
        self.poll_interval = poll_interval
        self._fh = None
        self._from_start = from_start
        self.closed = False

    def _ensure_open(self) -> bool:
        if self._fh is not None:
            return True
        if not os.path.exists(self.path):
            return False
        # binary mode: the partial-line rewind below needs BYTE offsets
        # (text-mode tell() is an opaque cookie and multibyte characters
        # make character length != byte length)
        self._fh = open(self.path, "rb")
        if not self._from_start:
            self._fh.seek(0, os.SEEK_END)
        return True

    def poll(self, timeout: Optional[float] = None):
        import time
        deadline = None if timeout is None else time.time() + timeout
        while True:
            if self._ensure_open():
                line = self._fh.readline()
                if line.endswith(b"\n"):
                    return line.rstrip(b"\r\n").decode("utf-8")
                # partial line: rewind to its start and wait for the rest
                if line:
                    self._fh.seek(-len(line), os.SEEK_CUR)
            if deadline is None or time.time() >= deadline:
                return None
            time.sleep(self.poll_interval)

    def close(self) -> None:
        super().close()
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class SocketRecordSource(RecordSource):
    """TCP listener for newline-delimited records (the network-endpoint
    role).  ``port=0`` binds an ephemeral port exposed as ``.port``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 capacity: int = 4096):
        self._queue: "queue.Queue" = queue.Queue(maxsize=capacity)
        outer = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    try:
                        outer._queue.put(
                            raw.decode("utf-8").rstrip("\r\n"), timeout=5.0)
                    except queue.Full:
                        pass            # drop under sustained overload

        self._server = socketserver.ThreadingTCPServer(
            (host, port), _Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self.closed = False

    def poll(self, timeout: Optional[float] = None):
        try:
            if timeout is None:
                return self._queue.get_nowait()
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self, timeout: float = 5.0) -> None:
        """Stop listening and join the accept thread."""
        super().close()
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout)

    @staticmethod
    def send(host: str, port: int, lines: Iterable[str]) -> None:
        """Convenience client: ship newline-delimited records."""
        with socket.create_connection((host, port), timeout=5.0) as s:
            payload = "".join(line + "\n" for line in lines)
            s.sendall(payload.encode("utf-8"))
