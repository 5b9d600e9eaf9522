"""Crash-safe file writes (port of ``deeplearning4j_tpu/utils/fileio.py``:
``atomic_write`` and its bytes, text and JSON forms).

After a crash at any point, the destination holds either the complete old
content or the complete new content, never a torn mix:

1. write to a uniquely named temp file in the destination directory
   (``os.replace`` is atomic only within one filesystem);
2. flush and ``os.fsync`` the temp file, so the data is durable before the
   rename publishes it;
3. ``os.replace`` it over the destination;
4. best-effort ``fsync`` of the directory, so the rename is durable too.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Any, Iterator, Optional


def _fsync_dir(directory: str) -> None:
    """Best-effort directory fsync (skipped where the filesystem refuses
    an O_RDONLY directory handle)."""
    try:
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "wb",
                 encoding: Optional[str] = None) -> Iterator[Any]:
    """Yield a file object whose contents replace ``path`` atomically on a
    clean exit, and leave ``path`` untouched on an exception or a crash.
    ``mode`` must be a write mode (``"wb"`` or ``"w"``)."""
    if "w" not in mode:
        raise ValueError(f"atomic_write needs a write mode, got {mode!r}")
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=f".tmp-{os.path.basename(path)}.")
    fh = None
    try:
        fh = os.fdopen(fd, mode, encoding=encoding)
        yield fh
        fh.flush()
        os.fsync(fh.fileno())
        fh.close()
        os.replace(tmp, path)
        _fsync_dir(directory)
    finally:
        if fh is not None and not fh.closed:
            try:
                fh.close()
            except OSError:
                pass
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Atomically replace ``path`` with ``data``."""
    with atomic_write(path, "wb") as fh:
        fh.write(data)


def atomic_write_text(path: str, text: str,
                      encoding: str = "utf-8") -> None:
    """Atomically replace ``path`` with ``text``."""
    with atomic_write(path, "w", encoding=encoding) as fh:
        fh.write(text)


def atomic_write_json(path: str, obj: Any, **json_kwargs) -> None:
    """Atomically replace ``path`` with ``json.dumps(obj)``."""
    atomic_write_text(path, json.dumps(obj, **json_kwargs))
