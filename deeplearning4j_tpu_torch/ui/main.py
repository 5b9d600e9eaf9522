"""UIServer CLI entry point (port of ``deeplearning4j_tpu/ui/main.py``).

The equivalent of the reference's ``PlayUIServer`` CLI (``--uiPort``
flag): start the training dashboard and block.  The server is the port's
:class:`~deeplearning4j_tpu_torch.ui.server.UIServer`; it needs no card
(the dashboard reads stats storage), so this entry point takes no device.

Run: ``python -m deeplearning4j_tpu_torch.ui.main --port 9000``
"""

from __future__ import annotations

import argparse
import threading
from typing import Optional, Sequence

from .server import UIServer
from .storage import FileStatsStorage, InMemoryStatsStorage


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.ui.main",
        description="Training dashboard server (PlayUIServer)")
    p.add_argument("--port", type=int, default=9000,
                   help="HTTP port (0 = ephemeral)")
    p.add_argument("--storage-file", default=None,
                   help="sqlite stats-storage path (default: in-memory; "
                        "remote trainers POST to /remote either way)")
    return p


def serve(argv: Optional[Sequence[str]] = None,
          block: bool = True) -> UIServer:
    """Start the dashboard; with ``block`` wait until interrupted, then
    stop it.  Returns the server (running when ``block`` is False)."""
    args = build_parser().parse_args(argv)
    storage = (FileStatsStorage(args.storage_file) if args.storage_file
               else InMemoryStatsStorage())
    server = UIServer(storage, port=args.port).start()
    print(f"UIServer listening at {server.url}")
    if block:
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            server.stop()
    return server


if __name__ == "__main__":
    serve()
