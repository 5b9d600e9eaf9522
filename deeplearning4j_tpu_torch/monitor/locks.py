"""Lock constructor for the port's threaded subsystems (port of
``deeplearning4j_tpu/monitor/locks.py``).

Every multi-threaded part of the port (the serving engine, the session
cache) builds its locks through :func:`make_lock` with a stable dotted
site name, so that an instrumented lock-order tracker can later be
swapped in at one place.  The JAX package's instrumented mode
(``DL4J_TPU_LOCK_DEBUG=1``, ``tools/analyze/lockgraph``) reports into the
JAX package's own metrics registry, so the port returns plain locks until
that analyzer is ported.
"""

from __future__ import annotations

import threading


def make_lock(name: str, rlock: bool = False):
    """A lock for the call site named ``name`` (``"package.role"``
    convention, e.g. ``"serving.engine.placed"``); reentrant with
    ``rlock=True``."""
    return threading.RLock() if rlock else threading.Lock()
