"""Lock constructor for the port's threaded subsystems (port of
``deeplearning4j_tpu/monitor/locks.py``): plain locks in production,
instrumented lock-order tracking under ``DL4J_TPU_LOCK_DEBUG=1``.

Every multi-threaded part of the port (serving, scaleout, streaming,
deploy, resilience, the alert engine) builds its locks through
:func:`make_lock` with a stable dotted site name.  Off (the default) this
returns a bare ``threading.Lock``/``RLock``: no wrapper, no overhead.  On,
it returns the port's :class:`~deeplearning4j_tpu_torch.analyze.
lockgraph.InstrumentedLock`, which records the per-thread acquisition
graph, detects lock-order cycles (deadlock hazards), counts long holds
and blocked acquires, and publishes the ``lockgraph_*`` metrics into the
port's registry.  The choice is made when the lock is built: set the flag
before building the objects whose locks it should watch.
"""

from __future__ import annotations

import threading

from ..analyze import lockgraph


def make_lock(name: str, rlock: bool = False):
    """A lock for the call site named ``name`` (``"package.role"``
    convention, e.g. ``"serving.engine.placed"``); reentrant with
    ``rlock=True``; instrumented when ``DL4J_TPU_LOCK_DEBUG=1``."""
    if lockgraph.enabled():
        return lockgraph.instrumented_lock(name, rlock=rlock)
    return threading.RLock() if rlock else threading.Lock()
