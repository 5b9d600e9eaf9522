"""The port's runtime analyzers (port of the runtime half of
``tools/analyze``): :mod:`.lockgraph`, the lock-order race detector behind
``monitor.locks.make_lock`` under ``DL4J_TPU_LOCK_DEBUG=1``, and
:mod:`.sanitizer`, the dispatch sanitizer behind ``monitor.
sanitize_scenario`` under ``DL4J_TPU_SANITIZE=1``, with its
``budgets.json``.  Both report into the port's own metrics registry and
flight recorder.  The static lint rules of ``tools/analyze`` read source
trees and have no runtime counterpart here."""

from . import lockgraph, sanitizer

__all__ = ["lockgraph", "sanitizer"]
