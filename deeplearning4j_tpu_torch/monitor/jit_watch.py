"""The port's compile watch (port of ``deeplearning4j_tpu/monitor/
jit_watch.py``): make every per-signature build visible.

The JAX package wraps ``jax.jit`` so that a retrace (a new abstract
signature: tree structure, leaf shapes and dtypes, or a static argument's
value) is counted apart from a cache hit.  Eager PyTorch traces nothing,
so an eager train step compiles nothing and is never counted here.  What
the port does build once per signature, and what this module watches:

- the serving bucket callables of ``compile_output``
  (``mln.output`` / ``cg.output``): one build per bucket, counted when it
  is made, as the JAX package's ahead-of-time ``compile()`` is;
- the captured CUDA graph of a cached train step (``nn/step_graph.py``,
  ``mln.gather_train_step`` / ``cg.gather_train_step``): warm-up steps plus
  the capture, one per capture key;
- the KV-ring growth of the decode path (``mln.decode_grow`` /
  ``cg.decode_grow``), through :class:`WatchedCall` (the port's
  ``watched_jit``: nothing is jitted): the first call at a new (carry
  shapes, cache_len) is the build, later calls are cache hits;
- the hand kernels' library (``kernels.build``): a compile when ``nvcc``
  runs, a cache hit when the library is already on disk.

Series and spans carry the JAX package's names:

- ``jit_compiles_total{fn=...}`` / ``jit_cache_hits_total{fn=...}``;
- ``jit_compile_ms{fn=...}``: wall time of each build;
- a ``jit/compile/<name>`` span whose ``signature`` attribute names the
  shape that caused the build.

:func:`abstract_signature` keeps the JAX package's rules and spelling:
Python scalars are weak-typed (``int[]``, ``float[]``, ``bool[]``: a value
change is not a new signature), static arguments hash by ``repr``, and a
tree prints as jax's ``PyTreeDef(...)`` over lists, tuples, dicts and
``None``, each leaf as ``dtype[shape]`` (a torch dtype by its numpy name).
The XLA cost-analysis gauges have no counterpart: no compiler reports
costs here.

Under ``DL4J_TPU_SANITIZE=1`` every dispatch reports to the dispatch
sanitizer (``analyze/sanitizer.py``), as every ``watched_jit`` call does in
the JAX package: a :class:`WatchedCall` call itself, and the body of
:func:`dispatching` at the sites that run one JAX dispatch's work (an
epoch-cache fit group, a session's model step).  Whether a dispatch built,
and whether it built a further signature of a function (``recompile``),
is read from the builds :func:`compiling` counts on this thread.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Iterator, List, Optional, Sequence, Set, \
    Tuple

from ..analyze import sanitizer as _sanitizer
from .metrics import registry
from .tracing import tracer

COMPILES_TOTAL = "jit_compiles_total"
CACHE_HITS_TOTAL = "jit_cache_hits_total"
COMPILE_MS = "jit_compile_ms"

_HELP = {
    COMPILES_TOTAL: "jitted-function compilations (first call per "
                    "abstract signature)",
    CACHE_HITS_TOTAL: "jitted-function calls served from the trace cache",
    COMPILE_MS: "wall time of each compiling call (trace + compile + "
                "first dispatch, ms)",
}


def _dtype_name(dtype: Any) -> str:
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def _leaf_desc(leaf: Any) -> str:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{_dtype_name(dtype)}[{','.join(str(int(d)) for d in shape)}]"
    # weak-typed python scalars: a value change is not a new signature
    if isinstance(leaf, bool):
        return "bool[]"
    if isinstance(leaf, int):
        return "int[]"
    if isinstance(leaf, float):
        return "float[]"
    if isinstance(leaf, complex):
        return "complex[]"
    return repr(leaf)


def _structure(obj: Any, leaves: List[Any]) -> str:
    """jax's treedef spelling of ``obj``; its leaves go to ``leaves``."""
    if obj is None:
        return "None"
    if type(obj) is tuple:
        inner = [_structure(x, leaves) for x in obj]
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") \
            + ")"
    if type(obj) is list:
        return "[" + ", ".join(_structure(x, leaves) for x in obj) + "]"
    if type(obj) is dict:
        return "{" + ", ".join(f"{k!r}: {_structure(obj[k], leaves)}"
                               for k in sorted(obj)) + "}"
    leaves.append(obj)
    return "*"


def _tree_desc(obj: Any) -> str:
    leaves: List[Any] = []
    structure = _structure(obj, leaves)
    return f"PyTreeDef({structure}):" + ",".join(_leaf_desc(l)
                                                 for l in leaves)


def abstract_signature(args: Tuple, kwargs: dict,
                       static_argnums: Sequence[int] = ()) -> str:
    """The JAX package's cache-key string for this call: static arguments
    by value, the others by tree structure and per-leaf ``dtype[shape]``."""
    static = set(static_argnums or ())
    parts = []
    for i, arg in enumerate(args):
        parts.append(f"static{i}={arg!r}" if i in static
                     else _tree_desc(arg))
    for k in sorted(kwargs):
        parts.append(f"{k}={_tree_desc(kwargs[k])}")
    return "; ".join(parts)


# builds (and recompiles among them) made on each thread, so that a
# dispatch can tell whether it built
_tls = threading.local()


def _builds() -> Tuple[int, int]:
    return getattr(_tls, "builds", 0), getattr(_tls, "recompiles", 0)


def _armed():
    """The dispatch sanitizer when ``DL4J_TPU_SANITIZE=1``, else None."""
    return _sanitizer if _sanitizer.enabled() else None


def cache_hit(name: str) -> None:
    """Count one call of ``name`` that found its build ready."""
    registry().counter(CACHE_HITS_TOTAL, _HELP[CACHE_HITS_TOTAL]).inc(
        fn=name)


@contextlib.contextmanager
def compiling(name: str, signature: str = "",
              recompile: bool = False) -> Iterator[None]:
    """Time the enclosed build of ``name`` under a ``jit/compile/<name>``
    span and count it (``jit_compiles_total``, ``jit_compile_ms``).  A
    build that raises is not counted."""
    t0 = time.perf_counter()
    with tracer().span(f"jit/compile/{name}", signature=signature,
                       recompile=recompile):
        yield
    elapsed = time.perf_counter() - t0
    reg = registry()
    reg.counter(COMPILES_TOTAL, _HELP[COMPILES_TOTAL]).inc(fn=name)
    reg.histogram(COMPILE_MS, _HELP[COMPILE_MS]).observe(elapsed * 1e3,
                                                         fn=name)
    builds, recompiles = _builds()
    _tls.builds, _tls.recompiles = builds + 1, recompiles + int(recompile)


@contextlib.contextmanager
def dispatching(name: str) -> Iterator[None]:
    """The enclosed work is one dispatch of ``name`` for the armed
    dispatch sanitizer (a no-op unarmed); it built (``compiled``) if a
    build of :func:`compiling` ran inside it, and recompiled if one of
    those was a further signature of its function."""
    san = _armed()
    if san is None:
        yield
        return
    builds, recompiles = _builds()
    yield
    after, re_after = _builds()
    san.record_dispatch(name, compiled=after > builds,
                        recompile=re_after > recompiles)


class WatchedCall:
    """A callable that builds per abstract signature: its first call at a
    signature counts as a compile (timed, spanned), later calls at that
    signature as cache hits."""

    def __init__(self, fn: Callable, name: Optional[str] = None,
                 static_argnums: Sequence[int] = ()):
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "fn")
        self._static_argnums = tuple(static_argnums or ())
        self._seen: Set[str] = set()
        self.__wrapped__ = fn

    def __call__(self, *args, **kwargs):
        signature = abstract_signature(args, kwargs, self._static_argnums)
        san = _armed()
        if signature in self._seen:
            cache_hit(self.name)
            if san is not None:
                san.record_dispatch(self.name, compiled=False,
                                    recompile=False)
            return self._fn(*args, **kwargs)
        recompile = bool(self._seen)
        if san is not None:
            san.record_dispatch(self.name, compiled=True,
                                recompile=recompile)
        with compiling(self.name, signature, recompile=recompile):
            out = self._fn(*args, **kwargs)
        self._seen.add(signature)
        return out

    @property
    def compile_count(self) -> int:
        return len(self._seen)
