"""Persistent on-disk build cache for serving workers (port of
``deeplearning4j_tpu/serving/compile_cache.py``).

Cold start is the enemy of elasticity: a respawned fleet worker that has
to build again what its predecessor built spends that time before its
first reply.  In the JAX package the build is XLA's compile of the whole
bucket ladder, and this module points JAX's persistent compilation cache
at a per-model namespace.  The port compiles nothing per bucket:
``compile_output`` returns a closure over the eager forward.  The one
ahead-of-time artifact the port makes is the hand kernels' library
(``ops/kernel_build.py``, ``nvcc`` into a shared library), so
:func:`enable` points the kernel build at ``<root>/sig-<sig>/kernels``,
and a respawn in that namespace loads the library instead of running
``nvcc`` again.

A fleet model that launches no hand kernel writes no entry: none of the
three ``serving.fleet.FLEET_SPECS`` (two LSTM stacks and an MLP) has
attention, so their namespaces stay empty and a respawn's gain is
nothing to build.  The JAX package's "respawn >= 5x faster" figure
measured XLA's ladder compile, which the port does not have; the port's
respawn times are recorded (``chip_smoke.py`` phase 19) and not gated.

Key discipline, as in the JAX package: the namespace is keyed by
:func:`signature` (architecture + device kind + bucket policy), so
unrelated models never share one, and the library's own name hashes its
sources and flags (``kernel_build.library_path``), so a stale library is
never loaded.

Env: ``DL4J_TPU_FLEET_COMPILE_CACHE`` is the cache root; the no-argument
:func:`enable` uses it, and an empty or unset value disables the cache
(builds go to the default ``build/kernels/``).
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import torch

from .. import monitor as _monitor
from ..device import DeviceLike, resolve_device
from ..ops import kernel_build

ENV_CACHE_DIR = "DL4J_TPU_FLEET_COMPILE_CACHE"

_enabled_dir: Optional[str] = None


def device_kind(device: DeviceLike = None) -> str:
    """``"cuda:<name>:sm_<major><minor>"`` for a card, ``"cpu"`` for the
    CPU (``None`` means the card, which must then exist)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(index)
    return f"cuda:{torch.cuda.get_device_name(index)}:sm_{major}{minor}"


def signature(conf, policy, device: DeviceLike = None) -> str:
    """The cache-namespace key for (model conf, device, bucket policy):
    the first 16 hex digits of sha256 over ``conf.to_json(indent=None)``,
    :func:`device_kind` and ``policy.describe()``, joined by ``|``."""
    try:
        conf_txt = conf.to_json(indent=None)
    except Exception:
        conf_txt = repr(conf)
    payload = "|".join((conf_txt, device_kind(device), policy.describe()))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def cache_dir_for(root: str, sig: str) -> str:
    """The per-model-signature namespace directory under ``root``."""
    return os.path.join(root, f"sig-{sig}")


def enable(root: Optional[str] = None,
           sig: Optional[str] = None) -> Optional[str]:
    """Point the kernel build at ``<root>/sig-<sig>/kernels`` (or
    ``<root>/kernels`` when ``sig`` is None).  ``root=None`` reads
    ``DL4J_TPU_FLEET_COMPILE_CACHE``; unset or empty means "no cache" and
    returns None.  Idempotent; enabling another directory repoints the
    process (one build directory at a time).

    Returns the active cache directory (created if missing)."""
    global _enabled_dir
    if root is None:
        root = os.environ.get(ENV_CACHE_DIR, "").strip() or None
    if not root:
        return None
    path = cache_dir_for(root, sig) if sig else root
    os.makedirs(path, exist_ok=True)
    kernel_build.set_build_dir(os.path.join(path, "kernels"))
    _enabled_dir = path
    _observe(path)
    return path


def disable() -> None:
    """Detach the process from the cache: builds go to the default
    directory again."""
    global _enabled_dir
    kernel_build.set_build_dir(None)
    _enabled_dir = None


def enabled_dir() -> Optional[str]:
    """The directory :func:`enable` last activated (None = no cache)."""
    return _enabled_dir


def stats(path: Optional[str] = None) -> dict:
    """``{"dir", "entries", "bytes"}`` for ``path`` (default: the enabled
    directory).  Entries are the built libraries (``*.so``)."""
    path = path or _enabled_dir
    if not path or not os.path.isdir(path):
        return {"dir": path, "entries": 0, "bytes": 0}
    entries = n_bytes = 0
    for base, _dirs, files in os.walk(path):
        for name in files:
            if not name.endswith(".so"):
                continue
            entries += 1
            try:
                n_bytes += os.path.getsize(os.path.join(base, name))
            except OSError:
                pass
    return {"dir": path, "entries": entries, "bytes": n_bytes}


def _observe(path: str) -> None:
    snap = stats(path)
    _monitor.gauge(
        "fleet_compile_cache_entries",
        "serialized executables in the persistent compile cache").set(
        snap["entries"])
    _monitor.gauge(
        "fleet_compile_cache_bytes",
        "bytes of serialized executables in the persistent compile "
        "cache").set(snap["bytes"])
