"""Versioned weight snapshots: the durable handoff between a learner
and a serving process (port of ``deeplearning4j_tpu/deploy/store.py``;
the zips cross between the packages in both directions, ``flat.bin`` and
its manifest digest byte for byte).

A deployment needs a different artifact than a checkpoint: a resume
needs *everything* (updater state, RNG, epoch counters) while a server
needs only the inference weights, stamped with a **monotonic version**
so a polling reader can reason about "newer" without trusting
filenames or mtimes.  ``VersionedWeightStore`` keeps one zip per
version::

    <dir>/weights-v0000000007.zip
        flat.bin        float32-LE flat parameter vector
                        (``get_flat_params`` order)
        version.json    {"version": 7, "step": 1200, "wall_time": ...,
                         "source": "fit", "meta": {...}}
        manifest.json   per-entry SHA-256 + exact sizes

written with the checkpoint contract (``utils.fileio.atomic_write_bytes``:
temp file in the same directory -> fsync -> ``os.replace`` -> directory
fsync) so a SIGKILL mid-publish leaves either the old set or a complete
new zip, never a torn one.  Reads re-verify every hash; a flipped bit
raises :class:`WeightStoreCorruptError` *before* any weights reach a
server: the rollout controller refuses the push, never swaps.

Ordering is on the **stamp, not the filename**: ``latest()`` and
``versions()`` read each zip's ``version.json`` stamp, so a copied or
renamed file cannot smuggle stale weights to the front of the queue
(as ``CheckpointManager.latest()`` orders checkpoints).

Publishers:

- :class:`DeploymentListener` — a ``fit()`` listener that publishes the
  live model every N iterations/epochs (device->host fetch happens only
  on the publish cadence);
- :class:`ParamServerPoller` — subscribes to a parameter-server client
  (duck-typed on ``version()``, ``pull()`` and ``pull_coded()``; the TCP
  client itself is ROADMAP A11's ``scaleout/``), pulling the full flat
  vector when its version advances — the learner never needs to know a
  store exists.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np

from .. import monitor as _monitor
from ..monitor.locks import make_lock
from ..resilience.checkpoint import _sha256
from ..utils.fileio import atomic_write_bytes

STORE_PREFIX = "weights-v"
STORE_SUFFIX = ".zip"
FLAT_BIN = "flat.bin"
VERSION_JSON = "version.json"
MANIFEST_JSON = "manifest.json"


class WeightStoreCorruptError(RuntimeError):
    """A snapshot failed manifest verification (SHA-256 / size / missing
    entry): corrupt weights must never reach a swap."""


class WeightSnapshot:
    """One verified load: the flat f32 vector plus its stamps."""

    __slots__ = ("version", "step", "wall_time", "source", "meta", "flat")

    def __init__(self, version: int, step: int, wall_time: float,
                 source: str, meta: Dict[str, Any], flat: np.ndarray):
        self.version = int(version)
        self.step = int(step)
        self.wall_time = float(wall_time)
        self.source = str(source)
        self.meta = meta
        self.flat = flat

    def __repr__(self) -> str:
        return (f"WeightSnapshot(version={self.version}, "
                f"step={self.step}, n={self.flat.size})")


def _version_of(name: str) -> Optional[int]:
    if not (name.startswith(STORE_PREFIX) and name.endswith(STORE_SUFFIX)):
        return None
    try:
        return int(name[len(STORE_PREFIX):-len(STORE_SUFFIX)])
    except ValueError:
        return None


class VersionedWeightStore:
    """Monotonically versioned, corruption-verified weight snapshots.

    >>> store = VersionedWeightStore("/data/deploy/mnist")
    >>> v = store.publish(net.get_flat_params(), step=net.iteration)
    >>> snap = store.load(store.latest())          # verified or raises
    """

    def __init__(self, directory: str, *, keep_last: int = 8):
        self.directory = os.fspath(directory)
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        self.keep_last = int(keep_last)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = make_lock("deploy.store")

    # ------------------------------------------------------------ writing
    def publish(self, flat, *, step: int = 0, version: Optional[int] = None,
                source: str = "manual",
                meta: Optional[Dict[str, Any]] = None) -> int:
        """Atomically write one snapshot; returns its version.

        ``version=None`` allocates the next monotonic version
        (``latest() + 1``); an explicit version must be strictly newer
        than everything already in the store — the monotonicity
        invariant readers depend on.
        """
        flat = np.ascontiguousarray(np.asarray(flat, "<f4").ravel())
        with self._lock:
            head = self._latest_locked()
            if version is None:
                version = (head or 0) + 1
            version = int(version)
            if head is not None and version <= head:
                raise ValueError(
                    f"version {version} is not newer than the store head "
                    f"{head}; versions are monotonic")
            stamp = {
                "version": version,
                "step": int(step),
                "wall_time": time.time(),
                "source": str(source),
                "num_params": int(flat.size),
                "meta": dict(meta or {}),
            }
            payload = [
                (FLAT_BIN, flat.tobytes()),
                (VERSION_JSON, json.dumps(stamp, indent=2).encode("utf-8")),
            ]
            manifest = {
                "framework": "deeplearning4j_tpu",
                "kind": "weight_snapshot",
                "version": version,
                "step": int(step),
                "entries": {name: {"sha256": _sha256(data),
                                   "size": len(data)}
                            for name, data in payload},
            }
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
                for name, data in payload:
                    zf.writestr(name, data)
                zf.writestr(MANIFEST_JSON, json.dumps(manifest, indent=2))
            atomic_write_bytes(self._path(version), buf.getvalue())
            _monitor.counter(
                "deploy_snapshots_published_total",
                "weight snapshots published to the versioned store").inc()
            _monitor.gauge(
                "deploy_store_head_version",
                "newest version in the weight store").set(
                version, store=os.path.basename(self.directory) or "store")
            self._prune_locked()
        return version

    def publish_model(self, net, *, version: Optional[int] = None,
                      source: str = "fit",
                      meta: Optional[Dict[str, Any]] = None) -> int:
        """Publish a live container's current weights (the device-to-host
        fetch happens here, so call on the training thread)."""
        return self.publish(net.get_flat_params(),
                            step=int(getattr(net, "iteration", 0)),
                            version=version, source=source, meta=meta)

    def _path(self, version: int) -> str:
        return os.path.join(self.directory,
                            f"{STORE_PREFIX}{version:010d}{STORE_SUFFIX}")

    def _prune_locked(self) -> None:
        vs = self._versions_locked()
        for v in vs[:-self.keep_last]:
            try:
                os.remove(self._path(v))
            except OSError:
                pass

    # ------------------------------------------------------------ reading
    def _stamp_of(self, path: str) -> Optional[int]:
        """The monotonic version stamped INSIDE the zip (None when
        unreadable) — ordering authority, never the filename."""
        try:
            with zipfile.ZipFile(path, "r") as zf:
                stamp = json.loads(zf.read(VERSION_JSON))
            return int(stamp["version"])
        except Exception:
            return None

    def _versions_locked(self) -> List[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        out = []
        for n in names:
            if _version_of(n) is None:
                continue
            v = self._stamp_of(os.path.join(self.directory, n))
            if v is not None:
                out.append(v)
        return sorted(set(out))

    def versions(self) -> List[int]:
        """All readable versions, oldest first (stamp-ordered)."""
        with self._lock:
            return self._versions_locked()

    def _latest_locked(self) -> Optional[int]:
        vs = self._versions_locked()
        return vs[-1] if vs else None

    def latest(self) -> Optional[int]:
        """Newest version by stamp (None for an empty store)."""
        with self._lock:
            return self._latest_locked()

    def load(self, version: int) -> WeightSnapshot:
        """Verified load: every manifest entry's size and SHA-256 is
        re-checked before any bytes are trusted."""
        path = self._path(int(version))
        if not os.path.exists(path):
            raise KeyError(f"weight store has no version {version}")
        try:
            with zipfile.ZipFile(path, "r") as zf:
                names = set(zf.namelist())
                if MANIFEST_JSON not in names:
                    raise WeightStoreCorruptError(
                        f"{path}: no {MANIFEST_JSON} — torn write or not "
                        "a weight snapshot")
                try:
                    manifest = json.loads(zf.read(MANIFEST_JSON))
                except ValueError as e:
                    raise WeightStoreCorruptError(
                        f"{path}: unreadable manifest: {e}") from e
                blobs: Dict[str, bytes] = {}
                for name, ent in manifest.get("entries", {}).items():
                    if name not in names:
                        raise WeightStoreCorruptError(
                            f"{path}: manifest lists {name} but the zip "
                            "does not contain it")
                    try:
                        data = zf.read(name)
                    except Exception as e:   # CRC / deflate corruption
                        raise WeightStoreCorruptError(
                            f"{path}: {name} unreadable ({e}) — corrupt "
                            "snapshot") from e
                    if len(data) != int(ent["size"]):
                        raise WeightStoreCorruptError(
                            f"{path}: {name} is {len(data)} bytes, "
                            f"manifest says {ent['size']} — truncated or "
                            "torn write")
                    if _sha256(data) != ent["sha256"]:
                        raise WeightStoreCorruptError(
                            f"{path}: {name} SHA-256 mismatch — refusing "
                            "to deploy corrupt weights")
                    blobs[name] = data
        except zipfile.BadZipFile as e:
            raise WeightStoreCorruptError(
                f"{path}: not a valid zip ({e})") from e
        if FLAT_BIN not in blobs or VERSION_JSON not in blobs:
            raise WeightStoreCorruptError(
                f"{path}: manifest does not cover {FLAT_BIN}/"
                f"{VERSION_JSON}")
        stamp = json.loads(blobs[VERSION_JSON])
        flat = np.frombuffer(blobs[FLAT_BIN], "<f4").copy()
        if int(stamp["version"]) != int(version):
            raise WeightStoreCorruptError(
                f"{path}: stamped version {stamp['version']} does not "
                f"match requested {version}")
        return WeightSnapshot(stamp["version"], stamp.get("step", 0),
                              stamp.get("wall_time", 0.0),
                              stamp.get("source", "?"),
                              stamp.get("meta", {}), flat)

    def verify(self, version: int) -> bool:
        """True when ``version`` loads cleanly (corruption returns
        False instead of raising — the poll-loop probe)."""
        try:
            self.load(version)
            return True
        except WeightStoreCorruptError:
            return False


# ======================================================================
# Publishers
# ======================================================================

class DeploymentListener:
    """``fit()`` listener that publishes the live model into a
    :class:`VersionedWeightStore` every ``every_n_iterations`` (and/or
    at each epoch end).

    >>> net.add_listener(DeploymentListener(store, every_n_iterations=50))
    >>> net.fit(X, y, epochs=3)    # versions appear while training runs
    """

    def __init__(self, store: VersionedWeightStore, *,
                 every_n_iterations: int = 0,
                 publish_on_epoch_end: bool = True):
        self.store = store
        self.every_n_iterations = int(every_n_iterations)
        self.publish_on_epoch_end = bool(publish_on_epoch_end)
        self.published: List[int] = []

    def _publish(self, model, source: str) -> None:
        v = self.store.publish_model(model, source=source)
        self.published.append(v)

    def iteration_done(self, model, iteration: int) -> None:
        if (self.every_n_iterations > 0 and iteration > 0
                and iteration % self.every_n_iterations == 0):
            self._publish(model, "fit")

    def on_epoch_end(self, model) -> None:
        if self.publish_on_epoch_end:
            self._publish(model, "fit_epoch")


class ParamServerPoller:
    """Subscribe a weight store to a parameter server: probe the ``V``
    (version) op, and when the server's version counter advances pull
    the full flat vector and publish it.

    Works with either wire client (``pull()`` plain f64 or
    ``pull_coded()`` under the negotiated codec via ``prefer_coded``).
    ``poll_once()`` is the synchronous unit the background thread (and
    the tests) drive.
    """

    def __init__(self, client, store: VersionedWeightStore, *,
                 interval_s: float = 1.0, prefer_coded: bool = False):
        self.client = client
        self.store = store
        self.interval_s = float(interval_s)
        self.prefer_coded = bool(prefer_coded)
        self._last_server_version: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def poll_once(self) -> Optional[int]:
        """One probe: returns the newly published store version, or
        None when the server hasn't advanced."""
        sv = int(self.client.version())
        if self._last_server_version is not None \
                and sv <= self._last_server_version:
            return None
        flat = (self.client.pull_coded() if self.prefer_coded
                else self.client.pull())
        self._last_server_version = sv
        return self.store.publish(
            np.asarray(flat, np.float32).ravel(), step=sv,
            source="param_server", meta={"server_version": sv})

    def start(self) -> "ParamServerPoller":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception:
                    pass   # transient wire errors: retry next interval
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="deploy-ps-poller")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def tree_from_flat(model, flat: np.ndarray):
    """Build a fresh params tree for ``model`` from a flat vector WITHOUT
    touching the model's own weights: the deploy-side twin of
    ``set_flat_params`` (the same layer and param order, the same
    per-leaf dtypes), feeding ``InferenceEngine.stage_weights``.  The
    leaves are host (CPU) tensors; the engine places them."""
    import torch
    model.init()
    flat = np.asarray(flat).ravel()
    src = torch.from_numpy(np.ascontiguousarray(
        flat if flat.dtype == np.float64 else flat.astype(np.float32)))
    offset = 0
    pairs = []
    slots = model._slots()
    for key, layer in slots:
        tree = model.params[key]
        leaf = {}
        for p in layer.param_order():
            ref = tree[p]
            size = ref.numel()
            if offset + size > src.numel():
                raise ValueError(
                    f"flat weight vector has {flat.size} values, too few "
                    "for this model — wrong model for this snapshot")
            leaf[p] = src[offset:offset + size].reshape(ref.shape).to(
                ref.dtype).clone()
            offset += size
        for p, ref in tree.items():
            if p not in leaf:
                leaf[p] = ref.detach().cpu().clone()
        pairs.append((key, leaf))
    # graph keys without a layer slot pass through (as in the JAX package)
    slotted = {key for key, _ in slots}
    pairs += [(key, {p: v.detach().cpu().clone() for p, v in tree.items()})
              for key, tree in model._items(model.params)
              if key not in slotted]
    if offset != flat.size:
        raise ValueError(
            f"flat weight vector has {flat.size} values, model needs "
            f"{offset} — wrong model for this snapshot")
    return model._trees(pairs)
