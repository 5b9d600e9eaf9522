"""Preemption-safe checkpointing for ``fit()`` and the sharded pod
checkpoints of a ``parallel.mesh.MeshRuntime`` (port of
``deeplearning4j_tpu/resilience/checkpoint.py``).

A checkpoint here is a *superset* of the ``utils/model_serializer.py``
zip (same ``configuration.json`` / ``coefficients.bin`` /
``updaterState.bin`` / ``state.bin`` / ``manifest.json`` entries, so
``restore_multi_layer_network`` can open one).  For the same weights the
four model entries are byte-identical to the JAX package's.  It adds:

- ``resume.json`` — the full fit-resume state: epoch, iteration, the
  **step offset inside the current epoch**, and the state of the fit's
  generator (dropout).  The epoch-cache path derives every epoch's
  example order from a device generator seeded by the network's seed and
  the epoch (``nn/ingest.epoch_permutation``), so a restore replays the
  *identical* order from the exact step a preemption interrupted, which
  is what makes kill-and-resume bit-identical to an uninterrupted run.

  Deliberate difference: the JAX package stores its threefry key words
  under ``rng_key``; the port stores its ``torch.Generator`` state bytes
  under ``rng_state`` (with the generator's device type), since torch
  cannot reproduce the threefry stream.  A checkpoint's model entries
  load in either package; its RNG entry resumes only in the package that
  wrote it.
- a manifest ``entries`` table with per-entry SHA-256 and exact byte
  sizes, verified on every restore and by :meth:`CheckpointManager.
  latest` — a torn, truncated, or bit-rotted checkpoint is *rejected
  with a diagnostic* (:class:`CheckpointCorruptError`), never silently
  loaded, and ``latest()`` falls back to the newest checkpoint that
  does verify.

Durability: writes go to a temp file in the same directory, are
``fsync``-ed, then ``os.replace``-d into place (plus a directory fsync)
— a SIGKILL at any instant leaves either the previous checkpoint or the
new one, never a half-written file under the final name.

Overlap: ``save()`` snapshots device state on the *training* thread (the
cache path's captured step updates its buffers in place, so they must be
read before the next dispatch) and hands the host copies to a single
background writer thread that does the zip/deflate/fsync work off the
training loop.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import monitor as _monitor
from ..monitor.locks import make_lock
from ..utils.fileio import atomic_write, atomic_write_bytes
from ..utils.model_serializer import (COEFFICIENTS_BIN, CONFIG_JSON,
                                      MANIFEST_JSON, STATE_BIN, UPDATER_BIN,
                                      ModelSerializationError, _flatten_state,
                                      _restore_into)
from . import faults as _faults

RESUME_JSON = "resume.json"
CHECKPOINT_PREFIX = "checkpoint-"
CHECKPOINT_SUFFIX = ".zip"

WRITES_TOTAL = "checkpoint_writes_total"
WRITE_MS = "checkpoint_write_ms"
BYTES_GAUGE = "checkpoint_bytes"
LAST_UNIXTIME = "checkpoint_last_write_unixtime"
CORRUPT_SKIPPED = "checkpoint_corrupt_skipped_total"
RESTORES_TOTAL = "checkpoint_restores_total"
PRUNED_TOTAL = "checkpoint_pruned_total"

_HELP = {
    WRITES_TOTAL: "checkpoints durably written (post-rename)",
    WRITE_MS: "background checkpoint write (zip+fsync+rename, ms)",
    BYTES_GAUGE: "size of the most recent checkpoint zip",
    LAST_UNIXTIME: "unix time of the most recent durable checkpoint",
    CORRUPT_SKIPPED: "checkpoints that failed verification and were "
                     "skipped while resolving latest()",
    RESTORES_TOTAL: "successful checkpoint restores",
    PRUNED_TOTAL: "checkpoints deleted by keep_last/keep_best retention",
}


class CheckpointCorruptError(ModelSerializationError):
    """A checkpoint failed SHA-256/size verification or is not a readable
    zip — refuse to load it (a silent misload trains on garbage)."""


# Process-wide status the /healthz endpoint reports: the most recent
# durable write and the state this process resumed from (if any).
_status_lock = make_lock("resilience.checkpoint.status")
_last_write: Optional[Dict[str, Any]] = None
_resumed_from: Optional[Dict[str, Any]] = None


def status() -> Optional[Dict[str, Any]]:
    """Checkpoint/resume facts for ``GET /healthz``: the last durable
    write (path, iteration, age) and what this process resumed from."""
    with _status_lock:
        if _last_write is None and _resumed_from is None:
            return None
        out: Dict[str, Any] = {"resumed_from": _resumed_from}
        if _last_write is not None:
            out.update(_last_write)
            out["age_seconds"] = round(time.time() - _last_write["unixtime"],
                                       3)
        return out


def _reset_status() -> None:
    global _last_write, _resumed_from
    with _status_lock:
        _last_write = None
        _resumed_from = None


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def checkpoint_path(directory: str, iteration: int) -> str:
    return os.path.join(
        directory, f"{CHECKPOINT_PREFIX}{iteration:010d}{CHECKPOINT_SUFFIX}")


def _iteration_of(name: str) -> Optional[int]:
    if not (name.startswith(CHECKPOINT_PREFIX)
            and name.endswith(CHECKPOINT_SUFFIX)):
        return None
    stem = name[len(CHECKPOINT_PREFIX):-len(CHECKPOINT_SUFFIX)]
    try:
        return int(stem)
    except ValueError:
        return None


def list_checkpoints(directory: str) -> List[str]:
    """Checkpoint paths in ``directory``, newest (highest iteration)
    first."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    pairs = [(it, n) for n in names
             if (it := _iteration_of(n)) is not None]
    return [os.path.join(directory, n)
            for _, n in sorted(pairs, reverse=True)]


def checkpoint_stamp(path: str) -> Optional[Tuple[int, float]]:
    """The ``(iteration, wall_time)`` stamped INSIDE a checkpoint (its
    manifest plus ``resume.json``), or None when unreadable.  This is
    the ordering authority for :meth:`CheckpointManager.latest`: a
    file's NAME is writable by anyone (copies, renames, clock-skewed
    retention moves), but the stamp was written atomically with the
    payload it describes."""
    try:
        with zipfile.ZipFile(path, "r") as zf:
            manifest = json.loads(zf.read(MANIFEST_JSON))
            it = int(manifest["iteration"])
            wall = 0.0
            if RESUME_JSON in zf.namelist():
                try:
                    wall = float(json.loads(
                        zf.read(RESUME_JSON)).get("wall_time") or 0.0)
                except (ValueError, TypeError):
                    wall = 0.0
            return (it, wall)
    except Exception:
        return None


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Verify ``path`` against its own manifest (entry presence, exact
    sizes, SHA-256) and return the manifest.  Raises
    :class:`CheckpointCorruptError` with a diagnostic naming the first
    failing entry, after dumping a ``checkpoint_corrupt`` flight-recorder
    bundle (corruption is rare and always worth a post-mortem)."""
    try:
        return _verify_checkpoint(path)
    except CheckpointCorruptError as e:
        _monitor.record_incident("checkpoint_corrupt",
                                 {"path": path, "error": str(e)})
        raise


def _verify_checkpoint(path: str) -> Dict[str, Any]:
    try:
        with zipfile.ZipFile(path, "r") as zf:
            names = set(zf.namelist())
            if MANIFEST_JSON not in names:
                raise CheckpointCorruptError(
                    f"{path}: no {MANIFEST_JSON} entry — not a checkpoint "
                    "or torn write")
            try:
                manifest = json.loads(zf.read(MANIFEST_JSON))
            except (ValueError, zipfile.BadZipFile) as e:
                raise CheckpointCorruptError(
                    f"{path}: unreadable {MANIFEST_JSON}: {e}") from e
            entries = manifest.get("entries", {})
            if COEFFICIENTS_BIN not in names:
                raise CheckpointCorruptError(
                    f"{path}: missing {COEFFICIENTS_BIN}")
            for name, ent in entries.items():
                if name not in names:
                    raise CheckpointCorruptError(
                        f"{path}: manifest lists {name} but the zip does "
                        "not contain it")
                try:
                    data = zf.read(name)
                except (zipfile.BadZipFile, Exception) as e:
                    raise CheckpointCorruptError(
                        f"{path}: {name} unreadable ({e}) — corrupt "
                        "checkpoint") from e
                if len(data) != int(ent["size"]):
                    raise CheckpointCorruptError(
                        f"{path}: {name} is {len(data)} bytes, manifest "
                        f"says {ent['size']} — truncated or torn write")
                if _sha256(data) != ent["sha256"]:
                    raise CheckpointCorruptError(
                        f"{path}: {name} SHA-256 mismatch — bit rot or "
                        "tampering; refusing to load")
            return manifest
    except zipfile.BadZipFile as e:
        raise CheckpointCorruptError(
            f"{path}: not a valid zip ({e}) — torn write or corruption"
        ) from e


def _rng_state(net) -> Dict[str, Any]:
    """The fit generator's state as JSON: its bytes and device type."""
    gen = getattr(net, "_rng", None)
    if gen is None:
        return {}
    return {"rng_state": [int(b) for b in gen.get_state().tolist()],
            "rng_device": gen.device.type}


def _restore_rng(net, resume: Dict[str, Any]) -> None:
    words = resume.get("rng_state") or []
    gen = getattr(net, "_rng", None)
    if not words or gen is None:
        return
    if resume.get("rng_device", gen.device.type) != gen.device.type:
        raise CheckpointCorruptError(
            f"checkpoint generator state is for a {resume['rng_device']} "
            f"generator; this network's is on {gen.device.type}")
    import torch
    gen.set_state(torch.tensor(words, dtype=torch.uint8))


class ResumeState:
    """What a restore hands back to ``fit()``: where training stood when
    the checkpoint was taken."""

    def __init__(self, path: str, epoch: int, iteration: int,
                 step_in_epoch: int, score: Optional[float] = None):
        self.path = path
        self.epoch = int(epoch)
        self.iteration = int(iteration)
        self.step_in_epoch = int(step_in_epoch)
        self.score = score

    def __repr__(self) -> str:
        return (f"ResumeState(epoch={self.epoch}, "
                f"iteration={self.iteration}, "
                f"step_in_epoch={self.step_in_epoch}, "
                f"path={self.path!r})")


def snapshot(net, step_in_epoch: int = 0) -> Dict[str, Any]:
    """Device->host snapshot of everything a resume needs, taken on the
    TRAINING thread (the captured step reuses its buffers).  Returns
    plain host data safe to serialize on any thread."""
    net.init()
    flat = np.asarray(net.get_flat_params(), "<f4")
    upd = np.asarray(net.get_flat_updater_state(), "<f4")
    state_flat, state_manifest = _flatten_state(net)
    score = getattr(net, "_score", None)
    if score is not None:
        score = float(score)     # a device scalar reads with one copy
    pol = net._pol() if hasattr(net, "_pol") else None
    resume = {
        "epoch": int(getattr(net, "epoch", 0)),
        "iteration": int(getattr(net, "iteration", 0)),
        "step_in_epoch": int(step_in_epoch),
        **_rng_state(net),
        "score": score,
        "model_class": type(net).__name__,
        "wall_time": time.time(),
        # the precision policy shapes the updater-state layout (fp32
        # masters ride updaterState.bin); a resume under a different
        # policy cannot line up, so stamp it for the restore-side check
        "precision": pol.describe() if pol is not None else None,
    }
    return {
        "config": net.conf.to_json(),
        "flat": flat,
        "updater": upd,
        "state_flat": np.asarray(state_flat, "<f4"),
        "state_manifest": state_manifest,
        "resume": resume,
        "pretrain_done": bool(getattr(net, "_pretrain_done", False)),
    }


def write_snapshot(snap: Dict[str, Any], path: str) -> None:
    """Serialize ``snap`` atomically to ``path``: temp file in the same
    directory -> fsync -> ``os.replace`` -> directory fsync.  Any
    interruption leaves either the old file or the new one."""
    resume = snap["resume"]
    payload: List[Tuple[str, bytes]] = [
        (CONFIG_JSON, snap["config"].encode("utf-8")),
        (COEFFICIENTS_BIN, snap["flat"].tobytes()),
        (UPDATER_BIN, snap["updater"].tobytes()),
    ]
    if snap["state_flat"].size:
        payload.append((STATE_BIN, snap["state_flat"].tobytes()))
    payload.append((RESUME_JSON,
                    json.dumps(resume, indent=2).encode("utf-8")))
    manifest = {
        "framework": "deeplearning4j_tpu_torch",
        "model_class": resume["model_class"],
        "num_params": int(snap["flat"].size),
        "num_updater_values": int(snap["updater"].size),
        "iteration": resume["iteration"],
        "epoch": resume["epoch"],
        "pretrain_done": snap["pretrain_done"],
        "state": snap["state_manifest"],
        "entries": {name: {"sha256": _sha256(data), "size": len(data)}
                    for name, data in payload},
    }
    with atomic_write(path, "wb") as fh:
        with zipfile.ZipFile(fh, "w", zipfile.ZIP_DEFLATED) as zf:
            for name, data in payload:
                zf.writestr(name, data)
            zf.writestr(MANIFEST_JSON, json.dumps(manifest, indent=2))


def restore(net, path: str) -> ResumeState:
    """Verify ``path`` and load it into ``net`` (params, updater state,
    layer state, iteration/epoch, fit generator state).  Returns the
    :class:`ResumeState` carrying the step offset in the epoch.  Raises
    :class:`CheckpointCorruptError` on any verification failure."""
    global _resumed_from
    verify_checkpoint(path)
    net.init()
    with zipfile.ZipFile(path, "r") as zf:
        names = set(zf.namelist())
        if RESUME_JSON in names:
            saved_pol = json.loads(zf.read(RESUME_JSON)).get("precision")
            cur_pol = (net._pol().describe()
                       if hasattr(net, "_pol") else None)
            if saved_pol and cur_pol and saved_pol != cur_pol:
                raise CheckpointCorruptError(
                    f"{path}: checkpoint was written under precision "
                    f"policy {saved_pol} but this process resolves "
                    f"{cur_pol}; set DL4J_TPU_PRECISION to match before "
                    "resuming")
        _restore_into(net, zf, load_updater=True)
        resume = (json.loads(zf.read(RESUME_JSON))
                  if RESUME_JSON in names else {})
    _restore_rng(net, resume)
    rs = ResumeState(path=path,
                     epoch=int(getattr(net, "epoch", 0)),
                     iteration=int(getattr(net, "iteration", 0)),
                     step_in_epoch=int(resume.get("step_in_epoch", 0)),
                     score=resume.get("score"))
    _monitor.counter(RESTORES_TOTAL, _HELP[RESTORES_TOTAL]).inc()
    with _status_lock:
        _resumed_from = {
            "path": path,
            "epoch": rs.epoch,
            "iteration": rs.iteration,
            "step_in_epoch": rs.step_in_epoch,
        }
    return rs


class CheckpointManager:
    """Rolling, atomic, background-written checkpoints for ``fit()``.

    ``every_steps`` / ``every_seconds`` set the save cadence (either or
    both; with neither set, saves happen at epoch boundaries and at the
    end of fit).  ``keep_last`` newest checkpoints are retained plus the
    ``keep_best`` lowest-score ones; everything else is pruned after
    each write.  ``async_write=True`` (default) moves zip+fsync to a
    single background thread — the training thread only pays the
    device->host fetch."""

    def __init__(self, directory: str,
                 every_steps: Optional[int] = None,
                 every_seconds: Optional[float] = None,
                 keep_last: int = 3, keep_best: int = 0,
                 async_write: bool = True):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.every_steps = (int(every_steps)
                            if every_steps is not None else None)
        if self.every_steps is not None and self.every_steps <= 0:
            raise ValueError("every_steps must be positive")
        self.every_seconds = (float(every_seconds)
                              if every_seconds is not None else None)
        self.keep_last = max(1, int(keep_last))
        self.keep_best = max(0, int(keep_best))
        self._async = bool(async_write)
        self._steps_since = 0
        self._last_save_t = time.monotonic()
        self._saved_iteration: Optional[int] = None
        self._scores: Dict[str, Optional[float]] = {}
        self._queue: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=2)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_lock = make_lock("resilience.checkpoint.error")

    # ---- cadence ---------------------------------------------------------
    def note_steps(self, n: int) -> None:
        """Account ``n`` completed optimizer steps toward the cadence."""
        self._steps_since += int(n)

    def steps_to_next_save(self) -> int:
        """How many more steps until the step cadence fires (large when
        no step cadence is set) — the epoch-cache loop sizes its
        chunks with this so a dispatch never overshoots a save point."""
        if self.every_steps is None:
            return 1 << 30
        return max(1, self.every_steps - self._steps_since)

    def due(self, epoch_boundary: bool = False) -> bool:
        """True when the cadence says to save now.  With no cadence
        configured at all, epoch boundaries are the save points."""
        if self.every_steps is not None \
                and self._steps_since >= self.every_steps:
            return True
        if self.every_seconds is not None \
                and time.monotonic() - self._last_save_t \
                >= self.every_seconds:
            return True
        if (epoch_boundary and self.every_steps is None
                and self.every_seconds is None):
            return True
        return False

    # ---- write path ------------------------------------------------------
    def _raise_pending_error(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                "background checkpoint write failed") from err

    def _writer_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            snap, path = job
            try:
                self._write_job(snap, path)
            except BaseException as e:
                with self._error_lock:
                    self._error = e

    def _write_job(self, snap: Dict[str, Any], path: str) -> None:
        global _last_write
        t0 = time.perf_counter()
        write_snapshot(snap, path)
        if _faults.corrupt_checkpoint():
            _faults.corrupt_file(path)
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(path)
        self._scores[path] = snap["resume"].get("score")
        _monitor.counter(WRITES_TOTAL, _HELP[WRITES_TOTAL]).inc()
        _monitor.histogram(WRITE_MS, _HELP[WRITE_MS]).observe(elapsed_ms)
        _monitor.gauge(BYTES_GAUGE, _HELP[BYTES_GAUGE]).set(size)
        now = time.time()
        _monitor.gauge(LAST_UNIXTIME, _HELP[LAST_UNIXTIME]).set(now)
        with _status_lock:
            _last_write = {
                "path": path,
                "iteration": snap["resume"]["iteration"],
                "epoch": snap["resume"]["epoch"],
                "step_in_epoch": snap["resume"]["step_in_epoch"],
                "unixtime": now,
                "bytes": size,
            }
        self._prune()

    def save(self, net, step_in_epoch: int = 0,
             blocking: bool = False) -> str:
        """Checkpoint ``net`` now.  The device->host snapshot happens on
        the calling (training) thread; serialization happens on the
        background writer unless ``blocking`` or the manager was built
        with ``async_write=False``.  Returns the final checkpoint
        path."""
        self._raise_pending_error()
        snap = snapshot(net, step_in_epoch=step_in_epoch)
        path = checkpoint_path(self.directory,
                               snap["resume"]["iteration"])
        self._steps_since = 0
        self._last_save_t = time.monotonic()
        self._saved_iteration = snap["resume"]["iteration"]
        if blocking or not self._async:
            self._write_job(snap, path)
            return path
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="checkpoint-writer")
            self._writer.start()
        self._queue.put((snap, path))
        return path

    def save_if_progress(self, net, step_in_epoch: int = 0,
                         blocking: bool = False) -> Optional[str]:
        """Save unless the current iteration is already checkpointed
        (the end-of-fit hook: avoids a duplicate write when the cadence
        just fired)."""
        if self._saved_iteration == int(getattr(net, "iteration", 0)):
            return None
        return self.save(net, step_in_epoch=step_in_epoch,
                         blocking=blocking)

    def flush(self) -> None:
        """Block until every queued write is durable; re-raise any
        background write error on the caller."""
        if self._writer is not None and self._writer.is_alive():
            self._queue.put(None)
            self._writer.join()
            self._writer = None
        self._raise_pending_error()

    # ---- retention / discovery ------------------------------------------
    def _score_of(self, path: str) -> Optional[float]:
        if path in self._scores:
            return self._scores[path]
        try:
            with zipfile.ZipFile(path, "r") as zf:
                if RESUME_JSON in zf.namelist():
                    score = json.loads(zf.read(RESUME_JSON)).get("score")
                else:
                    score = None
        except Exception:
            score = None
        self._scores[path] = score
        return score

    def _prune(self) -> None:
        paths = list_checkpoints(self.directory)  # newest first
        keep = set(paths[:self.keep_last])
        if self.keep_best:
            scored = [(s, p) for p in paths
                      if (s := self._score_of(p)) is not None]
            scored.sort(key=lambda t: t[0])
            keep.update(p for _, p in scored[:self.keep_best])
        pruned = 0
        for p in paths:
            if p in keep:
                continue
            try:
                os.remove(p)
                pruned += 1
            except OSError:
                pass
            self._scores.pop(p, None)
        if pruned:
            _monitor.counter(PRUNED_TOTAL, _HELP[PRUNED_TOTAL]).inc(pruned)

    def checkpoints(self) -> List[str]:
        return list_checkpoints(self.directory)

    def latest(self, validate: bool = True) -> Optional[str]:
        """Newest checkpoint that passes verification (corrupt ones are
        skipped with a counter — a torn last write must not block
        recovery from the one before it).

        "Newest" is decided by the monotonic ``(iteration, wall_time)``
        stamp inside each checkpoint (:func:`checkpoint_stamp`), NOT by
        filename: a snapshot copied/renamed to a higher-numbered name
        (clock skew, retention tooling, manual restores) must not
        shadow genuinely newer training state, and a reader polling the
        directory depends on this ordering."""
        stamped, stampless = [], []
        for i, path in enumerate(list_checkpoints(self.directory)):
            stamp = checkpoint_stamp(path)
            if stamp is not None:
                stamped.append((stamp, path))
            else:
                stampless.append(path)   # keeps filename (newest-first)
        stamped.sort(key=lambda t: t[0], reverse=True)
        # any stamped candidate outranks every stampless one; stampless
        # files (pre-stamp era or unreadable manifests) keep the old
        # filename ordering as a last resort
        for path in [p for _, p in stamped] + stampless:
            if not validate:
                return path
            try:
                verify_checkpoint(path)
                return path
            except CheckpointCorruptError:
                _monitor.counter(CORRUPT_SKIPPED,
                                 _HELP[CORRUPT_SKIPPED]).inc()
        return None

    def restore_latest(self, net) -> Optional[ResumeState]:
        path = self.latest()
        return None if path is None else restore(net, path)


def as_manager(checkpoint) -> Optional[CheckpointManager]:
    """Normalize ``fit(checkpoint=...)``: None passes through, a
    :class:`CheckpointManager` is used as-is, a directory path gets a
    default manager (epoch-boundary saves, keep_last=3)."""
    if checkpoint is None or isinstance(checkpoint, CheckpointManager):
        return checkpoint
    if isinstance(checkpoint, (str, os.PathLike)):
        return CheckpointManager(os.fspath(checkpoint))
    raise TypeError(
        f"checkpoint= expects None, a directory path, or a "
        f"CheckpointManager; got {type(checkpoint).__name__}")


def resume_for_fit(net, resume_from,
                   ckpt: Optional[CheckpointManager]
                   ) -> Optional[ResumeState]:
    """Resolve ``fit(resume_from=...)`` and restore into ``net``.

    - ``"auto"``/``"latest"``: the manager's newest *valid* checkpoint
      (requires ``checkpoint=``); ``None`` when the directory is empty —
      a cold start, not an error (first run of a preemptible job).
    - a directory: its newest valid checkpoint (or cold start).
    - a file path: that exact checkpoint; missing or corrupt raises.
    """
    if resume_from in ("auto", "latest"):
        if ckpt is None:
            raise ValueError(
                "resume_from='auto' needs checkpoint= (a manager or "
                "directory) to know where to look")
        path = ckpt.latest()
        return None if path is None else restore(net, path)
    resume_from = os.fspath(resume_from)
    if os.path.isdir(resume_from):
        for path in list_checkpoints(resume_from):
            try:
                return restore(net, path)
            except CheckpointCorruptError:
                _monitor.counter(CORRUPT_SKIPPED,
                                 _HELP[CORRUPT_SKIPPED]).inc()
        return None
    if not os.path.exists(resume_from):
        raise FileNotFoundError(
            f"resume_from checkpoint does not exist: {resume_from}")
    return restore(net, resume_from)


def resolve_fit_resilience(net, checkpoint, resume_from, epochs):
    """The shared ``fit()`` front half for both network classes:
    normalize ``checkpoint=``, perform the restore, and convert the
    caller's TOTAL epoch target into remaining epochs (the restored
    partial epoch, if any, counts as the first remaining one — so the
    resumed invocation is the *identical* fit call the preempted run
    made).  Returns ``(manager, start_step, remaining_epochs)``."""
    ckpt = as_manager(checkpoint)
    start_step = 0
    if resume_from is not None:
        rs = resume_for_fit(net, resume_from, ckpt)
        if rs is not None:
            start_step = rs.step_in_epoch
            epochs = max(0, int(epochs) - rs.epoch)
    return ckpt, start_step, epochs


# ======================================================================
# Pod (multi-process, sharded) checkpoints
#
# A pod checkpoint is a DIRECTORY ``pod-<step>/`` under the checkpoint
# root, written cooperatively by every process of a
# ``parallel.mesh.MeshRuntime`` pod, in the JAX package's layout:
#
# - each process atomically writes ``shard-<pid>.zip`` holding its
#   pieces of every leaf (raw bytes under ``data/<tree>/<leaf>/<shard>``,
#   leaves in ``jax.tree_util`` order, plus a ``shards.json`` table with
#   global shape / dtype / index windows / SHA-256 / size per entry);
# - all processes barrier;
# - process 0 writes ``pod-manifest.json`` LAST (atomic rename), stamping
#   the mesh topology and the SHA-256 of every shard file;
# - all processes barrier again.
#
# The manifest-last ordering is the kill-safety invariant: a manifest
# implies every shard is durable, so a SIGKILL at any instant leaves
# either a valid pod checkpoint or an ignorable partial directory.
# Restore refuses a topology mismatch and re-verifies every hash.  A
# tensor leaf is written whole (a replicated value); a
# ``parallel.mesh.Sharded`` leaf (per-slot state) as its distinct pieces,
# so for the same values and topology the shard entries are byte for
# byte the JAX package's and a pod checkpoint crosses between them.
# ======================================================================

POD_PREFIX = "pod-"
POD_MANIFEST = "pod-manifest.json"
POD_SHARDS_JSON = "shards.json"


def pod_checkpoint_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"{POD_PREFIX}{int(step):010d}")


def _pod_step_of(name: str) -> Optional[int]:
    if not name.startswith(POD_PREFIX):
        return None
    try:
        return int(name[len(POD_PREFIX):])
    except ValueError:
        return None


def list_pod_checkpoints(directory: str) -> List[str]:
    """Pod checkpoint directories under ``directory`` that have a manifest
    (i.e. completed the two-phase write), newest first."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    out = [(st, os.path.join(directory, n)) for n in names
           if (st := _pod_step_of(n)) is not None
           and os.path.exists(os.path.join(directory, n, POD_MANIFEST))]
    return [p for _, p in sorted(out, reverse=True)]


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return str(np.dtype(dtype))


def _host_bytes(t) -> bytes:
    """Raw little-endian bytes of a tensor or array (bfloat16 as its
    16-bit pattern, which is what the JAX package writes)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


def _leaf_shards(leaf):
    """(global_shape, dtype name, [(windows, piece), ...]) of one leaf:
    a tensor or array whole, a ``Sharded`` leaf's distinct pieces."""
    from ..parallel.mesh import Sharded
    if isinstance(leaf, Sharded):
        return (leaf.global_shape, _dtype_name(leaf.dtype),
                leaf.distinct_pieces())
    shape = tuple(leaf.shape)
    return shape, _dtype_name(leaf.dtype), [
        (tuple((0, d) for d in shape), leaf)]


def pod_save(runtime, directory: str, step: int, trees: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> str:
    """Write one pod checkpoint of ``trees`` (a dict of named trees:
    params, updater state, ...) at ``step``.  Collective: EVERY process of
    the pod must call this with the same arguments.  Returns the pod
    directory."""
    import io
    from ..parallel.mesh import tree_leaves
    pdir = pod_checkpoint_dir(directory, step)
    os.makedirs(pdir, exist_ok=True)
    pid = runtime.process_index
    table: List[Dict[str, Any]] = []
    payload: List[Tuple[str, bytes]] = []
    for name in sorted(trees):
        for li, leaf in enumerate(tree_leaves(trees[name])):
            shape, dtype, shards = _leaf_shards(leaf)
            for si, (windows, piece) in enumerate(shards):
                entry = f"data/{name}/{li}/{si}"
                data = _host_bytes(piece)
                payload.append((entry, data))
                table.append({
                    "key": name, "leaf": li, "entry": entry,
                    "global_shape": list(shape), "dtype": dtype,
                    "windows": [list(w) for w in windows],
                    "sha256": _sha256(data), "size": len(data),
                })
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for entry, data in payload:
            zf.writestr(entry, data)
        zf.writestr(POD_SHARDS_JSON, json.dumps(
            {"process": pid, "shards": table}, indent=2))
    atomic_write_bytes(os.path.join(pdir, f"shard-{pid:05d}.zip"),
                       buf.getvalue())
    # every shard durable before the manifest stamps the set complete
    runtime.barrier(f"pod_save:{step}")
    if pid == 0:
        files = {}
        for i in range(runtime.process_count):
            fname = f"shard-{i:05d}.zip"
            with open(os.path.join(pdir, fname), "rb") as fh:
                data = fh.read()
            files[fname] = {"sha256": _sha256(data), "size": len(data)}
        manifest = {
            "framework": "deeplearning4j_tpu_torch",
            "kind": "pod_checkpoint",
            "step": int(step),
            "topology": runtime.topology(),
            "trees": sorted(trees),
            "extra": extra or {},
            "wall_time": time.time(),
            "files": files,
        }
        atomic_write_bytes(os.path.join(pdir, POD_MANIFEST),
                           json.dumps(manifest, indent=2).encode("utf-8"))
        _monitor.counter(WRITES_TOTAL, _HELP[WRITES_TOTAL]).inc()
        _monitor.gauge(BYTES_GAUGE, _HELP[BYTES_GAUGE]).set(
            sum(f["size"] for f in files.values()))
    # no process may go on (or prune) until the manifest is durable
    runtime.barrier(f"pod_manifest:{step}")
    return pdir


def verify_pod_checkpoint(pdir: str,
                          topology: Optional[Dict[str, int]] = None
                          ) -> Dict[str, Any]:
    """Verify a pod checkpoint directory: manifest present, every shard
    file present with matching SHA-256/size, and (when ``topology`` is
    given) an exact mesh-shape match.  Returns the manifest."""
    mpath = os.path.join(pdir, POD_MANIFEST)
    if not os.path.exists(mpath):
        raise CheckpointCorruptError(
            f"{pdir}: no {POD_MANIFEST} — incomplete pod checkpoint "
            "(a process died before the manifest was stamped)")
    try:
        with open(mpath, "rb") as fh:
            manifest = json.loads(fh.read())
    except ValueError as e:
        raise CheckpointCorruptError(
            f"{pdir}: unreadable {POD_MANIFEST}: {e}") from e
    if topology is not None and manifest.get("topology") != topology:
        raise CheckpointCorruptError(
            f"{pdir}: checkpoint topology {manifest.get('topology')} != "
            f"this pod's {topology}; refusing to misassemble — relaunch "
            "with the recorded mesh shape")
    for fname, ent in manifest.get("files", {}).items():
        fpath = os.path.join(pdir, fname)
        if not os.path.exists(fpath):
            raise CheckpointCorruptError(
                f"{pdir}: manifest lists {fname} but it is missing")
        with open(fpath, "rb") as fh:
            data = fh.read()
        if len(data) != int(ent["size"]) or _sha256(data) != ent["sha256"]:
            raise CheckpointCorruptError(
                f"{pdir}: {fname} fails size/SHA-256 verification — torn "
                "write or bit rot; refusing to load")
    return manifest


def _host_array(data: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.frombuffer(bytearray(data), dtype=torch.int16).view(
            torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(data, np.dtype(dtype)).copy()
                            ).reshape(shape)


def pod_restore(runtime, directory: str, templates: Dict[str, Any],
                step: Optional[int] = None
                ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """Restore the newest (or ``step``'s) pod checkpoint under
    ``directory`` into host trees shaped like ``templates`` (the names and
    tree structures given to :func:`pod_save`).  Every process reads all
    shard files and reassembles the whole global arrays as CPU tensors;
    the caller places them on its slots.  Returns ``(trees, manifest)``,
    or ``None`` when no completed pod checkpoint of this topology exists
    (a cold start)."""
    from ..parallel.mesh import tree_leaves, tree_unflatten
    if step is not None:
        candidates = [pod_checkpoint_dir(directory, step)]
        if not os.path.exists(os.path.join(candidates[0], POD_MANIFEST)):
            raise FileNotFoundError(
                f"no completed pod checkpoint at step {step} under "
                f"{directory}")
    else:
        candidates = list_pod_checkpoints(directory)
    for pdir in candidates:
        try:
            manifest = verify_pod_checkpoint(pdir, runtime.topology())
        except CheckpointCorruptError:
            _monitor.counter(CORRUPT_SKIPPED, _HELP[CORRUPT_SKIPPED]).inc()
            if step is not None:
                raise
            continue
        bufs: Dict[Tuple[str, int], torch.Tensor] = {}
        filled: Dict[Tuple[str, int], int] = {}
        for fname in sorted(manifest["files"]):
            with zipfile.ZipFile(os.path.join(pdir, fname), "r") as zf:
                table = json.loads(zf.read(POD_SHARDS_JSON))["shards"]
                for ent in table:
                    k = (ent["key"], int(ent["leaf"]))
                    windows = [tuple(w) for w in ent["windows"]]
                    data = zf.read(ent["entry"])
                    if _sha256(data) != ent["sha256"]:
                        raise CheckpointCorruptError(
                            f"{pdir}/{fname}: {ent['entry']} SHA-256 "
                            "mismatch")
                    piece = _host_array(data, ent["dtype"],
                                        [b - a for a, b in windows])
                    if k not in bufs:
                        bufs[k] = torch.empty(
                            tuple(ent["global_shape"]), dtype=piece.dtype)
                        filled[k] = 0
                    bufs[k][tuple(slice(a, b) for a, b in windows)] = piece
                    filled[k] += piece.numel()
        trees: Dict[str, Any] = {}
        for name in sorted(templates):
            count = len(tree_leaves(templates[name]))
            out = []
            for li in range(count):
                k = (name, li)
                if k not in bufs:
                    raise CheckpointCorruptError(
                        f"{pdir}: checkpoint has no data for "
                        f"{name}/leaf{li} — tree structure mismatch with "
                        "the saving run")
                if filled[k] < bufs[k].numel():
                    raise CheckpointCorruptError(
                        f"{pdir}: {name}/leaf{li} only "
                        f"{filled[k]}/{bufs[k].numel()} elements present "
                        "— a shard file is missing coverage")
                out.append(bufs[k])
            trees[name] = tree_unflatten(templates[name], out)
        _monitor.counter(RESTORES_TOTAL, _HELP[RESTORES_TOTAL]).inc()
        return trees, manifest
    return None


def prune_pod_checkpoints(runtime, directory: str,
                          keep_last: int = 2) -> int:
    """Delete all but the ``keep_last`` newest completed pod checkpoints
    (process 0 only; returns how many were removed)."""
    if runtime.process_index != 0:
        return 0
    import shutil
    pruned = 0
    for pdir in list_pod_checkpoints(directory)[max(1, keep_last):]:
        try:
            shutil.rmtree(pdir)
            pruned += 1
        except OSError:
            pass
    if pruned:
        _monitor.counter(PRUNED_TOTAL, _HELP[PRUNED_TOTAL]).inc(pruned)
    return pruned
