"""Training listeners (port of
``deeplearning4j_tpu/optimize/listeners/listeners.py``).

Equivalents of the reference's ``IterationListener``/``TrainingListener``
contract and of ``ScoreIterationListener``, ``PerformanceListener``
(samples/s and batches/s), ``CollectScoresIterationListener`` and
``ParamAndGradientIterationListener``, plus ``ProfilerListener`` (a
``torch.profiler`` capture) and ``CheckpointListener`` (model zips through
the port's serializer).

Listeners run on the host after each update.  A listener that reads
``model.score()`` waits for the step to finish on the device: one host
sync per firing, as in the JAX package.  ``ProfilerListener`` records
its capture window as a ``profiler/capture`` trace span.
"""

from __future__ import annotations

import io
import logging
import os
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    """Reference ``IterationListener`` contract."""

    def iteration_done(self, model, iteration: int) -> None:
        raise NotImplementedError


class TrainingListener(IterationListener):
    """Adds the epoch hooks (reference ``TrainingListener``)."""

    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass

    def iteration_done(self, model, iteration: int) -> None:
        pass


class ScoreIterationListener(IterationListener):
    """Log the score every N iterations (reference
    ``ScoreIterationListener``)."""

    def __init__(self, print_iterations: int = 10, out=None):
        self.print_iterations = max(1, print_iterations)
        self._out = out

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.print_iterations == 0:
            msg = f"Score at iteration {iteration} is {model.score():.6f}"
            if self._out is not None:
                print(msg, file=self._out)
            else:
                logger.info(msg)


class PerformanceListener(IterationListener):
    """Throughput sampling (reference ``PerformanceListener``): samples/s
    and batches/s between firings, by the host clock."""

    def __init__(self, frequency: int = 1, report_score: bool = False,
                 out=None):
        self.frequency = max(1, frequency)
        self.report_score = report_score
        self._out = out
        self._last_time: Optional[float] = None
        self._last_iter: Optional[int] = None
        # (iteration, samples/s, batches/s)
        self.history: List[Tuple[int, float, float]] = []

    def iteration_done(self, model, iteration: int) -> None:
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            if dt > 0 and iters > 0:
                batch_size = getattr(model, "last_batch_size", None)
                batches_per_sec = iters / dt
                samples_per_sec = (batches_per_sec * batch_size
                                   if batch_size else float("nan"))
                self.history.append((iteration, samples_per_sec,
                                     batches_per_sec))
                msg = (f"iteration {iteration}: {samples_per_sec:.1f} "
                       f"samples/sec, {batches_per_sec:.2f} batches/sec")
                if self.report_score:
                    msg += f", score {model.score():.6f}"
                if self._out is not None:
                    print(msg, file=self._out)
                else:
                    logger.info(msg)
        if iteration % self.frequency == 0:
            self._last_time = now
            self._last_iter = iteration

    def average_samples_per_sec(self, skip: int = 1) -> float:
        """Mean throughput, skipping the first ``skip`` samples (warm-up)."""
        vals = [s for _, s, _ in self.history[skip:]]
        return float(np.mean(vals)) if vals else float("nan")


class CollectScoresIterationListener(IterationListener):
    """Collect (iteration, score) pairs (reference
    ``CollectScoresIterationListener``)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score()))


class ParamAndGradientIterationListener(IterationListener):
    """Per-parameter statistics every N iterations (reference
    ``ParamAndGradientIterationListener``: mean, min/max, mean absolute
    value, tab-delimited to the log and/or a file).

    The gradients live only inside the step, so the reference's gradient
    columns are ``update_win`` statistics: the parameter delta since this
    listener last ran (what the updater applied over the window).  With
    the health layer enabled (``monitor.health``) two exact per-step
    columns follow, from the model's last recorded dispatch:
    ``grad_l2_step`` and ``update_ratio_step`` of the param's layer
    (blank when the layer is not in the snapshot)."""

    def __init__(self, iterations: int = 1, print_header: bool = True,
                 print_mean: bool = True, print_min_max: bool = True,
                 print_mean_abs_value: bool = True,
                 output_to_console: bool = True,
                 file_path: Optional[str] = None, delimiter: str = "\t"):
        self.iterations = max(1, iterations)
        self.print_header = print_header
        self.print_mean = print_mean
        self.print_min_max = print_min_max
        self.print_mean_abs = print_mean_abs_value
        self.output_to_console = output_to_console
        self.file_path = file_path
        self.delimiter = delimiter
        self._last_params = None
        self._header_written = False
        if file_path:
            # truncated once; the rows are appended as they come
            open(file_path, "w").close()

    @staticmethod
    def _device_stats(snap, name):
        """(grad_l2, update_ratio) of ``name``'s layer in a health
        snapshot, as text."""
        stats = snap["layers"].get(name.rsplit("_", 1)[0])
        if stats is None:
            return ("", "")
        return (f"{stats['grad_l2']:.6g}", f"{stats['update_ratio']:.6g}")

    def _stats(self, name, arr, prev):
        cols = [name]
        upd = arr - prev if prev is not None else np.zeros_like(arr)
        for a in (arr, upd):
            if self.print_mean:
                cols.append(f"{float(np.mean(a)):.6g}")
            if self.print_min_max:
                cols += [f"{float(np.min(a)):.6g}",
                         f"{float(np.max(a)):.6g}"]
            if self.print_mean_abs:
                cols.append(f"{float(np.mean(np.abs(a))):.6g}")
        return cols

    def _header(self, with_device: bool = False):
        cols = ["param"]
        for kind in ("param", "update_win"):
            if self.print_mean:
                cols.append(f"{kind}_mean")
            if self.print_min_max:
                cols += [f"{kind}_min", f"{kind}_max"]
            if self.print_mean_abs:
                cols.append(f"{kind}_mean_abs")
        if with_device:
            cols += ["grad_l2_step", "update_ratio_step"]
        return cols

    def _emit(self, line: str) -> None:
        if self.output_to_console:
            logger.info(line)
        if self.file_path:
            with open(self.file_path, "a", encoding="utf-8") as f:
                f.write(line + "\n")

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.iterations != 0:
            return
        from ...monitor import health as _health
        tables = (model.param_table() if hasattr(model, "param_table")
                  else {})
        snap = _health.last_for(model) if _health.enabled() else None
        if self.print_header and not self._header_written:
            self._emit(self.delimiter.join(
                ["iteration"] + self._header(snap is not None)))
            self._header_written = True
        prev = self._last_params or {}
        for name, arr in tables.items():
            cols = self._stats(name, arr, prev.get(name))
            if snap is not None:
                cols += list(self._device_stats(snap, name))
            self._emit(self.delimiter.join([str(iteration)] + cols))
        self._last_params = tables


def finalize_listeners(listeners) -> None:
    """Run every listener's end-of-training hooks (``stop()`` then
    ``flush()`` where present).  ``fit()`` calls this in a ``finally``
    block, so an open profiler capture is closed and async checkpoint
    writes are joined even when training raises.  A hook's exception is
    logged, not raised: it must not mask the error of ``fit``."""
    for listener in listeners or ():
        for hook in ("stop", "flush"):
            fn = getattr(listener, hook, None)
            if callable(fn):
                try:
                    fn()
                except Exception:  # pragma: no cover - defensive
                    logger.warning(
                        "listener %s.%s() failed during finalization",
                        type(listener).__name__, hook, exc_info=True)


class ProfilerListener(TrainingListener):
    """``torch.profiler`` capture of iterations ``[start_iteration,
    end_iteration)``, written as a Chrome trace to
    ``log_dir/trace_<start>_<end>.json``, plus the host time of every
    iteration.  The JAX package's twin captures with ``jax.profiler``."""

    def __init__(self, log_dir: str, start_iteration: int = 2,
                 end_iteration: int = 5):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.end_iteration = end_iteration
        self._prof = None
        self._started_at: Optional[int] = None
        self._capture_t0: Optional[float] = None
        self._capture_ctx = None
        self._last_t: Optional[float] = None
        self.iteration_times_ms: List[float] = []
        self.trace_path: Optional[str] = None

    def iteration_done(self, model, iteration: int) -> None:
        now = time.perf_counter()
        if self._last_t is not None:
            self.iteration_times_ms.append((now - self._last_t) * 1e3)
        self._last_t = now
        if (self._prof is None and self.trace_path is None
                and self.start_iteration <= iteration < self.end_iteration):
            import torch
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            self._started_at = iteration
            from ... import monitor as _monitor
            self._capture_t0 = time.time()
            self._capture_ctx = _monitor.current_context()
        elif self._prof is not None and iteration >= self.end_iteration:
            self._stop_trace(iteration)

    def _stop_trace(self, iteration: Optional[int] = None) -> None:
        """Close the capture once and write its trace; a failure while
        closing is logged (on the error path it must not mask the error
        of ``fit``).  The capture window is also recorded once as a
        ``profiler/capture`` span (attr ``log_dir``), parented on the
        context current when the capture started."""
        prof, self._prof = self._prof, None
        if prof is None:
            return
        try:
            prof.__exit__(None, None, None)
            os.makedirs(self.log_dir, exist_ok=True)
            end = self.end_iteration if iteration is None else iteration
            path = os.path.join(self.log_dir,
                                f"trace_{self._started_at}_{end}.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
        except (RuntimeError, OSError):
            logger.warning("profiler capture failed to close",
                           exc_info=True)
        if self._capture_t0 is not None:
            from ... import monitor as _monitor
            ctx = self._capture_ctx
            _monitor.tracer().record_span(
                "profiler/capture",
                trace_id=(ctx.trace_id if ctx is not None
                          else _monitor.new_trace_id()),
                parent_id=ctx.span_id if ctx is not None else None,
                ts=self._capture_t0,
                dur_ms=(time.time() - self._capture_t0) * 1e3,
                log_dir=self.log_dir)
            self._capture_t0 = None
            self._capture_ctx = None

    def stop(self) -> None:
        """Close a capture still open (training ended before
        ``end_iteration``).  Not tied to epoch ends: a capture over an
        epoch boundary stays one trace.  Idempotent."""
        self._stop_trace()

    def phase_report(self) -> dict:
        """Host time per iteration: mean, p50, p95 in ms."""
        if not self.iteration_times_ms:
            return {"iterations": 0}
        arr = np.asarray(self.iteration_times_ms)
        return {"iterations": int(arr.size),
                "mean_ms": float(arr.mean()),
                "p50_ms": float(np.percentile(arr, 50)),
                "p95_ms": float(np.percentile(arr, 95))}


class CheckpointListener(TrainingListener):
    """Periodic training checkpoints with retention and async writes.

    Every ``save_every_n_iterations`` iterations (or every
    ``save_every_epochs`` epoch ends) the full training state (the
    ModelSerializer zip: configuration, params, updater state, layer
    state) goes to ``checkpoint_<iteration>.zip`` in ``checkpoint_dir``,
    written atomically (temp file, then rename); ``keep_last`` bounds the
    files kept.  With ``async_write`` the zip is built on the calling
    thread (a snapshot of the state) and written by a background thread;
    ``flush()`` joins the writes and raises if one failed."""

    def __init__(self, checkpoint_dir: str,
                 save_every_n_iterations: int = 0,
                 save_every_epochs: int = 0, keep_last: int = 3,
                 async_write: bool = True):
        if save_every_n_iterations <= 0 and save_every_epochs <= 0:
            raise ValueError("set save_every_n_iterations and/or "
                             "save_every_epochs")
        self.dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.every_iter = int(save_every_n_iterations)
        self.every_epochs = int(save_every_epochs)
        self.keep_last = max(1, int(keep_last))
        self.async_write = async_write
        self._epoch = 0
        self._last_saved_iter = None
        self._pending: dict = {}       # path -> writer thread
        self._write_errors: list = []  # (path, exception)
        self.saved: list = []          # checkpoint paths, oldest first

    def iteration_done(self, model, iteration: int) -> None:
        if self.every_iter > 0 and iteration % self.every_iter == 0:
            self._save(model, iteration)

    def on_epoch_end(self, model) -> None:
        self._epoch += 1
        if self.every_epochs > 0 and self._epoch % self.every_epochs == 0:
            self._save(model, model.iteration)

    def _save(self, model, iteration: int) -> None:
        from ...utils.fileio import atomic_write_bytes
        from ...utils.model_serializer import write_model

        if iteration == self._last_saved_iter:
            return      # the iteration and epoch triggers fired together
        self._last_saved_iter = iteration
        buf = io.BytesIO()
        write_model(model, buf)
        data = buf.getvalue()
        path = os.path.join(self.dir, f"checkpoint_{iteration}.zip")

        def write():
            try:
                atomic_write_bytes(path, data)
            except BaseException as e:  # raised by flush()
                self._write_errors.append((path, e))

        if self.async_write:
            prior = self._pending.get(path)
            if prior is not None:
                prior.join()     # the same path again: the last one wins
            t = threading.Thread(target=write, daemon=True)
            t.start()
            self._pending[path] = t
        else:
            write()
            self._raise_write_errors()
        if path in self.saved:
            self.saved.remove(path)
        self.saved.append(path)
        while len(self.saved) > self.keep_last:
            old = self.saved.pop(0)
            t = self._pending.pop(old, None)
            if t is not None:
                t.join()
            try:
                os.remove(old)
            except OSError:
                pass

    def _raise_write_errors(self) -> None:
        if self._write_errors:
            path, err = self._write_errors[0]
            self._write_errors = []
            raise RuntimeError(
                f"checkpoint write failed for {path}") from err

    def flush(self) -> None:
        """Join the outstanding writes; raises if any failed."""
        for t in self._pending.values():
            t.join()
        self._pending = {}
        self._raise_write_errors()

    def last_checkpoint(self) -> "str | None":
        self.flush()
        return self.saved[-1] if self.saved else None
