"""Streaming micro-batch pipeline (port of
``deeplearning4j_tpu/streaming/pipeline.py``).

Equivalent of the reference's
``streaming/pipeline/spark/SparkStreamingPipeline.java``: an unbounded
record source is consumed in micro-batches; each batch is converted to
arrays and either (a) scored through the network with predictions handed
to a callback (online inference) or (b) used for an online ``fit`` step
(online training), or both.

Micro-batching policy: a batch closes when ``batch_size`` records have
arrived OR ``flush_interval`` seconds pass with a non-empty partial
batch (Spark Streaming's batch-duration analogue).  A predict batch is
padded up to ``batch_size`` with copies of its last row, as in the JAX
package (where it keeps one compiled program), and a fit batch is filled
to ``batch_size`` by cycling its labelled rows.  The network's
``output`` returns a tensor on its device; the pipeline copies it to the
host before the callback sees it (one device read a micro-batch).
Offsets commit after a micro-batch is processed, so delivery is
at-least-once.

The pipeline's thread runs ``output`` and ``fit`` on the network; a
caller that uses the same network from another thread while the
pipeline runs shares its parameters with that thread, as in the JAX
package.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from .. import monitor as _monitor
from ..datasets.dataset import DataSet
from ..device import DeviceLike, resolve_device
from .conversion import RecordConverter
from .sources import RecordSource


class StreamingPipeline:
    """source -> converter -> micro-batch -> predict and/or fit loop.

    Parameters
    ----------
    net: a ``MultiLayerNetwork`` (or graph) — used for ``output`` and/or
        ``fit``.
    source / converter: see :mod:`.sources`, :mod:`.conversion`.
    mode: ``"predict"``, ``"fit"``, or ``"both"``.
    batch_size / flush_interval: micro-batch policy (see module doc).
    on_prediction: callback ``(features, outputs)`` per micro-batch, both
        host numpy arrays.
    device: the device the network must live on (default the card); a
        network elsewhere is refused.
    """

    def __init__(self, net, source: RecordSource,
                 converter: RecordConverter, mode: str = "predict",
                 batch_size: int = 32, flush_interval: float = 0.5,
                 on_prediction: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if net.device.type != self.device.type:
            raise ValueError(f"the network lives on {net.device} but the "
                             f"pipeline asked for {self.device}")
        if mode not in ("predict", "fit", "both"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode in ("fit", "both") and batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.net = net
        self.source = source
        self.converter = converter
        self.mode = mode
        self.batch_size = max(1, batch_size)
        self.flush_interval = flush_interval
        self.on_prediction = on_prediction
        self.records_processed = 0
        self.batches_processed = 0
        self.errors: List[Exception] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "StreamingPipeline":
        if self._thread is not None:
            raise RuntimeError("pipeline already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    "streaming worker did not stop within "
                    f"{timeout}s; still draining — retry stop()")
            self._thread = None

    def __enter__(self) -> "StreamingPipeline":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- the loop --------------------------------------------------------
    def _run(self) -> None:
        feats: List[np.ndarray] = []
        labels: List[Optional[np.ndarray]] = []
        last_flush = time.time()
        while not self._stop.is_set():
            record = self.source.poll(timeout=0.05)
            now = time.time()
            if record is not None:
                try:
                    f, l = self.converter.convert(record)
                    feats.append(f)
                    labels.append(l)
                    self.records_processed += 1
                    _monitor.counter("streaming_records_total",
                                     "records converted off the "
                                     "source").inc()
                except Exception as e:   # poison record: count, continue
                    self.errors.append(e)
                    _monitor.counter("streaming_errors_total",
                                     "streaming pipeline errors (poison "
                                     "records, callback and process "
                                     "failures)").inc(reason="convert")
            full = len(feats) >= self.batch_size
            stale = feats and (now - last_flush) >= self.flush_interval
            if full or stale:
                self._process(feats, labels)
                feats, labels = [], []
                last_flush = now
            elif not feats:
                last_flush = now
        if feats:                        # drain the tail on stop
            self._process(feats, labels)

    def _process(self, feats: List[np.ndarray],
                 labels: List[Optional[np.ndarray]]) -> None:
        with _monitor.span("streaming/batch", records=len(feats)):
            t0 = time.perf_counter()
            self._process_inner(feats, labels)
            _monitor.registry().histogram(
                "streaming_batch_ms",
                "end-to-end processing of one streaming micro-batch "
                "(ms)").observe((time.perf_counter() - t0) * 1e3)

    def _process_inner(self, feats: List[np.ndarray],
                       labels: List[Optional[np.ndarray]]) -> None:
        n = len(feats)
        x = np.stack(feats)
        # pad to the static micro-batch size: one compiled program
        if n < self.batch_size:
            pad = np.repeat(x[-1:], self.batch_size - n, axis=0)
            x_padded = np.concatenate([x, pad])
        else:
            x_padded = x
        try:
            if self.mode in ("predict", "both"):
                out = self.net.output(x_padded).detach().cpu().numpy()[:n]
                if self.on_prediction is not None:
                    try:
                        # a broken user callback must not cancel training
                        self.on_prediction(x, out)
                    except Exception as e:
                        self.errors.append(e)
                        _monitor.counter(
                            "streaming_errors_total",
                            "streaming pipeline errors (poison records, "
                            "callback and process failures)").inc(
                                reason="callback")
            if self.mode in ("fit", "both"):
                have = [i for i, l in enumerate(labels) if l is not None]
                if have:
                    xf = np.stack([feats[i] for i in have])
                    yf = np.stack([labels[i] for i in have])
                    if len(have) < self.batch_size:
                        # ndim-safe upsample: cycle row indices (features
                        # may be >1-D for image-shaped converters)
                        idx = np.arange(self.batch_size) % len(have)
                        xf, yf = xf[idx], yf[idx]
                    self.net.fit(DataSet(xf, yf))
            self.batches_processed += 1
            _monitor.counter("streaming_batches_total",
                             "streaming micro-batches processed").inc()
            # offset-tracking sources (BrokerRecordSource) commit the
            # processed prefix here: commit-after-process gives the
            # at-least-once resume contract of the reference's
            # Kafka -> Spark Streaming pipeline
            if hasattr(self.source, "on_batch_processed"):
                self.source.on_batch_processed()
        except Exception as e:
            self.errors.append(e)
            _monitor.counter("streaming_errors_total",
                             "streaming pipeline errors (poison records, "
                             "callback and process failures)").inc(
                                 reason="process")
