"""Parameter-averaging cluster training (port of
``deeplearning4j_tpu/scaleout/param_avg.py``; reference
``dl4j-spark/.../impl/paramavg/ParameterAveragingTrainingMaster.java``,
split sizing ``:329``: ``numWorkers × batchSizePerWorker ×
averagingFrequency``, ``executeTraining:344`` → ``doIteration:374``, and
``ParameterAveragingTrainingWorker.java``, ``getInitialModel:89``,
``processMinibatch:162-220``), with results folded like
``aggregator/ParameterAveragingElementAddFunction.java:19`` (sum of params
+ updater state, weighted average on the master).

Execution model: per split, the master broadcasts (conf, params, updater
state), each worker configures its replica, fits its partition of
``averaging_frequency`` minibatches, and returns flat params + updater
state; the master averages and rebroadcasts for the next split.  Workers
run on a thread pool in-process — the Spark ``local[N]`` pattern
(reference ``BaseSparkTest.java:45``); on several hosts the same master
runs per host over its path shard and the average crosses hosts through
:mod:`.dcn`.

On the card: every replica lives on the master network's device, so the
pool threads share one card and its default stream.  Each replica steps
through the network's eager per-batch path (``fit`` of one batch, which
runs ``_fit_batch``; no CUDA graph is captured), and a replica's work
depends only on its own trees, so its result does not depend on how the
threads interleave.  The fold runs on the host, exactly as the JAX
package's: float64 numpy, weighted by ``batches_processed``, in worker
order, cast to the params' dtype; so for the same worker results the
master's params are the JAX package's bit for bit.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike
from .api import (NetBroadcastTuple, TrainingMaster, TrainingWorker,
                  WorkerResult)
from .data import batch_and_export, load_dataset

logger = logging.getLogger("deeplearning4j_tpu_torch")


class ParameterAveragingTrainingWorker(TrainingWorker):
    """Fit one partition from a broadcast replica (reference
    ``ParameterAveragingTrainingWorker.java``).

    The replica network is built once and kept across splits — later
    broadcasts only push new params/updater state into it (the analogue
    of the reference keeping executor JVMs warm)."""

    def __init__(self):
        self._broadcast: Optional[NetBroadcastTuple] = None
        self._net = None

    def configure(self, broadcast: NetBroadcastTuple,
                  device: DeviceLike = None) -> None:
        """Load ``broadcast`` into the replica, built on ``device`` (None:
        the card) the first time or when the container changes."""
        self._broadcast = broadcast
        if (self._net is not None
                and type(self._net).__name__ == broadcast.model_class
                and (device is None
                     or self._net.device == torch.device(device))):
            self._net.set_flat_params(broadcast.params)
            if broadcast.updater_state is not None \
                    and broadcast.updater_state.size:
                self._net.set_flat_updater_state(broadcast.updater_state)
            self._net.iteration = broadcast.iteration
        else:
            self._net = broadcast.build_model(device)

    def process_partition(self, partition: Iterable) -> WorkerResult:
        if self._net is None:
            raise ValueError("Worker not configured with a broadcast tuple")
        net = self._net
        count = 0
        for item in partition:
            ds = load_dataset(item) if isinstance(item, str) else item
            net.fit(ds)
            count += 1
        return WorkerResult(
            params=net.get_flat_params(),
            updater_state=net.get_flat_updater_state(),
            batches_processed=count,
            score=float(net.score()),
        )


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Split sizing + worker orchestration + weighted averaging.

    Builder-parity kwargs (reference ``ParameterAveragingTrainingMaster
    .Builder``): ``num_workers``, ``batch_size_per_worker``,
    ``averaging_frequency``, ``average_updaters``, ``export_dir``
    (rdd-Export analogue: re-batch + spill to files before training;
    ``None`` = Direct approach, train straight off the in-memory list).
    The replicas live on the trained network's device.
    """

    def __init__(self, num_workers: int, batch_size_per_worker: int = 32,
                 averaging_frequency: int = 5, average_updaters: bool = True,
                 export_dir: Optional[str] = None,
                 worker_factory: Callable[[], TrainingWorker] =
                 ParameterAveragingTrainingWorker):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.num_workers = num_workers
        self.batch_size_per_worker = batch_size_per_worker
        self.averaging_frequency = max(1, averaging_frequency)
        self.average_updaters = average_updaters
        self.export_dir = export_dir
        self.worker_factory = worker_factory
        self.stats: List[dict] = []     # per-split telemetry (CommonSpark-
        #                                 TrainingStats role)
        self._workers: List[TrainingWorker] = []

    # ---- split sizing (reference :329-334) -------------------------------
    @property
    def split_size(self) -> int:
        """Minibatches per split = workers × averagingFrequency (each worker
        consumes avgFreq batches of batchSizePerWorker between averages)."""
        return self.num_workers * self.averaging_frequency

    # ---- entry points ----------------------------------------------------
    def execute_training(self, net, data_source) -> None:
        """``data_source``: iterable of :class:`DataSet` minibatches (the
        RDD analogue).  Export approach re-batches to files first."""
        if self.export_dir is not None:
            paths = batch_and_export(data_source, self.export_dir,
                                     self.batch_size_per_worker)
            self.execute_training_paths(net, paths)
            return
        items = list(data_source)
        self._run_splits(net, items)

    def execute_training_paths(self, net, paths: Sequence[str]) -> None:
        """Train from exported minibatch files (reference ``fitPaths:260``)."""
        self._run_splits(net, list(paths))

    # ---- the split loop (reference executeTrainingDirect/doIteration) ----
    def _run_splits(self, net, items: List) -> None:
        net.init()
        for start in range(0, len(items), self.split_size):
            split = items[start:start + self.split_size]
            t0 = time.perf_counter()
            fold_s = self._do_iteration(net, split)
            self.stats.append({
                "split_start": start,
                "minibatches": len(split),
                "wall_time_sec": time.perf_counter() - t0,
                "fold_time_sec": fold_s,
            })

    def _do_iteration(self, net, split: List) -> float:
        """One split: broadcast, the workers' partitions, the fold.
        Returns the fold's seconds (the host average and the writes back
        into ``net``)."""
        broadcast = NetBroadcastTuple.from_model(net)
        # partition the split round-robin across workers (reference
        # repartitioning to numWorkers partitions)
        partitions: List[List] = [split[i::self.num_workers]
                                  for i in range(self.num_workers)]
        partitions = [p for p in partitions if p]
        # persistent worker pool: replicas survive across splits
        while len(self._workers) < len(partitions):
            self._workers.append(self.worker_factory())

        def run_worker(worker, partition):
            worker.configure(broadcast, net.device)
            return worker.process_partition(partition)

        if len(partitions) == 1:
            results = [run_worker(self._workers[0], partitions[0])]
        else:
            with ThreadPoolExecutor(max_workers=len(partitions)) as pool:
                results = list(pool.map(run_worker, self._workers,
                                        partitions))
        t0 = time.perf_counter()
        fold_results(net, results, self.average_updaters)
        return time.perf_counter() - t0


def fold_results(net, results: List[WorkerResult],
                 average_updaters: bool = True) -> None:
    """The master's fold (``ParameterAveragingElementAddFunction``: the
    sums, then the master divides): params and, with
    ``average_updaters``, updater state averaged on the host in float64,
    weighted by batches processed, in worker order, cast back to the
    workers' dtype; the iteration advances by the deepest worker's steps
    and the score is the weighted mean of the workers' scores."""
    weights = np.array([r.batches_processed for r in results],
                       dtype=np.float64)
    total = weights.sum()
    if total == 0:
        return
    params = np.zeros_like(results[0].params, dtype=np.float64)
    for r, w in zip(results, weights):
        params += w * r.params.astype(np.float64)
    net.set_flat_params((params / total).astype(results[0].params.dtype))
    if average_updaters and results[0].updater_state is not None \
            and results[0].updater_state.size:
        ustate = np.zeros_like(results[0].updater_state, dtype=np.float64)
        for r, w in zip(results, weights):
            ustate += w * r.updater_state.astype(np.float64)
        net.set_flat_updater_state((ustate / total).astype(
            results[0].updater_state.dtype))
    # advance by the steps the averaged state actually went through (the
    # deepest worker), not the nominal averaging frequency — keeps
    # iteration-keyed lr schedules honest on ragged final splits
    net.iteration += int(weights.max())
    net._score = float(np.average([r.score for r in results],
                                  weights=weights))
