"""ParallelWrapper: data-parallel training with local-SGD parameter
averaging (port of ``deeplearning4j_tpu/parallel/parallel_wrapper.py``;
reference ``ParallelWrapper.java``: round-robin dispatch of minibatches
to worker replicas, ``averagingFrequency`` local steps each, then
``Nd4j.averageAndPropagate`` of the params and, optionally, of the
updater state).

The replicas are the slots of the data x zero extent of a
:class:`~deeplearning4j_tpu_torch.parallel.mesh.MeshRuntime`.  A round:

- each worker runs ``averaging_frequency`` local steps on its own batches
  (round-robin: worker ``i`` takes batches ``[i, w + i, 2w + i, ...]``)
  through the network's pure step ``_Network._train_step``, its trees on
  its slot's device; a tBPTT network runs its own ``_tbptt_window_loss``
  window by window, the recurrent carries detached between windows;
- then the means over workers (:meth:`MeshRuntime.mean_trees`, one
  reduction per dtype): of the params; of the updater state when
  ``average_updaters`` (otherwise each worker keeps its own across
  rounds); of the layer state; of each worker's mean score; and of the
  health stack, so one worker's NaN poisons the averaged vector.

In one process the workers step one after another (one card named four
times runs four replicas); in a pod every process passes the same global
round and steps its own slots.  ``averaging_frequency=1`` is lockstep
all-reduce SGD; > 1 is local SGD (params averaged, not gradients: for
Adam this differs from gradient averaging, as in the reference).

Staging: a round's batches are stacked per worker on the host (pinned
for a card), the u8 wire twin where every batch carries one (decoded on
the device by ``ingest.device_decode``), and copied to the slot's
device; with ``prefetch_buffer(n) > 0`` a thread stages round k+1 while
round k runs, ``prefetch_buffer(0)`` is the synchronous path.

Deliberate difference: a worker's dropout draws come from a
``torch.Generator`` seeded by (the network's seed, the iteration, the
worker index), ``mesh.worker_generator``, where the JAX package folds the
same three into threefry; the streams differ, so parity tests use nets
without dropout.  A tBPTT worker's health vector is its last window's
(the JAX package computes one over the whole batch).
"""

from __future__ import annotations

import collections
import contextlib
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional

import torch

from .. import monitor as _monitor
from ..datasets.dataset import DataSet, MultiDataSet
from ..monitor import health as _health
from ..nn.multilayer import _mask_presence
from .mesh import MeshRuntime, default_devices, tree_to, worker_generator

_DP = ("data", "zero")


def _trimmed(ds, rows: int):
    """``ds`` cut to its first ``rows`` examples (a round trains equal
    batch sizes); ``ds`` itself when it has no more."""
    if ds.num_examples() <= rows:
        return ds
    if isinstance(ds, MultiDataSet):
        def cut(seq):
            return None if seq is None else [
                None if a is None else a[:rows] for a in seq]
        return MultiDataSet(cut(ds.features), cut(ds.labels),
                            cut(ds.features_masks), cut(ds.labels_masks))
    def one(a):
        return None if a is None else a[:rows]
    return DataSet(one(ds.features), one(ds.labels),
                   one(ds.features_mask), one(ds.labels_mask))


def check_uniform_masks(items, what: str) -> None:
    """A round trains every batch with its own masks, so it must be
    uniform: masks on all batches or on none."""
    for which in ("features_masks", "labels_masks"):
        if len({_mask_presence(it, which) for it in items}) > 1:
            raise ValueError(
                f"Mixed mask presence across batches within one {what}; "
                "provide masks on all batches or none")


class ParallelWrapper:
    """Builder and fit API of the reference (``ParallelWrapper.Builder``:
    workers, averaging frequency, average updaters, report score,
    prefetch).  ``devices`` lists one device a worker (default: every
    visible card; ``["cuda:0"] * 4`` runs four workers on one card);
    ``runtime`` hands over a pod's mesh instead."""

    def __init__(self, model, workers: Optional[int] = None,
                 averaging_frequency: int = 1, average_updaters: bool = True,
                 report_score: bool = False, prefetch_size: int = 2,
                 devices: Optional[list] = None,
                 runtime: Optional[MeshRuntime] = None):
        from ..nn.computation_graph import ComputationGraph
        self.model = model
        self._is_graph = isinstance(model, ComputationGraph)
        if runtime is None:
            devices = list(devices) if devices is not None \
                else default_devices()
            self.workers = workers or len(devices)
            if self.workers > len(devices):
                raise ValueError(
                    f"{self.workers} workers > {len(devices)} devices")
            runtime = MeshRuntime.local(data=self.workers, devices=devices)
        else:
            if runtime.pipe_degree != 1:
                raise ValueError(
                    "ParallelWrapper runs on the data x zero extent; got "
                    f"a runtime with pipe={runtime.pipe_degree} (compose "
                    "pipeline via PipelineParallel)")
            self.workers = runtime.dp_degree
        self.runtime = runtime
        self.devices = list(runtime.devices)
        if any(d.type != model.device.type for d in self.devices):
            raise ValueError(
                f"the network lives on {model.device}; its workers' "
                f"devices {[str(d) for d in self.devices]} must be of that "
                "type")
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.average_updaters = average_updaters
        self.report_score = report_score
        self.prefetch_size = prefetch_size
        self.listeners: List[Any] = []
        #: per local worker updater state, kept across rounds
        self._worker_ustate: Optional[List[Any]] = None
        #: stragglers left unfitted (reference parity)
        self.skipped_tail_batches = 0
        self.last_score: Optional[float] = None

    # -- builder-style API (reference ParallelWrapper.Builder) -------------
    class Builder:
        def __init__(self, model):
            self._model = model
            self._kw = {}

        def workers(self, n: int) -> "ParallelWrapper.Builder":
            self._kw["workers"] = int(n)
            return self

        def averaging_frequency(self, k: int) -> "ParallelWrapper.Builder":
            self._kw["averaging_frequency"] = int(k)
            return self

        def average_updaters(self, flag: bool) -> "ParallelWrapper.Builder":
            self._kw["average_updaters"] = flag
            return self

        def report_score_after_averaging(self, flag: bool
                                         ) -> "ParallelWrapper.Builder":
            self._kw["report_score"] = flag
            return self

        def prefetch_buffer(self, n: int) -> "ParallelWrapper.Builder":
            self._kw["prefetch_size"] = int(n)
            return self

        def devices(self, devices) -> "ParallelWrapper.Builder":
            self._kw["devices"] = list(devices)
            return self

        def build(self) -> "ParallelWrapper":
            return ParallelWrapper(self._model, **self._kw)

    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    # ------------------------------------------------------------------ fit
    def fit(self, iterator, epochs: int = 1) -> "ParallelWrapper":
        """Reference ``fit(DataSetIterator)``: round-robin dispatch of
        minibatches to workers, averaging every ``averaging_frequency``
        per-worker iterations.  An incomplete last round is left unfitted,
        as in the reference; ``skipped_tail_batches`` counts it."""
        net = self.model
        net.init()
        k, w = self.averaging_frequency, self.workers
        rounds_run = 0
        self.skipped_tail_batches = 0
        prefetch = max(0, int(self.prefetch_size or 0))
        executor = (ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix="pw-prefetch")
                    if prefetch else None)
        staged: "collections.deque" = collections.deque()
        try:
            for _ in range(epochs):
                if hasattr(iterator, "reset"):
                    iterator.reset()
                pending: List[Any] = []
                for ds in iterator:
                    pending.append(ds)
                    if len(pending) < k * w:
                        continue
                    if executor is not None:
                        staged.append(executor.submit(self._stage_round,
                                                      pending))
                        _monitor.gauge(
                            "parallel_prefetch_depth",
                            "rounds staged ahead of dispatch").set(
                            len(staged))
                        if len(staged) > prefetch:
                            self._dispatch_staged(staged.popleft())
                            rounds_run += 1
                    else:
                        self._run_round(pending)
                        rounds_run += 1
                    pending = []
                self.skipped_tail_batches += len(pending)
            while staged:
                self._dispatch_staged(staged.popleft())
                rounds_run += 1
        finally:
            while staged:
                staged.popleft().cancel()
            if executor is not None:
                executor.shutdown(wait=True)
        if self.skipped_tail_batches:
            _monitor.counter(
                "parallel_skipped_tail_batches_total",
                "straggler batches dropped by incomplete averaging "
                "rounds").inc(self.skipped_tail_batches)
        if rounds_run == 0:
            warnings.warn(
                f"ParallelWrapper.fit trained NOTHING: the iterator yielded "
                f"fewer than workers*averaging_frequency = {w * k} batches "
                f"per epoch ({self.skipped_tail_batches} straggler batches "
                f"dropped across {epochs} epoch(s)). Use a bigger dataset, "
                f"fewer workers, or a smaller averaging_frequency.",
                stacklevel=2)
        return self

    def _run_round(self, batches) -> None:
        with _monitor.span("parallel/round", workers=self.workers,
                           steps=self.averaging_frequency):
            self._dispatch_round(self._stage_round(batches))

    def _dispatch_staged(self, future) -> None:
        with _monitor.span("parallel/round", workers=self.workers,
                           steps=self.averaging_frequency, prefetched=True):
            self._dispatch_round(future.result())

    # -------------------------------------------------------------- staging
    def _stage_round(self, batches) -> list:
        """Host side of a round: for each of this process's workers, its
        ``averaging_frequency`` batches stacked into (k, b, ...) per input
        and copied to its slot's device.  Returns per local worker
        ``(features, labels, features masks, labels masks, wires)``."""
        net = self.model
        k, w = self.averaging_frequency, self.workers
        t0 = time.perf_counter()
        rows = min(ds.num_examples() for ds in batches)
        items = [net._window_item(_trimmed(ds, rows)) for ds in batches]
        check_uniform_masks(items, "averaging round")
        out, nbytes = [], 0
        for slot, dev in zip(self.runtime.local_slots, self.devices):
            mine = [items[j * w + slot] for j in range(k)]
            pin = dev.type == "cuda"
            fs, ls, fms, lms, wires = net._host_window(mine, pin)

            def put(seq):
                return None if seq is None else [
                    None if a is None else a.to(dev, non_blocking=pin)
                    for a in seq]

            nbytes += sum(a.numel() * a.element_size() for a in fs + ls)
            out.append((put(fs), put(ls), put(fms), put(lms), wires))
        _monitor.gauge(
            "ingest_staged_bytes",
            "bytes uploaded to the device per staging event").set(
            nbytes, path="parallel")
        _monitor.observe_phase("data", time.perf_counter() - t0)
        return out

    # ---------------------------------------------------------- the workers
    def _worker_steps(self, slot: int, dev: torch.device, staged, params,
                      ustate, nstate, iteration: int):
        """One worker's local steps of a round: returns (params, updater
        state, layer state, mean score, health stack or None)."""
        net = self.model
        seed = int(net.conf.conf.seed)
        tbptt = (not self._is_graph and net.conf.backprop_type == "tbptt")
        it = iteration
        scores, hvecs = [], []
        for j in range(self.averaging_frequency):
            batch = net._row_batch(*staged, j)
            if tbptt:
                params, ustate, nstate, score, hvec, it = self._tbptt_steps(
                    slot, dev, batch, params, ustate, nstate, it)
            else:
                gen = worker_generator(seed, it, slot, dev)
                params, ustate, nstate, score, hvec, _ = net._train_step(
                    params, ustate, nstate,
                    lambda p, s, b=batch, g=gen: net._loss_fn(
                        p, s, *b, g, True),
                    it, health=True)
                it += 1
            scores.append(score)
            hvecs.append(hvec)
        hstack = (torch.stack(hvecs) if hvecs[0] is not None else None)
        return params, ustate, nstate, torch.stack(scores).mean(), hstack

    def _tbptt_steps(self, slot, dev, batch, params, ustate, nstate,
                     it: int):
        """The network's truncated-BPTT windows on one batch, one update
        each, through its own ``_tbptt_window_loss``; the carries start
        from zero and are detached at each window boundary."""
        net = self.model
        f, l, fm, lm = batch
        net._require_carry_support("truncated BPTT")
        window = net.conf.tbptt_fwd_length
        back = net.conf.tbptt_back_length or window
        seed = int(net.conf.conf.seed)
        carries = tree_to(net._init_carries(f.shape[0]), dev)
        score = hvec = None
        for start in range(0, f.shape[1], window):
            sl = slice(start, start + window)
            fw, lw = f[:, sl], l[:, sl]
            fmw = None if fm is None else fm[:, sl]
            lmw = None if lm is None else lm[:, sl]
            loss = net._tbptt_window_loss(max(0, fw.shape[1] - back),
                                          carries)
            gen = worker_generator(seed, it, slot, dev)
            params, ustate, nstate, score, hvec, carries = net._train_step(
                params, ustate, nstate,
                lambda p, s, a=(fw, lw, fmw, lmw), g=gen, fn=loss: fn(
                    p, s, *a, g),
                it, health=True)
            it += 1
        return params, ustate, nstate, score, hvec, it

    def _dispatch_round(self, staged) -> None:
        """Device side of a round: every local worker's steps, the means
        over workers, and the results folded back into the model."""
        net = self.model
        k, w = self.averaging_frequency, self.workers
        if self._worker_ustate is None:
            # every worker starts from the model's updater state (the
            # reference's per-worker model replication)
            self._worker_ustate = [tree_to(net.updater_state, dev)
                                   for dev in self.devices]
        t1 = time.perf_counter()
        outs = []
        for i, (slot, dev) in enumerate(zip(self.runtime.local_slots,
                                            self.devices)):
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                outs.append(self._worker_steps(
                    slot, dev, staged[i], tree_to(net.params, dev),
                    self._worker_ustate[i], tree_to(net.net_state, dev),
                    net.iteration))
        means = self.runtime.mean_trees(
            [(p, u if self.average_updaters else None, s, score, h)
             for p, u, s, score, h in outs], _DP)
        params, _, nstate, score, health = means[0]
        net.params = tree_to(params, net.device)
        net.net_state = tree_to(nstate, net.device)
        self._worker_ustate = ([m[1] for m in means] if self.average_updaters
                               else [o[1] for o in outs])
        _health.record_dispatch(net, health, net.iteration)
        _monitor.observe_phase("step", time.perf_counter() - t1)
        _monitor.counter("parallel_rounds_total",
                         "parameter-averaging rounds (one mean each)").inc()
        _monitor.counter("parallel_worker_steps_total",
                         "per-replica local train steps across all "
                         "workers").inc(k * w)
        # the model keeps worker 0's updater state (identical across
        # workers when average_updaters is on); a pod's processes do not
        # all hold worker 0, so its checkpoints read the per-worker state
        if not self.runtime.is_multiprocess:
            net.updater_state = tree_to(self._worker_ustate[0], net.device)
        self.runtime.publish_state_bytes(self.worker_state(), axis="data")
        net.iteration += k
        net._score = score
        self.last_score = float(score) if self.report_score else None
        t2 = time.perf_counter()
        for listener in self.listeners + net.listeners:
            listener.iteration_done(net, net.iteration)
        if self.listeners or net.listeners:
            _monitor.observe_phase("listener", time.perf_counter() - t2)

    def worker_state(self):
        """The per-worker updater state as one tree of ``mesh.Sharded``
        leaves of shape (workers, ...): what the state gauge counts and a
        pod checkpoint writes (the JAX package's stacked state)."""
        state = self._worker_ustate or [
            tree_to(self.model.updater_state, dev) for dev in self.devices]
        return self.runtime.stack_slots(state)

    def load_worker_state(self, stacked) -> None:
        """Set the per-worker updater state from whole (workers, ...) host
        arrays (a pod checkpoint's), each worker taking its row."""
        self._worker_ustate = self.runtime.unstack_slots(
            stacked, self.model.updater_state)
        if not self.runtime.is_multiprocess:
            self.model.updater_state = tree_to(self._worker_ustate[0],
                                               self.model.device)

    # ------------------------------------------------------------ shutdown
    def shutdown(self) -> None:
        """Reference API parity (the prefetch thread ends with each
        ``fit``)."""

    def __enter__(self) -> "ParallelWrapper":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

