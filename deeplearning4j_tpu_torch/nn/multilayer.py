"""MultiLayerNetwork: the sequential network container (port of
``deeplearning4j_tpu/nn/multilayer.py``).

Eager PyTorch: ``fit`` runs one forward, one autograd backward and one
DL4J-order updater step per batch, or per window under truncated BPTT
(``backprop_type("tbptt")``: windows of ``tbptt_fwd_length`` steps, the
recurrent carries detached at each window boundary, the gradient of the
recurrent trunk cut to the last ``tbptt_back_length`` steps).  Params
are a list of per-layer dicts of tensors in the JAX package's layouts
and order, so the flat parameter vector (``get_flat_params``/
``set_flat_params``) maps one to one between the packages.

The network lives on one device: the card unless ``device="cpu"`` is
passed.  Its precision policy follows that device (``mixed_bf16`` on the
card, fp32 on the CPU; see :mod:`.precision`), with the fp32-logits
contract: the output head's logits are cast to fp32 before the
softmax/loss, and every output the network returns is fp32.

Streaming inference over explicit carries: ``rnn_time_step`` (the
model's own state slot), ``rnn_stateless_step`` and ``decode_step`` (state
with the caller, the KV rings of ``CausalSelfAttention`` included),
``grow_decode_carries`` (the serving cache-len bucket hop) and
``compile_output`` (one inference callable per bucket shape, what
``serving.InferenceEngine`` warms).

Layer state (batch-norm running statistics) lives in ``net_state``: a
``fit`` step updates it, ``output()`` reads it in inference mode.  The
input preprocessors of the configuration run before their layers.  The
updater state crosses to the ModelSerializer as one flat vector in the
JAX package's leaf order (``get_flat_updater_state``).

The training harness: ``fit`` takes a DataSet, an array pair or an
iterator (``datasets.iterators``), fires the listeners of
``set_listeners``/``add_listener`` after every update and at each epoch's
start and end (``optimize.listeners``), and routes the line-search
``optimization_algo`` values (``lbfgs``, ``conjugate_gradient``,
``line_gradient_descent``) to ``optimize.solvers.Solver`` in place of the
updater.  ``do_evaluation``/``evaluate``/``evaluate_roc``/
``evaluate_roc_multi_class``/``evaluate_regression``/``f1_score`` feed the
``eval`` metrics; ``clone`` copies the whole training state.  That
machinery lives in ``_Network``, which ``computation_graph.
ComputationGraph`` shares: the two containers differ only in how they
name, order and compose their layers.

The fused training runtime (``_Network``, shared by both containers):
``fit(iterator)`` trains a cacheable iterator from the device-resident
epoch cache (``ingest="auto"``/``"cache"``; on the card each step is one
replay of a captured CUDA graph, ``nn/step_graph.py``), other iterators in
staged windows (``"window"``), and ``fit_scan`` a list of batches in one
call; every path computes the ``monitor.health`` vector and its guard
when ``monitor.health.in_step()`` asks for them;
``checkpoint=``/``resume_from=`` write and resume
``resilience.checkpoint`` checkpoints, mid-epoch on the cache path.  See
``nn/ingest.py`` for the deliberate difference in the cache path's
shuffle.

Layer-wise unsupervised pretraining (``pretrain``/``pretrain_layer``, and
``fit`` when the configuration says ``pretrain(True)``, once, ahead of
backprop): each step forwards the batch to the layer's input in inference
mode without gradient, takes the layer's ``pretrain_grads`` on the draws
of ``_pretrain_draws`` and applies them through ``apply_layer_updates``
(l1/l2, normalization, the rule).  Under a policy with fp32 masters that
updates the masters and re-derives the params by one cast, so the updater
state keeps its tree and a later ``fit`` starts from the pretrained
weights; the JAX package's pretrain step subtracts from the bf16 params
and leaves the masters at their init (a deliberate difference).
"""

from __future__ import annotations

import copy
import functools
import time
import warnings
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import monitor as _monitor
from ..datasets.dataset import DataSet, MultiDataSet
from ..device import DeviceLike, resolve_device
from ..eval.evaluation import Evaluation
from ..eval.regression import RegressionEvaluation
from ..eval.roc import ROC, ROCMultiClass
from ..monitor import health as _health
from ..optimize import solvers as _solvers
from ..optimize.listeners.listeners import finalize_listeners
from ..resilience import faults as _faults
from . import ingest as _ingest
from . import precision as _precision
from . import step_graph as _step_graph
from . import updaters as _updaters
from .conf.neural_net_configuration import MultiLayerConfiguration
from .layers import pretrain as _pretrain
from .layers.core import EmbeddingLayer
from .layers.recurrent import BaseRecurrentLayer

Tensor = torch.Tensor


class _Network:
    """What the two containers share (``MultiLayerNetwork`` and
    ``computation_graph.ComputationGraph``): init, the autograd step and
    the updater, the fit loop with its listeners and epoch hooks, the
    fused runtime (the epoch cache, windowed staging, ``fit_scan``, the
    health guard, checkpoints), the solver route, the flat parameter and
    updater-state vectors, carry support and ``clone``.

    A container names its layers by a *key* (the layer index, or the
    vertex name) and lists them in flat-parameter order in ``_slots()``;
    ``params``, ``net_state`` and ``updater_state`` hold one tree per
    key, in ``_trees`` form (a list, or a dict keyed by name)."""

    def __init__(self, conf, device: DeviceLike = None):
        self.conf = conf
        self.device = resolve_device(device)
        self.iteration = 0
        self.epoch = 0
        self.listeners: List[Any] = []
        self._init_done = False
        # set by unsupervised pretraining (A6); a transfer carries it over
        self._pretrain_done = False
        self._score: Optional[Tensor] = None
        self._rng: Optional[torch.Generator] = None
        self._policy: Optional[_precision.PrecisionPolicy] = None
        self._rnn_carries = None
        self._rnn_carry_batch = -1
        # the cache path's captured steps (nn/step_graph.py) and the
        # windowed path's copy stream, made on first use on a card
        self._static: Optional[_step_graph.StaticTrees] = None
        self._graphs: Dict[tuple, _step_graph.CapturedGatherStep] = {}
        self._graph_pool = None
        self._stage_stream = None
        # None, or ``source(layer, iteration, specs)`` giving a pretrain
        # step's draws (``pretrain_draw_specs`` order, arrays or tensors)
        # in place of the network's own stream: parity tests feed the JAX
        # package's, card-against-CPU checks one CPU stream
        self.pretrain_draw_source = None

    # ---- the container's layout ------------------------------------------
    def _slots(self):
        """``(key, layer)`` of every layer, in flat-parameter order."""
        raise NotImplementedError

    def _trees(self, pairs):
        """The container of per-layer trees built from ``(key, tree)``
        pairs in ``_slots()`` order."""
        raise NotImplementedError

    def _items(self, trees):
        """``(key, tree)`` pairs of a container of per-layer trees."""
        raise NotImplementedError

    def _layer_at(self, key):
        raise NotImplementedError

    def _pol(self) -> _precision.PrecisionPolicy:
        if self._policy is None:
            self._policy = _precision.resolve_policy(self.conf.conf,
                                                     self.device)
        return self._policy

    @functools.cached_property
    def _solver(self):
        """The line-search solver when ``optimization_algo`` names one
        (reference ``Solver.java``); None for the updater path.  An unknown
        algorithm raises rather than training with SGD."""
        algo = (self.conf.conf.optimization_algo or _solvers.SGD).lower()
        if algo == _solvers.SGD:
            return None
        if self.conf.backprop_type == "tbptt":
            raise ValueError(
                f"optimization_algo {algo!r} is incompatible with tBPTT; "
                "use stochastic_gradient_descent")
        return _solvers.Solver(self, algo)

    # ------------------------------------------------------------------ init
    def init(self):
        """Initialize params, layer state and updater state from the conf
        seed (CPU draws in ``_slots()`` order, then moved to the device)."""
        if self._init_done:
            return self
        pol = self._pol()
        _precision.publish(pol)
        seed = int(self.conf.conf.seed)
        gen = torch.Generator().manual_seed(seed)
        slots = self._slots()
        self.params = self._trees(
            [(key, layer.init_params(gen, pol.param_dtype, self.device))
             for key, layer in slots])
        self.net_state = self._trees(
            [(key, layer.init_state(pol.param_dtype, self.device))
             for key, layer in slots])
        self.updater_state = self._trees(
            [(key, _updaters.init_state(
                self._updater_conf(key),
                _updaters.updatable_params(layer, self.params[key]),
                policy=pol))
             for key, layer in slots])
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._init_done = True
        return self

    def _updater_conf(self, key) -> _updaters.UpdaterConfig:
        return self._layer_at(key).updater or self.conf.conf.updater

    def _reg_score(self, params):
        return sum(_updaters.regularization_score(
            params[key], layer.l1_by_param(), layer.l2_by_param())
            for key, layer in self._slots())

    def _tensor(self, a, dtype: Optional[torch.dtype] = None
                ) -> Optional[Tensor]:
        if a is None:
            return None
        t = torch.as_tensor(a, device=self.device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    def _label_dtype(self) -> torch.dtype:
        """Labels in f32, or in f64 for a network that computes in f64."""
        return (torch.float64 if self._pol().compute_dtype == torch.float64
                else torch.float32)

    # ------------------------------------------------------------- training
    def _train_step(self, params, updater_state, net_state, loss_fn,
                    iteration: int, scalars=None, health: bool = False):
        """One forward, one autograd backward and the DL4J-order update, as
        a pure function of the trees it is given (the step every fit path
        shares, eager or captured).  ``loss_fn(params, net_state) ->
        (loss, new_state, new_carries)`` runs on fresh leaves of
        ``params``.  Returns ``(new_params, new_updater_state, new_state,
        score, hvec, new_carries)``.  With ``health`` the packed health
        vector of ``monitor.health`` and its guard, where
        ``health.in_step()`` asks for them (else ``hvec`` is None);
        ``scalars`` (per layer key) replaces the iteration's updater
        scalars (a captured step reads them from the device)."""
        data_loss, new_state, new_carries, grads = self._loss_and_grads(
            params, net_state, loss_fn, health and _health.in_step())
        with torch.no_grad():
            score = data_loss.detach() + self._reg_score(params)
            new_params, new_ustate = self._updated(
                params, updater_state, grads, iteration, scalars)
            new_state = self._stored_state(new_state)
            hvec = None
            if health and _health.in_step():
                hvec, bad = _health.layer_stats(
                    _flat_leaves(self, params), _flat_leaves(self, new_params),
                    grads, data_loss, _health.leaf_counts(self),
                    _health.layer_matrix(self))
                new_params, new_ustate, new_state = _health.guard_select(
                    bad, (new_params, new_ustate, new_state),
                    (params, updater_state, net_state))
        return new_params, new_ustate, new_state, score, hvec, new_carries

    def _loss_and_grads(self, params, net_state, loss_fn,
                        all_layers: bool):
        """``loss_fn(leaves, net_state) -> (loss, new_state, new_carries)``
        on fresh leaves of ``params`` and its gradient: returns ``(loss,
        new_state, new_carries, grads)``, the grads in flat-parameter
        order.  A frozen layer's gradient is read only by the health
        vector (the updater and the solvers skip the layer), so unless
        ``all_layers`` the layer's params stay out of autograd, and so does
        every layer below a frozen trunk; the layer then takes a zero
        gradient."""
        need = self._grad_keys(all_layers)
        leaves = self._trees(
            [(key, {k: p.detach().requires_grad_(
                p.is_floating_point() and key in need)
                for k, p in tree.items()})
             for key, tree in self._items(params)])
        data_loss, new_state, new_carries = loss_fn(leaves, net_state)
        flat = [p for _, tree in self._items(leaves) for p in tree.values()]
        wanted = [p for p in flat if p.requires_grad]
        got = iter(torch.autograd.grad(data_loss, wanted, allow_unused=True)
                   if wanted else ())
        grads = [next(got) if p.requires_grad else None for p in flat]
        with torch.no_grad():
            grads = [torch.zeros_like(leaf) if g is None else g
                     for g, leaf in zip(grads, flat)]
        return data_loss, new_state, new_carries, grads

    def _grad_keys(self, all_layers: bool) -> set:
        """The layer keys whose params take part in autograd: every layer
        when ``all_layers``, else the layers that are not frozen."""
        return {key for key, layer in self._slots()
                if all_layers or not getattr(layer, "frozen", False)}

    def _updated(self, params, updater_state, flat_grads, iteration: int,
                 scalars=None):
        """New (params, updater state) trees after the updater step of
        every layer; ``flat_grads`` in flat-parameter order."""
        grads_iter = iter(flat_grads)
        new_p, new_u = [], []
        for key, layer in self._slots():
            g = {name: next(grads_iter) for name in params[key]}
            if g:
                p, u = _updaters.apply_layer_updates(
                    self._updater_conf(key), layer, params[key],
                    updater_state[key], g, iteration,
                    scalars=None if scalars is None else scalars.get(key))
            else:
                p, u = params[key], updater_state[key]
            new_p.append((key, p))
            new_u.append((key, u))
        return self._trees(new_p), self._trees(new_u)

    def _update(self, loss_fn, health: bool = False):
        """One step of the network on its own trees (per-batch and tBPTT
        paths): the health vector is recorded when ``health``; listeners
        fire.  Returns the new carries."""
        t0 = time.perf_counter()
        (self.params, self.updater_state, self.net_state, score, hvec,
         new_carries) = self._train_step(
            self.params, self.updater_state, self.net_state, loss_fn,
            self.iteration, health=health)
        self._score = score
        if health:
            _health.record_dispatch(self, hvec, self.iteration)
        self.iteration += 1
        _iterations().inc()
        _monitor.observe_phase("step", time.perf_counter() - t0)
        self._fire_listeners()
        return new_carries

    def _stored_state(self, new_state):
        """The layer state a step returned, detached, as the network keeps
        it."""
        return self._trees([(key, {k: v.detach() for k, v in s.items()})
                            for key, s in self._items(new_state)])

    def _fit_batch(self, ds) -> None:
        """One forward, one backward and one update per iteration (per
        window under tBPTT), or one solver iteration."""
        _faults.slow_worker()
        t0 = time.perf_counter()
        batch = self._batch(ds)
        _monitor.observe_phase("data", time.perf_counter() - t0)
        self.last_batch_size = ds.num_examples()
        solver = self._solver
        for _ in range(self.conf.conf.num_iterations):
            if solver is not None:
                self._score = solver.optimize(*batch)
                self.iteration += 1
                _iterations().inc()
                self._fire_listeners()
                continue
            if self.conf.backprop_type == "tbptt":
                self._fit_tbptt(*batch)
            else:
                self._update(lambda p, s: self._loss_fn(
                    p, s, *batch, self._rng, True), health=True)

    def _fire_listeners(self) -> None:
        if not self.listeners:
            return
        t0 = time.perf_counter()
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration)
        _monitor.observe_phase("listener", time.perf_counter() - t0)

    def _batches(self, data, labels):
        """``fit``'s data as a list of batches or an iterator."""
        raise NotImplementedError

    # ---- the fused paths' container hooks --------------------------------
    def _step_batch(self, fs, ls, fms, lms):
        """``_loss_fn``'s (features, labels, masks) from per-input lists of
        device tensors (mask lists may be None)."""
        raise NotImplementedError

    def _window_item(self, ds):
        """An iterator's batch as the windowed path buffers it."""
        raise NotImplementedError

    def _window_sig(self, item):
        raise NotImplementedError

    def _window_stack(self, items, pin: bool, wires=None):
        """Host (W, B, ...) per-input lists (features, labels, features
        masks or None, labels masks or None) of a window; an input whose
        entry of ``wires`` is not None stacks its uint8 wire twins in
        place of its features."""
        raise NotImplementedError

    def _window_wires(self, items):
        """The per-input wire specs of a window (None for an input that
        goes as its features)."""
        raise NotImplementedError

    # ---- the device-resident epoch cache ---------------------------------
    def _gather_step(self, params, updater_state, net_state, data_fs,
                     data_ls, wires, idx, iteration: int, scalars=None):
        """The cache path's step: gather the minibatch ``idx`` from the
        resident per-input arrays (``index_select``), decode the wire,
        train.  Returns ``(new_params, new_updater_state, new_state,
        score, hvec)``."""
        ldt = self._label_dtype()
        fs = [_ingest.device_decode(d.index_select(0, idx), w)
              for d, w in zip(data_fs, wires)]
        ls = [d.index_select(0, idx).to(ldt) for d in data_ls]
        batch = self._step_batch(fs, ls, None, None)
        return self._train_step(
            params, updater_state, net_state,
            lambda p, s: self._loss_fn(p, s, *batch, self._rng, True),
            iteration, scalars=scalars, health=True)[:5]

    def _captured_step(self, data_fs, data_ls, wires, batch_rows: int,
                       capacity: int, columns):
        """The CUDA graph of the gather step for this dataset and batch
        shape, captured on first use (``nn/step_graph.py``); the static
        trees take the network's current values."""
        if self._static is None:
            self._static = _step_graph.StaticTrees(self)
        else:
            self._static.load(self)
        key = _step_graph.capture_key(data_fs, data_ls, batch_rows,
                                      capacity, _health.config_key())
        step = self._graphs.get(key)
        if step is None:
            if any(k[:2] != key[:2] for k in self._graphs):
                # another dataset: drop its graphs, and their memory pool
                # with them (a pool all of whose graphs are gone cannot
                # take a new capture)
                self._graphs.clear()
                self._graph_pool = None
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            score_dtype = self._label_dtype()
            # a weak reference: no cycle through the graph, so a dropped
            # network frees its graphs at once, never in the middle of
            # another network's capture
            net = weakref.ref(self)
            step = _step_graph.CapturedGatherStep(
                self, self._static,
                lambda p, u, s, idx, sc: net()._gather_step(
                    p, u, s, data_fs, data_ls, wires, idx, 0, sc),
                batch_rows, capacity, columns, score_dtype,
                2 + 3 * len(self._slots()) if _health.in_step() else 0,
                self._graph_pool, recompile=bool(self._graphs))
            self._graphs[key] = step
        return step

    def _fit_device_cached(self, source, epochs: int, start_step: int = 0,
                           ckpt=None):
        """One ``fit`` over a device-resident dataset.  ``source`` is the
        ``ListDataSetIterator`` vetted by ``ingest.cacheable_source``.
        Batch boundaries (the tail batch included) and the per-iteration
        updater and dropout streams are those of the per-batch path; the
        example order is ``ingest.epoch_permutation`` (continuing across
        fits through ``self.epoch``).  On the card each step is one replay
        of the captured gather step; on the CPU the same step runs in an
        eager loop.  ``start_step``/``ckpt`` are the resume offset and the
        checkpoint manager of ``ingest.run_device_cached_fit``."""
        dev_f, dev_l, wire = _ingest.device_cached_arrays(
            self, source._ds, source.get_preprocessor())
        data_fs, data_ls, wires = (dev_f,), (dev_l,), (wire,)
        n, batch = source._ds.num_examples(), source._batch
        steps, tail = divmod(n, batch)
        shuffle, seed = bool(source._shuffle), int(self.conf.conf.seed)
        capture = self.device.type == "cuda"
        if capture:
            fuse_cap = max(1, _ingest.max_steps_per_dispatch()
                           // max(1, steps))
            columns = _step_graph.table_columns(self)
            it0 = self.iteration
            table = _step_graph.scalar_table(
                self, columns, it0, epochs * (steps + (1 if tail else 0)),
                self.device)

        def rows_of(first_epoch, fused, tail_rows, start, run):
            out = []
            for e in range(first_epoch, first_epoch + fused):
                perm = _ingest.epoch_permutation(seed, e, n, shuffle,
                                                 self.device)
                if tail_rows:
                    out.append(perm[steps * batch:].reshape(1, tail_rows))
                else:
                    out.append(perm[start * batch:(start + run) * batch]
                               .reshape(run, batch))
            return torch.cat(out)

        def dispatch(first_epoch, fused, tail_rows, start=0, run=None):
            rows = rows_of(first_epoch, fused, tail_rows, start,
                           steps if run is None else run)
            if capture:
                step = self._captured_step(
                    data_fs, data_ls, wires, rows.shape[1],
                    1 if tail_rows else fuse_cap * steps, columns)
                r = self.iteration - it0
                scores, hstack = step.run(rows, table[r:r + rows.shape[0]])
                self._static.bind(self)
            else:
                scores, hs = [], []
                for j in range(rows.shape[0]):
                    (self.params, self.updater_state, self.net_state, score,
                     hvec) = self._gather_step(
                        self.params, self.updater_state, self.net_state,
                        data_fs, data_ls, wires, rows[j], self.iteration + j)
                    scores.append(score)
                    hs.append(hvec)
                scores, hstack = torch.stack(scores), _stacked(hs)
            _health.record_dispatch(self, hstack, self.iteration)
            return scores

        try:
            return _ingest.run_device_cached_fit(
                self, source, epochs, dispatch, start_step=start_step,
                ckpt=ckpt)
        finally:
            if capture and self._static is not None:
                self._static.release(self)

    # ---- windowed staging and fit_scan ------------------------------------
    def _stage(self, host):
        """Copy host tensors (or None) to the device.  On the card they
        come from pinned memory and go ``non_blocking`` on a side stream;
        the returned event orders the copy before their use
        (:meth:`_await_staged`)."""
        if self.device.type != "cuda":
            return [None if t is None else t.to(self.device)
                    for t in host], None
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(self._stage_stream):
            dev = [None if t is None else t.to(self.device,
                                               non_blocking=True)
                   for t in host]
        done = torch.cuda.Event()
        done.record(self._stage_stream)
        return dev, done

    def _await_staged(self, dev, done) -> None:
        if done is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(done)
        for t in dev:
            if t is not None:
                t.record_stream(cur)     # the allocator waits for our use

    def _row_batch(self, fs, ls, fms, lms, wires, j: int):
        """``_loss_fn``'s batch from row ``j`` of stacked per-input device
        tensors: the wire decoded, labels in the label dtype, masks in
        float32."""
        ldt = self._label_dtype()

        def row(ts, dtype=None):
            if ts is None:
                return None
            return [None if t is None else
                    (t[j] if dtype is None or not t.is_floating_point()
                     else t[j].to(dtype)) for t in ts]

        f = [_ingest.device_decode(x, w) for x, w in zip(row(fs), wires)]
        return self._step_batch(f, row(ls, ldt), row(fms, torch.float32),
                                row(lms, torch.float32))

    def _multi_steps(self, fs, ls, fms, lms, wires):
        """One step per leading row of the stacked per-input device
        tensors (the JAX package's scan over a window), on the network's
        own trees.  Returns the (S,) scores and the (S, 2+3L) health stack
        (None when the steps computed none)."""
        scores, hs = [], []
        for j in range(fs[0].shape[0]):
            batch = self._row_batch(fs, ls, fms, lms, wires, j)
            (self.params, self.updater_state, self.net_state, score, hvec,
             _) = self._train_step(
                self.params, self.updater_state, self.net_state,
                lambda p, s: self._loss_fn(p, s, *batch, self._rng, True),
                self.iteration + j, health=True)
            scores.append(score)
            hs.append(hvec)
        return torch.stack(scores), _stacked(hs)

    def _host_window(self, items, pin: bool, wires):
        """A window stacked on the host (into pinned memory with ``pin``):
        per-input (features, labels, features masks or None, labels masks
        or None).  Features are the uint8 wire where ``wires`` (from
        :meth:`_window_wires`) has a spec, else float32 cast on the host
        to a bf16 compute dtype."""
        fs, ls, fms, lms = self._window_stack(items, pin, wires)
        cdt = self._pol().compute_dtype
        fs = [f if w is not None else _ingest.cast_for_transfer(f, cdt)
              for f, w in zip(fs, wires)]
        return fs, ls, fms, lms

    def _staged_window(self, items, pin: bool):
        """Stack a window on the host (into pinned memory on the card),
        ship the uint8 wire where every batch has one, else cast float32
        features to a bf16 compute dtype on the host, and start the copy.
        Returns what :meth:`_train_window` takes.  The host's part runs in
        a ``fit/stage`` span, the copy's start in ``fit/copy``; both
        together (and the fault layer's straggler point) are the window's
        ``phase_data_ms``.  ``fit/stage``'s ``wire`` attr and the
        ``ingest_window_batches_total`` counter's label say how the
        features went: ``"uint8"`` when every input ships the wire, else
        ``"float32"``."""
        t0 = time.perf_counter()
        _faults.slow_worker()
        rows = sum(it.num_examples() for it in items)
        wires = self._window_wires(items)
        kind = ("uint8" if all(w is not None for w in wires)
                else "float32")
        with _monitor.span("fit/stage", steps=len(items), rows=rows,
                           wire=kind):
            fs, ls, fms, lms = self._host_window(items, pin, wires)
        _monitor.counter("ingest_window_batches_total",
                         _ingest._WINDOW_BATCHES_HELP).inc(len(items),
                                                           wire=kind)
        parts = [fs, ls, fms or [], lms or []]
        flat = [t for part in parts for t in part]
        nbytes = sum(_ingest._nbytes(t) for t in flat)
        with _monitor.span("fit/copy", bytes=nbytes):
            dev, done = self._stage(flat)
        _monitor.gauge("ingest_staged_bytes", _ingest._STAGED_HELP).set(
            sum(_ingest._nbytes(t) for t in fs + ls), path="window")
        _monitor.observe_phase("data", time.perf_counter() - t0)
        cut = [len(part) for part in parts]
        out, at = [], 0
        for k in cut:
            out.append(dev[at:at + k])
            at += k
        return (out[0], out[1], out[2] if fms is not None else None,
                out[3] if lms is not None else None, wires, dev, done,
                len(items), items[0].num_examples())

    def _train_window(self, staged, replay) -> None:
        """Enqueue a staged window's steps in a ``fit/dispatch`` span, the
        window's ``phase_step_ms``."""
        fs, ls, fms, lms, wires, dev, done, count, rows = staged
        t0 = time.perf_counter()
        with _monitor.span("fit/dispatch", steps=count, rows=count * rows):
            self._await_staged(dev, done)
            scores, hstack = self._multi_steps(fs, ls, fms, lms, wires)
            _health.record_dispatch(self, hstack, self.iteration)
        _monitor.observe_phase("step", time.perf_counter() - t0)
        replay.add(self.iteration, scores)
        _iterations().inc(count)
        self.iteration += count
        self.last_batch_size = rows

    def _fit_windowed(self, iterator, epochs: int, window: int, ckpt=None):
        """Streaming ``fit(iterator)`` in multi-batch windows: window k+1
        is stacked on the host and its copy started on a side stream
        before window k's steps are enqueued, so the copy overlaps them
        (datasets that fit the card take ``_fit_device_cached``).  A
        window ends at ``window`` batches or at a change of shape or
        masks.  ``ckpt`` saves at epoch boundaries (windows re-stack from
        the host iterator, so mid-epoch offsets are not replayable here;
        the epoch-cache path owns exact mid-epoch resume).  Each call of
        the iterator (the one that ends the epoch too) runs in a
        ``fit/iterator`` span.  Where ``ingest.wire_source`` accepts the
        iterator (an affine pixel scaler over uint8 features), its
        batches are drawn before the scaler and ship their uint8 rows,
        which the step decodes on the device, bit-exactly."""
        replay = _ingest.ScoreReplayer(self)
        bound = _ingest.EpochBoundary(self, ckpt, replay)
        pin = self.device.type == "cuda"
        end = object()
        for _ in range(epochs):
            with bound.epoch("window"):
                source = _ingest.wire_source(iterator)
                if source is not None:
                    batches = _ingest.wired_epoch(*source)
                else:
                    if hasattr(iterator, "reset"):
                        iterator.reset()
                    batches = iter(iterator)
                buf, sig, pending = [], None, None
                while True:
                    with _monitor.span("fit/iterator"):
                        ds = next(batches, end)
                        item = ds if ds is end else self._window_item(ds)
                    if item is end:
                        break
                    s = self._window_sig(item)
                    if buf and (s != sig or len(buf) >= window):
                        staged = self._staged_window(buf, pin)
                        if pending is not None:
                            self._train_window(pending, replay)
                        pending, buf = staged, []
                    sig = s
                    buf.append(item)
                if buf:
                    staged = self._staged_window(buf, pin)
                    if pending is not None:
                        self._train_window(pending, replay)
                    pending = staged
                if pending is not None:
                    self._train_window(pending, replay)
        bound.finish()
        return self

    def fit_scan(self, batches) -> np.ndarray:
        """Fit a list of same-shaped minibatches in one dispatch; returns
        the per-step scores.  Listeners fire once at the end with the last
        iteration.  The standard-backprop regime only: tBPTT,
        ``num_iterations > 1`` and line-search solvers raise (use
        ``fit``)."""
        self.init()
        if self.conf.backprop_type == "tbptt":
            raise ValueError("fit_scan does not support tBPTT; use fit()")
        if self.conf.pretrain and not self._pretrain_done:
            raise ValueError("fit_scan does not run pretraining; call "
                             "pretrain() (or fit()) first")
        if self.conf.conf.num_iterations != 1:
            raise ValueError("fit_scan runs one update per batch; "
                             "num_iterations > 1 must use fit()")
        if self._solver is not None:
            raise ValueError("fit_scan supports the SGD path only; this "
                             "config uses a line-search solver")
        items = [self._window_item(b) for b in batches]
        for which in ("features_masks", "labels_masks"):
            present = [_mask_presence(it, which) for it in items]
            if len(set(present)) > 1:
                raise ValueError(
                    "Mixed mask presence across batches in fit_scan; "
                    "provide masks on all batches or none")
        _faults.slow_worker()
        fs, ls, fms, lms = self._window_stack(items, False)
        parts = [fs, ls, fms or [], lms or []]
        dev, done = self._stage([t for part in parts for t in part])
        self._await_staged(dev, done)
        n_f, n_l, n_fm = len(fs), len(ls), len(parts[2])
        fs, ls = dev[:n_f], dev[n_f:n_f + n_l]
        fms = dev[n_f + n_l:n_f + n_l + n_fm] if fms is not None else None
        lms = dev[n_f + n_l + n_fm:] if lms is not None else None
        scores, hstack = self._multi_steps(fs, ls, fms, lms,
                                           (None,) * len(fs))
        _health.record_dispatch(self, hstack, self.iteration)
        _iterations().inc(len(items))
        self.iteration += len(items)
        self._score = scores[-1]
        self.last_batch_size = items[0].num_examples()
        self._fire_listeners()
        return scores.detach().cpu().numpy()

    # ------------------------------------------------------------------- fit
    def _resolve_resilience(self, checkpoint, resume_from, epochs):
        """``(manager, start_step, remaining_epochs)`` of ``fit``'s
        ``checkpoint=``/``resume_from=``."""
        if checkpoint is None and resume_from is None:
            return None, 0, epochs
        from ..resilience.checkpoint import resolve_fit_resilience
        return resolve_fit_resilience(self, checkpoint, resume_from, epochs)

    @staticmethod
    def _warn_partial_epoch_restart(start_step: int, path: str) -> None:
        """Only the epoch-cache path can seek into an epoch (its order is
        re-derived from the seed and the epoch); the others restart the
        interrupted epoch."""
        if start_step:
            warnings.warn(
                f"resume_from checkpoint was taken mid-epoch "
                f"(step_in_epoch={start_step}) but the {path} path "
                "cannot seek into an epoch; restarting the epoch from "
                "step 0 (at-least-once semantics)", RuntimeWarning)

    def fit(self, data, labels=None, epochs: int = 1, ingest: str = "auto",
            window: int = 16, checkpoint=None, resume_from=None):
        """Train on a batch, a features array with ``labels``, or an
        iterator of batches (reset at each epoch): one update per batch,
        listeners fired after each.

        ``ingest`` selects the iterator's data path, as in the JAX
        package: ``"auto"`` (default) trains from the device-resident
        epoch cache when ``ingest.cacheable_source`` accepts the iterator
        (a ``ListDataSetIterator`` of dense floats, ``MnistDataSetIterator``
        included, possibly behind an ``AsyncDataSetIterator``), else in
        windows of ``window`` batches staged while the previous window
        trains; ``"cache"``, ``"window"`` and ``"batch"`` force one path.
        The cache and window paths fire listeners by replaying each
        step's exact score after the dispatch (the params a listener sees
        are the dispatch's last); solver, tBPTT and ``num_iterations > 1``
        networks always take the per-batch path.  With shuffle, the cache
        path's example order is ``ingest.epoch_permutation``'s, not the
        iterator's.

        With ``pretrain(True)`` in the configuration the first call
        pretrains every pretrainable layer once (one epoch) before
        backprop; with ``backprop(False)`` only pretraining runs.

        ``checkpoint=`` (a ``resilience.CheckpointManager`` or a
        directory) saves checkpoints at the manager's step or time
        cadence (epoch boundaries by default); ``resume_from=``
        (``"auto"``, a directory or a checkpoint file) restores params,
        updater state, the fit generator and the progress first, and
        ``epochs`` is then the TOTAL epoch target of the original run.  On
        the cache path a mid-epoch restore resumes at the exact step
        (bit-identical to the uninterrupted run); the window and batch
        paths restart the interrupted epoch."""
        if ingest not in ("auto", "cache", "window", "batch"):
            raise ValueError(
                f"unknown ingest mode {ingest!r}; expected 'auto', "
                "'cache', 'window', or 'batch'")
        self.init()
        ckpt, start_step, epochs = self._resolve_resilience(
            checkpoint, resume_from, epochs)
        batches = self._batches(data, labels)
        single = labels is not None or isinstance(data,
                                                  (DataSet, MultiDataSet))
        try:
            if self.conf.pretrain and not self._pretrain_done:
                if not single and not hasattr(batches, "reset"):
                    # a one-shot iterable, materialised once so that each
                    # layer and the supervised phase see all of it; the
                    # list then trains per batch, as in the JAX package
                    batches = list(batches)
                    ingest = "batch"
                self.pretrain(batches)
            if not self.conf.backprop:
                return self
            if (not single and ingest != "batch" and self._solver is None
                    and self.conf.backprop_type != "tbptt"
                    and self.conf.conf.num_iterations == 1):
                if ingest in ("auto", "cache"):
                    source = _ingest.cacheable_source(batches)
                    if source is not None:
                        return self._fit_device_cached(
                            source, epochs, start_step=start_step,
                            ckpt=ckpt)
                    if ingest == "cache":
                        raise ValueError(
                            "ingest='cache' but the iterator is not "
                            "device-cacheable (see nn/ingest.py "
                            "eligibility)")
                self._warn_partial_epoch_restart(start_step, "window")
                return self._fit_windowed(batches, epochs, window, ckpt=ckpt)
            self._warn_partial_epoch_restart(start_step, "batch")
            bound = _ingest.EpochBoundary(self, ckpt)
            for _ in range(epochs):
                with bound.epoch("batch"):
                    if hasattr(batches, "reset"):
                        batches.reset()
                    for ds in batches:
                        self._fit_batch(ds)
            bound.finish()
            return self
        finally:
            finalize_listeners(self.listeners)

    # -------------------------------------------------------------- pretrain
    def _pretrain_features(self, ds):
        """A batch's features as ``_pretrain_input`` takes them."""
        raise NotImplementedError

    def _pretrain_input(self, key, features) -> Tensor:
        """The input of layer ``key`` (its preprocessor applied) in
        inference mode."""
        raise NotImplementedError

    def _pretrain_draws(self, layer, x: Tensor, iteration: int):
        """The draws of one pretrain step of ``layer`` on input ``x``: from
        ``pretrain_draw_source`` when set, else from a generator on the
        network's device seeded by the seed and the iteration."""
        specs = layer.pretrain_draw_specs(int(x.shape[0]))
        dtype = _pretrain.draw_dtype(x.dtype)
        if self.pretrain_draw_source is None:
            gen = torch.Generator(device=self.device).manual_seed(
                _pretrain.pretrain_seed(self.conf.conf.seed, iteration))
            return _pretrain.make_draws(specs, gen, self.device, dtype)
        draws = [None if d is None else torch.as_tensor(
            np.array(d) if not isinstance(d, Tensor) else d).to(
                self.device) for d in self.pretrain_draw_source(
                    layer, iteration, specs)]
        _pretrain.check_draws(specs, draws, "pretrain_draw_source")
        return draws

    def _pretrain_step(self, key, x: Tensor, iteration: int):
        """One unsupervised step of layer ``key`` on its input ``x``:
        ``(new_params, new_updater_state, score)``.  The layer computes in
        ``x``'s dtype; without fp32 masters the gradients are cast to the
        params' dtypes, with them the update runs on the masters."""
        layer = self._layer_at(key)
        params, ustate = self.params[key], self.updater_state[key]
        draws = self._pretrain_draws(layer, x, iteration)
        work = {k: p.to(x.dtype) if p.is_floating_point() else p
                for k, p in params.items()}
        score, grads = layer.pretrain_grads(work, x, draws)
        with torch.no_grad():
            if _updaters.MASTER_KEY not in ustate:
                grads = {k: g.to(params[k].dtype) for k, g in grads.items()}
            new_p, new_u = _updaters.apply_layer_updates(
                self._updater_conf(key), layer, params, ustate, grads,
                iteration)
            score = score.detach() + _updaters.regularization_score(
                params, layer.l1_by_param(), layer.l2_by_param())
        return new_p, new_u, score

    def pretrain(self, data, epochs: int = 1):
        """Greedy layer-wise unsupervised pretraining of every pretrainable
        layer (AutoEncoder, RBM, VariationalAutoencoder) in order (a
        graph's in topological order); marks pretraining done, so ``fit``
        does not run it again (the flag travels in model zips and
        checkpoints)."""
        self.init()
        if not isinstance(data, (DataSet, MultiDataSet)) \
                and not hasattr(data, "reset"):
            data = list(data)  # one-shot iterable: each layer needs a pass
        for key, layer in self._slots():
            if getattr(layer, "IS_PRETRAINABLE", False):
                self.pretrain_layer(key, data, epochs)
        self._pretrain_done = True
        return self

    def pretrain_layer(self, key, data, epochs: int = 1):
        """Pretrain one layer (an index, or a vertex name) for ``epochs``
        passes over ``data``; a layer that cannot pretrain, or is frozen,
        is skipped.  One step per batch: the iteration advances and the
        listeners fire."""
        self.init()
        layer = self._layer_at(key)
        if not getattr(layer, "IS_PRETRAINABLE", False) \
                or getattr(layer, "frozen", False):
            return self
        batches = [data] if isinstance(data, (DataSet, MultiDataSet)) \
            else data
        for _ in range(epochs):
            if hasattr(batches, "reset"):
                batches.reset()
            for ds in batches:
                with torch.no_grad():
                    x = self._pretrain_input(
                        key, self._pretrain_features(ds))
                (self.params[key], self.updater_state[key],
                 self._score) = self._pretrain_step(key, x, self.iteration)
                self.iteration += 1
                self._fire_listeners()
        return self

    # --------------------------------------------------------------- carries
    def _require_carry_support(self, what: str) -> None:
        """A layer whose pass needs the whole sequence cannot carry state
        across chunks of it."""
        for key, layer in self._slots():
            if (isinstance(layer, BaseRecurrentLayer)
                    and not layer.SUPPORTS_CARRY):
                raise ValueError(
                    f"{self._describe(key)} ({type(layer).__name__}) does "
                    f"not support {what}: its backward pass needs the full "
                    "sequence")

    def _describe(self, key) -> str:
        raise NotImplementedError

    def has_kv_ring(self) -> bool:
        """Whether any layer carries a KV-cache ring (the decode state)."""
        return any(getattr(layer, "HAS_KV_RING", False)
                   for _, layer in self._slots())

    def max_cache_len(self) -> int:
        """Largest KV-ring capacity across layers (0 without rings): the
        top of the serving cache-len ladder."""
        return max((int(layer.cache_len) for _, layer in self._slots()
                    if getattr(layer, "HAS_KV_RING", False)), default=0)

    def _carry_of(self, layer, batch: int, cache_len: Optional[int]):
        """Zero carry of one recurrent layer in the compute dtype;
        ``cache_len`` overrides a KV ring's capacity."""
        dtype = self._pol().compute_dtype
        if cache_len is not None and getattr(layer, "HAS_KV_RING", False):
            return layer.init_carry(batch, dtype, self.device,
                                    cache_len=cache_len)
        return layer.init_carry(batch, dtype, self.device)

    def rnn_clear_previous_state(self) -> None:
        """Reference ``rnnClearPreviousState()``."""
        self._rnn_carries = None
        self._rnn_carry_batch = -1

    def _check_carry_batch(self, batch: int) -> None:
        """Start the stored state at ``batch`` rows, or check it holds
        that many."""
        if self._rnn_carries is None:
            self._rnn_carries = self._init_carries(batch)
            self._rnn_carry_batch = batch
        elif self._rnn_carry_batch != batch:
            raise ValueError(
                f"rnn_time_step batch size {batch} != stored state "
                f"batch size {self._rnn_carry_batch}; call "
                "rnn_clear_previous_state() between unrelated sequences")

    # ----------------------------------------------------------- evaluation
    def evaluate(self, iterator):
        """Classification evaluation over an iterator (reference
        ``evaluate``)."""
        return self.do_evaluation(iterator, Evaluation())[0]

    def evaluate_roc(self, iterator, threshold_steps: int = 30):
        """Binary ROC over an iterator (reference ``evaluateROC``)."""
        return self.do_evaluation(iterator, ROC(threshold_steps))[0]

    def evaluate_roc_multi_class(self, iterator,
                                 threshold_steps: int = 30):
        """One-vs-all ROC (reference ``evaluateROCMultiClass``)."""
        return self.do_evaluation(iterator,
                                  ROCMultiClass(threshold_steps))[0]

    def evaluate_regression(self, iterator):
        """Per-column regression statistics (reference
        ``evaluateRegression``)."""
        return self.do_evaluation(iterator, RegressionEvaluation())[0]

    def _eval_batches(self, iterator):
        if isinstance(iterator, (DataSet, MultiDataSet)):
            iterator = [iterator]
        if hasattr(iterator, "reset"):
            iterator.reset()
        return iterator

    def _feed_evaluators(self, evaluators, fast: bool, labels, mask,
                         guess=None, out=None) -> None:
        """One batch into every evaluator: top-1 class indices (``fast``)
        or the host output."""
        if fast:
            actual = labels.argmax(-1)
            if labels.ndim == 3:
                actual, guess = actual.reshape(-1), guess.reshape(-1)
                if mask is not None:
                    keep = mask.reshape(-1) > 0
                    actual, guess = actual[keep], guess[keep]
            for ev in evaluators:
                ev.eval_class_indices(actual, guess, labels.shape[-1])
            return
        for ev in evaluators:
            if out.ndim == 3:
                ev.eval_time_series(labels, out, mask)
            else:
                ev.eval(labels, out)

    @staticmethod
    def _fast_eval(evaluators) -> bool:
        return bool(evaluators) and all(
            type(ev) is Evaluation and ev.top_n == 1 for ev in evaluators)

    @staticmethod
    def _publish_eval_bytes(bytes_moved: int, fast: bool) -> None:
        _monitor.gauge(
            "eval_bytes_transferred",
            "device->host bytes moved by the most recent do_evaluation",
        ).set(bytes_moved, path="indices" if fast else "logits")

    # ------------------------------------------------ flat-param invariant
    def _ordered(self):
        for key, layer in self._slots():
            for name in layer.param_order():
                yield key, name

    def param_table(self) -> Dict[str, np.ndarray]:
        """Named params ``{"0_Wq": ..., "1_b": ...}`` (a graph names them
        by vertex: ``{"dense_W": ...}``) as float32 numpy."""
        self.init()
        return {f"{key}_{name}": self.params[key][name].detach().float()
                .cpu().numpy() for key, name in self._ordered()}

    def num_params(self) -> int:
        self.init()
        return sum(p.numel() for _, tree in self._items(self.params)
                   for p in tree.values())

    def get_flat_params(self) -> np.ndarray:
        """All params as one vector, in layer/param order (the JAX
        package's ``get_flat_params`` order): float64 for a float64
        network, else float32."""
        self.init()
        dtype = (torch.float64 if self._pol().param_dtype == torch.float64
                 else torch.float32)
        chunks = [self.params[key][name].detach().reshape(-1).to(dtype)
                  .cpu() for key, name in self._ordered()]
        if not chunks:
            return np.zeros((0,), np.float32)
        return torch.cat(chunks).numpy()

    def set_flat_params(self, flat) -> None:
        """Assign every param from one vector in ``get_flat_params`` order
        (cast to each param's dtype; a float64 vector keeps its precision
        up to that cast); fp32 masters are re-derived."""
        self.init()
        flat = np.asarray(flat)
        flat = torch.as_tensor(flat if flat.dtype == np.float64
                               else flat.astype(np.float32))
        offset = 0
        for key, name in self._ordered():
            p = self.params[key][name]
            size = p.numel()
            if offset + size > flat.numel():
                raise ValueError(f"Flat param size mismatch: vector of "
                                 f"{flat.numel()} is too short")
            self.params[key][name] = flat[offset:offset + size].reshape(
                p.shape).to(device=self.device, dtype=p.dtype)
            offset += size
        if offset != flat.numel():
            raise ValueError(f"Flat param size mismatch: expected {offset}, "
                             f"got {flat.numel()}")
        self._sync_masters_from_params()

    def _sync_masters_from_params(self) -> None:
        """Re-derive the fp32 masters from freshly assigned params, so that
        params == cast(masters) holds after a direct write."""
        for key, state in self._items(self.updater_state):
            masters = state.get(_updaters.MASTER_KEY)
            if masters is not None:
                state[_updaters.MASTER_KEY] = {
                    k: self.params[key][k].float().clone() for k in masters}

    def get_flat_updater_state(self) -> np.ndarray:
        """The updater state as one float32 vector, leaves in the order of
        the JAX package's ``jax.tree_util.tree_leaves`` (dict keys sorted
        at every level, so ``_master`` comes before ``m`` and ``v``, and
        ``W`` before ``b``): the ``updaterState.bin`` payload."""
        self.init()
        leaves = [leaf.detach().reshape(-1).float().cpu()
                  for _, tree in self._items(self.updater_state)
                  for leaf in _sorted_leaves(tree)]
        if not leaves:
            return np.zeros((0,), np.float32)
        return torch.cat(leaves).numpy()

    def set_flat_updater_state(self, flat) -> None:
        """Inverse of :meth:`get_flat_updater_state`.  A vector without the
        fp32 masters (one written under a policy without them) also
        loads into a network that keeps masters: the masters then stay
        as ``set_flat_params`` derived them."""
        self.init()
        flat = torch.as_tensor(np.asarray(flat, dtype=np.float32))
        with_masters = sum(leaf.numel()
                           for _, tree in self._items(self.updater_state)
                           for leaf in _sorted_leaves(tree))
        skip = () if flat.numel() == with_masters else \
            (_updaters.MASTER_KEY,)
        offset = 0

        def take(leaf):
            nonlocal offset
            size = leaf.numel()
            if offset + size > flat.numel():
                raise ValueError(f"updater state of {flat.numel()} values "
                                 "is too short for the network")
            out = flat[offset:offset + size].reshape(leaf.shape).to(
                device=leaf.device, dtype=leaf.dtype)
            offset += size
            return out

        self.updater_state = self._trees(
            [(key, _map_sorted_leaves(tree, take, skip))
             for key, tree in self._items(self.updater_state)])
        if offset != flat.numel():
            raise ValueError(f"updater state size mismatch: the network "
                             f"holds {with_masters} values, the vector "
                             f"{flat.numel()}")

    # -------------------------------------------------------------- misc API
    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

    def clone(self):
        """A copy on the same device (reference ``clone()``): the
        configuration, params, layer state, updater state with the fp32
        masters, and the iteration; listeners are not copied."""
        self.init()
        other = type(self)(copy.deepcopy(self.conf), device=self.device)
        other.init()
        other.params = _cloned(self.params)
        other.net_state = _cloned(self.net_state)
        other.updater_state = _cloned(self.updater_state)
        other.iteration = self.iteration
        other._pretrain_done = self._pretrain_done
        return other


class MultiLayerNetwork(_Network):
    """Sequential model: list of layer configs -> train/inference."""

    def __init__(self, conf: MultiLayerConfiguration,
                 device: DeviceLike = None):
        super().__init__(conf, device)
        self.layers = conf.layers
        self.params: List[Dict[str, Tensor]] = []
        self.net_state: List[Dict[str, Tensor]] = []
        self.updater_state: List[Dict[str, Any]] = []

    def _slots(self):
        return list(enumerate(self.layers))

    def _trees(self, pairs):
        return [tree for _, tree in pairs]

    def _items(self, trees):
        return list(enumerate(trees))

    def _layer_at(self, key):
        return self.layers[key]

    def _describe(self, key) -> str:
        return f"Layer {key}"

    # --------------------------------------------------------------- forward
    def _forward(self, params, net_state, x: Tensor, *, train: bool,
                 rng: Optional[torch.Generator], mask=None, carries=None,
                 to_layer: Optional[int] = None, from_layer: int = 0,
                 preoutput_last: bool = False,
                 acts: Optional[List[Tensor]] = None):
        """Compose the layers ``from_layer`` to ``to_layer`` (default: all)
        with ``x`` as the input of ``from_layer``.  Returns (out,
        new_state, new_carries).  ``carries`` is a per-layer list of
        recurrent carries (``()`` for a stateless layer) threaded through
        ``forward_seq``; None runs every recurrent layer from zero state.
        With ``preoutput_last`` the last layer composed contributes its
        pre-activation, so the loss can fuse softmax stably.  ``acts``
        collects each layer's activation as ``to_layer=i`` would return
        it."""
        pol = self._pol()
        if x.is_floating_point():
            x = x.to(pol.compute_dtype)
        if pol.compute_dtype != pol.param_dtype:
            params = [{k: p.to(pol.compute_dtype) if p.is_floating_point()
                       else p for k, p in tree.items()} for tree in params]
        new_state = list(net_state)
        new_carries = (list(carries) if carries is not None
                       else [() for _ in self.layers])
        n = len(self.layers) if to_layer is None else to_layer + 1
        preprocessors = self.conf.input_preprocessors
        for i in range(from_layer, n):
            layer = self.layers[i]
            if i in preprocessors:
                x = preprocessors[i](x)
            if preoutput_last and i == n - 1 and hasattr(layer,
                                                         "pre_output"):
                x = layer.apply_dropout(x, train, rng)
                x = layer.pre_output(params[i], x)
            elif (pol.downcasts_output and i == len(self.layers) - 1
                  and hasattr(layer, "pre_output")):
                # fp32 logits contract: the head's logits go to fp32
                # BEFORE the softmax, so probabilities are not bf16-rounded.
                # Checked before the carries branch, so a carried step
                # honours it too (else N decode steps drift from output());
                # the only recurrent head, RnnOutputLayer, carries ()
                x = layer.apply_dropout(x, train, rng)
                x = layer._activate(layer.pre_output(params[i], x).float())
            elif carries is not None and isinstance(layer,
                                                    BaseRecurrentLayer):
                x, new_carries[i] = layer.forward_seq(
                    params[i], x, carries[i], train=train, rng=rng,
                    mask=mask)
            else:
                x, new_state[i] = layer.forward(
                    params[i], net_state[i], x, train=train, rng=rng,
                    mask=mask)
            if acts is not None:
                acts.append(x.float() if pol.downcasts_output else x)
        if pol.downcasts_output:
            x = x.float()
        return x, new_state, new_carries

    # ----------------------------------------------------------------- loss
    def _loss_fn(self, params, net_state, features, labels, features_mask,
                 labels_mask, rng, train: bool, carries=None,
                 from_layer: int = 0, per_example: bool = False):
        """Data loss, new layer state and new carries.  Regularization is
        added to the reported score only, and to the gradient by the
        updater, in DL4J order.  ``from_layer`` scores a mid-stack
        activation through the remaining layers (the tBPTT suffix).  A
        head with ``NEEDS_INPUT_FOR_SCORE`` (center loss) scores against
        its input, after its preprocessor and its dropout."""
        out_layer = self.layers[-1]
        if getattr(out_layer, "NEEDS_INPUT_FOR_SCORE", False):
            n = len(self.layers)
            x, new_state, new_carries = self._forward(
                params, net_state, features, train=train, rng=rng,
                mask=features_mask, carries=carries, to_layer=n - 2,
                from_layer=from_layer)
            if (n - 1) in self.conf.input_preprocessors:
                x = self.conf.input_preprocessors[n - 1](x)
            x = out_layer.apply_dropout(x, train, rng)
            if per_example:
                loss = out_layer.compute_score_examples_with_input(
                    params[n - 1], labels, x, labels_mask)
            else:
                loss = out_layer.compute_score_with_input(
                    params[n - 1], labels, x, labels_mask,
                    average=self.conf.conf.mini_batch)
            return loss, new_state, new_carries
        if not hasattr(out_layer, "compute_score"):
            raise ValueError("Last layer must be an output/loss layer to "
                             "fit()")
        preout, new_state, new_carries = self._forward(
            params, net_state, features, train=train, rng=rng,
            mask=features_mask, carries=carries, from_layer=from_layer,
            preoutput_last=True)
        lmask = labels_mask
        if lmask is None and features_mask is not None and preout.dim() == 3:
            lmask = features_mask   # per-timestep output: features mask
        if per_example:
            loss = out_layer.compute_score_examples(labels, preout, lmask)
        else:
            loss = out_layer.compute_score(labels, preout, lmask,
                                           average=self.conf.conf.mini_batch)
        return loss, new_state, new_carries

    # ------------------------------------------------------------- training
    def _batch(self, ds: DataSet):
        return (self._tensor(ds.features),
                self._tensor(ds.labels, self._label_dtype()),
                self._tensor(ds.features_mask, torch.float32),
                self._tensor(ds.labels_mask, torch.float32))

    def _batches(self, data, labels):
        if labels is not None:
            data = DataSet(data, labels)
        return [data] if isinstance(data, DataSet) else data

    def _step_batch(self, fs, ls, fms, lms):
        return (fs[0], ls[0], None if fms is None else fms[0],
                None if lms is None else lms[0])

    def _window_item(self, ds):
        return ds

    def _window_sig(self, item):
        return _ingest.window_signature(item)

    def _window_stack(self, items, pin: bool, wires=None):
        f, l, fm, lm = _ingest.stack_window(
            items, pin, wired=wires is not None and wires[0] is not None)
        return ([f], [l], None if fm is None else [fm],
                None if lm is None else [lm])

    def _window_wires(self, items):
        return (_ingest.window_wire_spec(items),)

    def _pretrain_features(self, ds):
        return self._tensor(ds.features)

    def _pretrain_input(self, key, features) -> Tensor:
        x, _, _ = self._forward(self.params, self.net_state, features,
                                train=False, rng=None, to_layer=key - 1)
        if key in self.conf.input_preprocessors:
            x = self.conf.input_preprocessors[key](x)
        return x

    # ---------------------------------------------------------------- tBPTT
    @staticmethod
    def _last_stateful_recurrent(carries) -> int:
        """Index of the deepest layer whose carry is not ``()`` (-1 if
        none): the tBPTT split point.  A time-distributed head such as
        RnnOutputLayer carries ``()`` and sits in the suffix."""
        return max((i for i, c in enumerate(carries) if len(c)), default=-1)

    def _tbptt_window_loss(self, adv: int, carries):
        """Loss closure for ONE truncated-BPTT window with ``carries`` in
        (detached at the window boundary): ``loss(p, ns, f, l, fm, lm, r)
        -> (loss, new_state, new_carries)``.

        ``adv`` > 0 is ``tbptt_back_length`` < the window: the leading
        ``adv`` steps run through the recurrent trunk without gradient,
        and the layers above the trunk still score them, so those layers
        learn from ALL window steps while the trunk sees only the trailing
        ``back`` steps (the reference's per-layer truncation)."""
        carries = _detached(carries)
        last_rec = self._last_stateful_recurrent(carries)

        def loss(p, ns, f, l, fm, lm, r):
            if adv == 0:
                return self._loss_fn(p, ns, f, l, fm, lm, r, True,
                                     carries=carries)
            fm_a = None if fm is None else fm[:, :adv]
            fm_b = None if fm is None else fm[:, adv:]
            lm_a = None if lm is None else lm[:, :adv]
            lm_b = None if lm is None else lm[:, adv:]
            with torch.no_grad():   # leading steps: trunk, no gradient
                trunk, _, mid = self._forward(
                    p, ns, f[:, :adv], train=True, rng=r, mask=fm_a,
                    carries=carries, to_layer=last_rec)
            loss_a, _, _ = self._loss_fn(p, ns, trunk, l[:, :adv], fm_a,
                                         lm_a, r, True,
                                         from_layer=last_rec + 1)
            loss_b, new_state, new_carries = self._loss_fn(
                p, ns, f[:, adv:], l[:, adv:], fm_b, lm_b, r, True,
                carries=mid)
            # a masked score averages over its segment's own mask count;
            # recombine so that the window averages over ALL its active
            # steps, as the adv == 0 path does
            eff_a = lm_a if lm_a is not None else fm_a
            eff_b = lm_b if lm_b is not None else fm_b
            if (self.conf.conf.mini_batch and eff_a is not None
                    and eff_b is not None):
                ca, cb = eff_a.sum(), eff_b.sum()
                total = (loss_a * ca + loss_b * cb) / torch.clamp_min(
                    ca + cb, 1.0)
                return total, new_state, new_carries
            return loss_a + loss_b, new_state, new_carries

        return loss

    def _fit_tbptt(self, features, labels, fmask, lmask) -> None:
        """Slice the time axis into ``tbptt_fwd_length`` windows, one
        update per window, carrying the recurrent state forward across
        windows (detached at each boundary).  The carries start from zero
        for each new minibatch; the score is the last window's."""
        self._require_carry_support("truncated BPTT")
        if labels.dim() < 3:
            raise ValueError(
                "Truncated BPTT needs per-timestep labels (batch, time, "
                f"...); got shape {tuple(labels.shape)}. Use standard "
                "backprop for sequence-level labels.")
        window = self.conf.tbptt_fwd_length
        back = self.conf.tbptt_back_length or window
        if back > window:
            raise ValueError(
                f"tbptt_back_length ({back}) > tbptt_fwd_length "
                f"({window}) is not meaningful")
        carries = self._init_carries(features.shape[0])
        for start in range(0, features.shape[1], window):
            sl = slice(start, start + window)
            f, l = features[:, sl], labels[:, sl]
            fm = None if fmask is None else fmask[:, sl]
            lm = None if lmask is None else lmask[:, sl]
            loss = self._tbptt_window_loss(max(0, f.shape[1] - back),
                                           carries)
            carries = self._update(lambda p, s: loss(
                p, s, f, l, fm, lm, self._rng))

    # ------------------------------------------------------------ inference
    def output(self, features, train: bool = False,
               features_mask=None) -> Tensor:
        """Forward pass (inference tier unless ``train``); a tensor on the
        network's device, fp32 under the mixed policy."""
        self.init()
        with torch.no_grad():
            out, _, _ = self._forward(
                self.params, self.net_state, self._tensor(features),
                train=train, rng=self._rng if train else None,
                mask=self._tensor(features_mask, torch.float32))
        return out

    def feed_forward(self, features) -> List[Tensor]:
        """Every layer's activation in inference mode (reference
        ``feedForward``), each as ``output`` returns its last one; one
        pass through the layers."""
        self.init()
        acts: List[Tensor] = []
        with torch.no_grad():
            self._forward(self.params, self.net_state,
                          self._tensor(features), train=False, rng=None,
                          acts=acts)
        return acts

    def predict(self, features) -> Tensor:
        """Argmax class indices (reference ``predict``)."""
        return self.output(features).argmax(-1)

    def compile_output(self, feature_shape, mask_shape=None, params=None,
                       net_state=None):
        """The inference forward for ONE input shape: the serving bucket
        primitive (``serving.InferenceEngine`` makes one per (batch
        bucket, timestep bucket) at ``warmup``).  Eager PyTorch compiles
        nothing ahead of time; the callable checks its inputs against the
        bucket and runs under ``torch.inference_mode()``.

        Call it as ``fn(params, net_state, features, features_mask)``
        with arrays of exactly ``feature_shape`` (and ``mask_shape``;
        ``None`` for the mask iff ``mask_shape`` was ``None``); it returns
        the output tensor on the device of ``params``.  ``params``/
        ``net_state`` here only fix that device (default: the network's);
        each call passes its own, so one callable serves any copy of the
        weights on that device.  Each callable made counts once in
        ``jit_compiles_total{fn="mln.output"}`` (``monitor.jit_watch``),
        as each of the JAX package's bucket executables does."""
        self.init()
        shape = tuple(int(d) for d in feature_shape)
        mshape = (None if mask_shape is None
                  else tuple(int(d) for d in mask_shape))
        with _monitor.jit_watch.compiling(
                "mln.output", signature=f"features={shape}; mask={mshape}"):
            self._check_feature_shape(shape)
            return self._bucket_callable(shape, mshape, params)

    def _check_feature_shape(self, shape) -> None:
        """Raise ``TypeError`` when features of ``shape`` cannot feed the
        first layer (see :func:`feature_widths`).  Bucket callables and
        session steps both check, so a serving request of that shape
        answers 400 on either path, as the JAX package's does (XLA's
        ``dot_general`` check when a bucket is lowered, the LSTM einsum's
        ``ValueError`` in a step)."""
        check_feature_width(shape, feature_widths(
            self.conf.input_type, self.layers[0],
            0 in self.conf.input_preprocessors))

    def _bucket_callable(self, shape, mshape, params):
        ref = next((p for tree in (params if params is not None
                                   else self.params) for p in tree.values()),
                   None)
        device = ref.device if ref is not None else self.device

        def run(params, net_state, features, features_mask=None):
            if tuple(features.shape) != shape:
                raise ValueError(f"features of shape {tuple(features.shape)}"
                                 f" for the bucket {shape}")
            got = (None if features_mask is None
                   else tuple(features_mask.shape))
            if got != mshape:
                raise ValueError(f"mask of shape {got} for the bucket "
                                 f"{mshape}")
            with torch.inference_mode():
                x = torch.as_tensor(features, device=device)
                m = (None if features_mask is None
                     else torch.as_tensor(features_mask, device=device))
                out, _, _ = self._forward(params, net_state, x, train=False,
                                          rng=None, mask=m)
            return out

        return run

    # --------------------------------------------- rnn streaming state API
    def _init_carries(self, batch: int, cache_len: Optional[int] = None):
        """Zero carries, one entry per layer (``()`` if stateless), in the
        compute dtype on the network's device.  ``cache_len`` overrides
        the KV-ring capacities (the serving cache-len ladder)."""
        return [self._carry_of(layer, batch, cache_len)
                if isinstance(layer, BaseRecurrentLayer) else ()
                for layer in self.layers]

    def _carried_step(self, params, net_state, carries, x):
        with torch.inference_mode():
            out, _, new_carries = self._forward(
                params, net_state, self._tensor(x), train=False, rng=None,
                carries=carries)
        return out, new_carries

    def rnn_time_step(self, features) -> Tensor:
        """Stateful streaming inference (reference ``rnnTimeStep``): feeds
        one or more timesteps, carrying state between calls in the
        network's own slot.  2-D input (batch, features) is one timestep
        and returns (batch, n_out); 3-D input returns (batch, time,
        n_out)."""
        self.init()
        self._require_carry_support("rnn_time_step")
        x = self._tensor(features)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        self._check_carry_batch(x.shape[0])
        out, self._rnn_carries = self._carried_step(
            self.params, self.net_state, self._rnn_carries, x)
        return out[:, -1] if squeeze else out

    def rnn_stateless_step(self, carries, features, params=None,
                           net_state=None):
        """Explicit-carry streaming step: advance ``carries`` by the input
        timesteps and return ``(out, new_carries)`` without touching the
        network's own state slot, so sessions can share one network.
        ``carries=None`` starts from zero state; the carries passed in are
        never written.  3-D ``(batch, time, n_in)`` features only.
        ``params``/``net_state`` override the weights (a session pinned
        to a weight version)."""
        self.init()
        self._require_carry_support("rnn_stateless_step")
        return self._explicit_step("rnn_stateless_step", carries, features,
                                   params, net_state)

    def decode_step(self, carries, features, params=None, net_state=None):
        """Autoregressive decode step: :meth:`rnn_stateless_step` over any
        per-layer state, KV-cache rings included.  Returns ``(out,
        new_carries)``; N single-token calls match one full-sequence
        ``output()`` (the fp32-logits contract included).
        ``carries=None`` starts a fresh state (ring capacity from the
        layers' ``cache_len``).  3-D features only."""
        self.init()
        self._require_carry_support("decode_step")
        return self._explicit_step("decode_step", carries, features,
                                   params, net_state)

    def _explicit_step(self, what, carries, features, params, net_state):
        x = self._tensor(features)
        if x.dim() != 3:
            raise ValueError(f"{what} expects (batch, time, features), got "
                             f"shape {tuple(x.shape)}")
        self._check_feature_shape(tuple(x.shape))
        if carries is None:
            carries = self._init_carries(int(x.shape[0]))
        return self._carried_step(
            self.params if params is None else params,
            self.net_state if net_state is None else net_state, carries, x)

    def grow_decode_carries(self, carries, cache_len: int):
        """Pad every KV ring in ``carries`` up to ``cache_len`` slots
        (other carries pass through): the serving cache-len bucket hop.
        Slots past the cursor are masked to exact zeros, so growth never
        changes results.  The first growth at each (carry shapes,
        cache_len) counts as a build of ``mln.decode_grow`` in the compile
        watch, later ones as cache hits."""
        self.init()
        cache_len = int(cache_len)
        grow = self._decode_grow.get(cache_len)
        if grow is None:
            def grow_to(carries):
                with torch.inference_mode():
                    return [layer.grow_carry(carries[i], cache_len)
                            if getattr(layer, "HAS_KV_RING", False)
                            else carries[i]
                            for i, layer in enumerate(self.layers)]
            grow = self._decode_grow[cache_len] = \
                _monitor.jit_watch.WatchedCall(grow_to,
                                               name="mln.decode_grow")
        return grow(carries)

    @functools.cached_property
    def _decode_grow(self) -> Dict[int, Any]:
        # one watched growth function per cache length, as the JAX
        # package keeps one jitted function per target
        return {}

    def rnn_get_previous_state(self, layer: int):
        """Carry of one layer (reference ``rnnGetPreviousState``)."""
        return (None if self._rnn_carries is None
                else self._rnn_carries[layer])

    def rnn_set_previous_state(self, layer: int, state) -> None:
        if self._rnn_carries is None:
            raise ValueError("No rnn state yet; call rnn_time_step first")
        self._rnn_carries[layer] = state

    def score(self, dataset: Optional[DataSet] = None) -> float:
        """Mean loss (+ regularization) on ``dataset``; without one, the
        score of the last training batch."""
        if dataset is None:
            return float("nan") if self._score is None else \
                float(self._score)
        self.init()
        features, labels, fmask, lmask = self._batch(dataset)
        with torch.no_grad():
            loss, _, _ = self._loss_fn(self.params, self.net_state,
                                       features, labels, fmask, lmask, None,
                                       False)
            return float(loss + self._reg_score(self.params))

    def score_examples(self, data: DataSet,
                       add_regularization_terms: bool = True) -> Tensor:
        """Per-example loss vector (batch,), no batch averaging."""
        self.init()
        features, labels, fmask, lmask = self._batch(data)
        with torch.no_grad():
            per, _, _ = self._loss_fn(self.params, self.net_state,
                                      features, labels, fmask, lmask, None,
                                      False, per_example=True)
            if add_regularization_terms:
                per = per + self._reg_score(self.params)
        return per

    # ----------------------------------------------------------- evaluation
    def do_evaluation(self, iterator, *evaluators):
        """One forward pass per batch feeding every evaluator (reference
        ``doEvaluation``); a time-series output goes through the masked
        ``eval_time_series`` route.  Returns the evaluators.

        When every evaluator is a top-1 ``Evaluation``, the argmax runs on
        the device after the forward and only int32 class indices cross to
        the host; the labels' argmax and the mask filter stay on the host.
        The ``eval_bytes_transferred`` gauge holds the bytes the last call
        moved from the device."""
        self.init()
        fast = self._fast_eval(evaluators)
        bytes_moved = 0
        for ds in self._eval_batches(iterator):
            labels = _host(ds.labels)
            mask = (ds.labels_mask if ds.labels_mask is not None
                    else ds.features_mask)
            mask = None if mask is None else _host(mask)
            if fast:
                with torch.no_grad():
                    out, _, _ = self._forward(
                        self.params, self.net_state,
                        self._tensor(ds.features), train=False, rng=None,
                        mask=self._tensor(ds.features_mask, torch.float32))
                    guess = out.argmax(-1).to(torch.int32).cpu().numpy()
                bytes_moved += guess.nbytes
                self._feed_evaluators(evaluators, True, labels, mask,
                                      guess=guess)
                continue
            out = self.output(ds.features, features_mask=ds.features_mask)
            bytes_moved += out.numel() * out.element_size()
            self._feed_evaluators(evaluators, False, labels, mask,
                                  out=out.cpu().numpy())
        self._publish_eval_bytes(bytes_moved, fast)
        return evaluators

    def f1_score(self, data) -> float:
        """Macro F1 on a DataSet or an iterator (reference ``f1Score``)."""
        return self.evaluate(data).f1()


def _iterations():
    return _monitor.counter("train_iterations_total",
                            "supervised train iterations")


def _flat_leaves(net, trees) -> List[Tensor]:
    """Param leaves of ``trees`` in flat-parameter order."""
    return [p for _, tree in net._items(trees) for p in tree.values()]


def _stacked(hvecs) -> Optional[Tensor]:
    """The steps' health vectors as one (S, 2+3L) stack, or None when the
    steps computed none."""
    return torch.stack(hvecs) if hvecs and hvecs[0] is not None else None


def _mask_presence(item, which: str):
    """Which inputs of a DataSet or MultiDataSet carry a mask."""
    if isinstance(item, DataSet):
        return (item.features_mask if which == "features_masks"
                else item.labels_mask) is not None
    masks = getattr(item, which)
    return None if masks is None else tuple(m is not None for m in masks)


def feature_widths(input_type, layer, preprocessed: bool):
    """The last-axis widths a network input may have: those of its input
    type, else the ``n_in`` of the layer it feeds when no preprocessor
    stands between them; ``None`` when neither says (no type and no
    ``n_in``, or an embedding, whose indices carry no width)."""
    if input_type is not None:
        return {"ff": (input_type.flat_size(),),
                "recurrent": (input_type.flat_size(),),
                "cnn": (getattr(input_type, "channels", 0),),
                "cnn_flat": (input_type.flat_size(),
                             getattr(input_type, "channels", 0))
                }.get(input_type.kind)
    n_in = int(getattr(layer, "n_in", 0) or 0)
    if preprocessed or n_in <= 0 or isinstance(layer, EmbeddingLayer):
        return None
    return (n_in,)


def check_feature_width(shape, widths) -> None:
    """Raise ``TypeError`` unless ``shape``'s last axis is one of
    ``widths`` (``None``: nothing to check)."""
    if widths is not None and (len(shape) < 2 or shape[-1] not in widths):
        raise TypeError(
            f"features of shape {tuple(shape)} cannot feed the network: "
            f"the last axis must be {' or '.join(map(str, widths))}")


def _host(a) -> np.ndarray:
    """``a`` (numpy or a tensor on any device) as host numpy."""
    return a.detach().cpu().numpy() if isinstance(a, Tensor) else \
        np.asarray(a)


def _cloned(tree):
    """Nested lists and dicts with every tensor cloned."""
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cloned(v) for v in tree]
    return tree.clone() if isinstance(tree, Tensor) else copy.deepcopy(tree)


def _detached(tree):
    """A carry tree (nested lists, tuples and dicts) with every tensor
    detached; other leaves (a ring cursor) pass through."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(t) for t in tree)
    return tree.detach() if isinstance(tree, Tensor) else tree


def _sorted_leaves(tree):
    """Tensor leaves of nested dicts in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _sorted_leaves(tree[key])
    elif isinstance(tree, Tensor):
        yield tree


def _map_sorted_leaves(tree, fn, skip=()):
    """``tree`` with each leaf replaced by ``fn(leaf)``, called in
    ``_sorted_leaves`` order; top-level keys in ``skip`` are kept as
    they are."""
    if isinstance(tree, Tensor):
        return fn(tree)
    out = {key: (tree[key] if key in skip
                 else _map_sorted_leaves(tree[key], fn))
           for key in sorted(tree)}
    return {key: out[key] for key in tree}
