"""Overlapped ingest for ``fit(iterator)``: the device-resident epoch cache
and windowed staging (port of ``deeplearning4j_tpu/nn/ingest.py``).

1. **Device-resident epoch cache** — a dataset that fits the card is
   uploaded ONCE and stays resident across epochs and ``fit`` calls; each
   epoch's permutation is drawn ON the device (:func:`epoch_permutation`)
   and every step gathers its minibatch with ``index_select`` from the
   resident arrays, so steady-state epochs copy zero bytes from host to
   device.  On the card the gather step is captured once per batch shape
   as a CUDA graph and replayed once a step (``nn/step_graph.py``, the
   port's analogue of the JAX package's one ``lax.scan`` per fused
   epoch); consecutive epochs fuse into one dispatch (bounded by
   :func:`max_steps_per_dispatch`) when no listener needs per-epoch
   callbacks and there is no tail batch.
2. **Windowed staging** — other iterators stream in multi-batch windows:
   the host stacks window k+1 into pinned memory and copies it with
   ``non_blocking=True`` on a side stream while window k trains; an event
   orders the copy before its use.

Both ship the **uint8 wire** when the source carries one
(``datasets/dataset.attach_wire``) or when the iterator's preprocessor is
an affine pixel scaler over uint8 features (:func:`cacheable_source`,
:func:`wire_source`): 1 byte a pixel instead of 4, and the
``f32(u8) / denom * mult + add`` decode runs on the device
(:func:`device_decode`) in numpy's op order, bit-exact with the host's
float32 path (``DL4J_TPU_WIRE_UINT8=0`` is the escape hatch).

Both keep per-iteration listener semantics by REPLAY: a dispatch returns
its per-step scores in one device tensor, read once, and the listeners
fire once per iteration with that step's score (the params a replayed
listener sees are those at the end of the dispatch, as in the JAX
package).

Deliberate difference: the JAX package draws each epoch's permutation
from threefry ``fold_in(key, epoch)``, which torch cannot reproduce; the
port draws ``torch.randperm`` from a generator on the network's device
seeded by the network's seed and the epoch.  Both are deterministic
across ``fit`` calls and re-derivable on resume; batch boundaries (the
tail batch included) and the per-iteration updater and dropout streams
are those of the per-batch path.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import monitor as _monitor
from ..datasets.dataset import attach_wire, wire_enabled, wire_of

#: Datasets larger than this (features + labels bytes) never
#: device-cache.  The JAX package's default, 2 GB.
DEVICE_CACHE_LIMIT_BYTES = int(os.environ.get(
    "DL4J_TPU_DEVICE_CACHE_LIMIT", 2_000_000_000))

#: integer features and labels (token ids, class indices) go as they are:
#: no float cast, so an id past 2**8 keeps every bit
_CACHEABLE_DTYPES = ("float32", "bfloat16", "int32", "int64")
_STAGED_HELP = "bytes uploaded to the device per staging event"
_WINDOW_BATCHES_HELP = ("batches staged by the windowed fit, by the wire "
                        "their features went as")


def max_steps_per_dispatch() -> int:
    """Upper bound on the steps folded into ONE epoch-cache dispatch
    (``DL4J_TPU_MAX_STEPS_PER_DISPATCH``, default 1024): it bounds the
    score stack and how far listeners can lag behind the card."""
    return int(os.environ.get("DL4J_TPU_MAX_STEPS_PER_DISPATCH", 1024))


def _dtype_name(a) -> str:
    """numpy's dtype name of an array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).rsplit(".", 1)[-1]
    return np.asarray(a).dtype.name


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return np.asarray(a).nbytes


def _scaler_wire(preprocessor, features):
    """(u8, fmt) when ``preprocessor`` is an affine pixel scaler over
    uint8 features (the one preprocessor the device decode reproduces
    bit-exactly), else None."""
    from ..datasets.normalizers import wire_format_of
    if preprocessor is None or _dtype_name(features) != "uint8":
        return None
    fmt = wire_format_of(preprocessor)
    return None if fmt is None else (np.asarray(features), fmt)


def _list_source(iterator):
    """The exact ``ListDataSetIterator`` that serves ``iterator``, else
    None: the iterator itself, or the one inside an
    ``AsyncDataSetIterator`` without a preprocessor of its own.  A
    subclass overriding ``__next__``/``reset`` keeps its override by
    falling back."""
    from ..datasets.iterators import (AsyncDataSetIterator,
                                      ListDataSetIterator)
    u = iterator
    if isinstance(u, AsyncDataSetIterator):
        if u.get_preprocessor() is not None:
            return None
        u = u._under
    if not isinstance(u, ListDataSetIterator):
        return None
    if (type(u).__next__ is not ListDataSetIterator.__next__
            or type(u).reset is not ListDataSetIterator.reset):
        return None
    return u


def cacheable_source(iterator):
    """The underlying ``ListDataSetIterator`` when ``iterator`` can be
    served by the device-resident epoch cache, else None.

    Exact ``ListDataSetIterator`` semantics only (:func:`_list_source`),
    dense float32/bfloat16 or int32/int64 features and labels (integers
    are uploaded and gathered as they are), no masks, total bytes
    under :data:`DEVICE_CACHE_LIMIT_BYTES`.  A preprocessor disqualifies,
    with ONE exception: an affine pixel scaler
    (``ImagePreProcessingScaler``) over uint8 features, whose transform
    is the wire decode (wire enabled only)."""
    u = _list_source(iterator)
    if u is None:
        return None
    ds = u._ds
    if ds.features is None or ds.labels is None:
        return None
    if ds.features_mask is not None or ds.labels_mask is not None:
        return None
    f, l = ds.features, ds.labels
    if u.get_preprocessor() is not None:
        if not (wire_enabled()
                and _scaler_wire(u.get_preprocessor(), f) is not None):
            return None
    elif _dtype_name(f) not in _CACHEABLE_DTYPES:
        return None
    if _dtype_name(l) not in _CACHEABLE_DTYPES:
        return None
    if _nbytes(f) + _nbytes(l) > DEVICE_CACHE_LIMIT_BYTES:
        return None
    return u


def wire_source(iterator):
    """``(list_iterator, WireFormat)`` when the windowed path can draw
    ``iterator``'s batches as raw uint8 rows and decode them on the
    device, else None: the exact ``ListDataSetIterator`` of
    :func:`_list_source` whose preprocessor is an affine pixel scaler
    (``normalizers.wire_format_of``) over uint8 features, wire enabled.
    No size limit: this is the path of datasets the cache refuses."""
    u = _list_source(iterator)
    if u is None or not wire_enabled() or u._ds.features is None:
        return None
    wire = _scaler_wire(u.get_preprocessor(), u._ds.features)
    return None if wire is None else (u, wire[1])


def wired_epoch(u, fmt):
    """One epoch of ``u``'s batches before its preprocessor, each carrying
    its own uint8 features as the wire twin in ``fmt`` (the scaler's
    transform, decoded on the device).  ``u`` goes through the state
    transitions of the float32 path: the explicit ``reset()`` and
    ``__iter__``'s, then ``next_raw`` until the epoch ends, so its epoch
    count, permutation and position are those ``fit`` leaves behind on
    that path."""
    u.reset()
    u.reset()

    def draw():
        while True:
            try:
                ds = u.next_raw()
            except StopIteration:
                return
            yield attach_wire(ds, ds.features, fmt)
    return draw()


def _to_device(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def device_cached_arrays(model, ds, preprocessor=None) -> Tuple:
    """``(dev_features, dev_labels, wire_spec)``: device copies of ``ds``
    that stay resident ACROSS ``fit`` calls.

    With a uint8 wire twin on ``ds`` (or an affine pixel scaler over
    uint8 features) and the wire enabled, the UINT8 buffer is what is
    uploaded and ``wire_spec`` is the ``(denom, mult, add)`` triple whose
    :func:`device_decode` reproduces the float32 features bit-exactly;
    else the features go as they are and ``wire_spec`` is None.

    The cache lives on the model, keyed by host-array identity and the
    wire decision: assigning new arrays re-uploads; mutating the same
    arrays in place between fits is not detected (a dataset is immutable
    while training on it).  The ``ingest_staged_bytes{path="cache"}``
    gauge holds the bytes of the last upload."""
    f, l = ds.features, ds.labels
    wire = None
    if wire_enabled():
        w = wire_of(ds)
        if w is not None and tuple(w[0].shape) == tuple(f.shape):
            wire = w
        else:
            wire = _scaler_wire(preprocessor, f)
    fmt = None if wire is None else wire[1]
    cache = getattr(model, "_ingest_device_cache", None)
    if (cache is not None and cache[0] is f and cache[1] is l
            and cache[2] == fmt):
        return cache[3], cache[4], cache[5]
    model._ingest_device_cache = None      # free the old copy first
    if wire is not None:
        dev_f = _to_device(wire[0], model.device)
        wire_spec = fmt.as_tuple()
    else:
        dev_f = _to_device(f, model.device)
        wire_spec = None
    dev_l = _to_device(l, model.device)
    _monitor.gauge("ingest_staged_bytes", _STAGED_HELP).set(
        _nbytes(dev_f) + _nbytes(dev_l), path="cache")
    model._ingest_device_cache = (f, l, fmt, dev_f, dev_l, wire_spec)
    return dev_f, dev_l, wire_spec


def device_decode(f: torch.Tensor, wire) -> torch.Tensor:
    """The on-device wire decode ``f32(u8) / denom * mult + add``, all
    three ops always (``/1.0``, ``*1.0`` and ``+0.0`` are exact on the
    non-negative pixel range).  The op order is the host readers' numpy
    float32 arithmetic (``u8.astype(f32) / 255.0``;
    ``ImagePreProcessingScaler.transform``), and each op rounds to nearest
    even in float32 on both sides: the wire-vs-float32 parity.  ``wire``
    is a ``(denom, mult, add)`` triple, or None for pass-through.  The
    divisor is a 0-dim tensor on ``f``'s device: PyTorch's CUDA division
    by a host scalar multiplies by its reciprocal, which is not the
    correctly rounded quotient numpy computes."""
    if wire is None:
        return f
    denom, mult, add = wire
    f = f.to(torch.float32)
    return f / f.new_full((), denom) * mult + add


def consume_epoch(u) -> None:
    """Advance ``u`` through one epoch's state transitions without
    building a batch: the two resets the per-batch ``fit(iterator)`` path
    makes (the explicit ``reset()`` and ``__iter__``'s), then the
    iterator is marked consumed, so observers and a later per-batch fit
    see the same iterator state.  The ORDER of the cache path comes from
    :func:`epoch_permutation`, not from the iterator's host RNG."""
    u.reset()
    u.reset()
    u._pos = u._ds.num_examples()


def epoch_index_batches(order: np.ndarray,
                        batch: int) -> List[np.ndarray]:
    """Split an epoch permutation into (S, B) full-batch indices plus an
    optional (1, tail) remainder: the batch boundaries of
    ``ListDataSetIterator.__next__``."""
    n = order.shape[0]
    s, tail = divmod(n, batch)
    out = []
    if s:
        out.append(order[:s * batch].reshape(s, batch).astype(np.int32))
    if tail:
        out.append(order[s * batch:].reshape(1, tail).astype(np.int32))
    return out


def epoch_permutation(seed: int, epoch: int, n: int, shuffle: bool,
                      device) -> torch.Tensor:
    """The cache path's example order for ``epoch``: ``torch.randperm``
    drawn on ``device`` from a generator seeded by the network's ``seed``
    and the epoch (``arange`` without shuffle).  Deterministic across
    ``fit`` calls, so a resumed epoch re-derives it."""
    device = torch.device(device)
    if not shuffle:
        return torch.arange(n, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(epoch)) % (1 << 63))
    return torch.randperm(n, generator=gen, device=device)


def window_signature(ds) -> Tuple:
    """Shape and mask-presence signature of a DataSet; a window only
    stacks batches with equal signatures (a change flushes the window)."""
    def shp(a):
        return None if a is None else tuple(a.shape)
    return (shp(ds.features), shp(ds.labels), shp(ds.features_mask),
            shp(ds.labels_mask))


def multi_window_signature(mds) -> Tuple:
    """Signature of a MultiDataSet (lists of inputs, labels and masks)."""
    def shps(seq):
        if seq is None:
            return None
        return tuple(None if a is None else tuple(a.shape) for a in seq)
    return (shps(mds.features), shps(mds.labels),
            shps(mds.features_masks), shps(mds.labels_masks))


def _stack(arrays, pin: bool = False) -> torch.Tensor:
    """Host (W, B, ...) stack of numpy arrays or host tensors; with
    ``pin``, written straight into pinned (page-locked) memory."""
    parts = [a if isinstance(a, torch.Tensor)
             else torch.from_numpy(np.asarray(a)) for a in arrays]
    if not pin:
        return torch.stack(parts)
    out = torch.empty((len(parts),) + tuple(parts[0].shape),
                      dtype=parts[0].dtype, pin_memory=True)
    return torch.stack(parts, out=out)


def _multi_wire_of(mds, i: int):
    """The uint8 twin of input ``i`` of a MultiDataSet (the per-input
    ``_wires`` list ``computation_graph._as_multi`` sets), or None."""
    wires = getattr(mds, "_wires", None)
    return None if wires is None or len(wires) <= i else wires[i]


def stack_window(batches, pin: bool = False, wired: bool = False) -> Tuple:
    """Stack a window of same-signature DataSets into host (W, B, ...)
    tensors (pinned with ``pin``): (features, labels, fmask, lmask).
    With ``wired`` (:func:`window_wire_spec` accepted the window) the
    features stack is the batches' uint8 wire twins, not their
    features."""
    features = _stack([wire_of(b)[0] if wired else b.features
                       for b in batches], pin)
    labels = _stack([b.labels for b in batches], pin)
    fm = (None if batches[0].features_mask is None else
          _stack([b.features_mask for b in batches], pin))
    lm = (None if batches[0].labels_mask is None else
          _stack([b.labels_mask for b in batches], pin))
    return features, labels, fm, lm


def stack_multi_window(mbs, pin: bool = False, wires=None) -> Tuple:
    """:func:`stack_window` for MultiDataSets: per-input stacked lists;
    an input whose entry of ``wires`` (:func:`multi_window_wire_specs`)
    is not None stacks its uint8 wire twins."""
    n_in = len(mbs[0].features)
    n_out = len(mbs[0].labels)
    features = [_stack([_multi_wire_of(m, i)[0]
                        if wires is not None and wires[i] is not None
                        else m.features[i] for m in mbs], pin)
                for i in range(n_in)]
    labels = [_stack([m.labels[i] for m in mbs], pin)
              for i in range(n_out)]

    def masks(get, count):
        if all(get(m) is None for m in mbs):
            return None
        out = []
        for i in range(count):
            if get(mbs[0]) is None or get(mbs[0])[i] is None:
                out.append(None)
            else:
                out.append(_stack([get(m)[i] for m in mbs], pin))
        return out

    fmasks = masks(lambda m: m.features_masks, n_in)
    lmasks = masks(lambda m: m.labels_masks, n_out)
    return features, labels, fmasks, lmasks


def _common_wire(wires, features) -> Optional[Tuple]:
    """The ``(denom, mult, add)`` spec when every entry of ``wires`` is a
    uint8 twin of the same format and of its ``features``' shape, else
    None."""
    if any(w is None for w in wires):
        return None
    if len({w[1] for w in wires}) != 1:
        return None
    if any(tuple(w[0].shape) != tuple(f.shape)
           for w, f in zip(wires, features)):
        return None
    return wires[0][1].as_tuple()


def window_wire_spec(batches) -> Optional[Tuple]:
    """When EVERY batch of a window carries a same-format uint8 wire twin
    (and the wire is enabled): the ``(denom, mult, add)`` spec of the
    decode, and :func:`stack_window` ships the twins.  Else None."""
    if not wire_enabled():
        return None
    return _common_wire([wire_of(b) for b in batches],
                        [b.features for b in batches])


def multi_window_wire_specs(mbs) -> Tuple:
    """:func:`window_wire_spec` per input of a window of MultiDataSets:
    a per-input tuple with None for an unwired input."""
    n_in = len(mbs[0].features)
    if not wire_enabled():
        return (None,) * n_in
    return tuple(_common_wire([_multi_wire_of(m, i) for m in mbs],
                              [m.features[i] for m in mbs])
                 for i in range(n_in))


def cast_for_transfer(features: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Halve the windowed path's host-to-device bytes: when the network
    computes in bfloat16, cast float32 feature stacks on the HOST.  The
    step's first action on floating inputs is this exact cast
    (``_forward``), and both sides round to nearest even, so the numerics
    are the same.  Integer features and labels are left as they are."""
    if compute_dtype != torch.bfloat16 or features.dtype != torch.float32:
        return features
    if not features.is_pinned():
        return features.to(torch.bfloat16)
    out = torch.empty(features.shape, dtype=torch.bfloat16,
                      pin_memory=True)
    return out.copy_(features)


class ScoreReplayer:
    """Collects (start iteration, device scores) per dispatch and replays
    the listeners with per-step scores.  Reading a dispatch's scores is
    the only point that waits for the card, so dispatch k+1's host work
    overlaps dispatch k on the card."""

    def __init__(self, model):
        self._model = model
        self._pending: List[Tuple[int, torch.Tensor]] = []

    def add(self, start_iteration: int, scores: torch.Tensor) -> None:
        self._pending.append((start_iteration, scores))

    def replay(self) -> None:
        """Read the pending scores (one copy per dispatch) and fire
        ``iteration_done`` once per step with that step's score."""
        model = self._model
        for start, dev_scores in self._pending:
            scores = dev_scores.detach().cpu()
            for j in range(scores.shape[0]):
                model._score = scores[j]
                for listener in model.listeners:
                    listener.iteration_done(model, start + j + 1)
        self._pending = []

    def finish(self) -> None:
        """End-of-fit bookkeeping without listeners: leave ``_score`` as
        the last step's device scalar (``score()`` reads it on demand)."""
        if self._pending:
            self._model._score = self._pending[-1][1][-1]
            self._pending = []


class EpochBoundary:
    """The epoch bookkeeping every ``fit`` path shares (per-batch,
    windowed, epoch cache; both containers): the listeners' epoch hooks,
    the epoch count, the checkpoint cadence and saves, the fault layer's
    preemption point after each save, and the end-of-fit save.  A path
    supplies only how it trains an epoch.  ``replay`` (a
    :class:`ScoreReplayer`, None on the per-batch path) is flushed before
    listeners see an epoch end and before every save, so listener output
    never trails a checkpoint."""

    def __init__(self, model, ckpt=None, replay: Optional[ScoreReplayer] = None):
        self.model = model
        self.ckpt = ckpt
        self.replay = replay
        self._mark = model.iteration

    def _flush(self) -> None:
        """Replay the pending scores to the listeners, in a
        ``fit/listeners`` span."""
        if self.replay is not None:
            with _monitor.span("fit/listeners"):
                self.replay.replay()

    def note_steps(self) -> None:
        """Tell the checkpoint manager the steps run since the last
        note."""
        if self.ckpt is not None:
            self.ckpt.note_steps(self.model.iteration - self._mark)
        self._mark = self.model.iteration

    def save_if_due(self, step_in_epoch: int,
                    epoch_boundary: bool = False) -> None:
        if self.ckpt is not None and self.ckpt.due(
                epoch_boundary=epoch_boundary):
            self._flush()
            self.ckpt.save(self.model, step_in_epoch=step_in_epoch)

    @contextlib.contextmanager
    def epoch(self, path: str, count: int = 1, fresh: bool = True,
              **attrs):
        """One epoch (``count`` epochs fused into one dispatch) inside a
        ``fit/epoch`` trace span with attrs ``epoch``, ``path`` (the data
        path: ``"batch"``, ``"window"`` or ``"cache"``) and ``attrs``.
        The span closes after the listeners' epoch end and the epoch
        count, before the checkpoint save, as in the JAX package.  On the
        window and cache paths the score replay before the listeners'
        epoch end is the epoch's ``phase_listener_ms``.
        ``fresh=False`` (a cache epoch resumed mid-way) skips the
        listeners' epoch start."""
        from ..resilience import faults as _faults
        model = self.model
        with _monitor.span("fit/epoch", epoch=model.epoch, path=path,
                           **attrs):
            if fresh:
                for listener in model.listeners:
                    if hasattr(listener, "on_epoch_start"):
                        listener.on_epoch_start(model)
            yield
            if model.listeners and self.replay is not None:
                t0 = time.perf_counter()
                self._flush()  # waits for the card: exact per-step scores
                _monitor.observe_phase("listener", time.perf_counter() - t0)
            for listener in model.listeners:
                if hasattr(listener, "on_epoch_end"):
                    listener.on_epoch_end(model)
            model.epoch += count
        self.note_steps()
        self.save_if_due(0, epoch_boundary=True)
        _faults.maybe_die(model.iteration)

    def finish(self) -> None:
        """The end-of-fit save (when steps ran since the last one)."""
        if self.ckpt is not None:
            self._flush()
            self.ckpt.save_if_progress(self.model, step_in_epoch=0)
            self.ckpt.flush()
        if self.replay is not None:
            self.replay.finish()


def run_device_cached_fit(model, u, epochs: int, dispatch, *,
                          start_step: int = 0, ckpt=None):
    """The epoch loop of the device-resident cache fit, shared by
    ``MultiLayerNetwork`` and ``ComputationGraph``.  ``u`` is the vetted
    ``ListDataSetIterator``; ``dispatch(first_epoch, fused, tail, start,
    run)`` trains ``run`` full-batch steps from step ``start`` of each of
    ``fused`` consecutive epochs (or, with ``tail > 0``, the epoch's tail
    batch) and returns the per-step scores on the device.

    One dispatch per epoch normally; when no listener is attached, the
    batch divides the dataset (no tail) and no step-cadence checkpoint is
    active, up to :func:`max_steps_per_dispatch` steps' worth of
    CONSECUTIVE epochs fold into one dispatch.  A tail batch runs as its
    own 1-step dispatch (the same permutation's last ``tail`` entries),
    keeping the per-batch path's batch boundaries.

    Resilience: ``start_step`` (a restored checkpoint's
    ``step_in_epoch``) starts the FIRST epoch at that step, over the same
    permutation, so the split epoch trains the step sequence an
    uninterrupted run would have.  ``ckpt`` (a
    ``resilience.CheckpointManager``) bounds dispatch chunks to its step
    cadence, saves when due and gives the fault layer its preemption
    point *after* each save (:class:`EpochBoundary`).

    Under the armed dispatch sanitizer each ``dispatch`` is one dispatch
    of ``<mln|cg>.gather_train_step``, and the clean path (neither resumed
    nor checkpointed by steps) is one ``fit.epoch_cache`` scenario per
    fused group: ``units`` the fused epochs, ``extra`` 1 for the tail
    batch, as in the JAX package."""
    from ..resilience import faults as _faults
    from .step_graph import gather_step_name

    replay = ScoreReplayer(model)
    bound = EpochBoundary(model, ckpt, replay)
    iters = _monitor.counter("train_iterations_total",
                             "supervised train iterations")
    n = u._ds.num_examples()
    batch = u._batch
    steps, tail = divmod(n, batch)
    fuse_cap = max(1, max_steps_per_dispatch() // max(1, steps))
    pos = int(start_step)
    if pos < 0 or pos >= steps:
        pos = 0
    step_cadence = (getattr(ckpt, "every_steps", None)
                    if ckpt is not None else None)

    name = gather_step_name(model)
    raw_dispatch = dispatch

    def dispatch(first_epoch, fused, tail_rows, start, run):
        with _monitor.span("fit/dispatch",
                           steps=1 if tail_rows else fused * run,
                           rows=tail_rows or fused * run * batch), \
                _monitor.jit_watch.dispatching(name):
            return raw_dispatch(first_epoch, fused, tail_rows, start, run)

    def ran(scores, count, batch_rows):
        replay.add(model.iteration, scores)
        iters.inc(count)
        model.iteration += count
        model.last_batch_size = batch_rows
        bound.note_steps()

    done = 0
    while done < epochs:
        fuse = 1
        if (not model.listeners and tail == 0 and steps > 0 and pos == 0
                and step_cadence is None):
            fuse = min(epochs - done, fuse_cap)
        with bound.epoch("cache", count=fuse, fresh=pos == 0,
                         fused=fuse, start=pos):
            t0 = time.perf_counter()
            for _ in range(fuse):
                consume_epoch(u)
            t1 = time.perf_counter()
            _monitor.observe_phase("data", t1 - t0)
            chunked = bool(steps and (pos or step_cadence is not None))
            # only the clean path is budgeted: resumed and checkpointed
            # epochs chunk into several dispatches by design
            with (contextlib.nullcontext() if chunked else
                  _monitor.sanitize_scenario("fit.epoch_cache", units=fuse,
                                             extra=1 if tail else 0)):
                if chunked:
                    # a resumed and/or checkpointed epoch: chunks over
                    # [pos, steps), each ending on a save point
                    while pos < steps:
                        run = steps - pos
                        if step_cadence is not None:
                            run = min(run, ckpt.steps_to_next_save())
                        ran(dispatch(model.epoch, 1, 0, pos, run), run,
                            batch)
                        pos += run
                        if pos < steps:
                            bound.save_if_due(pos)
                            _faults.maybe_die(model.iteration)
                elif steps:
                    ran(dispatch(model.epoch, fuse, 0, 0, steps),
                        fuse * steps, batch)
                if tail:
                    ran(dispatch(model.epoch, 1, tail, 0, 0), 1, tail)
            _monitor.observe_phase("step", time.perf_counter() - t1)
        pos = 0
        done += fuse
    bound.finish()
    return model
