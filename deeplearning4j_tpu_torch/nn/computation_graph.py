"""ComputationGraph: the DAG network container (port of
``deeplearning4j_tpu/nn/computation_graph.py``).

Eager PyTorch: ``_forward`` runs the vertices in the configuration's
topological order (Kahn's algorithm, insertion-order ties), keeping every
activation by vertex name; ``fit`` runs one forward, one autograd backward
and one DL4J-order updater step per batch (per window under truncated
BPTT), through the same step, updater, listener and solver code as the
``MultiLayerNetwork`` (``multilayer._Network``).  Batches are
``MultiDataSet``s (a ``DataSet`` is one input and one output); losses and
outputs follow ``network_outputs`` order.

Three orders meet here and must not be mixed up:

- the topological order of the layer vertices, each layer's params in
  ``param_order()``: the flat parameter vector, the flat updater state and
  the model zip (the JAX package's ``get_flat_params``);
- sorted vertex names: the line-search solver's flat vector (the JAX
  package ravels the ``params`` dict with ``ravel_pytree``) and the JAX
  package's tree walks over carries and layer state;
- ``network_outputs`` order: the losses and the outputs.

Params, layer state and updater state are dicts keyed by vertex name.
The fp32-logits contract is keyed to ``conf.network_outputs``: under a
bf16 policy each output vertex's logits go to fp32 before its softmax,
and every output the graph returns is fp32.  Input masks flow along the
DAG: a vertex passes on the first mask among its inputs;
``LastTimeStepVertex`` ends the mask and ``DuplicateToTimeSeriesVertex``
takes its reference input's.

Carries (``rnn_time_step``, ``rnn_stateless_step``, ``decode_step``,
``grow_decode_carries``, truncated BPTT) are dicts keyed by the names of
the recurrent layer vertices.

The fused training runtime is shared with the ``MultiLayerNetwork``
(``multilayer._Network``): the device-resident epoch cache (a captured
CUDA graph per step on the card), windowed staging over
``MultiDataSet``s, ``fit_scan``, the health guard and checkpoint/resume;
the graph supplies only how a batch's per-input lists become its
``_loss_fn`` arguments and how a window stacks.  So is layer-wise
pretraining (``pretrain`` in topological order, ``pretrain_layer`` by
vertex name): the graph supplies a vertex's input.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence

import torch

from .. import monitor as _monitor
from ..datasets.dataset import DataSet, MultiDataSet, wire_of
from ..device import DeviceLike
from . import ingest as _ingest
from .conf.computation_graph import (ComputationGraphConfiguration,
                                     DuplicateToTimeSeriesVertex,
                                     LastTimeStepVertex, LayerVertex)
from .layers.recurrent import BaseRecurrentLayer
from .multilayer import (_detached, _host, _Network,
                         check_feature_width, feature_widths)

Tensor = torch.Tensor


def _as_multi(data) -> MultiDataSet:
    if isinstance(data, MultiDataSet):
        return data
    if isinstance(data, DataSet):
        mds = MultiDataSet(
            features=[data.features], labels=[data.labels],
            features_masks=(None if data.features_mask is None
                            else [data.features_mask]),
            labels_masks=(None if data.labels_mask is None
                          else [data.labels_mask]))
        wire = wire_of(data)
        if wire is not None:
            # the per-input wire list of ingest.multi_window_wire: a
            # wrapped DataSet wires its single input
            mds._wires = [wire]
        return mds
    raise TypeError(f"Expected DataSet/MultiDataSet, got {type(data)}")


class ComputationGraph(_Network):
    """DAG network with named vertices (reference ``ComputationGraph``)."""

    def __init__(self, conf: ComputationGraphConfiguration,
                 device: DeviceLike = None):
        super().__init__(conf, device)
        self.topo = conf.topological_order()
        self.vertices = conf.vertices
        self.params: Dict[str, Dict[str, Tensor]] = {}
        self.net_state: Dict[str, Dict[str, Tensor]] = {}
        self.updater_state: Dict[str, Any] = {}

    # ---- the container's layout ------------------------------------------
    def _layer_names(self) -> List[str]:
        return [n for n in self.topo
                if isinstance(self.vertices[n], LayerVertex)]

    def _slots(self):
        return [(n, self.vertices[n].layer) for n in self._layer_names()]

    def _trees(self, pairs):
        return dict(pairs)

    def _items(self, trees):
        return list(trees.items())

    def _layer_at(self, key):
        return self.vertices[key].layer

    def _describe(self, key) -> str:
        return f"Vertex '{key}'"

    def _stored_state(self, new_state):
        # keys sorted, as the JAX package's jitted step returns its dicts:
        # a trained graph's state.bin walks the vertices in that order
        return {key: {k: v.detach() for k, v in new_state[key].items()}
                for key in sorted(new_state)}

    # --------------------------------------------------------------- forward
    def _forward(self, params, net_state, inputs: Sequence[Tensor], *,
                 train: bool, rng: Optional[torch.Generator],
                 input_masks: Optional[Dict[str, Tensor]] = None,
                 preoutput_outputs: bool = False, carries=None):
        """Run the DAG.  Returns (activations by vertex name, new layer
        state, new carries).  With ``carries`` (a dict by recurrent vertex
        name), those vertices run ``forward_seq`` with explicit state in
        and out; ``preoutput_outputs`` leaves the output vertices'
        pre-activations in the activations, for the loss."""
        conf = self.conf
        pol = self._pol()
        acts: Dict[str, Tensor] = {}
        for name, x in zip(conf.network_inputs, inputs):
            if x.is_floating_point():
                x = x.to(pol.compute_dtype)
            acts[name] = x
        if pol.compute_dtype != pol.param_dtype:
            params = {n: {k: p.to(pol.compute_dtype) if p.is_floating_point()
                          else p for k, p in tree.items()}
                      for n, tree in params.items()}
        new_state = dict(net_state)
        masks: Dict[str, Optional[Tensor]] = dict(input_masks or {})
        new_carries = dict(carries) if carries is not None else {}
        outputs = conf.network_outputs
        for name in self.topo:
            v = self.vertices[name]
            xs = [acts[i] for i in v.inputs]
            mask = next((masks[i] for i in v.inputs
                         if masks.get(i) is not None), None)
            if isinstance(v, LayerVertex):
                x = xs[0]
                if v.preprocessor is not None:
                    x = v.preprocessor(x)
                layer = v.layer
                if (preoutput_outputs and name in outputs
                        and hasattr(layer, "pre_output")):
                    x = layer.apply_dropout(x, train, rng)
                    out = layer.pre_output(params[name], x)
                elif (pol.downcasts_output and name in outputs
                      and hasattr(layer, "pre_output")):
                    # fp32 logits contract: an output head's logits go to
                    # fp32 BEFORE its softmax; checked before the carries
                    # branch so a carried step honours it too (the only
                    # recurrent head, RnnOutputLayer, carries ())
                    x = layer.apply_dropout(x, train, rng)
                    out = layer._activate(
                        layer.pre_output(params[name], x).float())
                elif carries is not None and name in carries:
                    out, new_carries[name] = layer.forward_seq(
                        params[name], x, carries[name], train=train,
                        rng=rng, mask=mask)
                else:
                    out, new_state[name] = layer.forward(
                        params[name], net_state[name], x, train=train,
                        rng=rng, mask=mask)
                acts[name] = out
                masks[name] = mask
            elif isinstance(v, DuplicateToTimeSeriesVertex):
                ref = v.reference_input
                acts[name] = v.apply(*xs, masks=masks,
                                     timesteps=acts[ref].shape[1])
                masks[name] = masks.get(ref)
            elif isinstance(v, LastTimeStepVertex):
                acts[name] = v.apply(*xs, masks=masks)
                masks[name] = None
            else:
                acts[name] = v.apply(*xs, masks=masks)
                masks[name] = mask
        if pol.downcasts_output:
            for out in outputs:
                acts[out] = acts[out].float()
        return acts, new_state, new_carries

    def _input_masks(self, features_masks):
        if features_masks is None:
            return None
        return {n: m for n, m in zip(self.conf.network_inputs,
                                     features_masks) if m is not None}

    # ------------------------------------------------------------------ loss
    def _loss_fn(self, params, net_state, features, labels, features_masks,
                 labels_masks, rng, train: bool, carries=None,
                 per_example: bool = False):
        """Data loss summed over the output vertices (in
        ``network_outputs`` order), new layer state and new carries;
        ``per_example`` sums the unreduced (batch,) score vectors.  An
        output with ``NEEDS_INPUT_FOR_SCORE`` (center loss) scores against
        its input activation, after its preprocessor and its dropout."""
        acts, new_state, new_carries = self._forward(
            params, net_state, features, train=train, rng=rng,
            input_masks=self._input_masks(features_masks),
            preoutput_outputs=True, carries=carries)
        total = None
        for i, out_name in enumerate(self.conf.network_outputs):
            v = self.vertices[out_name]
            layer = v.layer
            if getattr(layer, "NEEDS_INPUT_FOR_SCORE", False):
                x = acts[v.inputs[0]]
                if v.preprocessor is not None:
                    x = v.preprocessor(x)
                if rng is not None:
                    x = layer.apply_dropout(x, train, rng)
                lmask = None if labels_masks is None else labels_masks[i]
                loss = (layer.compute_score_examples_with_input(
                    params[out_name], labels[i], x, lmask) if per_example
                    else layer.compute_score_with_input(
                        params[out_name], labels[i], x, lmask,
                        average=self.conf.conf.mini_batch))
                total = loss if total is None else total + loss
                continue
            if not hasattr(layer, "compute_score"):
                raise ValueError(
                    f"Output vertex '{out_name}' is not an output layer")
            lmask = None if labels_masks is None else labels_masks[i]
            if per_example:
                loss = layer.compute_score_examples(labels[i],
                                                    acts[out_name], lmask)
            else:
                loss = layer.compute_score(labels[i], acts[out_name], lmask,
                                           average=self.conf.conf.mini_batch)
            total = loss if total is None else total + loss
        return total, new_state, new_carries

    # ------------------------------------------------------------- training
    def _batch(self, data):
        mds = _as_multi(data)
        ldt = self._label_dtype()

        def masks(ms):
            return None if ms is None else tuple(
                self._tensor(m, torch.float32) for m in ms)

        return (tuple(self._tensor(f) for f in mds.features),
                tuple(self._tensor(l, ldt) for l in mds.labels),
                masks(mds.features_masks), masks(mds.labels_masks))

    def _batches(self, data, labels):
        if labels is not None:
            data = DataSet(data, labels)
        return ([data] if isinstance(data, (DataSet, MultiDataSet))
                else data)

    def _step_batch(self, fs, ls, fms, lms):
        return (tuple(fs), tuple(ls),
                None if fms is None else tuple(fms),
                None if lms is None else tuple(lms))

    def _window_item(self, ds):
        return _as_multi(ds)

    def _window_sig(self, item):
        return _ingest.multi_window_signature(item)

    def _window_stack(self, items, pin: bool):
        return _ingest.stack_multi_window(items, pin)

    def _window_wires(self, items, n_in: int, pin: bool):
        return _ingest.multi_window_wire(items, n_in, pin)

    def _pretrain_features(self, ds):
        return tuple(self._tensor(f) for f in _as_multi(ds).features)

    def _pretrain_input(self, key, features) -> Tensor:
        """The vertex's first input after its preprocessor, from a whole
        inference forward (as the JAX package's step takes it)."""
        v = self.vertices[key]
        acts, _, _ = self._forward(self.params, self.net_state, features,
                                   train=False, rng=None)
        x = acts[v.inputs[0]]
        return v.preprocessor(x) if v.preprocessor is not None else x

    # ---------------------------------------------------------------- tBPTT
    def _fit_tbptt(self, features, labels, fmasks, lmasks) -> None:
        """Slice every (batch, time, ...) input, label and mask into
        ``tbptt_fwd_length`` windows, one update per window, the recurrent
        vertices' carries passed on (detached at each boundary).  With
        ``tbptt_back_length`` shorter than the window, the window's leading
        ``fwd - back`` steps only advance the carries, without gradient
        and unscored, as in the JAX package's graph."""
        self._require_carry_support("truncated BPTT")
        if any(l.dim() > 3 for l in labels):
            raise ValueError(
                "Graph tBPTT supports (batch, time, features) labels only; "
                "got a label of rank "
                f"{max(l.dim() for l in labels)} (4-D per-timestep targets "
                "are not time-sliceable here)")
        seq = [l for l in labels if l.dim() == 3]
        if not seq:
            raise ValueError(
                "Truncated BPTT needs per-timestep labels (batch, time, "
                "...); use standard backprop for sequence-level labels.")
        T = seq[0].shape[1]
        window = self.conf.tbptt_fwd_length
        back = self.conf.tbptt_back_length or window
        if back > window:
            raise ValueError(
                f"tbptt_back_length ({back}) > tbptt_fwd_length "
                f"({window}) is not meaningful")
        carries = self._init_carries(features[0].shape[0])

        def cut(arrs, sl, masks=False):
            # time is axis 1 of 3-D arrays and of 2-D masks; 2-D labels,
            # static inputs and 4-D images pass through whole (an image
            # whose height equals T must not be cropped)
            if arrs is None:
                return None

            def want(a):
                return (a.dim() == 3 or (masks and a.dim() == 2)) \
                    and a.shape[1] == T
            return tuple(None if a is None else (a[:, sl] if want(a) else a)
                         for a in arrs)

        for start in range(0, T, window):
            stop = min(start + window, T)
            adv = max(0, (stop - start) - back)
            if adv:
                asl = slice(start, start + adv)
                with torch.no_grad():
                    _, carries = self._advance(
                        self.params, self.net_state, carries,
                        cut(features, asl), cut(fmasks, asl, True))
                start += adv
            sl = slice(start, stop)
            window_in = _detached(carries)
            f, l = cut(features, sl), cut(labels, sl)
            fm, lm = cut(fmasks, sl, True), cut(lmasks, sl, True)
            carries = self._update(lambda p, s: self._loss_fn(
                p, s, f, l, fm, lm, self._rng, True, carries=window_in))

    # --------------------------------------------- rnn streaming state API
    def _recurrent_vertex_names(self) -> List[str]:
        return [n for n, layer in self._slots()
                if isinstance(layer, BaseRecurrentLayer)]

    def _init_carries(self, batch: int,
                      cache_len: Optional[int] = None) -> Dict[str, Any]:
        """Zero carries per recurrent vertex; ``cache_len`` overrides the
        KV-ring capacities (the serving cache-len ladder)."""
        return {n: self._carry_of(self.vertices[n].layer, batch, cache_len)
                for n in self._recurrent_vertex_names()}

    def _advance(self, params, net_state, carries, features,
                 features_masks=None):
        """Inference forward with carries: (outputs in ``network_outputs``
        order, new carries)."""
        acts, _, new_carries = self._forward(
            params, net_state, features, train=False, rng=None,
            input_masks=self._input_masks(features_masks), carries=carries)
        return [acts[o] for o in self.conf.network_outputs], new_carries

    def _carried_step(self, params, net_state, carries, xs):
        with torch.inference_mode():
            return self._advance(params, net_state, carries,
                                 tuple(self._tensor(x) for x in xs))

    def rnn_time_step(self, *features):
        """Stateful streaming inference (reference ``rnnTimeStep``): feeds
        one or more timesteps per input, carrying every recurrent vertex's
        state between calls.  2-D inputs (batch, features) are one
        timestep and the matching outputs come back 2-D; 3-D inputs
        return (batch, time, n_out).  One output comes back as a tensor,
        several as a list."""
        self.init()
        self._require_carry_support("rnn_time_step")
        xs = [self._tensor(f) for f in features]
        squeeze = xs[0].dim() == 2
        xs = [x[:, None, :] if x.dim() == 2 else x for x in xs]
        self._check_carry_batch(xs[0].shape[0])
        outs, self._rnn_carries = self._carried_step(
            self.params, self.net_state, self._rnn_carries, xs)
        if squeeze:
            outs = [o[:, -1] if o.dim() == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_stateless_step(self, carries, *features, params=None,
                           net_state=None):
        """Explicit-carry streaming step: advance ``carries`` by the input
        timesteps and return ``(outs, new_carries)`` (``outs`` a list, one
        per graph output) without touching the graph's own state slot.
        ``carries=None`` starts from zero state; the carries passed in are
        never written.  3-D inputs only; ``params``/``net_state`` override
        the weights (a session pinned to a weight version)."""
        self.init()
        self._require_carry_support("rnn_stateless_step")
        return self._explicit_step("rnn_stateless_step", carries, features,
                                   params, net_state)

    def decode_step(self, carries, *features, params=None, net_state=None):
        """Autoregressive decode step: :meth:`rnn_stateless_step` over any
        per-vertex state, KV-cache rings included.  N single-token calls
        match one full-sequence ``output()`` (the fp32-logits contract
        included)."""
        self.init()
        self._require_carry_support("decode_step")
        return self._explicit_step("decode_step", carries, features,
                                   params, net_state)

    def _explicit_step(self, what, carries, features, params, net_state):
        xs = tuple(self._tensor(f) for f in features)
        for x in xs:
            if x.dim() != 3:
                raise ValueError(
                    f"{what} expects (batch, time, features) inputs, got "
                    f"shape {tuple(x.shape)}")
        self._check_feature_shapes([tuple(x.shape) for x in xs])
        if carries is None:
            carries = self._init_carries(int(xs[0].shape[0]))
        return self._carried_step(
            self.params if params is None else params,
            self.net_state if net_state is None else net_state, carries, xs)

    def grow_decode_carries(self, carries, cache_len: int):
        """Pad every KV ring in ``carries`` up to ``cache_len`` slots
        (other carries pass through): the serving cache-len bucket hop,
        watched as ``cg.decode_grow`` (see ``MultiLayerNetwork.
        grow_decode_carries``)."""
        self.init()
        cache_len = int(cache_len)
        grow = self._decode_grow.get(cache_len)
        if grow is None:
            def grow_to(carries):
                with torch.inference_mode():
                    return {n: (self.vertices[n].layer.grow_carry(
                                c, cache_len)
                                if getattr(self.vertices[n].layer,
                                           "HAS_KV_RING", False) else c)
                            for n, c in carries.items()}
            grow = self._decode_grow[cache_len] = \
                _monitor.jit_watch.WatchedCall(grow_to,
                                               name="cg.decode_grow")
        return grow(carries)

    @functools.cached_property
    def _decode_grow(self) -> Dict[int, Any]:
        # one watched growth function per cache length, as the JAX
        # package keeps one jitted function per target
        return {}

    def rnn_get_previous_state(self, vertex_name: str):
        """Carry of one recurrent vertex (reference
        ``rnnGetPreviousState(String)``)."""
        return (None if self._rnn_carries is None
                else self._rnn_carries.get(vertex_name))

    def rnn_set_previous_state(self, vertex_name: str, state) -> None:
        if self._rnn_carries is None:
            raise ValueError("No rnn state yet; call rnn_time_step first")
        if vertex_name not in self._rnn_carries:
            raise KeyError(f"'{vertex_name}' is not a recurrent vertex")
        self._rnn_carries[vertex_name] = state

    # ------------------------------------------------------------- inference
    def _outputs(self, params, net_state, features, features_masks):
        acts, _, _ = self._forward(
            params, net_state, features, train=False, rng=None,
            input_masks=self._input_masks(features_masks))
        return [acts[o] for o in self.conf.network_outputs]

    def output(self, *features, features_masks=None):
        """Forward to every output (inference tier): one tensor for a
        single-output graph, else a list in ``network_outputs`` order, on
        the graph's device, fp32 under the mixed policy."""
        self.init()
        fmasks = (None if features_masks is None else tuple(
            self._tensor(m, torch.float32) for m in features_masks))
        with torch.no_grad():
            outs = self._outputs(self.params, self.net_state,
                                 tuple(self._tensor(f) for f in features),
                                 fmasks)
        return outs[0] if len(outs) == 1 else outs

    def compile_output(self, feature_shapes, mask_shapes=None, params=None,
                       net_state=None):
        """The inference forward for ONE shape per graph input (the
        serving bucket primitive; see ``MultiLayerNetwork.compile_output``).
        Call it as ``fn(params, net_state, features, features_masks)``
        with a tuple of arrays of exactly ``feature_shapes`` and a tuple
        of masks of ``mask_shapes`` (``None`` iff ``mask_shapes`` was
        ``None``); it returns the list of outputs on the device of
        ``params``.  Each callable made counts once as ``cg.output`` in
        the compile watch."""
        self.init()
        shapes = [tuple(int(d) for d in s) for s in feature_shapes]
        mshapes = (None if mask_shapes is None else
                   [None if s is None else tuple(int(d) for d in s)
                    for s in mask_shapes])
        with _monitor.jit_watch.compiling(
                "cg.output", signature=f"features={shapes}; masks={mshapes}"):
            self._check_feature_shapes(shapes)
            return self._bucket_callable(shapes, mshapes, params)

    def _check_feature_shapes(self, shapes) -> None:
        """Raise ``TypeError`` when an input of ``shapes`` (one per
        network input) cannot feed the layers it goes to: the widths of
        its input type, else the ``n_in`` of each layer vertex that takes
        it alone (``multilayer.feature_widths``).  Bucket callables and
        session steps both check, so a serving request answers 400 on
        either path, as in the JAX package."""
        types = self.conf.input_types
        for i, (name, shape) in enumerate(zip(self.conf.network_inputs,
                                              shapes)):
            it = types[i] if types is not None and i < len(types) else None
            if it is not None:
                check_feature_width(shape, feature_widths(it, None, False))
                continue
            for v in self.vertices.values():
                if isinstance(v, LayerVertex) and list(v.inputs) == [name]:
                    check_feature_width(shape, feature_widths(
                        None, v.layer, v.preprocessor is not None))

    def _bucket_callable(self, shapes, mshapes, params):
        ref = next((p for tree in (params if params is not None
                                   else self.params).values()
                    for p in tree.values()), None)
        device = ref.device if ref is not None else self.device

        def run(params, net_state, features, features_masks=None):
            got = [tuple(f.shape) for f in features]
            if got != shapes:
                raise ValueError(f"features of shapes {got} for the bucket "
                                 f"{shapes}")
            mgot = (None if features_masks is None else
                    [None if m is None else tuple(m.shape)
                     for m in features_masks])
            if mgot != mshapes:
                raise ValueError(f"masks of shapes {mgot} for the bucket "
                                 f"{mshapes}")
            with torch.inference_mode():
                xs = tuple(torch.as_tensor(f, device=device)
                           for f in features)
                ms = (None if features_masks is None else tuple(
                    None if m is None else torch.as_tensor(m, device=device)
                    for m in features_masks))
                return self._outputs(params, net_state, xs, ms)

        return run

    def predict(self, *features) -> Tensor:
        """Class indices of a single-output graph."""
        out = self.output(*features)
        if isinstance(out, list):
            raise ValueError("predict() requires a single-output graph")
        return out.argmax(-1)

    def score(self, data=None) -> float:
        """Loss (+ regularization) on a DataSet or MultiDataSet; without
        one, the score of the last training update."""
        if data is None:
            return float("nan") if self._score is None else \
                float(self._score)
        self.init()
        with torch.no_grad():
            loss, _, _ = self._loss_fn(self.params, self.net_state,
                                       *self._batch(data), None, False)
            return float(loss + self._reg_score(self.params))

    def score_examples(self, data,
                       add_regularization_terms: bool = True) -> Tensor:
        """Per-example loss vector summed over the output vertices, no
        batch averaging (reference ``scoreExamples``); ``data`` is a
        (Multi)DataSet or an iterator of them, scored batch by batch."""
        self.init()
        batches = ([data] if isinstance(data, (DataSet, MultiDataSet))
                   else data)
        out = []
        with torch.no_grad():
            for b in batches:
                per, _, _ = self._loss_fn(self.params, self.net_state,
                                          *self._batch(b), None, False,
                                          per_example=True)
                if add_regularization_terms:
                    per = per + self._reg_score(self.params)
                out.append(per)
        if not out:
            return torch.zeros((0,), device=self.device)
        return torch.cat(out)

    # ----------------------------------------------------------- evaluation
    def do_evaluation(self, iterator, *evaluators):
        """One forward pass per batch feeding every evaluator (reference
        ``doEvaluation``); single-output graphs only.  Top-1
        ``Evaluation``s take int32 class indices from the card, as the
        ``MultiLayerNetwork``'s do."""
        if len(self.conf.network_outputs) != 1:
            raise ValueError("do_evaluation() requires a single-output "
                             "graph")
        self.init()
        fast = self._fast_eval(evaluators)
        bytes_moved = 0
        for ds in self._eval_batches(iterator):
            mds = _as_multi(ds)
            labels = _host(mds.labels[0])
            if mds.labels_masks is not None:
                mask = mds.labels_masks[0]
            elif mds.features_masks is not None:
                mask = mds.features_masks[0]
            else:
                mask = None
            mask = None if mask is None else _host(mask)
            features, _, fmasks, _ = self._batch(mds)
            with torch.no_grad():
                out = self._outputs(self.params, self.net_state, features,
                                    fmasks)[0]
                if fast:
                    guess = out.argmax(-1).to(torch.int32).cpu().numpy()
            if fast:
                bytes_moved += guess.nbytes
                self._feed_evaluators(evaluators, True, labels, mask,
                                      guess=guess)
                continue
            bytes_moved += out.numel() * out.element_size()
            self._feed_evaluators(evaluators, False, labels, mask,
                                  out=out.cpu().numpy())
        self._publish_eval_bytes(bytes_moved, fast)
        return evaluators
