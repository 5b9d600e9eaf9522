"""Transfer learning: freeze a feature extractor, swap the head, keep the
pretrained weights (port of ``deeplearning4j_tpu/nn/transfer.py``).

Frozen layers are plain configs with ``frozen=True``: the updater and the
solvers skip them, and a training step keeps their params out of
autograd unless the health vector reads their gradients
(``_Network._train_step``), so a frozen trunk costs its forward only.

The new network lives on the source network's device.  Each kept layer's
params and layer state are cloned there, and the fp32 masters of a mixed
precision policy are then re-derived from them
(``_sync_masters_from_params``), so that the first fine-tune step starts
from the transferred weights.  This is a deliberate difference: the JAX
package leaves the masters at their fresh init, and under ``mixed_bf16``
its first step overwrites every unfrozen kept layer with them.

Typical use::

    new_net = (TransferLearning.builder(trained_net)
               .fine_tune_learning_rate(1e-4)
               .set_feature_extractor(1)      # freeze layers 0..1
               .remove_layers_from(3)          # drop the old head
               .add_layer(OutputLayer(n_in=64, n_out=5))
               .build())
"""

from __future__ import annotations

import copy
from typing import List, Optional


def _apply_fine_tune_overrides(layers, global_updater, lr, updater):
    """Push the fine-tune lr/updater into the global conf and into each
    unfrozen layer's own (finalized, de-aliased) updater conf."""
    if lr is not None:
        global_updater.learning_rate = lr
    if updater is not None:
        global_updater.updater = updater
    for layer in layers:
        if layer is None or getattr(layer, "frozen", False) \
                or layer.updater is None:
            continue
        if lr is not None:
            layer.updater.learning_rate = lr
        if updater is not None:
            layer.updater.updater = updater


def _copy_entry(src_net, dst_net, key):
    """Clone one layer's params and layer state onto ``dst_net``'s device
    (the new net's steps must not write into the source's tensors)."""
    dev = dst_net.device
    dst_net.params[key] = {k: v.detach().to(dev, copy=True)
                           for k, v in src_net.params[key].items()}
    dst_net.net_state[key] = {k: v.detach().to(dev, copy=True)
                              for k, v in src_net.net_state[key].items()}


def _transferred(src_net, net, keys):
    """Copy ``keys``' entries from ``src_net`` into the fresh ``net``,
    re-derive its fp32 masters and carry the pretraining flag."""
    for key in keys:
        _copy_entry(src_net, net, key)
    net._sync_masters_from_params()
    # the source's completed pretraining carries over: fit() must not
    # re-run unsupervised pretraining over the transferred weights
    net._pretrain_done = src_net._pretrain_done
    return net


class TransferLearning:
    """Namespace of the reference's ``TransferLearning.Builder`` and
    ``TransferLearning.GraphBuilder``."""

    @staticmethod
    def builder(net) -> "TransferLearningBuilder":
        return TransferLearningBuilder(net)

    @staticmethod
    def graph_builder(net) -> "GraphTransferLearningBuilder":
        return GraphTransferLearningBuilder(net)


class TransferLearningBuilder:
    def __init__(self, net):
        from .multilayer import MultiLayerNetwork
        if not isinstance(net, MultiLayerNetwork):
            raise ValueError(
                "TransferLearning.builder operates on MultiLayerNetwork; "
                "use TransferLearning.graph_builder for ComputationGraph")
        net.init()
        self._src = net
        self._conf = copy.deepcopy(net.conf)
        self._keep = len(self._conf.layers)     # layers [0, _keep) kept
        self._frozen_up_to = -1
        self._added: List[object] = []
        self._lr: Optional[float] = None
        self._updater: Optional[str] = None

    # ---------------------------------------------------------- fine-tune
    def fine_tune_learning_rate(self, lr: float) -> "TransferLearningBuilder":
        """The learning rate of the fine-tune (reference
        ``FineTuneConfiguration.learningRate``)."""
        self._lr = float(lr)
        return self

    def fine_tune_updater(self, updater: str) -> "TransferLearningBuilder":
        self._updater = updater
        return self

    # ------------------------------------------------------------ surgery
    def set_feature_extractor(self, layer_index: int
                              ) -> "TransferLearningBuilder":
        """Freeze layers ``0..layer_index`` inclusive (reference
        ``setFeatureExtractor``)."""
        self._frozen_up_to = int(layer_index)
        return self

    def remove_output_layer(self) -> "TransferLearningBuilder":
        return self.remove_layers_from(self._keep - 1)

    def remove_layers_from(self, layer_index: int
                           ) -> "TransferLearningBuilder":
        """Drop layers ``layer_index..end`` (reference
        ``removeLayersFromOutput``)."""
        if not 0 <= layer_index <= self._keep:
            raise ValueError(f"layer_index {layer_index} out of range "
                             f"[0, {self._keep}]")
        self._keep = int(layer_index)
        return self

    def add_layer(self, layer) -> "TransferLearningBuilder":
        """Append a freshly initialized layer config (reference
        ``addLayer``)."""
        self._added.append(layer)
        return self

    # -------------------------------------------------------------- build
    def build(self):
        from .multilayer import MultiLayerNetwork

        if self._frozen_up_to >= self._keep:
            raise ValueError(
                f"cannot freeze through layer {self._frozen_up_to}: only "
                f"{self._keep} layers are retained (added layers are new "
                f"heads and train by definition)")
        # build() is repeatable and leaves the source's conf alone
        conf = copy.deepcopy(self._conf)
        kept_layers = [copy.deepcopy(l) for l in conf.layers[:self._keep]]
        for i, layer in enumerate(kept_layers):
            # freezes of an earlier transfer stay
            layer.frozen = layer.frozen or i <= self._frozen_up_to
        _apply_fine_tune_overrides(kept_layers, conf.conf.updater,
                                   self._lr, self._updater)
        added = [copy.deepcopy(l) for l in self._added]
        for layer in added:
            # new layers inherit the (possibly overridden) global defaults
            layer.finalize_defaults(conf.conf.layer_defaults())
        conf.layers = kept_layers + added
        if not conf.layers:
            raise ValueError("transfer result has no layers")
        # a removed layer's preprocessor must not apply to a new layer at
        # its index
        conf.input_preprocessors = {
            i: p for i, p in conf.input_preprocessors.items()
            if i < self._keep}
        net = MultiLayerNetwork(conf, device=self._src.device).init()
        return _transferred(self._src, net, range(self._keep))


class GraphTransferLearningBuilder:
    """ComputationGraph transfer (reference ``TransferLearning
    .GraphBuilder``, for its main uses): freeze a vertex and all its
    ancestors as the feature extractor, replace output-layer vertices for
    a new task, and override the fine-tune hyperparameters."""

    def __init__(self, net):
        from .computation_graph import ComputationGraph
        if not isinstance(net, ComputationGraph):
            raise ValueError("graph_builder requires a ComputationGraph")
        net.init()
        self._src = net
        self._conf = copy.deepcopy(net.conf)
        self._freeze_roots: List[str] = []
        self._replaced: dict = {}
        self._lr: Optional[float] = None
        self._updater: Optional[str] = None

    def fine_tune_learning_rate(self, lr: float
                                ) -> "GraphTransferLearningBuilder":
        self._lr = float(lr)
        return self

    def fine_tune_updater(self, updater: str
                          ) -> "GraphTransferLearningBuilder":
        self._updater = updater
        return self

    def set_feature_extractor(self, *vertex_names: str
                              ) -> "GraphTransferLearningBuilder":
        """Freeze the named vertices and every ancestor vertex (reference
        ``setFeatureExtractor(vertexName)``)."""
        unknown = [n for n in vertex_names if n not in self._conf.vertices]
        if unknown:
            raise ValueError(f"unknown vertices: {unknown}")
        self._freeze_roots.extend(vertex_names)
        return self

    def replace_output_layer(self, vertex_name: str, new_layer
                             ) -> "GraphTransferLearningBuilder":
        """Swap the layer config of an output layer vertex (a head for a
        new class count); its params re-initialize."""
        v = self._conf.vertices.get(vertex_name)
        if v is None or not hasattr(v, "layer"):
            raise ValueError(
                f"{vertex_name!r} is not a layer vertex of this graph")
        if vertex_name not in self._conf.network_outputs:
            # a mid-graph swap would copy old-shaped params of downstream
            # kept vertices into the re-inferred net
            raise ValueError(
                f"{vertex_name!r} is not a network output of this graph "
                f"(outputs: {list(self._conf.network_outputs)}); "
                "replace_output_layer only swaps output heads")
        self._replaced[vertex_name] = new_layer
        return self

    def _ancestors(self, roots: List[str]) -> set:
        """The roots and every vertex they read from, transitively (the
        network inputs, which carry no params, excluded)."""
        out, stack = set(), list(roots)
        while stack:
            name = stack.pop()
            if name in out or name not in self._conf.vertices:
                continue
            out.add(name)
            stack.extend(self._conf.vertices[name].inputs or [])
        return out

    def build(self):
        from .computation_graph import ComputationGraph
        from .conf.computation_graph import _infer_graph_shapes

        conf = copy.deepcopy(self._conf)
        frozen = self._ancestors(self._freeze_roots)
        overlap = frozen & set(self._replaced)
        if overlap:
            raise ValueError(
                f"vertices both frozen and replaced: {sorted(overlap)}")
        for name in frozen:
            v = conf.vertices[name]
            if getattr(v, "layer", None) is not None:
                v.layer.frozen = True
        _apply_fine_tune_overrides(
            [getattr(v, "layer", None) for v in conf.vertices.values()],
            conf.conf.updater, self._lr, self._updater)
        for name, new_layer in self._replaced.items():
            nl = copy.deepcopy(new_layer)
            nl.finalize_defaults(conf.conf.layer_defaults())
            conf.vertices[name].layer = nl
        if self._replaced and conf.input_types:
            # a new head given without n_in takes it from shape inference
            _infer_graph_shapes(conf)
        net = ComputationGraph(conf, device=self._src.device).init()
        # replaced heads keep their fresh init
        return _transferred(self._src, net,
                            [k for k in self._src.params
                             if k not in self._replaced])
