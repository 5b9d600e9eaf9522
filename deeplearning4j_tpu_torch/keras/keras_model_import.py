"""Keras 1.x HDF5 model import (port of
``deeplearning4j_tpu/keras/keras_model_import.py``; the reference's
``deeplearning4j-modelimport``: ``KerasModelImport.java:48-156``,
``KerasSequentialModel`` to a MultiLayerConfiguration, ``KerasModel.java:59``
for the functional API to a ComputationGraph, and the per-layer mappers of
``layers/Keras*.java``).

h5py reads the file; it is imported inside the functions that open one,
so the package needs it only for an import.  Supported Keras 1.x layers:
Dense, Activation, Dropout, Flatten, Convolution2D, MaxPooling2D,
AveragePooling2D, ZeroPadding2D, BatchNormalization, LSTM, Embedding, and
the functional API's Merge (concat/sum).

Weight layouts (as the reference mappers; activations are NHWC and
kernels HWIO, as in the JAX package):
- Dense: W (in, out), b, as is.
- Convolution2D: Keras 'tf' kernels are (kh, kw, stack, nb_filter), which
  is HWIO; 'th' kernels are (nb_filter, stack, kh, kw) and Theano's true
  convolution, so they are rotated 180 degrees and transposed
  (:func:`th_kernel_to_hwio`), and the Dense after a 'th' Flatten gets
  its input rows permuted from (C, H, W) to (H, W, C) order.
- LSTM: the per-gate arrays go into DL4J's gate order [c|f|o|i], with 3
  zero peephole columns appended to the recurrent weights
  (``KerasLstm.java:150-230``).
- BatchNormalization: gamma, beta; ``running_mean`` and ``running_std``
  go into the layer state's mean and var.

A trailing Activation folds into the Dense before it, and the last Dense
becomes an OutputLayer.  The network is built on ``device`` (the card
unless ``device="cpu"``); after the weights are written the fp32 masters
of a mixed precision policy are re-derived from them.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike
from ..nn.conf import inputs as _inputs
from ..nn.conf.computation_graph import MergeVertex, ElementWiseVertex
from ..nn.conf.neural_net_configuration import NeuralNetConfiguration
from ..nn.computation_graph import ComputationGraph
from ..nn.layers.convolution import (ConvolutionLayer, SubsamplingLayer,
                                     ZeroPaddingLayer)
from ..nn.layers.core import (ActivationLayer, DenseLayer, DropoutLayer,
                              EmbeddingLayer, OutputLayer)
from ..nn.layers.normalization import BatchNormalization
from ..nn.layers.recurrent import GravesLSTM
from ..nn.multilayer import MultiLayerNetwork

_ACTIVATIONS = {
    "relu": "relu", "sigmoid": "sigmoid", "tanh": "tanh",
    "softmax": "softmax", "linear": "identity", "softplus": "softplus",
    "softsign": "softsign", "hard_sigmoid": "hardsigmoid", "elu": "elu",
}


def _map_activation(name: str) -> str:
    if name not in _ACTIVATIONS:
        raise ValueError(f"Unsupported Keras activation '{name}'")
    return _ACTIVATIONS[name]


def _layer_weights(wgroup, layer_name: str) -> Dict[str, np.ndarray]:
    """Read {short_param_name: array} for one layer (Keras 1.x layout:
    group per layer, attrs['weight_names'] ordering)."""
    if layer_name not in wgroup:
        return {}
    g = wgroup[layer_name]
    names = [n.decode() if isinstance(n, bytes) else str(n)
             for n in g.attrs.get("weight_names", [])]
    out = {}
    for full in names:
        short = full.split("/")[-1]
        # keras1 names like 'dense_1_W' -> 'W'; 'lstm_1_W_i' -> 'W_i'
        for prefix in (layer_name + "_", ):
            if short.startswith(prefix):
                short = short[len(prefix):]
        out[short] = np.asarray(g[full])
    return out


class _ImportedLayer:
    def __init__(self, conf_layer, params: Optional[Dict[str, np.ndarray]],
                 state: Optional[Dict[str, np.ndarray]] = None):
        self.conf_layer = conf_layer
        self.params = params
        self.state = state or {}


def _convert_layer(cls: str, cfg: dict, weights: Dict[str, np.ndarray],
                   dim_ordering: Optional[str]) -> Optional[_ImportedLayer]:
    """One Keras layer config -> our layer config + mapped params.
    Returns None for no-op layers (Flatten/Input — handled by preprocessors/
    shape inference)."""
    act = cfg.get("activation", "linear")
    if cls == "Dense":
        layer = DenseLayer(n_out=cfg["output_dim"],
                           activation=_map_activation(act))
        return _ImportedLayer(layer, {"W": weights["W"], "b": weights["b"]})
    if cls == "Activation":
        return _ImportedLayer(
            ActivationLayer(activation=_map_activation(act)), None)
    if cls == "Dropout":
        return _ImportedLayer(DropoutLayer(dropout=cfg.get("p", 0.0)), None)
    if cls in ("Flatten", "InputLayer"):
        return None
    if cls == "Convolution2D":
        ordering = cfg.get("dim_ordering", dim_ordering) or "tf"
        W = weights["W"]
        if ordering == "th":
            W = th_kernel_to_hwio(W)
        border = cfg.get("border_mode", "valid")
        mode = "same" if border == "same" else "truncate"
        layer = ConvolutionLayer(
            n_out=cfg["nb_filter"],
            kernel_size=(cfg["nb_row"], cfg["nb_col"]),
            stride=tuple(cfg.get("subsample", (1, 1))),
            convolution_mode=mode,
            activation=_map_activation(act))
        return _ImportedLayer(layer, {"W": W, "b": weights["b"]})
    if cls == "ZeroPadding2D":
        ph, pw = cfg.get("padding", (1, 1))
        return _ImportedLayer(
            ZeroPaddingLayer(padding=(ph, ph, pw, pw)), None)
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        border = cfg.get("border_mode", "valid")
        layer = SubsamplingLayer(
            pooling_type="max" if cls == "MaxPooling2D" else "avg",
            kernel_size=tuple(cfg.get("pool_size", (2, 2))),
            stride=tuple(cfg.get("strides") or cfg.get("pool_size", (2, 2))),
            convolution_mode="same" if border == "same" else "truncate")
        return _ImportedLayer(layer, None)
    if cls == "BatchNormalization":
        if cfg.get("mode", 0) != 0:
            raise ValueError("Only BatchNormalization mode=0 supported")
        layer = BatchNormalization(eps=cfg.get("epsilon", 1e-5))
        params = {"gamma": weights["gamma"], "beta": weights["beta"]}
        state = {"mean": weights.get("running_mean"),
                 "var": weights.get("running_std")}
        return _ImportedLayer(layer, params, state)
    if cls == "Embedding":
        layer = EmbeddingLayer(n_in=cfg["input_dim"],
                               n_out=cfg["output_dim"],
                               activation="identity")
        W = weights["W"]
        return _ImportedLayer(layer, {"W": W,
                                      "b": np.zeros(W.shape[1],
                                                    np.float32)})
    if cls == "LSTM":
        H = cfg["output_dim"]
        inner = _map_activation(cfg.get("inner_activation", "hard_sigmoid"))
        layer = GravesLSTM(n_out=H, activation=_map_activation(act),
                           gate_activation_fn=inner,
                           forget_gate_bias_init=0.0)
        # DL4J gate order [c|f|o|i] + zero peepholes (KerasLstm.java)
        W = np.concatenate([weights["W_c"], weights["W_f"], weights["W_o"],
                            weights["W_i"]], axis=1)
        U = np.concatenate([weights["U_c"], weights["U_f"], weights["U_o"],
                            weights["U_i"], np.zeros((H, 3), W.dtype)],
                           axis=1)
        b = np.concatenate([weights["b_c"], weights["b_f"], weights["b_o"],
                            weights["b_i"]])
        return _ImportedLayer(layer, {"W": W, "RW": U, "b": b})
    raise ValueError(f"Unsupported Keras layer class '{cls}'")


def _conv_out(size: int, k: int, s: int, border: str) -> int:
    if border == "same":
        return -(-size // s)          # ceil
    return (size - k) // s + 1        # valid


def _track_spatial(cls: str, cfg: dict, spatial):
    """Propagate (h, w, c) through conv/pool configs so a th-ordering
    Flatten->Dense can be layout-corrected (below)."""
    if spatial is None:
        return None
    h, w, c = spatial
    if cls == "Convolution2D":
        s = cfg.get("subsample", (1, 1))
        border = cfg.get("border_mode", "valid")
        return (_conv_out(h, cfg["nb_row"], s[0], border),
                _conv_out(w, cfg["nb_col"], s[1], border),
                cfg["nb_filter"])
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        k = cfg.get("pool_size", (2, 2))
        s = cfg.get("strides") or k
        border = cfg.get("border_mode", "valid")
        return (_conv_out(h, k[0], s[0], border),
                _conv_out(w, k[1], s[1], border), c)
    if cls == "ZeroPadding2D":
        ph, pw = cfg.get("padding", (1, 1))
        return (h + 2 * ph, w + 2 * pw, c)
    if cls in ("Activation", "Dropout", "BatchNormalization", "Flatten"):
        return spatial
    return None  # Dense etc. leave the spatial domain


def _input_spatial(cfg: dict, dim_ordering: Optional[str]):
    """(h, w, c) from a 4D ``batch_input_shape``, else None."""
    shape = cfg.get("batch_input_shape")
    if shape is None or len(shape) != 4:
        return None
    dims = shape[1:]
    return (tuple(dims[1:]) + (dims[0],) if dim_ordering == "th"
            else tuple(dims))


def th_kernel_to_hwio(W: np.ndarray) -> np.ndarray:
    """Keras-Theano conv kernel (nb_filter, stack, kh, kw), stored with
    Theano's 180°-rotated filters (true convolution, vs the
    cross-correlation a framework computes — reference
    ``KerasConvolution.java:127-139`` reverses each filter) -> HWIO.
    Shared by the model importer and the trained-models loader so the two
    can never disagree on Theano semantics."""
    return W[:, :, ::-1, ::-1].transpose(2, 3, 1, 0)


def _th_flatten_permutation(spatial) -> np.ndarray:
    """Row permutation taking a Keras-Theano flattened (C, H, W) dense
    kernel to this framework's NHWC (H, W, C) flatten order (reference
    role: ``TensorFlowCnnToFeedForwardPreProcessor`` exists because
    orderings genuinely differ — DL4J is NCHW so 'th' was free there;
    we are NHWC so 'th' needs the permutation and 'tf' is free)."""
    h, w, c = spatial
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).ravel()


def th_dense_rows_to_nhwc(W: np.ndarray, spatial) -> np.ndarray:
    """Permute a post-Flatten dense kernel's input rows from Keras-th
    (C, H, W) flatten order to NHWC flatten order."""
    return np.asarray(W)[_th_flatten_permutation(spatial)]


def _keras_input_type(cfg: dict, dim_ordering: str):
    shape = cfg.get("batch_input_shape")
    if shape is None:
        return None
    dims = [d for d in shape[1:]]
    if len(dims) == 1:
        return _inputs.feed_forward(dims[0])
    if len(dims) == 2:
        return _inputs.recurrent(dims[1], dims[0])
    if len(dims) == 3:
        if dim_ordering == "th":
            c, h, w = dims
        else:
            h, w, c = dims
        return _inputs.convolutional(h, w, c)
    raise ValueError(f"Cannot map batch_input_shape {shape}")


def _open(path: str):
    import h5py
    return h5py.File(path, "r")


def _model_config(f) -> dict:
    raw = f.attrs["model_config"]
    if isinstance(raw, bytes):
        raw = raw.decode("utf-8")
    return json.loads(raw)


def _weights_group(f):
    return f["model_weights"] if "model_weights" in f else f


def import_keras_sequential_model_and_weights(path: str,
                                              train_config: bool = False,
                                              device: DeviceLike = None
                                              ) -> MultiLayerNetwork:
    """Reference ``KerasModelImport.importKerasSequentialModelAndWeights``:
    Keras 1.x Sequential .h5 -> MultiLayerNetwork with copied weights.

    The final Dense+softmax collapses into an OutputLayer (the reference
    requires a loss layer for training parity; inference is identical).
    """
    with _open(path) as f:
        conf = _model_config(f)
        if conf["class_name"] != "Sequential":
            raise ValueError("Not a Sequential model; use "
                             "import_keras_model_and_weights")
        layer_confs = conf["config"]
        wgroup = _weights_group(f)

        builder = (NeuralNetConfiguration.builder().updater("sgd")
                   .activation("identity").weight_init("xavier").list())
        imported: List[_ImportedLayer] = []
        input_type = None
        dim_ordering = None
        for lc in layer_confs:
            cfg = lc["config"]
            dim_ordering = cfg.get("dim_ordering", dim_ordering)
        spatial = None          # (h, w, c) while inside the conv domain
        flatten_perm = None     # pending th-order Flatten->Dense fixup
        for i, lc in enumerate(layer_confs):
            cls, cfg = lc["class_name"], lc["config"]
            name = cfg.get("name") or cfg.get("layer_name") or f"layer_{i}"
            if input_type is None:
                it = _keras_input_type(cfg, dim_ordering or "tf")
                if it is not None:
                    input_type = it
                    spatial = _input_spatial(cfg, dim_ordering)
            weights = _layer_weights(wgroup, name)
            if (cls == "Flatten" and dim_ordering == "th"
                    and spatial is not None):
                # Keras-th flattened (C,H,W); we flatten NHWC -> permute
                # the next Dense kernel's input rows
                flatten_perm = _th_flatten_permutation(spatial)
            if cls == "Dense" and flatten_perm is not None:
                weights = dict(weights)
                weights["W"] = np.asarray(weights["W"])[flatten_perm]
                flatten_perm = None
            spatial = _track_spatial(cls, cfg, spatial)
            conv = _convert_layer(cls, cfg, weights, dim_ordering)
            if conv is not None:
                imported.append(conv)

        # Keras commonly ends Dense(linear) + Activation(softmax): fold
        # the trailing Activation into the Dense before output-collapse
        if (len(imported) >= 2
                and isinstance(imported[-1].conf_layer, ActivationLayer)
                and isinstance(imported[-2].conf_layer, DenseLayer)):
            act_layer = imported.pop()
            d = imported[-1].conf_layer
            imported[-1] = _ImportedLayer(
                DenseLayer(n_out=d.n_out,
                           activation=act_layer.conf_layer.activation),
                imported[-1].params)

        # last Dense becomes OutputLayer (reference KerasLoss handling)
        last = imported[-1]
        if isinstance(last.conf_layer, DenseLayer):
            d = last.conf_layer
            imported[-1] = _ImportedLayer(
                OutputLayer(n_out=d.n_out, activation=d.activation or
                            "softmax",
                            loss="mcxent" if (d.activation == "softmax")
                            else "mse"),
                last.params)
        for il in imported:
            builder.layer(il.conf_layer)
        if input_type is not None:
            builder.set_input_type(input_type)
        net = MultiLayerNetwork(builder.build(), device=device).init()
        _write_weights(net, enumerate(imported))
        return net


def _write_weights(net, entries) -> None:
    """Write each ``(key, _ImportedLayer)``'s params and layer state into
    ``net`` (in the net's dtypes, on its device), then re-derive the fp32
    masters from them."""
    for key, il in entries:
        for k, v in (il.params or {}).items():
            p = net.params[key][k]
            net.params[key][k] = _tensor_like(v, p).reshape(p.shape)
        for k, v in (il.state or {}).items():
            if v is not None and k in net.net_state[key]:
                net.net_state[key][k] = _tensor_like(v, net.net_state[key][k])
    net._sync_masters_from_params()


def _tensor_like(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(
        device=like.device, dtype=like.dtype)


def import_keras_model_and_weights(path: str,
                                   train_config: bool = False,
                                   device: DeviceLike = None
                                   ) -> ComputationGraph:
    """Reference ``KerasModelImport.importKerasModelAndWeights``: Keras 1.x
    functional-API .h5 -> ComputationGraph."""
    with _open(path) as f:
        conf = _model_config(f)
        if conf["class_name"] not in ("Model", "Functional"):
            raise ValueError("Not a functional-API model")
        mc = conf["config"]
        layer_confs = mc["layers"]
        wgroup = _weights_group(f)

        dim_ordering = None
        for lc in layer_confs:
            dim_ordering = lc["config"].get("dim_ordering", dim_ordering)

        g = (NeuralNetConfiguration.builder().updater("sgd")
             .activation("identity").weight_init("xavier").graph_builder())
        input_names = [l[0] for l in mc["input_layers"]]
        output_names = [l[0] for l in mc["output_layers"]]
        input_types = []
        imported: Dict[str, _ImportedLayer] = {}
        passthrough: Dict[str, str] = {}  # flatten-like no-op mapping
        spatial_of: Dict[str, object] = {}   # name -> (h, w, c) or None
        perm_of: Dict[str, np.ndarray] = {}  # name -> pending th-flat perm
        records: List[tuple] = []  # ("layer"|"vertex", name, obj, in_names)

        def resolve(name: str) -> str:
            while name in passthrough:
                name = passthrough[name]
            return name

        # -- phase 1: parse every layer into records ------------------------
        for lc in layer_confs:
            cls, cfg = lc["class_name"], lc["config"]
            name = lc.get("name") or cfg.get("name")
            inbound = lc.get("inbound_nodes") or []
            # keras1 inbound_nodes: [[[name, node_idx, tensor_idx], ...]]
            raw_in = [x[0] for x in inbound[0]] if inbound else []
            in_names = [resolve(x) for x in raw_in]
            in_spatial = spatial_of.get(raw_in[0]) if raw_in else None
            inherited_perm = perm_of.get(raw_in[0]) if raw_in else None
            if cls == "InputLayer":
                input_types.append(
                    _keras_input_type(cfg, dim_ordering or "tf"))
                spatial_of[name] = _input_spatial(cfg, dim_ordering)
                continue
            if cls == "Flatten":
                passthrough[name] = in_names[0]
                if dim_ordering == "th" and in_spatial is not None:
                    perm_of[name] = _th_flatten_permutation(in_spatial)
                continue
            if cls == "Merge":
                mode = cfg.get("mode", "concat")
                if mode == "concat":
                    records.append(("vertex", name, MergeVertex(),
                                    in_names))
                elif mode == "sum":
                    records.append(("vertex", name,
                                    ElementWiseVertex(op="add"), in_names))
                else:
                    raise ValueError(f"Unsupported Merge mode '{mode}'")
                continue
            weights = _layer_weights(wgroup, name)
            if inherited_perm is not None:
                # a th Flatten upstream still awaits its Dense consumer
                if cls == "Dense":
                    weights = dict(weights)
                    weights["W"] = np.asarray(
                        weights["W"])[inherited_perm]
                elif cls in ("Activation", "Dropout"):
                    perm_of[name] = inherited_perm  # order-preserving
                else:
                    raise ValueError(
                        f"th Flatten feeding a '{cls}' layer is not "
                        "supported (the pending layout permutation "
                        "cannot flow through it)")
            spatial_of[name] = _track_spatial(cls, cfg, in_spatial)
            conv = _convert_layer(cls, cfg, weights, dim_ordering)
            if conv is None:
                passthrough[name] = in_names[0]
                if inherited_perm is not None:
                    perm_of[name] = inherited_perm
                continue
            imported[name] = conv
            records.append(("layer", name, conv, in_names))

        # -- phase 2: output folds ------------------------------------------
        by_name = {r[1]: i for i, r in enumerate(records)}

        def record_of(name):
            i = by_name.get(resolve(name))
            return records[i] if i is not None else None

        for out in output_names:
            rec = record_of(out)
            if rec is None or rec[0] != "layer":
                continue
            kind, name, il, in_names = rec
            # Dense(linear) -> Activation at an output folds into the
            # Dense before output-collapse (same as the sequential path)
            if (isinstance(il.conf_layer, ActivationLayer)
                    and len(in_names) == 1):
                prev = record_of(in_names[0])
                if (prev is not None and prev[0] == "layer"
                        and isinstance(prev[2].conf_layer, DenseLayer)):
                    d = prev[2].conf_layer
                    records[by_name[prev[1]]] = (
                        "layer", prev[1],
                        _ImportedLayer(
                            DenseLayer(n_out=d.n_out,
                                       activation=il.conf_layer.activation),
                            prev[2].params, prev[2].state),
                        prev[3])
                    imported.pop(name, None)
                    imported[prev[1]] = records[by_name[prev[1]]][2]
                    records[by_name[name]] = None
                    passthrough[name] = prev[1]
                    rec = records[by_name[prev[1]]]
                    kind, name, il, in_names = rec
            if isinstance(il.conf_layer, DenseLayer):
                d = il.conf_layer
                folded = _ImportedLayer(
                    OutputLayer(n_out=d.n_out,
                                activation=d.activation or "softmax",
                                loss="mcxent" if d.activation == "softmax"
                                else "mse"), il.params, il.state)
                records[by_name[name]] = ("layer", name, folded, in_names)
                imported[name] = folded

        # -- phase 3: build the graph ---------------------------------------
        for rec in records:
            if rec is None:
                continue
            kind, name, obj, in_names = rec
            if kind == "vertex":
                g.add_vertex(name, obj, *in_names)
            else:
                g.add_layer(name, obj.conf_layer, *in_names)

        g.add_inputs(*input_names)
        g.set_outputs(*[resolve(n) for n in output_names])
        if all(t is not None for t in input_types) and input_types:
            g.set_input_types(*input_types)
        cg = ComputationGraph(g.build(), device=device).init()
        _write_weights(cg, imported.items())
        return cg


class KerasModelImport:
    """Namespace mirroring the reference entry points
    (``KerasModelImport.java:48-156``)."""

    import_keras_sequential_model_and_weights = staticmethod(
        import_keras_sequential_model_and_weights)
    import_keras_model_and_weights = staticmethod(
        import_keras_model_and_weights)
