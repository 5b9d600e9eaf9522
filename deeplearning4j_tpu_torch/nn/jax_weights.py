"""Carry a JAX-package network's parameters into the port.

The two packages keep the same layouts and the same parameter order, so a
network's parameters cross as plain numpy: either the flat vector of the
JAX ``get_flat_params()`` or the JAX network's ``params``: per-layer dicts
for a ``MultiLayerNetwork`` (a list), ``{vertex: {param: array}}`` for a
``ComputationGraph``, read in the port network's order (layers, or layer
vertices in topological order) and each layer's ``param_order()``.  This
module imports no JAX; the caller hands over arrays (anything
``numpy.asarray`` takes, bf16 included).  Initial values are never
compared between the packages: their random streams differ, so parity
tests load one set of weights into both.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np
import torch

JaxParams = Union[np.ndarray, Sequence[Mapping[str, object]],
                  Mapping[str, Mapping[str, object]]]


def flat_from_layer_dicts(net, layer_params) -> np.ndarray:
    """The flat vector of per-layer param dicts (a list by layer index, or
    a dict by vertex name), in the order of ``net``'s layers and each
    layer's ``param_order()``: float64 for a float64 network, else
    float32."""
    slots = net._slots()
    if len(layer_params) != len(slots):
        raise ValueError(f"{len(layer_params)} layer dicts for a network of "
                         f"{len(slots)} layers")
    dtype = (np.float64 if net._pol().param_dtype == torch.float64
             else np.float32)
    chunks = [np.asarray(layer_params[key][name], dtype=dtype).ravel()
              for key, layer in slots for name in layer.param_order()]
    return (np.concatenate(chunks) if chunks else np.zeros((0,), dtype))


def load_jax_params(net, params: JaxParams) -> None:
    """Load the JAX network's params (flat vector, per-layer dicts or
    per-vertex dicts) into ``net``; its fp32 masters, if any, follow."""
    if isinstance(params, np.ndarray):
        flat = params
    else:
        flat = flat_from_layer_dicts(net, params)
    net.set_flat_params(flat)
