"""Carry a JAX-package network's parameters into the port.

The two packages keep the same layouts and the same parameter order, so a
network's parameters cross as plain numpy: either the flat vector of the
JAX ``MultiLayerNetwork.get_flat_params()`` or its per-layer dicts
(``net.params``), read in each layer's ``param_order()``.  This module
imports no JAX; the caller hands over arrays (anything ``numpy.asarray``
takes, bf16 included).  Initial values are never compared between the
packages: their random streams differ, so parity tests load one set of
weights into both.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np

from .multilayer import MultiLayerNetwork

JaxParams = Union[np.ndarray, Sequence[Mapping[str, object]]]


def flat_from_layer_dicts(net: MultiLayerNetwork,
                          layer_params: Sequence[Mapping[str, object]]
                          ) -> np.ndarray:
    """The flat float32 vector of per-layer param dicts, in the order of
    ``net``'s layers and each layer's ``param_order()``."""
    if len(layer_params) != len(net.layers):
        raise ValueError(f"{len(layer_params)} layer dicts for a network of "
                         f"{len(net.layers)} layers")
    chunks = [np.asarray(layer_params[i][name], dtype=np.float32).ravel()
              for i, layer in enumerate(net.layers)
              for name in layer.param_order()]
    return (np.concatenate(chunks) if chunks
            else np.zeros((0,), np.float32))


def load_jax_params(net: MultiLayerNetwork, params: JaxParams) -> None:
    """Load the JAX network's params (flat vector or per-layer dicts)
    into ``net``; its fp32 masters, if any, follow."""
    if isinstance(params, np.ndarray):
        flat = params
    else:
        flat = flat_from_layer_dicts(net, params)
    net.set_flat_params(flat)
