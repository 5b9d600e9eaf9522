"""The system under test, as the benchmark reaches it: the network a
configuration names, built through the program's own builder and
container, with the benchmark's weights written into it, and the
program's trees read back by the reference's leaf names."""

from __future__ import annotations

import importlib
from typing import Dict

import torch


def _attr(path: str):
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def port_key(net, layer: str):
    """The program's key of the reference's layer name: the vertex name
    in a graph, the layer index (``layer<i>``) in a layer list."""
    if type(net).__name__ == "MultiLayerNetwork":
        return int(layer[len("layer"):])
    return layer


def build(cfg, device=None):
    """The configuration's network, initialised on ``device``."""
    prog = cfg["program"]
    conf = _attr(prog["builder"])(**prog.get("kwargs", {}))
    over = prog.get("updater_overrides", {})
    if over:
        layers = (conf.layers if hasattr(conf, "layers") else
                  [v.layer for v in conf.vertices.values()
                   if getattr(v, "layer", None) is not None])
        for u in [conf.conf.updater] + [l.updater for l in layers]:
            if u is not None:
                for k, v in over.items():
                    setattr(u, k, v)
    return _attr(prog["container"])(conf, device=device).init()


def load(net, weights: Dict[str, torch.Tensor],
         state: Dict[str, torch.Tensor]) -> None:
    """Write the benchmark's weights and running statistics into the
    program's trees (cast to the program's storage dtype) and re-derive
    its fp32 masters.  Every leaf of the program must be written."""
    seen = set()
    for trees, values in ((net.params, weights), (net.net_state, state)):
        for leaf, value in values.items():
            layer, name = leaf.split("/")
            key = port_key(net, layer)
            old = trees[key][name]
            if tuple(old.shape) != tuple(value.shape):
                raise ValueError(f"{leaf}: the program holds "
                                 f"{tuple(old.shape)}, the reference "
                                 f"{tuple(value.shape)}")
            trees[key][name] = value.to(device=old.device, dtype=old.dtype)
            seen.add((id(trees), key, name))
    for trees in (net.params, net.net_state):
        for key, tree in net._items(trees):
            for name in tree:
                if (id(trees), key, name) not in seen:
                    raise ValueError(f"the program's {key}/{name} has no "
                                     "reference leaf")
    net._sync_masters_from_params()


def read(net, leaf: str, tree: str) -> torch.Tensor:
    """A leaf of the program's fp32 masters (``master``), momentum
    (``v``) or running statistics (``state``)."""
    layer, name = leaf.split("/")
    key = port_key(net, layer)
    if tree == "state":
        return net.net_state[key][name]
    u = net.updater_state[key]
    if tree == "master":
        return u["_master"][name] if "_master" in u else net.params[key][name]
    return u[tree][name]
