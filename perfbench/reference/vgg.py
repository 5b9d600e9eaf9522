"""Plain float32 VGG-16 (Simonyan and Zisserman 2014, arXiv:1409.1556,
configuration D): thirteen 3x3 SAME convolutions with bias and relu in
five blocks, each block closed by a 2x2/2 max pool, then two dense
layers of 4096 with relu and a softmax dense head.  The features are
flattened in (H, W, C) order, as the program's NHWC layout flattens
them.

Leaves are named ``layer<i>/<param>`` with ``i`` the layer's index in
the program's layer list (the pools count), so the harness can hand the
same weights to both sides.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import ops


def _layers(cfg):
    """(kind, index, in, out) of every layer, pools included."""
    out, i, c = [], 0, cfg["channels"]
    for block in cfg["blocks"]:
        for width in block:
            out.append(("conv", i, c, width))
            c, i = width, i + 1
        out.append(("pool", i, c, c))
        i += 1
    h = cfg["height"] // 2 ** len(cfg["blocks"])
    w = cfg["width"] // 2 ** len(cfg["blocks"])
    n = h * w * c
    for width in cfg["dense"] + [cfg["n_classes"]]:
        out.append(("dense", i, n, width))
        n, i = width, i + 1
    return out


def leaves(cfg) -> List[Tuple[str, tuple, str]]:
    out = []
    for kind, i, cin, cout in _layers(cfg):
        if kind == "conv":
            out += [(f"layer{i}/W", (3, 3, cin, cout), "he"),
                    (f"layer{i}/b", (cout,), 0.0)]
        elif kind == "dense":
            out += [(f"layer{i}/W", (cin, cout), "he"),
                    (f"layer{i}/b", (cout,), 0.0)]
    return out


def state_leaves(cfg) -> List[Tuple[str, tuple, str]]:
    return []


def l2_of(cfg) -> Dict[str, float]:
    return {leaf: (cfg["l2"] if leaf.endswith("/W") else 0.0)
            for leaf, _, _ in leaves(cfg)}


def forward(cfg, P: Dict, S: Dict, x_nhwc: torch.Tensor, train: bool,
            quant: Optional[str] = None):
    x = x_nhwc.permute(0, 3, 1, 2)
    layers = _layers(cfg)
    last = layers[-1][1]
    for kind, i, _cin, _cout in layers:
        if kind == "conv":
            y = ops.conv(x, P[f"layer{i}/W"], 1, quant)
            y = ops.q(y + ops.q(P[f"layer{i}/b"], quant).reshape(1, -1, 1, 1),
                      quant)
            x = ops.q(torch.relu(y), quant)
        elif kind == "pool":
            x = ops.q(F.max_pool2d(x, 2, 2), quant)
        else:
            if x.dim() == 4:
                x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            x = ops.dense(x, P[f"layer{i}/W"], P[f"layer{i}/b"], quant)
            if i != last:
                x = ops.q(torch.relu(x), quant)
    return x, {}


def forward_flops(cfg) -> float:
    h, w = cfg["height"], cfg["width"]
    macs = 0.0
    for kind, _i, cin, cout in _layers(cfg):
        if kind == "conv":
            macs += h * w * 9 * cin * cout
        elif kind == "pool":
            h, w = h // 2, w // 2
        else:
            macs += cin * cout
    return 2.0 * macs
