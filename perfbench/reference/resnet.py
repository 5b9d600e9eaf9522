"""Plain float32 ResNet-50 (He et al. 2015, arXiv:1512.03385, Table 1):
bottleneck v1 with the stride on the first 1x1 of a block, SAME
convolutions without bias each followed by batch norm, a 7x7/2 stem and
a 3x3/2 max pool, global average pooling and a softmax dense head.

Leaves are named ``<layer>/<param>``; the layer names are those of the
graph the program builds (``stem_conv``, ``s0b0_a_bn``, ``fc``...), so
the harness can hand the same weights to both sides.  The l2
coefficient applies to every leaf but the dense bias, as the
configuration's global l2 reaches every layer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import ops


def _blocks(cfg):
    """(name, in channels, width, stride, projects) of every block."""
    out, c = [], cfg["stem_width"]
    for s, (count, width) in enumerate(cfg["stages"]):
        for b in range(count):
            stride = 2 if (s > 0 and b == 0) else 1
            out.append((f"s{s}b{b}", c, width, stride, b == 0))
            c = cfg["expansion"] * width
    return out


def _conv_bn(name: str, cin: int, cout: int, k: int,
             gamma: float = 1.0) -> List[Tuple]:
    return [(f"{name}_conv/W", (k, k, cin, cout), "he"),
            (f"{name}_bn/gamma", (cout,), gamma),
            (f"{name}_bn/beta", (cout,), 0.0)]


def leaves(cfg) -> List[Tuple[str, tuple, str]]:
    """(leaf, shape, init) of every trained parameter, in graph order:
    ``he`` or a constant.  The last batch norm of each residual branch
    starts at ``residual_gamma``."""
    out = _conv_bn("stem", cfg["channels"], cfg["stem_width"],
                   cfg["stem_kernel"])
    e = cfg["expansion"]
    for name, cin, w, _stride, project in _blocks(cfg):
        out += _conv_bn(f"{name}_a", cin, w, 1)
        out += _conv_bn(f"{name}_b", w, w, 3)
        out += _conv_bn(f"{name}_c", w, e * w, 1, cfg["residual_gamma"])
        if project:
            out += _conv_bn(f"{name}_sc", cin, e * w, 1)
    c = e * cfg["stages"][-1][1]
    out += [("fc/W", (c, cfg["n_classes"]), "he"),
            ("fc/b", (cfg["n_classes"],), 0.0)]
    return out


def state_leaves(cfg) -> List[Tuple[str, tuple, str]]:
    """(leaf, shape, init) of the batch norms' running statistics."""
    return [(f"{leaf.split('/')[0]}/{s}", shape, init)
            for leaf, shape, _ in leaves(cfg) if leaf.endswith("_bn/gamma")
            for s, init in (("mean", 0.0), ("var", 1.0))]


def l2_of(cfg) -> Dict[str, float]:
    return {leaf: (0.0 if leaf == "fc/b" else cfg["l2"])
            for leaf, _, _ in leaves(cfg)}


def forward(cfg, P: Dict, S: Dict, x_nhwc: torch.Tensor, train: bool,
            quant: Optional[str] = None):
    """Logits and the new running statistics of NHWC images."""
    eps, decay = cfg["bn_eps"], cfg["bn_decay"]
    new_s: Dict[str, torch.Tensor] = {}

    def conv_bn(name, x, stride, relu):
        y = ops.conv(x, P[f"{name}_conv/W"], stride, quant)
        bn = f"{name}_bn"
        y, (m, v) = ops.batch_norm(y, P[f"{bn}/gamma"], P[f"{bn}/beta"],
                                   S[f"{bn}/mean"], S[f"{bn}/var"], train,
                                   eps, decay, quant)
        new_s[f"{bn}/mean"], new_s[f"{bn}/var"] = m, v
        return ops.q(torch.relu(y), quant) if relu else y

    x = x_nhwc.permute(0, 3, 1, 2)
    x = conv_bn("stem", x, cfg["stem_stride"], True)
    x = ops.q(ops.max_pool_same(x, cfg["pool_kernel"], cfg["pool_stride"]),
              quant)
    for name, _cin, _w, stride, project in _blocks(cfg):
        y = conv_bn(f"{name}_a", x, stride, True)
        y = conv_bn(f"{name}_b", y, 1, True)
        y = conv_bn(f"{name}_c", y, 1, False)
        sc = conv_bn(f"{name}_sc", x, stride, False) if project else x
        x = ops.q(torch.relu(ops.q(y + sc, quant)), quant)
    x = ops.q(x.mean((2, 3)), quant)
    return ops.dense(x, P["fc/W"], P["fc/b"], quant), new_s


def forward_flops(cfg) -> float:
    """2 x multiply-adds of the convolutions and the dense head of one
    image's forward, from the layer shapes."""
    h, w = cfg["height"], cfg["width"]

    def down(n, s):
        return -(-n // s)

    macs = 0.0
    h, w = down(h, cfg["stem_stride"]), down(w, cfg["stem_stride"])
    k = cfg["stem_kernel"]
    macs += h * w * k * k * cfg["channels"] * cfg["stem_width"]
    h, w = down(h, cfg["pool_stride"]), down(w, cfg["pool_stride"])
    e = cfg["expansion"]
    for _name, cin, width, stride, project in _blocks(cfg):
        ho, wo = down(h, stride), down(w, stride)
        macs += ho * wo * cin * width              # a: 1x1, strided
        macs += ho * wo * 9 * width * width        # b: 3x3
        macs += ho * wo * width * e * width        # c: 1x1
        if project:
            macs += ho * wo * cin * e * width
        h, w = ho, wo
    macs += e * cfg["stages"][-1][1] * cfg["n_classes"]
    return 2.0 * macs
