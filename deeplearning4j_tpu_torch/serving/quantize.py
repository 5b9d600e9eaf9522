"""int8 inference weights: per-tensor affine quantization over the uint8
wire decode (port of ``deeplearning4j_tpu/serving/quantize.py``).

The serving pager's economics are set by resident bytes per model.  This
module stores each large floating leaf as **uint8 plus a WireFormat
decode spec**, the affine decode the ingest wire uses
(``datasets.normalizers.WireFormat``); on the device

    f32 = float32(u8) / denom * mult + add

with ``denom=255``, ``mult=max-min``, ``add=min`` per tensor: per-tensor
affine quantization with a worst-case rounding error of 1/510 of the
tensor's range.  Resident weight bytes drop ~4x against float32 and ~2x
against bf16, so ``ModelRegistry`` fits correspondingly more models under
the same device budget.

Policy: only floating leaves of rank >= 2 with at least ``min_size``
elements quantize (weight matrices and conv kernels).  Biases, BN
statistics, gains and other small leaves pass through unchanged.

:func:`quantize_leaf` runs in numpy on the host, as the JAX package's
does, so for a float32 tree the uint8 leaves and the specs are bitwise
the JAX package's.  The decode (:func:`dequantize_tree`) runs as three
separate elementwise ops, each rounded to float32, in the wire's order,
then casts each leaf back to the dtype it had before quantizing; on the
CPU it is bitwise :func:`dequantize_host`.  The JAX package traces the
decode into the serving program, where XLA fuses it into the consuming
product; eager PyTorch materializes the decoded tree once per call, so a
batch's transient memory holds one decoded copy (resident bytes still
fall).

Deliberate difference: the JAX package quantizes only leaves whose numpy
dtype is floating, which excludes ``ml_dtypes.bfloat16``, so under its
``mixed_bf16`` policy ``quantize="int8"`` quantizes nothing.  Here a bf16
leaf is eligible too: it is quantized from its float32 upcast and
decoded back to bf16.

Leaves are visited depth first with dict keys sorted (the order
``jax.tree.flatten`` walks the same per-layer dicts), so a spec tuple
lines up with the JAX package's for the same network.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..datasets.normalizers import WireFormat

#: Leaves smaller than this stay unquantized (biases, BN stats).
MIN_QUANT_SIZE = 64


class QuantSpec(tuple):
    """A leaf's decode spec: the ``(denom, mult, add)`` triple (equal to
    the JAX package's plain tuple) with the leaf's original ``dtype``
    attached, which the decode casts back to."""

    def __new__(cls, denom: float, mult: float, add: float,
                dtype: torch.dtype = torch.float32):
        spec = super().__new__(cls, (denom, mult, add))
        spec.dtype = dtype
        return spec


def quantize_leaf(w) -> Tuple[np.ndarray, WireFormat]:
    """Per-tensor affine quantization of one weight tensor to uint8.

    ``q = round((w - min) / scale)`` with ``scale = (max - min) / 255``;
    the returned :class:`WireFormat` decodes back with the wire's exact
    expression ``f32(u8) / 255 * (max - min) + min``.
    """
    w = np.asarray(w, np.float32)
    lo = float(w.min())
    hi = float(w.max())
    if not np.isfinite(lo) or not np.isfinite(hi):
        raise ValueError("cannot quantize a tensor with non-finite values")
    if hi <= lo:
        # constant tensor: any scale decodes exactly to `lo` + q*0
        hi = lo + 1.0
        q = np.zeros(w.shape, np.uint8)
    else:
        scale = (hi - lo) / 255.0
        q = np.clip(np.rint((w - lo) / scale), 0, 255).astype(np.uint8)
    return q, WireFormat(denom=255.0, mult=hi - lo, add=lo)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype in (torch.bfloat16, torch.float16):
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _eligible(leaf, min_size: int) -> bool:
    if isinstance(leaf, torch.Tensor):
        floating = leaf.is_floating_point()
    else:
        floating = np.issubdtype(np.asarray(leaf).dtype, np.floating)
    return floating and leaf.ndim >= 2 and int(np.prod(leaf.shape)) \
        >= min_size


def _leaves(tree) -> list:
    """Leaves of a nested list/tuple/dict tree, depth first, dict keys
    sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for child in tree for leaf in _leaves(child)]
    return [tree]


def _rebuild(tree, it):
    """``tree`` with its leaves replaced, in :func:`_leaves` order, by the
    items of the iterator ``it`` (containers and key order kept)."""
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(child, it) for child in tree)
    return next(it)


def quantize_tree(params, min_size: int = MIN_QUANT_SIZE):
    """Quantize every eligible leaf of a params tree (the per-layer dicts
    of either container).

    Returns ``(qparams, specs)``: the tree with eligible leaves replaced
    by uint8 tensors on the leaf's device, and a flat tuple of per-leaf
    :class:`QuantSpec` (``None`` for passthrough leaves) aligned with
    the tree's leaf order."""
    qleaves: List = []
    specs: List[Optional[QuantSpec]] = []
    for leaf in _leaves(params):
        if _eligible(leaf, min_size):
            q, wf = quantize_leaf(_host(leaf))
            dtype = (leaf.dtype if isinstance(leaf, torch.Tensor)
                     else torch.float32)
            device = (leaf.device if isinstance(leaf, torch.Tensor)
                      else torch.device("cpu"))
            qleaves.append(torch.from_numpy(q).to(device))
            specs.append(QuantSpec(*wf.as_tuple(), dtype=dtype))
        else:
            qleaves.append(leaf)
            specs.append(None)
    return _rebuild(params, iter(qleaves)), tuple(specs)


def _decode_leaf(q: torch.Tensor, spec) -> torch.Tensor:
    denom, mult, add = spec
    f = q.to(torch.float32)
    # three separate ops, each rounded to float32, in the wire's order;
    # 0-dim operands on the leaf's device (CUDA's division by a host
    # scalar multiplies by its reciprocal)
    f = f / f.new_full((), denom)
    f = f * f.new_full((), mult)
    f = f + f.new_full((), add)
    return f.to(getattr(spec, "dtype", torch.float32))


def dequantize_tree(qparams, specs):
    """Decode a quantized tree on its device: uint8 leaves affine-decode
    to float32 with the wire expression (op order and float32 rounding of
    the host twin ``WireFormat.decode_host``), then cast to their
    original dtype; passthrough leaves are returned as they are."""
    leaves = _leaves(qparams)
    if len(leaves) != len(specs):
        raise ValueError(
            f"quantization specs cover {len(specs)} leaves, tree has "
            f"{len(leaves)}: params changed shape after quantize_tree")
    return _rebuild(qparams, iter(
        leaf if spec is None else _decode_leaf(leaf, spec)
        for leaf, spec in zip(leaves, specs)))


def dequantize_host(qparams, specs):
    """Host (numpy) twin of :func:`dequantize_tree`: the same expression
    and float32 rounding, as float32 numpy leaves (passthrough leaves as
    numpy too)."""
    leaves = _leaves(qparams)
    return _rebuild(qparams, iter(
        _host(leaf) if spec is None
        else WireFormat(*tuple(spec)).decode_host(_host(leaf))
        for leaf, spec in zip(leaves, specs)))


def tree_nbytes(tree) -> int:
    """Total bytes of every leaf of a tree (tensors or numpy arrays)."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += np.asarray(leaf).nbytes
    return int(total)


def _is_graph(model) -> bool:
    from ..nn.computation_graph import ComputationGraph
    return isinstance(model, ComputationGraph)


def quantized_output(model, specs, bucket: Optional[Callable] = None):
    """The inference forward over the *quantized* params tree: decode,
    then the model's own inference forward, with the calling convention
    of ``compile_output``'s callables (``run(qparams, net_state,
    features, features_mask)``).  ``bucket`` is a ``compile_output``
    callable of one bucket (the engine's); by default one is made for
    each call's shapes."""
    graph = _is_graph(model)

    def run(qparams, net_state, features, features_mask=None):
        params = dequantize_tree(qparams, specs)
        fn = bucket
        if fn is None and graph:
            fn = model.compile_output(
                [tuple(f.shape) for f in features],
                mask_shapes=(None if features_mask is None else
                             [None if m is None else tuple(m.shape)
                              for m in features_mask]),
                params=params)
        elif fn is None:
            fn = model.compile_output(
                tuple(features.shape),
                mask_shape=(None if features_mask is None
                            else tuple(features_mask.shape)),
                params=params)
        return fn(params, net_state, features, features_mask)

    return run


def quantized_decode(model, specs):
    """The decode step over the quantized params tree, the counterpart of
    :func:`quantized_output` for ``decode_step``: ``run(qparams,
    net_state, carries, features)`` returns ``(out, new_carries)`` (a
    graph takes a tuple of features and returns its list of outputs).
    The int8 engine hands it to ``SessionCache`` as its ``step_fn``.
    KV-ring state stays in the activation dtype: only weights quantize."""
    graph = _is_graph(model)

    def run(qparams, net_state, carries, features):
        params = dequantize_tree(qparams, specs)
        if graph:
            return model.decode_step(carries, *features, params=params,
                                     net_state=net_state)
        return model.decode_step(carries, features, params=params,
                                 net_state=net_state)

    return run
