"""Numerical-vs-analytic gradient checking (port of
``deeplearning4j_tpu/gradientcheck.py``).

``check_gradients``/``check_gradients_graph``: the analytic gradient comes
from autograd over the network's total loss (data loss plus
regularization, inference mode, as the JAX package checks it); the
numerical one from central differences on the flat parameter vector, one
parameter at a time.  ``check_pretrain_gradients`` holds one layer's
unsupervised step: the gradients its ``pretrain_grads`` gives (what the
pretrain step applies) plus the regularization's, against central
differences of its ``pretrain_loss`` plus the regularization score, the
random draws held fixed.  The network must compute in float64 on the CPU
(``.dtype("float64")``, ``device="cpu"``): in float32 the differences
drown in rounding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

DEFAULT_EPS = 1e-6
DEFAULT_MAX_REL_ERROR = 1e-3
DEFAULT_MIN_ABS_ERROR = 1e-8


def _compare(analytic: np.ndarray, numeric: np.ndarray, idxs: np.ndarray,
             max_rel_error: float, min_abs_error: float,
             print_results: bool, label: str) -> bool:
    """A parameter fails when both its relative error exceeds
    ``max_rel_error`` and its absolute error ``min_abs_error``."""
    a = analytic[idxs]
    denom = np.abs(a) + np.abs(numeric)
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.where(denom == 0, 0.0, np.abs(a - numeric) / denom)
    fails = (rel > max_rel_error) & (np.abs(a - numeric) > min_abs_error)
    n_fail = int(fails.sum())
    max_err = float(rel.max()) if rel.size else 0.0
    if print_results:
        for pos in np.nonzero(fails)[0][:50]:
            print(f"param {idxs[pos]}: analytic={a[pos]:.8g} "
                  f"numeric={numeric[pos]:.8g} rel={rel[pos]:.4g} FAIL")
        print(f"GradientCheck({label}): {idxs.size - n_fail} passed, "
              f"{n_fail} failed (maxRelError={max_err:.4g})")
    return n_fail == 0


def _subset(n: int, subset: Optional[int], seed: int) -> np.ndarray:
    idxs = np.arange(n)
    if subset is not None and subset < n:
        idxs = np.sort(np.random.RandomState(seed).choice(
            n, subset, replace=False))
    return idxs


def check_gradients(net, dataset, eps: float = DEFAULT_EPS,
                    max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                    min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                    print_results: bool = False,
                    subset: Optional[int] = None,
                    seed: int = 0) -> bool:
    """True when every checked parameter's analytic gradient agrees with
    its central difference (``subset`` checks that many, drawn with
    ``seed``)."""
    return _check(net, dataset, eps, max_rel_error, min_abs_error,
                  print_results, subset, seed, "MLN")


def check_gradients_graph(net, mds, eps: float = DEFAULT_EPS,
                          max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                          min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                          print_results: bool = False,
                          subset: Optional[int] = None,
                          seed: int = 0) -> bool:
    """The ComputationGraph check over a MultiDataSet (or a DataSet):
    the flat vector in topological order of the layer vertices."""
    return _check(net, mds, eps, max_rel_error, min_abs_error,
                  print_results, subset, seed, "graph")


def check_pretrain_gradients(net, dataset, layer_idx,
                             eps: float = DEFAULT_EPS,
                             max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                             min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                             print_results: bool = False,
                             subset: Optional[int] = None,
                             rng_seed: int = 42) -> bool:
    """The unsupervised step of layer ``layer_idx`` (an index, or a
    vertex name) on ``dataset``'s features.  The draws come from a CPU
    generator seeded by ``rng_seed`` and stay fixed, so the loss is a
    function of the params.  For the VariationalAutoencoder and the
    AutoEncoder; contrastive divergence (the RBM) is the gradient of no
    loss, so an RBM raises."""
    from .nn import updaters as _updaters
    from .nn.layers import pretrain as _pretrain

    _require_f64_cpu(net)
    layer = net._layer_at(layer_idx)
    if isinstance(layer, _pretrain.RBM) or not getattr(
            layer, "IS_PRETRAINABLE", False):
        raise ValueError(
            f"{type(layer).__name__} has no pretrain loss to check "
            "(contrastive divergence is the gradient of no loss)")
    with torch.no_grad():
        x = net._pretrain_input(layer_idx, net._pretrain_features(dataset))
    draws = _pretrain.make_draws(
        layer.pretrain_draw_specs(int(x.shape[0])),
        torch.Generator().manual_seed(int(rng_seed)), "cpu", torch.float64)
    names = list(layer.param_order())
    l1, l2 = layer.l1_by_param(), layer.l2_by_param()

    def total_loss(p):
        return (layer.pretrain_loss(p, x, draws)
                + _updaters.regularization_score(p, l1, l2))

    base = {k: net.params[layer_idx][k].detach().clone() for k in names}
    _, step_grads = layer.pretrain_grads(base, x, draws)
    leaves = {k: v.clone().requires_grad_(True) for k, v in base.items()}
    reg = _updaters.regularization_score(leaves, l1, l2)
    reg_grads = (torch.autograd.grad(reg, list(leaves.values()),
                                     allow_unused=True)
                 if isinstance(reg, torch.Tensor) else [None] * len(names))
    analytic = np.concatenate([
        (step_grads[k] + (0 if rg is None else rg)).reshape(-1).numpy()
        for k, rg in zip(names, reg_grads)])
    starts = np.cumsum([0] + [base[k].numel() for k in names])
    idxs = _subset(int(starts[-1]), subset, rng_seed)
    numeric = np.empty(idxs.size, np.float64)
    with torch.no_grad():
        for pos, j in enumerate(idxs):
            e = int(np.searchsorted(starts, j, side="right") - 1)
            view, k = base[names[e]].view(-1), int(j - starts[e])
            orig = view[k].item()
            view[k] = orig + eps
            f_plus = float(total_loss(base))
            view[k] = orig - eps
            f_minus = float(total_loss(base))
            view[k] = orig
            numeric[pos] = (f_plus - f_minus) / (2.0 * eps)
    return _compare(analytic, numeric, idxs, max_rel_error, min_abs_error,
                    print_results, f"pretrain layer {layer_idx}")


def _require_f64_cpu(net) -> None:
    net.init()
    pol = net._pol()
    if net.device.type != "cpu" or pol.compute_dtype != torch.float64 \
            or pol.param_dtype != torch.float64:
        raise ValueError("gradient checks run on the CPU in float64: build "
                         "the network with .dtype('float64') and "
                         "device='cpu'")


def _check(net, data, eps, max_rel_error, min_abs_error, print_results,
           subset, seed, label) -> bool:
    _require_f64_cpu(net)
    batch = net._batch(data)
    entries = list(net._ordered())

    def total_loss(params):
        data_loss, _, _ = net._loss_fn(params, net.net_state, *batch, None,
                                       False)
        return data_loss + net._reg_score(params)

    def copied(grad: bool):
        return net._trees(
            [(key, {k: p.detach().clone().requires_grad_(grad)
                    for k, p in tree.items()})
             for key, tree in net._items(net.params)])

    leaves = copied(True)
    flat_leaves = [leaves[key][name] for key, name in entries]
    grads = torch.autograd.grad(total_loss(leaves), flat_leaves,
                                allow_unused=True)
    analytic = np.concatenate(
        [np.zeros(p.numel()) if g is None else g.reshape(-1).numpy()
         for p, g in zip(flat_leaves, grads)] + [np.zeros((0,))])
    starts = np.cumsum([0] + [p.numel() for p in flat_leaves])
    idxs = _subset(int(starts[-1]), subset, seed)
    params = copied(False)
    numeric = np.empty(idxs.size, np.float64)
    with torch.no_grad():
        for pos, j in enumerate(idxs):
            e = int(np.searchsorted(starts, j, side="right") - 1)
            key, name = entries[e]
            view, k = params[key][name].view(-1), int(j - starts[e])
            orig = view[k].item()
            view[k] = orig + eps
            f_plus = float(total_loss(params))
            view[k] = orig - eps
            f_minus = float(total_loss(params))
            view[k] = orig
            numeric[pos] = (f_plus - f_minus) / (2.0 * eps)
    return _compare(analytic, numeric, idxs, max_rel_error, min_abs_error,
                    print_results, label)
