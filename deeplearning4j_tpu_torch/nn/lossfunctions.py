"""Loss functions (port of ``deeplearning4j_tpu/nn/lossfunctions.py``).

Each loss is ``loss(labels, preoutput, activation, mask) -> per-example
scores`` of shape ``(batch,)``; gradients come from autograd.  Losses take
the *pre-activation* output plus the output layer's activation name, so
softmax+MCXENT runs as ``log_softmax`` and sigmoid+XENT as ``softplus``,
the same numerically fused forms as the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import activations

Tensor = torch.Tensor

_EPS = 1e-7


def _activate(preout: Tensor, activation: str) -> Tensor:
    return activations.get(activation)(preout)


def _reduce_features(per_element: Tensor) -> Tensor:
    """Sum per-element scores over all non-batch axes -> (batch,)."""
    if per_element.dim() <= 1:
        return per_element
    return per_element.sum(dim=tuple(range(1, per_element.dim())))


def _apply_mask(per: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Zero the contributions of masked examples or timesteps, broadcasting
    a (batch,) or (batch, time) mask over the trailing axes."""
    if mask is None:
        return per
    m = mask.to(per.dtype)
    while m.dim() < per.dim():
        m = m.unsqueeze(-1)
    return per * m


def mcxent(labels: Tensor, preout: Tensor, activation: str = "softmax",
           mask: Optional[Tensor] = None) -> Tensor:
    """Multi-class cross entropy: -sum(labels * log(p))."""
    if activation == "softmax":
        logp = torch.log_softmax(preout, dim=-1)
    else:
        logp = torch.log(torch.clamp(_activate(preout, activation), _EPS, 1.0))
    return _reduce_features(_apply_mask(-labels * logp, mask))


def negativeloglikelihood(labels: Tensor, preout: Tensor,
                          activation: str = "softmax",
                          mask: Optional[Tensor] = None) -> Tensor:
    return mcxent(labels, preout, activation, mask)


def sparse_mcxent(labels: Tensor, preout: Tensor,
                  activation: str = "softmax",
                  mask: Optional[Tensor] = None) -> Tensor:
    """Multi-class cross entropy against integer class indices: labels of
    shape ``preout.shape[:-1]`` (a language model's (batch, time) next
    tokens) in place of one-hot rows, so no (tokens, classes) label
    tensor is made.  The log-softmax runs in ``preout``'s dtype."""
    if activation != "softmax":
        raise ValueError("sparse_mcxent takes softmax heads only, got "
                         f"{activation!r}")
    per = F.cross_entropy(preout.reshape(-1, preout.shape[-1]),
                          labels.reshape(-1).long(), reduction="none")
    return _reduce_features(_apply_mask(per.reshape(labels.shape), mask))


def xent(labels: Tensor, preout: Tensor, activation: str = "sigmoid",
         mask: Optional[Tensor] = None) -> Tensor:
    """Binary cross entropy per output unit."""
    if activation == "sigmoid":
        logp = -F.softplus(-preout)
        log1mp = -F.softplus(preout)
    else:
        p = torch.clamp(_activate(preout, activation), _EPS, 1.0 - _EPS)
        logp, log1mp = torch.log(p), torch.log1p(-p)
    per = -(labels * logp + (1.0 - labels) * log1mp)
    return _reduce_features(_apply_mask(per, mask))


def l2(labels: Tensor, preout: Tensor, activation: str = "identity",
       mask: Optional[Tensor] = None) -> Tensor:
    per = torch.square(_activate(preout, activation) - labels)
    return _reduce_features(_apply_mask(per, mask))


def mse(labels: Tensor, preout: Tensor, activation: str = "identity",
        mask: Optional[Tensor] = None) -> Tensor:
    """DL4J ``LossMSE`` = LossL2 / nOut."""
    return l2(labels, preout, activation, mask) / labels.shape[-1]


def l1(labels: Tensor, preout: Tensor, activation: str = "identity",
       mask: Optional[Tensor] = None) -> Tensor:
    per = torch.abs(_activate(preout, activation) - labels)
    return _reduce_features(_apply_mask(per, mask))


def mae(labels: Tensor, preout: Tensor, activation: str = "identity",
        mask: Optional[Tensor] = None) -> Tensor:
    """DL4J ``LossMAE`` = LossL1 / nOut."""
    return l1(labels, preout, activation, mask) / labels.shape[-1]


def mape(labels: Tensor, preout: Tensor, activation: str = "identity",
         mask: Optional[Tensor] = None) -> Tensor:
    out = _activate(preout, activation)
    denom = torch.where(labels == 0, torch.full_like(labels, _EPS), labels)
    per = 100.0 * torch.abs((out - labels) / denom)
    return _reduce_features(_apply_mask(per, mask)) / labels.shape[-1]


def msle(labels: Tensor, preout: Tensor, activation: str = "identity",
         mask: Optional[Tensor] = None) -> Tensor:
    out = _activate(preout, activation)
    per = torch.square(torch.log1p(out) - torch.log1p(labels))
    return _reduce_features(_apply_mask(per, mask)) / labels.shape[-1]


def hinge(labels: Tensor, preout: Tensor, activation: str = "identity",
          mask: Optional[Tensor] = None) -> Tensor:
    """Hinge loss; labels in {-1, +1}."""
    per = torch.clamp_min(1.0 - labels * _activate(preout, activation), 0.0)
    return _reduce_features(_apply_mask(per, mask))


def squared_hinge(labels: Tensor, preout: Tensor,
                  activation: str = "identity",
                  mask: Optional[Tensor] = None) -> Tensor:
    per = torch.square(
        torch.clamp_min(1.0 - labels * _activate(preout, activation), 0.0))
    return _reduce_features(_apply_mask(per, mask))


def kl_divergence(labels: Tensor, preout: Tensor, activation: str = "softmax",
                  mask: Optional[Tensor] = None) -> Tensor:
    out = torch.clamp(_activate(preout, activation), _EPS, 1.0)
    lab = torch.clamp(labels, _EPS, 1.0)
    per = labels * (torch.log(lab) - torch.log(out))
    return _reduce_features(_apply_mask(per, mask))


def poisson(labels: Tensor, preout: Tensor, activation: str = "identity",
            mask: Optional[Tensor] = None) -> Tensor:
    out = torch.clamp_min(_activate(preout, activation), _EPS)
    per = out - labels * torch.log(out)
    return _reduce_features(_apply_mask(per, mask))


def cosine_proximity(labels: Tensor, preout: Tensor,
                     activation: str = "identity",
                     mask: Optional[Tensor] = None) -> Tensor:
    out = _activate(preout, activation)
    if mask is not None:
        out = _apply_mask(out, mask)
        labels = _apply_mask(labels, mask)
    dot = torch.sum(labels * out, dim=-1)
    norm = torch.linalg.norm(labels, dim=-1) * torch.linalg.norm(out, dim=-1)
    sim = dot / torch.clamp_min(norm, _EPS)
    if sim.dim() > 1:
        sim = sim.sum(dim=tuple(range(1, sim.dim())))
    return -sim


_LOSSES: dict[str, Callable[..., Tensor]] = {
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "sparse_mcxent": sparse_mcxent,
    "xent": xent,
    "mse": mse,
    "l1": l1,
    "l2": l2,
    "mae": mae,
    "mape": mape,
    "msle": msle,
    "hinge": hinge,
    "squaredhinge": squared_hinge,
    "squared_hinge": squared_hinge,
    "kld": kl_divergence,
    "kl_divergence": kl_divergence,
    "poisson": poisson,
    "cosineproximity": cosine_proximity,
    "cosine_proximity": cosine_proximity,
}


def get(name: str) -> Callable[..., Tensor]:
    key = name.lower()
    if key not in _LOSSES:
        raise ValueError(
            f"Unknown loss '{name}'. Available: {sorted(_LOSSES)}")
    return _LOSSES[key]


def score(name: str, labels: Tensor, preout: Tensor, activation: str,
          mask: Optional[Tensor] = None, average: bool = True) -> Tensor:
    """Scalar minibatch score: the mean over examples when ``average``,
    over present timesteps under a (batch, time) mask."""
    per = get(name)(labels, preout, activation, mask)
    total = per.sum()
    if not average:
        return total
    if mask is not None and mask.dim() >= 2:
        return total / torch.clamp_min(mask.to(total.dtype).sum(), 1.0)
    return total / per.shape[0]


def score_examples(name: str, labels: Tensor, preout: Tensor,
                   activation: str,
                   mask: Optional[Tensor] = None) -> Tensor:
    """Per-example scores, shape (batch,), no batch reduction."""
    return get(name)(labels, preout, activation, mask)


def available() -> list[str]:
    return sorted(_LOSSES)
