"""Activation functions (port of ``deeplearning4j_tpu/nn/activations.py``).

Each activation is a plain function on tensors; gradients come from
autograd.  Names are the JAX package's lowercase config names, so a conf
read from its JSON resolves to the same functions.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def identity(x: Tensor) -> Tensor:
    return x


def sigmoid(x: Tensor) -> Tensor:
    return torch.sigmoid(x)


def tanh(x: Tensor) -> Tensor:
    return torch.tanh(x)


def relu(x: Tensor) -> Tensor:
    return torch.relu(x)


def leakyrelu(x: Tensor, alpha: float = 0.01) -> Tensor:
    return F.leaky_relu(x, negative_slope=alpha)


def softmax(x: Tensor) -> Tensor:
    """Row-wise softmax over the last (feature) axis."""
    return torch.softmax(x, dim=-1)


def softplus(x: Tensor) -> Tensor:
    return F.softplus(x)


def softsign(x: Tensor) -> Tensor:
    return F.softsign(x)


def elu(x: Tensor, alpha: float = 1.0) -> Tensor:
    return F.elu(x, alpha=alpha)


def cube(x: Tensor) -> Tensor:
    return x * x * x


def rationaltanh(x: Tensor) -> Tensor:
    """Rational approximation of tanh (ND4J ``ActivationRationalTanh``)."""
    y = 0.66667 * x
    ay = torch.abs(y)
    approx = 1.0 - 1.0 / (1.0 + ay + y * y + 1.41645 * (y ** 4))
    return 1.7159 * torch.sign(y) * approx


def rectifiedtanh(x: Tensor) -> Tensor:
    return torch.clamp_min(torch.tanh(x), 0.0)


def hardtanh(x: Tensor) -> Tensor:
    return torch.clamp(x, -1.0, 1.0)


def hardsigmoid(x: Tensor) -> Tensor:
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def selu(x: Tensor) -> Tensor:
    return F.selu(x)


def gelu(x: Tensor) -> Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def swish(x: Tensor) -> Tensor:
    return F.silu(x)


_ACTIVATIONS: dict[str, Callable[[Tensor], Tensor]] = {
    "identity": identity,
    "linear": identity,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "relu": relu,
    "leakyrelu": leakyrelu,
    "softmax": softmax,
    "softplus": softplus,
    "softsign": softsign,
    "elu": elu,
    "cube": cube,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "hardtanh": hardtanh,
    "hardsigmoid": hardsigmoid,
    "selu": selu,
    "gelu": gelu,
    "swish": swish,
}


_BUILTIN_ACTIVATIONS = frozenset(_ACTIVATIONS)


def register(name: str, fn: Callable[[Tensor], Tensor],
             overwrite: bool = False) -> None:
    """Register a user-defined activation under a (case-insensitive) name,
    so layer configs refer to it like a built-in (the reference's custom
    ``IActivation``).  ``fn`` is a function on tensors; its gradient comes
    from autograd.  Shadowing a built-in name changes every model in the
    process (``from_json`` restores included), so it raises unless
    ``overwrite=True``."""
    key = name.lower()
    if key in _BUILTIN_ACTIVATIONS and not overwrite:
        raise ValueError(
            f"'{key}' is a built-in activation; registering over it "
            "would change every model in this process — pass "
            "overwrite=True if that is really intended")
    _ACTIVATIONS[key] = fn


def get(name: str) -> Callable[[Tensor], Tensor]:
    """Resolve an activation by (case-insensitive) name."""
    key = name.lower()
    if key not in _ACTIVATIONS:
        raise ValueError(
            f"Unknown activation '{name}'. Available: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[key]


def available() -> list[str]:
    return sorted(_ACTIVATIONS)
