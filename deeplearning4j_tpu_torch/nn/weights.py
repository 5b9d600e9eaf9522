"""Weight initialization schemes and distributions (port of
``deeplearning4j_tpu/nn/weights.py``).

The fan rules are the JAX package's: ``(fan_in, fan_out)`` for dense
``(n_in, n_out)`` kernels, receptive-field-scaled fans for HWIO conv
kernels.  Draws come from an explicit CPU ``torch.Generator`` (so a seed
gives the same weights on every device) and are cast once to the storage
dtype.  The values never equal the JAX package's: its threefry stream is
another generator.  Parity tests carry weights across instead
(:mod:`.jax_weights`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from .conf import serde as _serde


@_serde.register("distribution", custom=True)
@dataclasses.dataclass
class Distribution:
    """Config-serializable sampling distribution: "normal" (mean/std),
    "uniform" (lower/upper), "binomial" (n_trials/prob_success)."""

    kind: str = "normal"
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0
    n_trials: int = 1
    prob_success: float = 0.5

    def sample(self, gen: torch.Generator,
               shape: Sequence[int]) -> torch.Tensor:
        shape = tuple(shape)
        if self.kind in ("normal", "gaussian"):
            return self.mean + self.std * torch.randn(shape, generator=gen)
        if self.kind == "uniform":
            return _uniform(gen, shape, self.lower, self.upper)
        if self.kind == "binomial":
            probs = torch.full(shape, float(self.prob_success))
            draws = torch.zeros(shape)
            for _ in range(int(self.n_trials)):
                draws += torch.bernoulli(probs, generator=gen)
            return draws
        raise ValueError(f"Unknown distribution kind '{self.kind}'")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Distribution":
        return Distribution(**d)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float):
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def _fans(shape: Sequence[int]) -> tuple[float, float]:
    """(fan_in, fan_out) for dense (I, O) or conv HWIO kernels."""
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    if len(shape) >= 3:
        receptive = float(math.prod(shape[:-2]))
        return receptive * shape[-2], receptive * shape[-1]
    return float(shape[0]), float(shape[0])


def init_weights(gen: torch.Generator, shape: Sequence[int],
                 scheme: str = "xavier",
                 distribution: Optional[Distribution] = None,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Initialize a weight tensor per a DL4J ``WeightInit`` scheme name,
    sampled in float32 on the CPU and cast once to ``dtype``."""
    w = _init_f32(gen, tuple(shape), scheme.lower(), distribution)
    return w.to(device=device, dtype=dtype)


def _init_f32(gen, shape, scheme, distribution) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    normal = lambda: torch.randn(shape, generator=gen)
    if scheme == "zero":
        return torch.zeros(shape)
    if scheme == "ones":
        return torch.ones(shape)
    if scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("identity init requires a square 2-D shape")
        return torch.eye(shape[0])
    if scheme == "distribution":
        if distribution is None:
            raise ValueError(
                "WeightInit 'distribution' requires a Distribution")
        return distribution.sample(gen, shape).float()
    if scheme == "xavier":
        return math.sqrt(2.0 / (fan_in + fan_out)) * normal()
    if scheme == "xavier_uniform":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, -a, a)
    if scheme in ("xavier_fan_in", "lecun_normal"):
        return normal() / math.sqrt(fan_in)
    if scheme == "xavier_legacy":
        return normal() * math.sqrt(1.0 / (fan_in + fan_out))
    if scheme in ("relu", "he_normal"):
        return normal() * math.sqrt(2.0 / fan_in)
    if scheme in ("relu_uniform", "he_uniform"):
        a = math.sqrt(6.0 / fan_in)
        return _uniform(gen, shape, -a, a)
    if scheme == "sigmoid_uniform":
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, -a, a)
    if scheme == "uniform":
        a = 1.0 / math.sqrt(fan_in)
        return _uniform(gen, shape, -a, a)
    if scheme == "lecun_uniform":
        a = math.sqrt(3.0 / fan_in)
        return _uniform(gen, shape, -a, a)
    if scheme == "normal":
        return normal()
    raise ValueError(f"Unknown WeightInit scheme '{scheme}'")
