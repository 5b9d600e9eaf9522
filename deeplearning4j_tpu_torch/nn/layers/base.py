"""Base layer contract (port of ``deeplearning4j_tpu/nn/layers/base.py``).

A layer is one dataclass: serializable hyperparameters plus plain
functions on tensors, ``init_params(gen, dtype, device)`` and
``forward(params, state, x, train, rng, mask) -> (out, new_state)``.
Params are a dict of tensors in the JAX package's layouts (dense kernels
``(n_in, n_out)``, used as ``x @ W``), so flat parameter vectors map one to
one between the packages.  Backprop is autograd over the composed forward.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .. import activations as _activations
from ..conf import inputs as _inputs
from ..updaters import UpdaterConfig
from ..weights import Distribution

Tensor = torch.Tensor
ParamTree = Dict[str, Tensor]
StateTree = Dict[str, Tensor]
InputType = _inputs.InputType


@dataclasses.dataclass
class BaseLayerConfig:
    """Hyperparameters shared by every layer; ``None`` inherits the
    network-level default at ``finalize_defaults``."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[Distribution] = None
    bias_init: Optional[float] = None
    dropout: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    updater: Optional[UpdaterConfig] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    frozen: bool = False

    _INHERITABLE = ("activation", "weight_init", "dist", "bias_init",
                    "dropout", "l1", "l2", "l1_bias", "l2_bias", "updater",
                    "gradient_normalization")

    def finalize_defaults(self, defaults: "Dict[str, object]") -> None:
        for field in self._INHERITABLE:
            if getattr(self, field, None) is None and field in defaults:
                setattr(self, field, defaults[field])

    # ---- shape inference -------------------------------------------------
    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def set_n_in(self, input_type: InputType) -> None:
        """Infer n_in from the incoming InputType (no-op by default)."""

    # ---- params / state --------------------------------------------------
    def init_params(self, gen: torch.Generator, dtype: torch.dtype,
                    device: torch.device) -> ParamTree:
        return {}

    def init_state(self, dtype: torch.dtype,
                   device: torch.device) -> StateTree:
        return {}

    def param_order(self) -> tuple[str, ...]:
        """Param order inside the flat parameter vector."""
        return ()

    # ---- forward ---------------------------------------------------------
    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng: Optional[torch.Generator] = None,
                mask: Optional[Tensor] = None) -> Tuple[Tensor, StateTree]:
        raise NotImplementedError

    # ---- regularization wiring ------------------------------------------
    def l1_by_param(self) -> Dict[str, float]:
        return {k: (self.l1_bias if k == "b" else self.l1) or 0.0
                for k in self.param_order()}

    def l2_by_param(self) -> Dict[str, float]:
        return {k: (self.l2_bias if k == "b" else self.l2) or 0.0
                for k in self.param_order()}

    # ---- helpers ---------------------------------------------------------
    def _activate(self, z: Tensor) -> Tensor:
        return _activations.get(self.activation)(z)

    def apply_dropout(self, x: Tensor, train: bool,
                      rng: Optional[torch.Generator]) -> Tensor:
        """Inverted dropout on the layer input during training.  The mask
        comes from ``rng``, a generator on ``x``'s device."""
        if not train or not self.dropout or self.dropout <= 0.0:
            return x
        if rng is None:
            raise ValueError(
                f"Layer {self.name or type(self).__name__}: dropout "
                "requires a generator at training time")
        keep = 1.0 - self.dropout
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))
