"""Core feed-forward layers: Dense, Output, Loss, Activation, Dropout and
Embedding (port of ``deeplearning4j_tpu/nn/layers/core.py``).

Dense kernels are ``(n_in, n_out)``, used as ``x @ W + b`` (cuBLAS on the
card), so the flat parameter vector is the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..conf import inputs as _inputs
from ..conf import serde
from .base import (BaseLayerConfig, FeedForwardLayerConfig, ParamTree,
                   ScoredHead, StateTree, Tensor)

InputType = _inputs.InputType


@serde.register("dense")
@dataclasses.dataclass
class DenseLayer(FeedForwardLayerConfig):
    """Fully connected layer: ``activation(x @ W + b)``."""

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None) -> Tuple[Tensor, StateTree]:
        x = self.apply_dropout(x, train, rng)
        return self._activate(x @ params["W"] + params["b"]), state


@serde.register("output")
@dataclasses.dataclass
class OutputLayer(ScoredHead, FeedForwardLayerConfig):
    """Dense + loss head; softmax with MCXENT by default."""

    activation: str = "softmax"
    loss: str = "mcxent"

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None) -> Tuple[Tensor, StateTree]:
        x = self.apply_dropout(x, train, rng)
        return self._activate(self.pre_output(params, x)), state

    def pre_output(self, params: ParamTree, x: Tensor) -> Tensor:
        return x @ params["W"] + params["b"]


@serde.register("loss")
@dataclasses.dataclass
class LossLayer(ScoredHead, BaseLayerConfig):
    """Loss-only head with no params."""

    activation: str = "identity"
    loss: str = "mse"

    INPUT_KIND = "any"

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None) -> Tuple[Tensor, StateTree]:
        return self._activate(x), state

    def pre_output(self, params: ParamTree, x: Tensor) -> Tensor:
        return x


@serde.register("activation")
@dataclasses.dataclass
class ActivationLayer(BaseLayerConfig):
    """Standalone activation."""

    INPUT_KIND = "any"

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None) -> Tuple[Tensor, StateTree]:
        return self._activate(x), state


@serde.register("dropout_layer")
@dataclasses.dataclass
class DropoutLayer(BaseLayerConfig):
    """Standalone dropout; identity at inference."""

    activation: str = "identity"

    INPUT_KIND = "any"

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None) -> Tuple[Tensor, StateTree]:
        return self._activate(self.apply_dropout(x, train, rng)), state


@serde.register("embedding")
@dataclasses.dataclass
class EmbeddingLayer(FeedForwardLayerConfig):
    """Index -> row of ``W``, plus ``b``.  Input: integer indices of shape
    ``(batch,)`` or ``(batch, 1)``; an integer tensor skips the network's
    compute-dtype cast, a float one is truncated to int as in the JAX
    package."""

    activation: str = "identity"

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None) -> Tuple[Tensor, StateTree]:
        idx = x.long()
        if idx.dim() == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        return self._activate(params["W"][idx] + params["b"]), state
