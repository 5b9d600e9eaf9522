"""Recurrent layer contract and the time-distributed output head (port of
``BaseRecurrentLayer`` and ``RnnOutputLayer`` from
``deeplearning4j_tpu/nn/layers/recurrent.py``).  GravesLSTM and the
bidirectional LSTM are not ported yet.

Activations are (batch, time, features), the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import lossfunctions as _losses
from ..conf import inputs as _inputs
from ..conf import serde
from ..weights import init_weights
from .base import BaseLayerConfig, ParamTree, StateTree, Tensor

InputType = _inputs.InputType


@dataclasses.dataclass
class BaseRecurrentLayer(BaseLayerConfig):
    """Layers consuming (batch, time, features) activations and optionally
    carrying state across calls."""

    INPUT_KIND = "rnn"
    SUPPORTS_CARRY = True

    n_in: int = 0
    n_out: int = 0

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in <= 0:
            if input_type.kind != "recurrent":
                raise ValueError(
                    f"{type(self).__name__} needs recurrent input, got "
                    f"{input_type.kind}")
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        ts = input_type.timesteps if input_type.kind == "recurrent" else -1
        return _inputs.recurrent(self.n_out, ts)

    def init_carry(self, batch: int, dtype: torch.dtype,
                   device: torch.device):
        raise NotImplementedError

    def forward_seq(self, params: ParamTree, x: Tensor, carry, *,
                    train: bool, rng=None, mask: Optional[Tensor] = None):
        """(out, new_carry)."""
        raise NotImplementedError

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None):
        out, _ = self.forward_seq(
            params, x, self.init_carry(x.shape[0], x.dtype, x.device),
            train=train, rng=rng, mask=mask)
        return out, state


@serde.register("rnn_output")
@dataclasses.dataclass
class RnnOutputLayer(BaseRecurrentLayer):
    """Time-distributed dense + loss head: the same W/b at every timestep,
    scored against (batch, time, classes) labels with an optional
    (batch, time) mask."""

    activation: str = "softmax"
    loss: str = "mcxent"

    def param_order(self) -> tuple[str, ...]:
        return ("W", "b")

    def init_params(self, gen, dtype, device) -> ParamTree:
        return {
            "W": init_weights(gen, (self.n_in, self.n_out),
                              self.weight_init or "xavier", self.dist,
                              dtype, device),
            "b": torch.full((self.n_out,), float(self.bias_init or 0.0),
                            dtype=dtype, device=device),
        }

    def init_carry(self, batch, dtype, device):
        return ()

    def forward_seq(self, params, x, carry, *, train, rng=None, mask=None):
        x = self.apply_dropout(x, train, rng)
        return self._activate(self.pre_output(params, x)), carry

    def pre_output(self, params: ParamTree, x: Tensor) -> Tensor:
        return x @ params["W"] + params["b"]

    def compute_score(self, labels: Tensor, preout: Tensor,
                      mask: Optional[Tensor] = None,
                      average: bool = True) -> Tensor:
        return _losses.score(self.loss, labels, preout, self.activation,
                             mask, average)

    def compute_score_examples(self, labels: Tensor, preout: Tensor,
                               mask: Optional[Tensor] = None) -> Tensor:
        return _losses.score_examples(self.loss, labels, preout,
                                      self.activation, mask)
