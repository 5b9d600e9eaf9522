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

from ..conf import inputs as _inputs
from ..conf import serde
from .base import (BaseLayerConfig, ParamTree, ScoredHead, StateTree,
                   Tensor, dense_params)

InputType = _inputs.InputType


@dataclasses.dataclass
class BaseRecurrentLayer(BaseLayerConfig):
    """Layers consuming (batch, time, features) activations and optionally
    carrying state across calls (``rnn_time_step``, ``decode_step``,
    ``serving.SessionCache``).  ``SUPPORTS_CARRY`` is False for a layer
    whose pass needs the whole sequence."""

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
        """(out, new_carry); the carry threads streaming state from one
        chunk of timesteps to the next."""
        raise NotImplementedError

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None):
        out, _ = self.forward_seq(
            params, x, self.init_carry(x.shape[0], x.dtype, x.device),
            train=train, rng=rng, mask=mask)
        return out, state


@serde.register("rnn_output")
@dataclasses.dataclass
class RnnOutputLayer(ScoredHead, BaseRecurrentLayer):
    """Time-distributed dense + loss head: the same W/b at every timestep,
    scored against (batch, time, classes) labels with an optional
    (batch, time) mask."""

    activation: str = "softmax"
    loss: str = "mcxent"

    def param_order(self) -> tuple[str, ...]:
        return ("W", "b")

    def init_params(self, gen, dtype, device) -> ParamTree:
        return dense_params(self, gen, dtype, device)

    def init_carry(self, batch, dtype, device):
        return ()

    def forward_seq(self, params, x, carry, *, train, rng=None, mask=None):
        x = self.apply_dropout(x, train, rng)
        return self._activate(self.pre_output(params, x)), carry

    def pre_output(self, params: ParamTree, x: Tensor) -> Tensor:
        return x @ params["W"] + params["b"]
