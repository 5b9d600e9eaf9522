"""Recurrent layers: the peephole LSTM scan, GravesLSTM,
GravesBidirectionalLSTM and the time-distributed output head (port of
``deeplearning4j_tpu/nn/layers/recurrent.py``).

Semantics kept from the JAX package:

- the fused 4H-wide preactivation ``[block input z | forget | output |
  input-mod g]`` over ``[0,H) [H,2H) [2H,3H) [3H,4H)``;
- the peepholes are 3 extra columns of the recurrent matrix ``RW`` of
  shape (H, 4H+3): column 4H (forget gate) and 4H+2 (input-mod gate) read
  ``c_prev``, column 4H+1 (output gate) reads the new ``c``;
- the block input and ``afn(c)`` use the layer's ``activation``, the
  three gates ``gate_activation_fn``;
- the forget-gate bias ``[H, 2H)`` starts at ``forget_gate_bias_init``.

The input projection ``x @ W + b`` runs once for all timesteps, outside the
loop; the loop is plain eager torch over time, one ``addmm`` of
``h_prev @ RW[:, :4H]`` onto each step's slice.  Activations are
(batch, time, features), the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import activations as _activations
from ..conf import inputs as _inputs
from ..conf import serde
from ..weights import init_weights
from .base import (BaseLayerConfig, ParamTree, ScoredHead, StateTree,
                   Tensor, dense_params)

InputType = _inputs.InputType

# An LSTM carry is (h, c), each (batch, hidden).
Carry = Tuple[Tensor, Tensor]


def lstm_scan(W: Tensor, RW: Tensor, b: Tensor, x: Tensor, carry: Carry, *,
              afn, gate_fn, mask: Optional[Tensor] = None,
              reverse: bool = False) -> Tuple[Tensor, Carry]:
    """Run the peephole LSTM over a (batch, time, n_in) sequence.

    Returns (outputs (batch, time, H), final (h, c)).  With a (batch, time)
    mask, a masked step passes the previous state through unchanged and
    emits zeros.  ``reverse`` scans from the last step to the first; the
    outputs stay in the original time order."""
    return lstm_scan_preact(RW, lstm_input_projection(W, b, x), carry,
                            afn=afn, gate_fn=gate_fn, mask=mask,
                            reverse=reverse)


def lstm_input_projection(W: Tensor, b: Tensor, x: Tensor) -> Tensor:
    """``x @ W + b`` for every timestep at once, in the result type of
    ``x`` and ``W`` (bf16 inputs with f32 weights project in f32)."""
    dtype = torch.promote_types(x.dtype, W.dtype)
    return x.to(dtype) @ W.to(dtype) + b


def lstm_scan_preact(RW: Tensor, xw: Tensor, carry: Carry, *, afn,
                     gate_fn, mask: Optional[Tensor] = None,
                     reverse: bool = False) -> Tuple[Tensor, Carry]:
    """The recurrent chain of :func:`lstm_scan` over the already projected
    (batch, time, 4H) preactivations, so that a caller holding the
    projection (the sequence-parallel ring in ``parallel/sequence.py``)
    does not compute it again.  The carry is promoted once to the result
    type of ``xw`` and ``RW``."""
    H = RW.shape[0]
    dtype = torch.promote_types(xw.dtype, RW.dtype)
    xw, RW = xw.to(dtype), RW.to(dtype)
    RWg = RW[:, :4 * H]
    w_ff = RW[:, 4 * H]       # forget-gate peephole (reads c_prev)
    w_oo = RW[:, 4 * H + 1]   # output-gate peephole (reads the new c)
    w_gg = RW[:, 4 * H + 2]   # input-mod-gate peephole (reads c_prev)
    h, c = (a.to(dtype) for a in carry)
    # unbind: one stack in the backward pass, not a full-size zero
    # gradient per step as indexing would give
    steps = xw.unbind(1)
    keeps = None if mask is None else (mask > 0).unsqueeze(-1).unbind(1)
    ys = [None] * len(steps)
    order = range(len(steps) - 1, -1, -1) if reverse else range(len(steps))
    for t in order:
        ifog = torch.addmm(steps[t], h, RWg)
        z = afn(ifog[:, :H])                            # block input
        f = gate_fn(ifog[:, H:2 * H] + c * w_ff)
        g = gate_fn(ifog[:, 3 * H:4 * H] + c * w_gg)
        c_new = f * c + g * z
        o = gate_fn(ifog[:, 2 * H:3 * H] + c_new * w_oo)
        h_new = o * afn(c_new)
        if keeps is None:
            h, c = h_new, c_new
            ys[t] = h_new
        else:
            keep = keeps[t]
            ys[t] = torch.where(keep, h_new, 0.0)
            h = torch.where(keep, h_new, h)
            c = torch.where(keep, c_new, c)
    return torch.stack(ys, 1), (h, c)


def _zero_carry(batch: int, hidden: int, dtype: torch.dtype,
                device: torch.device) -> Carry:
    return (torch.zeros((batch, hidden), dtype=dtype, device=device),
            torch.zeros((batch, hidden), dtype=dtype, device=device))


@dataclasses.dataclass
class BaseRecurrentLayer(BaseLayerConfig):
    """Layers consuming (batch, time, features) activations and optionally
    carrying state across calls (tBPTT windows, ``rnn_time_step``,
    ``decode_step``, ``serving.SessionCache``).  ``SUPPORTS_CARRY`` is
    False for a layer whose pass needs the whole sequence."""

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


@dataclasses.dataclass
class _LSTMConfig(BaseRecurrentLayer):
    """The hyperparameters and weights of one peephole LSTM direction."""

    forget_gate_bias_init: float = 1.0
    gate_activation_fn: str = "sigmoid"

    def _direction_params(self, gen, dtype, device, suffix: str = ""
                          ) -> ParamTree:
        """``W`` (n_in, 4H), ``RW`` (H, 4H+3), ``b`` (4H,) with the
        forget-gate slice at ``forget_gate_bias_init``."""
        H, scheme = self.n_out, self.weight_init or "xavier"
        b = torch.zeros((4 * H,), dtype=dtype, device=device)
        b[H:2 * H] = self.forget_gate_bias_init
        return {
            "W" + suffix: init_weights(gen, (self.n_in, 4 * H), scheme,
                                       self.dist, dtype, device),
            "RW" + suffix: init_weights(gen, (H, 4 * H + 3), scheme,
                                        self.dist, dtype, device),
            "b" + suffix: b,
        }

    def _scan(self, params: ParamTree, x: Tensor, carry: Carry, mask,
              suffix: str = "", reverse: bool = False):
        return lstm_scan(params["W" + suffix], params["RW" + suffix],
                         params["b" + suffix], x, carry,
                         afn=_activations.get(self.activation),
                         gate_fn=_activations.get(self.gate_activation_fn),
                         mask=mask, reverse=reverse)


@serde.register("graves_lstm")
@dataclasses.dataclass
class GravesLSTM(_LSTMConfig):
    """Peephole LSTM; params ``W``, ``RW``, ``b`` in that order."""

    def param_order(self) -> tuple[str, ...]:
        return ("W", "RW", "b")

    def init_params(self, gen, dtype, device) -> ParamTree:
        return self._direction_params(gen, dtype, device)

    def init_carry(self, batch, dtype, device) -> Carry:
        return _zero_carry(batch, self.n_out, dtype, device)

    def forward_seq(self, params, x, carry, *, train, rng=None, mask=None):
        x = self.apply_dropout(x, train, rng)
        return self._scan(params, x, carry, mask)


@serde.register("graves_bidirectional_lstm")
@dataclasses.dataclass
class GravesBidirectionalLSTM(_LSTMConfig):
    """Bidirectional peephole LSTM: the same cell forward and reversed over
    the sequence with the same mask, the two outputs SUMMED.  Params
    ``WF, RWF, bF, WB, RWB, bB``.  The reversed pass needs the whole
    sequence, so the layer carries no state across chunks."""

    SUPPORTS_CARRY = False

    def param_order(self) -> tuple[str, ...]:
        return ("WF", "RWF", "bF", "WB", "RWB", "bB")

    def init_params(self, gen, dtype, device) -> ParamTree:
        return {**self._direction_params(gen, dtype, device, "F"),
                **self._direction_params(gen, dtype, device, "B")}

    def init_carry(self, batch, dtype, device):
        return (_zero_carry(batch, self.n_out, dtype, device),
                _zero_carry(batch, self.n_out, dtype, device))

    def forward_seq(self, params, x, carry, *, train, rng=None, mask=None):
        x = self.apply_dropout(x, train, rng)
        fwd_carry, bwd_carry = carry
        out_f, new_f = self._scan(params, x, fwd_carry, mask, "F")
        out_b, new_b = self._scan(params, x, bwd_carry, mask, "B",
                                  reverse=True)
        return out_f + out_b, (new_f, new_b)


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
