"""Global pooling layer (port of
``deeplearning4j_tpu/nn/layers/pooling.py``): pools NHWC activations over
H and W, or (batch, time, features) over time with an optional per-step
mask."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..conf import inputs as _inputs
from ..conf import serde
from .base import BaseLayerConfig, ParamTree, StateTree, Tensor

InputType = _inputs.InputType


def _pnorm(x: Tensor, p: int, axes) -> Tensor:
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axes),
                     1.0 / p)


@serde.register("global_pooling")
@dataclasses.dataclass
class GlobalPoolingLayer(BaseLayerConfig):
    """pooling_type: max | avg | sum | pnorm; collapses the spatial or
    time axes, or keeps them as unit axes (``collapse_dimensions=False``:
    (batch, 1, 1, C) for CNN, (batch, 1, features) for RNN input)."""

    INPUT_KIND = "any"

    pooling_type: str = "avg"
    pnorm: int = 2
    collapse_dimensions: bool = True
    activation: str = "identity"

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind in ("cnn", "cnn_flat"):
            if not self.collapse_dimensions:
                return _inputs.convolutional(1, 1, input_type.channels)
            return _inputs.feed_forward(input_type.channels)
        if input_type.kind == "recurrent":
            if not self.collapse_dimensions:
                return _inputs.recurrent(input_type.size, 1)
            return _inputs.feed_forward(input_type.size)
        return input_type

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask: Optional[Tensor] = None):
        if x.dim() == 4:        # NHWC -> pool over H, W
            axes, m = (1, 2), None
        elif x.dim() == 3:      # (batch, time, features) -> pool over time
            axes, m = (1,), mask
        else:
            return x, state
        kind = self.pooling_type
        if m is not None:
            mm = m[..., None]      # (batch, time, 1)
            if kind == "max":
                neg = torch.finfo(x.dtype).min
                out = torch.amax(torch.where(mm > 0, x,
                                             torch.full_like(x, neg)),
                                 dim=axes)
            elif kind in ("avg", "sum"):
                out = torch.sum(x * mm, dim=axes)
                if kind == "avg":
                    out = out / torch.clamp_min(torch.sum(mm, dim=axes), 1.0)
            elif kind == "pnorm":
                out = _pnorm(x * mm, self.pnorm, axes)
            else:
                raise ValueError(f"Unknown pooling type '{kind}'")
        elif kind == "max":
            out = torch.amax(x, dim=axes)
        elif kind == "avg":
            out = torch.mean(x, dim=axes)
        elif kind == "sum":
            out = torch.sum(x, dim=axes)
        elif kind == "pnorm":
            out = _pnorm(x, self.pnorm, axes)
        else:
            raise ValueError(f"Unknown pooling type '{kind}'")
        if not self.collapse_dimensions:
            for a in axes:
                out = out.unsqueeze(a)
        return self._activate(out), state
