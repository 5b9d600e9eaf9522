"""Convolution, subsampling (pooling) and zero-padding layers (port of
``deeplearning4j_tpu/nn/layers/convolution.py``).

Activations are NHWC and the kernel ``W`` is stored HWIO, as in the JAX
package, whose flat parameter vector ravels HWIO as stored; the port keeps
that order.  The compute goes through :mod:`...ops.convolution`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ...ops import convolution as conv_ops
from ..conf import inputs as _inputs
from ..conf import serde
from ..weights import init_weights
from .base import BaseLayerConfig, ParamTree, StateTree, Tensor

InputType = _inputs.InputType


@serde.register("convolution")
@dataclasses.dataclass
class ConvolutionLayer(BaseLayerConfig):
    """2-D convolution; ``n_in`` input channels (inferred), ``n_out``
    filters, ``W`` (kh, kw, n_in, n_out)."""

    INPUT_KIND = "cnn"

    n_in: int = 0
    n_out: int = 0
    kernel_size: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"   # truncate | same | strict
    has_bias: bool = True

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in <= 0:
            if input_type.kind not in ("cnn", "cnn_flat"):
                raise ValueError(
                    f"ConvolutionLayer needs convolutional input, got "
                    f"{input_type.kind}")
            self.n_in = input_type.channels

    def output_type(self, input_type: InputType) -> InputType:
        h = conv_ops.conv_output_size(
            input_type.height, self.kernel_size[0], self.stride[0],
            self.padding[0], self.convolution_mode, self.dilation[0])
        w = conv_ops.conv_output_size(
            input_type.width, self.kernel_size[1], self.stride[1],
            self.padding[1], self.convolution_mode, self.dilation[1])
        return _inputs.convolutional(h, w, self.n_out)

    def param_order(self) -> tuple[str, ...]:
        return ("W", "b") if self.has_bias else ("W",)

    def init_params(self, gen, dtype, device) -> ParamTree:
        kh, kw = self.kernel_size
        params = {"W": init_weights(gen, (kh, kw, self.n_in, self.n_out),
                                    self.weight_init or "xavier", self.dist,
                                    dtype, device)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,),
                                     float(self.bias_init or 0.0),
                                     dtype=dtype, device=device)
        return params

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None):
        x = self.apply_dropout(x, train, rng)
        z = conv_ops.conv2d(x, params["W"], self.stride, self.padding,
                            self.convolution_mode, self.dilation)
        if self.has_bias:
            z = z + params["b"]
        return self._activate(z), state


@serde.register("subsampling")
@dataclasses.dataclass
class SubsamplingLayer(BaseLayerConfig):
    """Pooling layer; ``pooling_type``: max | avg | sum | pnorm."""

    INPUT_KIND = "cnn"

    pooling_type: str = "max"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2
    activation: str = "identity"

    def output_type(self, input_type: InputType) -> InputType:
        h = conv_ops.conv_output_size(
            input_type.height, self.kernel_size[0], self.stride[0],
            self.padding[0], self.convolution_mode)
        w = conv_ops.conv_output_size(
            input_type.width, self.kernel_size[1], self.stride[1],
            self.padding[1], self.convolution_mode)
        return _inputs.convolutional(h, w, input_type.channels)

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None):
        x = self.apply_dropout(x, train, rng)
        out = conv_ops.pool2d(x, self.pooling_type, self.kernel_size,
                              self.stride, self.padding,
                              self.convolution_mode, self.pnorm)
        return out, state


@serde.register("zero_padding")
@dataclasses.dataclass
class ZeroPaddingLayer(BaseLayerConfig):
    """Explicit spatial zero padding (top, bottom, left, right)."""

    INPUT_KIND = "cnn"

    padding: Tuple[int, int, int, int] = (0, 0, 0, 0)
    activation: str = "identity"

    def output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = self.padding
        return _inputs.convolutional(input_type.height + t + b,
                                     input_type.width + l + r,
                                     input_type.channels)

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None):
        t, b, l, r = self.padding
        return F.pad(x, (0, 0, l, r, t, b)), state
