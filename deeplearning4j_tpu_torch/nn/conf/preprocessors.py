"""Input preprocessors: shape adapters between layer families (port of
``deeplearning4j_tpu/nn/conf/preprocessors.py``).

Forward reshapes only: autograd carries the gradient back through them.
The layouts are the JAX package's: CNN activations are NHWC, RNN
activations (batch, time, features), so ``CnnToFeedForwardPreProcessor``
flattens NHWC row-major, and the flat vectors of a dense layer after a
convolution line up with the JAX package's.  The serde type names are the
same, so a configuration crosses between the packages.
"""

from __future__ import annotations

import dataclasses

import torch

from . import inputs as _inputs
from . import serde

Tensor = torch.Tensor
InputType = _inputs.InputType


@dataclasses.dataclass
class BasePreProcessor:
    def __call__(self, x: Tensor) -> Tensor:
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError


@serde.register("cnn_to_ff")
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(BasePreProcessor):
    """(batch, H, W, C) -> (batch, H*W*C), NHWC row-major."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x: Tensor) -> Tensor:
        return x.reshape(x.shape[0], -1)

    def output_type(self, input_type: InputType) -> InputType:
        return _inputs.feed_forward(input_type.flat_size())


@serde.register("ff_to_cnn")
@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(BasePreProcessor):
    """(batch, H*W*C) -> (batch, H, W, C)."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def __call__(self, x: Tensor) -> Tensor:
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type: InputType) -> InputType:
        return _inputs.convolutional(self.height, self.width, self.channels)


@serde.register("rnn_to_ff")
@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(BasePreProcessor):
    """(batch, time, features) -> (batch*time, features)."""

    def __call__(self, x: Tensor) -> Tensor:
        return x.reshape(-1, x.shape[-1])

    def output_type(self, input_type: InputType) -> InputType:
        return _inputs.feed_forward(input_type.flat_size())


@serde.register("ff_to_rnn")
@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(BasePreProcessor):
    """(batch*time, features) -> (batch, time, features); ``timesteps``
    must be known."""

    timesteps: int = -1

    def __call__(self, x: Tensor) -> Tensor:
        if self.timesteps <= 0:
            raise ValueError("FeedForwardToRnnPreProcessor needs timesteps")
        return x.reshape(-1, self.timesteps, x.shape[-1])

    def output_type(self, input_type: InputType) -> InputType:
        return _inputs.recurrent(input_type.flat_size(), self.timesteps)


@serde.register("cnn_to_rnn")
@dataclasses.dataclass
class CnnToRnnPreProcessor(BasePreProcessor):
    """(batch*time, H, W, C) -> (batch, time, H*W*C)."""

    timesteps: int = -1

    def __call__(self, x: Tensor) -> Tensor:
        feat = x.shape[1] * x.shape[2] * x.shape[3]
        return x.reshape(-1, self.timesteps, feat)

    def output_type(self, input_type: InputType) -> InputType:
        return _inputs.recurrent(input_type.flat_size(), self.timesteps)


@serde.register("rnn_to_cnn")
@dataclasses.dataclass
class RnnToCnnPreProcessor(BasePreProcessor):
    """(batch, time, H*W*C) -> (batch*time, H, W, C)."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def __call__(self, x: Tensor) -> Tensor:
        return x.reshape(-1, self.height, self.width, self.channels)

    def output_type(self, input_type: InputType) -> InputType:
        return _inputs.convolutional(self.height, self.width, self.channels)


@serde.register("reshape")
@dataclasses.dataclass
class ReshapePreProcessor(BasePreProcessor):
    """Any reshape that keeps the batch axis; ``shape`` excludes it."""

    shape: tuple = ()

    def __call__(self, x: Tensor) -> Tensor:
        return x.reshape((x.shape[0],) + tuple(self.shape))

    def output_type(self, input_type: InputType) -> InputType:
        shape = tuple(self.shape)
        if len(shape) == 1:
            return _inputs.feed_forward(shape[0])
        if len(shape) == 2:
            return _inputs.recurrent(shape[1], shape[0])
        if len(shape) == 3:
            return _inputs.convolutional(*shape)
        raise ValueError(f"Cannot infer InputType from shape {shape}")


@serde.register("flat_to_cnn")
@dataclasses.dataclass
class FlatToCnnPreProcessor(BasePreProcessor):
    """(batch, H*W*C) flat image rows -> NHWC, for ``convolutional_flat``
    inputs."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def __call__(self, x: Tensor) -> Tensor:
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type: InputType) -> InputType:
        return _inputs.convolutional(self.height, self.width, self.channels)
