"""Input-type system for shape inference.

A copy of ``deeplearning4j_tpu/nn/conf/inputs.py`` (which imports no JAX)
kept inside the port so that the port imports nothing of the JAX package.
The serde type names are the same, so JSON written by either package reads
in the other.  Equivalent of the reference's
``nn/conf/inputs/InputType.java:52-84`` (``feedForward`` / ``recurrent`` /
``convolutional`` / ``convolutionalFlat`` factories).

Layouts are the JAX package's: convolutional activations are NHWC and
recurrent activations are (batch, time, features).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import serde


@serde.register("input_ff")
@dataclasses.dataclass
class InputTypeFeedForward:
    size: int = 0

    @property
    def kind(self) -> str:
        return "ff"

    def flat_size(self) -> int:
        return self.size


@serde.register("input_recurrent")
@dataclasses.dataclass
class InputTypeRecurrent:
    size: int = 0
    timesteps: int = -1  # -1 = variable (padded/bucketed at batch time)

    @property
    def kind(self) -> str:
        return "recurrent"

    def flat_size(self) -> int:
        return self.size


@serde.register("input_cnn")
@dataclasses.dataclass
class InputTypeConvolutional:
    height: int = 0
    width: int = 0
    channels: int = 0

    @property
    def kind(self) -> str:
        return "cnn"

    def flat_size(self) -> int:
        return self.height * self.width * self.channels


@serde.register("input_cnn_flat")
@dataclasses.dataclass
class InputTypeConvolutionalFlat:
    """Flattened image input (e.g. MNIST rows of 784) that should be reshaped
    to NHWC before the first conv layer (reference ``convolutionalFlat``)."""

    height: int = 0
    width: int = 0
    channels: int = 1

    @property
    def kind(self) -> str:
        return "cnn_flat"

    def flat_size(self) -> int:
        return self.height * self.width * self.channels


InputType = (InputTypeFeedForward | InputTypeRecurrent |
             InputTypeConvolutional | InputTypeConvolutionalFlat)


def feed_forward(size: int) -> InputTypeFeedForward:
    return InputTypeFeedForward(size)


def recurrent(size: int, timesteps: int = -1) -> InputTypeRecurrent:
    return InputTypeRecurrent(size, timesteps)


def convolutional(height: int, width: int, channels: int) -> InputTypeConvolutional:
    return InputTypeConvolutional(height, width, channels)


def convolutional_flat(height: int, width: int,
                       channels: int = 1) -> InputTypeConvolutionalFlat:
    return InputTypeConvolutionalFlat(height, width, channels)
