"""LeNet-5 for MNIST (port of ``deeplearning4j_tpu/models/lenet.py``):
conv 5x5x20 -> max 2x2 -> conv 5x5x50 -> max 2x2 -> dense 500 relu ->
softmax 10, adam 1e-3, input ``convolutional_flat(28, 28, 1)``."""

from __future__ import annotations

from typing import Optional

from ..nn.conf import inputs
from ..nn.conf.neural_net_configuration import (MultiLayerConfiguration,
                                                NeuralNetConfiguration)
from ..nn.layers.convolution import ConvolutionLayer, SubsamplingLayer
from ..nn.layers.core import DenseLayer, OutputLayer


def lenet(seed: int = 123, learning_rate: float = 1e-3,
          updater: str = "adam", n_classes: int = 10,
          height: int = 28, width: int = 28, channels: int = 1,
          compute_dtype: Optional[str] = None) -> MultiLayerConfiguration:
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(updater).learning_rate(learning_rate)
         .weight_init("xavier").activation("identity"))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    return (b.list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                    stride=(1, 1), activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                    stride=(1, 1), activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=n_classes, activation="softmax",
                               loss="mcxent"))
            .set_input_type(inputs.convolutional_flat(height, width,
                                                      channels))
            .build())
