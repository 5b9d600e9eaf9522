"""ResNet-50 on the ComputationGraph (port of
``deeplearning4j_tpu/models/resnet.py``; BASELINE.md config #2).

The canonical bottleneck v1 (the stride on the first 1x1 of a block),
built through the GraphBuilder as a DL4J user would: SAME convolutions
without bias, each followed by BatchNormalization, an ElementWiseVertex
add for the identity or projection shortcut, an ActivationLayer relu,
global average pooling and a softmax OutputLayer.  NHWC activations.
"""

from __future__ import annotations

from typing import Optional

from ..nn.conf import inputs
from ..nn.conf.computation_graph import (ComputationGraphConfiguration,
                                         ElementWiseVertex)
from ..nn.conf.neural_net_configuration import NeuralNetConfiguration
from ..nn.layers.convolution import ConvolutionLayer, SubsamplingLayer
from ..nn.layers.core import ActivationLayer, OutputLayer
from ..nn.layers.normalization import BatchNormalization
from ..nn.layers.pooling import GlobalPoolingLayer

STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))  # (blocks, base width)


def _conv_bn(g, name, inp, n_out, kernel, stride, activation="relu"):
    g.add_layer(f"{name}_conv",
                ConvolutionLayer(n_out=n_out, kernel_size=kernel,
                                 stride=stride, convolution_mode="same",
                                 has_bias=False, activation="identity"),
                inp)
    g.add_layer(f"{name}_bn", BatchNormalization(activation=activation),
                f"{name}_conv")
    return f"{name}_bn"


def _bottleneck(g, name, inp, width, stride, project):
    """1x1 -> 3x3 -> 1x1 (x4) with an identity or projection shortcut."""
    x = _conv_bn(g, f"{name}_a", inp, width, (1, 1), (stride, stride))
    x = _conv_bn(g, f"{name}_b", x, width, (3, 3), (1, 1))
    x = _conv_bn(g, f"{name}_c", x, 4 * width, (1, 1), (1, 1),
                 activation="identity")
    if project:
        shortcut = _conv_bn(g, f"{name}_sc", inp, 4 * width, (1, 1),
                            (stride, stride), activation="identity")
    else:
        shortcut = inp
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, shortcut)
    g.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                f"{name}_add")
    return f"{name}_relu"


def resnet50(n_classes: int = 1000, height: int = 224, width: int = 224,
             channels: int = 3, seed: int = 123, learning_rate: float = 0.1,
             updater: str = "nesterovs",
             compute_dtype: Optional[str] = None
             ) -> ComputationGraphConfiguration:
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(updater).learning_rate(learning_rate)
         .weight_init("relu").activation("identity").l2(1e-4))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    g = b.graph_builder()
    g.add_inputs("input")
    x = _conv_bn(g, "stem", "input", 64, (7, 7), (2, 2))
    g.add_layer("stem_pool",
                SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                 stride=(2, 2), convolution_mode="same"),
                x)
    x = "stem_pool"
    for s, (blocks, width_) in enumerate(STAGES):
        for blk in range(blocks):
            stride = 2 if (s > 0 and blk == 0) else 1
            x = _bottleneck(g, f"s{s}b{blk}", x, width_, stride,
                            project=(blk == 0))
    g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("fc", OutputLayer(n_out=n_classes, activation="softmax",
                                  loss="mcxent"), "avgpool")
    g.set_outputs("fc")
    g.set_input_types(inputs.convolutional(height, width, channels))
    return g.build()
