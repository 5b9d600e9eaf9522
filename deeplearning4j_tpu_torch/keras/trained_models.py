"""The pretrained-model path: VGG-16 (port of
``deeplearning4j_tpu/keras/trained_models.py``; the reference's
``trainedmodels/TrainedModels.java:18``, the VGG16 / VGG16NOTOP enum that
fetches Keras-1 h5 weights and builds the network, with
``VGG16ImagePreProcessor`` and ``TrainedModelHelper``).

The architecture builder and the weight loader are here (BASELINE.md
config #5 is VGG-16 through the importer); fetching the ``.h5`` is the
caller's job: ``load_vgg16`` takes a local path.  The network is built
on ``device`` (the card unless ``device="cpu"``), and after the weights
are written the fp32 masters of a mixed precision policy are re-derived
from them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import DeviceLike
from ..nn.conf import inputs as _inputs
from ..nn.conf.neural_net_configuration import (MultiLayerConfiguration,
                                                NeuralNetConfiguration)
from ..nn.layers.convolution import ConvolutionLayer, SubsamplingLayer
from ..nn.layers.core import DenseLayer, OutputLayer
from ..nn.multilayer import MultiLayerNetwork
from .keras_model_import import (_tensor_like, th_dense_rows_to_nhwc,
                                 th_kernel_to_hwio)

# conv widths per block (reference VGG-16 topology)
_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
           (512, 512, 512))


def vgg16(n_classes: int = 1000, include_top: bool = True,
          height: int = 224, width: int = 224, channels: int = 3,
          compute_dtype: Optional[str] = None) -> MultiLayerConfiguration:
    """VGG-16 configuration (reference ``TrainedModels.VGG16`` /
    ``VGG16NOTOP`` when ``include_top=False``)."""
    b = (NeuralNetConfiguration.builder()
         .seed(12).updater("nesterovs").learning_rate(1e-2)
         .weight_init("relu").activation("identity"))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    lb = b.list()
    for widths in _BLOCKS:
        for w in widths:
            lb.layer(ConvolutionLayer(n_out=w, kernel_size=(3, 3),
                                      stride=(1, 1),
                                      convolution_mode="same",
                                      activation="relu"))
        lb.layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                  stride=(2, 2)))
    if include_top:
        lb.layer(DenseLayer(n_out=4096, activation="relu"))
        lb.layer(DenseLayer(n_out=4096, activation="relu"))
        lb.layer(OutputLayer(n_out=n_classes, activation="softmax",
                             loss="mcxent"))
    lb.set_input_type(_inputs.convolutional(height, width, channels))
    return lb.build()


class VGG16ImagePreProcessor:
    """ImageNet mean subtraction (reference ``VGG16ImagePreProcessor``):
    per-channel RGB means, applied to (batch, H, W, 3) f32 images in
    0-255 range.  Usable as a DataSet preprocessor or called directly."""

    MEANS = np.array([123.68, 116.779, 103.939], np.float32)

    def transform(self, features: np.ndarray) -> np.ndarray:
        return np.asarray(features, np.float32) - self.MEANS

    def preprocess(self, dataset) -> None:
        dataset.features = self.transform(dataset.features)

    __call__ = transform


class ImageNetLabels:
    """Class-index -> label decoding (reference
    ``modelimport/.../Utils/ImageNetLabels.java``: decodePredictions).

    The reference downloads the 1000 ImageNet label strings; in a
    zero-egress build the labels come from a user-supplied file (one
    label per line, index order) and default to ``class_0000``-style
    placeholders.
    """

    def __init__(self, labels_path: Optional[str] = None,
                 labels: Optional[list] = None, n_classes: int = 1000):
        if labels is not None:
            self.labels = list(labels)
        elif labels_path is not None:
            with open(labels_path, "r", encoding="utf-8") as f:
                self.labels = [ln.strip() for ln in f if ln.strip()]
        else:
            self.labels = [f"class_{i:04d}" for i in range(n_classes)]

    def label(self, idx: int) -> str:
        return self.labels[idx]

    def decode_predictions(self, predictions, top: int = 5):
        """(batch, classes) probabilities -> per-example
        [(label, probability), ...] of the ``top`` most probable classes
        (reference ``decodePredictions``)."""
        p = np.asarray(predictions)
        if p.ndim == 1:
            p = p[None]
        if p.shape[-1] != len(self.labels):
            raise ValueError(f"{p.shape[-1]} classes vs "
                             f"{len(self.labels)} labels")
        order = np.argsort(-p, axis=-1)[:, :top]
        return [[(self.labels[int(c)], float(row_p[int(c)]))
                 for c in row] for row, row_p in zip(order, p)]


def load_vgg16(weights_path: Optional[str] = None,
               n_classes: int = 1000,
               include_top: bool = True,
               device: DeviceLike = None) -> MultiLayerNetwork:
    """Build VGG-16 and (optionally) load Keras-1 h5 weights into it —
    the ``TrainedModelHelper.loadModel`` role.  The h5 must carry the
    standard Keras-1 VGG16 layer groups in file order (conv*/dense*)."""
    net = MultiLayerNetwork(vgg16(n_classes=n_classes,
                                  include_top=include_top),
                            device=device).init()
    if weights_path is None:
        return net
    import h5py
    with h5py.File(weights_path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        # layers with params, in order
        param_layers = [i for i, l in enumerate(net.conf.layers)
                        if net.params[i]]
        # Keras-1 save_weights records file order in the `layer_names`
        # root attr; h5py group iteration is alphabetical (conv2d_10
        # sorts before conv2d_2), so the attr is authoritative.
        layer_names = [n.decode() if isinstance(n, bytes) else str(n)
                       for n in g.attrs.get("layer_names", [])]
        if not layer_names:
            layer_names = list(g)
        h5_layers = []
        for name in layer_names:
            grp = g[name]
            names = list(grp.attrs.get("weight_names", []))
            if names:
                h5_layers.append((name, grp, names))
        if len(h5_layers) != len(param_layers):
            raise ValueError(
                f"VGG16 weight file has {len(h5_layers)} param layers, "
                f"architecture expects {len(param_layers)}")
        th_detected = False
        last_conv_channels = None
        seen_dense_after_conv = False
        for (name, grp, names), i in zip(h5_layers, param_layers):
            arrays = [np.asarray(grp[n if isinstance(n, str)
                                     else n.decode()]) for n in names]
            W, bias = arrays[0], arrays[1]
            want = net.params[i]["W"].shape
            if W.ndim == 4:
                last_conv_channels = want[-1]
                if W.shape[0] not in (1, 3) and W.shape[-1] != want[-1]:
                    # th ordering; shared transform with the importer
                    W = th_kernel_to_hwio(W)
                    th_detected = True
            elif (W.ndim == 2 and not seen_dense_after_conv
                  and last_conv_channels is not None):
                seen_dense_after_conv = True
                if th_detected:
                    # th flatten order is (C, H, W); this network flattens
                    # NHWC — permute the first dense layer's input rows
                    # (shared transform with the importer).
                    c = last_conv_channels
                    s = int(round((W.shape[0] / c) ** 0.5))
                    W = th_dense_rows_to_nhwc(W, (s, s, c))
            for k, a in (("W", W), ("b", bias)):
                p = net.params[i][k]
                net.params[i][k] = _tensor_like(a, p).reshape(p.shape)
    net._sync_masters_from_params()
    return net


class TrainedModels:
    """Reference enum-shaped namespace (``TrainedModels.java``)."""

    VGG16 = staticmethod(lambda weights_path=None, device=None: load_vgg16(
        weights_path, include_top=True, device=device))
    VGG16NOTOP = staticmethod(
        lambda weights_path=None, device=None: load_vgg16(
            weights_path, include_top=False, device=device))
