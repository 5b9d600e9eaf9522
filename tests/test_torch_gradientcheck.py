"""The port's gradient checker (``gradientcheck.py``): float64 checks pass
for an MLP and for a CNN with conv, pooling, batch norm, LRN and global
pooling, and fail for a deliberately wrong backward.  The thresholds are
the JAX package's (eps 1e-6, max relative error 1e-3, min absolute error
1e-8); the same networks pass the JAX package's checker, built from the
same JSON and weights.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.gradientcheck import check_gradients as jax_check
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import convolution as jconvl
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import pooling as jpool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import convolution as conv_ops

_LRN = conv_ops.local_response_normalization


def _mlp(dtype="float64"):
    return (JaxConf.builder().seed(12345).dtype(dtype).updater("sgd")
            .learning_rate(0.1).l1(0.01).l2(0.02).weight_init("xavier")
            .list()
            .layer(jcore.DenseLayer(n_out=6, activation="tanh"))
            .layer(jcore.DenseLayer(n_out=5, activation="elu"))
            .layer(jcore.OutputLayer(n_out=3))
            .set_input_type(jin.feed_forward(4)).build())


def _cnn():
    return (JaxConf.builder().seed(12345).dtype("float64").updater("sgd")
            .learning_rate(0.1).weight_init("xavier").activation("tanh")
            .list()
            .layer(jconvl.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                           stride=(2, 2),
                                           convolution_mode="same"))
            .layer(jnorm.BatchNormalization())
            .layer(jconvl.SubsamplingLayer(pooling_type="avg",
                                           kernel_size=(2, 2), stride=(1, 1),
                                           convolution_mode="same"))
            .layer(jnorm.LocalResponseNormalization(n=3, alpha=0.1))
            .layer(jconvl.SubsamplingLayer(pooling_type="pnorm", pnorm=2,
                                           kernel_size=(2, 2),
                                           stride=(1, 1)))
            .layer(jpool.GlobalPoolingLayer(pooling_type="avg"))
            .layer(jcore.OutputLayer(n_out=3))
            .set_input_type(jin.convolutional(7, 6, 2)).build())


def _pair(conf, features_shape, seed=0):
    jnet = JaxNet(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    net.set_flat_params(np.asarray(jnet.get_flat_params()))
    rng = np.random.RandomState(seed)
    x = rng.randn(*features_shape)
    y = np.eye(3)[rng.randint(0, 3, features_shape[0])]
    return jnet, net, x, y


def test_mlp_gradients_check_in_float64():
    jnet, net, x, y = _pair(_mlp(), (8, 4))
    assert check_gradients(net, DataSet(x, y), print_results=True)
    assert jax_check(jnet, JaxDataSet(x, y))


def test_cnn_gradients_check_in_float64():
    jnet, net, x, y = _pair(_cnn(), (4, 7, 6, 2))
    # non-trivial running statistics: the check runs in inference mode
    net.net_state[1] = {"mean": torch.full((3,), 0.1, dtype=torch.float64),
                        "var": torch.full((3,), 1.7, dtype=torch.float64)}
    assert check_gradients(net, DataSet(x, y), print_results=True)
    assert check_gradients(net, DataSet(x, y), subset=20, seed=3)
    assert jax_check(jnet, JaxDataSet(x, y))


class _LrnWithoutCrossTerm(torch.autograd.Function):
    """LRN whose backward treats the denominator as a constant: the
    forward is right, the gradient wrong."""

    @staticmethod
    def forward(ctx, x, k, n, alpha, beta):
        out = _LRN(x, k, n, alpha, beta)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.where(x == 0, torch.zeros_like(x), out / x), \
            None, None, None, None


def test_a_wrong_backward_fails_the_check(monkeypatch):
    _, net, x, y = _pair(_cnn(), (4, 7, 6, 2))
    assert check_gradients(net, DataSet(x, y))
    monkeypatch.setattr(conv_ops, "local_response_normalization",
                        _LrnWithoutCrossTerm.apply)
    assert not check_gradients(net, DataSet(x, y), print_results=True)


def test_a_float32_network_is_refused():
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _mlp("float32").to_json()), device="cpu").init()
    x = np.zeros((2, 4))
    with pytest.raises(ValueError, match="float64"):
        check_gradients(net, DataSet(x, np.eye(3)[[0, 1]]))
