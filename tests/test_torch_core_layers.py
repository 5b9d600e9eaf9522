"""The core feed-forward layers of the port (``nn/layers/core.py``: Dense,
Output, Loss, Activation, Dropout, Embedding) against the JAX package's:
each network is built in the JAX package, read by the port from its JSON,
given the same weights, and held on its output, its score, its
per-example scores and one update step.

Tolerances: float64 networks 1e-10 of max|JAX| (params) and 1e-10
relative (scores); float32 networks 1e-5 of both (f32 sums in another
order).  The JAX package computes the learning rate and Adam's bias
correction in float32 even for a float64 network, so the float64 updates
run the SGD-family rules at a learning rate and momentum exact in float32
(0.0625, 0.5), and Adam is held in float32.
"""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import inputs as jax_inputs
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.core import DropoutLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = {"float64": 1e-10, "float32": 1e-5}
N, N_IN, N_CLS = 6, 5, 3


def _stacks():
    """name -> (JAX layers, input type, regression labels?, int input?)"""
    return {
        "dense_output": ([jcore.DenseLayer(n_out=7, activation="tanh"),
                          jcore.OutputLayer(n_out=N_CLS)], False, False),
        "dense_l2_mse": ([jcore.DenseLayer(n_out=7, activation="relu",
                                           l2=1e-2, l1=1e-3),
                          jcore.DenseLayer(n_out=4, activation="sigmoid"),
                          jcore.OutputLayer(n_out=N_CLS,
                                            activation="identity",
                                            loss="mse")], True, False),
        "activation": ([jcore.DenseLayer(n_out=6, activation="identity"),
                        jcore.ActivationLayer(activation="elu"),
                        jcore.OutputLayer(n_out=N_CLS)], False, False),
        "loss_layer": ([jcore.DenseLayer(n_out=N_CLS, activation="identity"),
                        jcore.LossLayer(loss="mse", activation="tanh")],
                       True, False),
        "dropout_layer": ([jcore.DenseLayer(n_out=6, activation="tanh"),
                           jcore.DropoutLayer(dropout=0.0,
                                              activation="softsign"),
                           jcore.OutputLayer(n_out=N_CLS)], False, False),
        "embedding": ([jcore.EmbeddingLayer(n_in=10, n_out=4,
                                            activation="tanh"),
                       jcore.OutputLayer(n_out=N_CLS)], False, True),
    }


UPDATER = {"float64": ("sgd", 0.0625), "float32": ("adam", 0.05)}


def _pair(name, dtype, updater=None, lr=None):
    layers, regression, ints = _stacks()[name]
    updater, lr = (updater, lr) if updater else UPDATER[dtype]
    b = (JaxConf.builder().seed(7).dtype(dtype).updater(updater)
         .learning_rate(lr).momentum(0.5).activation("tanh").list())
    for layer in layers:
        b.layer(layer)
    n_in = 1 if ints else N_IN
    conf = b.set_input_type(jax_inputs.feed_forward(n_in)).build()
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    rng = np.random.RandomState(3)
    x = (rng.randint(0, 10, (N, 1)) if ints
         else rng.randn(N, n_in).astype(dtype))
    y = (rng.randn(N, N_CLS) if regression
         else np.eye(N_CLS)[rng.randint(0, N_CLS, N)]).astype(dtype)
    assert json.loads(pnet.conf.to_json()) == json.loads(conf.to_json())
    return jnet, pnet, x, y


def _flat(net):
    return np.asarray(net.get_flat_params(), np.float64)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(_stacks()))
def test_layer_forward_score_and_one_update_match_jax(name, dtype):
    jnet, pnet, x, y = _pair(name, dtype)
    tol = TOL[dtype]
    want = np.asarray(jnet.output(x), np.float64)
    got = pnet.output(x).numpy().astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
    np.testing.assert_allclose(pnet.score(DataSet(x, y)),
                               float(jnet.score(JaxDataSet(x, y))), rtol=tol)
    np.testing.assert_allclose(
        pnet.score_examples(DataSet(x, y)).numpy(),
        np.asarray(jnet.score_examples(JaxDataSet(x, y))), rtol=tol,
        atol=tol)
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    np.testing.assert_allclose(pnet.score(), float(jnet.score()), rtol=tol)
    a, b = _flat(jnet), _flat(pnet)
    np.testing.assert_allclose(b, a, rtol=0, atol=tol * np.abs(a).max())
    assert not np.array_equal(a, np.asarray(_pair(name, dtype)[0]
                                            .get_flat_params()))


@pytest.mark.parametrize("updater", ["sgd", "nesterovs", "rmsprop"])
def test_dense_update_matches_jax_for_other_updaters(updater):
    jnet, pnet, x, y = _pair("dense_l2_mse", "float64", updater, 0.0625)
    for _ in range(2):
        jnet.fit(JaxDataSet(x, y))
        pnet.fit(DataSet(x, y))
    a, b = _flat(jnet), _flat(pnet)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-10 * np.abs(a).max())


def test_embedding_takes_integer_indices_uncast():
    _, pnet, x, _ = _pair("embedding", "float32")
    idx = torch.as_tensor(x)
    assert not idx.is_floating_point()
    out = pnet.output(idx[:, 0])
    np.testing.assert_allclose(out.numpy(), pnet.output(x).numpy())
    w, b = pnet.params[0]["W"], pnet.params[0]["b"]
    hidden = torch.tanh(w[idx[:, 0]] + b)
    want = torch.softmax(hidden @ pnet.params[1]["W"] + pnet.params[1]["b"],
                         -1)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6)


def test_dropout_layer_is_inverted_dropout_in_training_only():
    layer = DropoutLayer(dropout=0.25, activation="identity")
    x = torch.ones(400, 50)
    out, _ = layer.forward({}, {}, x, train=False)
    assert torch.equal(out, x)
    gen = torch.Generator().manual_seed(0)
    out, _ = layer.forward({}, {}, x, train=True, rng=gen)
    kept = out != 0
    assert torch.all(out[kept] == 1.0 / 0.75)
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    with pytest.raises(ValueError, match="generator"):
        layer.forward({}, {}, x, train=True, rng=None)
