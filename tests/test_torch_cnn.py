"""The convolutional slice as a whole: LeNet-shaped networks and a CNN with
every ported family (conv stride 2 SAME, max and avg SAME pooling,
BatchNormalization, LRN, GlobalPooling) built in the JAX package, read by
the port from its JSON, given the same weights, and held on the forward
pass and on fit steps; the NHWC flatten order of CnnToFeedForward; the
preprocessors (each class, and the ones shape inference inserts).

Tolerances: float32 networks 1e-5 of max|JAX| for outputs, params and
batch-norm state and 1e-5 relative for scores (f32 sums in another
order); float64 1e-10 (SGD at an lr exact in float32, see
test_torch_core_layers.py).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.lenet import lenet as jax_lenet
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import convolution as jconvl
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import pooling as jpool
from deeplearning4j_tpu.nn.layers.recurrent import \
    RnnOutputLayer as JaxRnnOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.lenet import lenet
from deeplearning4j_tpu_torch.nn.conf import inputs
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers.convolution import ConvolutionLayer
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = {"float64": 1e-10, "float32": 1e-5}


def _pair(conf):
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(initial=0.0))


def _narrow_lenet(dtype, updater, lr, hw=20):
    """LeNet's layers and defaults at narrow widths (4 and 6 filters,
    dense 16) on a hw x hw image."""
    return (JaxConf.builder().seed(123).dtype(dtype).updater(updater)
            .learning_rate(lr).weight_init("xavier").activation("identity")
            .list()
            .layer(jconvl.ConvolutionLayer(n_out=4, kernel_size=(5, 5)))
            .layer(jconvl.SubsamplingLayer(pooling_type="max"))
            .layer(jconvl.ConvolutionLayer(n_out=6, kernel_size=(5, 5)))
            .layer(jconvl.SubsamplingLayer(pooling_type="max"))
            .layer(jcore.DenseLayer(n_out=16, activation="relu"))
            .layer(jcore.OutputLayer(n_out=10))
            .set_input_type(jin.convolutional_flat(hw, hw, 1))
            .build())


def _mnist_like(n, hw, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, hw * hw).astype(dtype)
    y = np.eye(10, dtype=dtype)[rng.randint(0, 10, n)]
    return x, y


@pytest.mark.parametrize("dtype,updater,lr", [("float32", "adam", 1e-3),
                                              ("float64", "sgd", 0.0625)])
def test_narrow_lenet_forward_and_one_step_match_jax(dtype, updater, lr):
    jnet, pnet = _pair(_narrow_lenet(dtype, updater, lr))
    x, y = _mnist_like(8, 20, dtype)
    tol = TOL[dtype]
    _close(pnet.output(x), jnet.output(x), tol)
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    np.testing.assert_allclose(pnet.score(), float(jnet.score()), rtol=tol)
    _close(pnet.get_flat_params(), jnet.get_flat_params(), tol)
    _close(pnet.get_flat_updater_state(), jnet.get_flat_updater_state(),
           tol)
    _close(pnet.output(x), jnet.output(x), tol)


def test_lenet_builder_writes_the_jax_configuration():
    conf, jconf = lenet(), jax_lenet()
    assert conf.to_json() == jconf.to_json()
    assert [type(p).__name__ for p in conf.input_preprocessors.values()] \
        == ["FlatToCnnPreProcessor", "CnnToFeedForwardPreProcessor"]
    assert sorted(conf.input_preprocessors) == [0, 4]
    assert conf.layers[4].n_in == 4 * 4 * 50
    assert lenet(compute_dtype="bfloat16").to_json() == \
        jax_lenet(compute_dtype="bfloat16").to_json()


def test_cnn_to_ff_flattens_nhwc_row_major():
    """The flat index of (h, w, c) is (h * W + w) * C + c, as in the JAX
    package (MANIFEST ``cnn_adam`` row): a dense layer after a conv reads
    the same weight rows in both packages."""
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    got = pp.CnnToFeedForwardPreProcessor(3, 4, 5)(torch.as_tensor(x))
    want = jpp.CnnToFeedForwardPreProcessor(3, 4, 5)(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    h, w, c = 2, 1, 3
    assert got[1, (h * 4 + w) * 5 + c] == x[1, h, w, c]
    conf = (JaxConf.builder().seed(1).list()
            .layer(jconvl.ConvolutionLayer(n_out=5, kernel_size=(1, 1),
                                           activation="identity",
                                           has_bias=False))
            .layer(jcore.OutputLayer(n_out=2, activation="identity",
                                     loss="mse"))
            .set_input_type(jin.convolutional(3, 4, 2)).build())
    jnet, pnet = _pair(conf)
    xin = np.random.RandomState(2).randn(3, 3, 4, 2).astype(np.float32)
    _close(pnet.output(xin), jnet.output(xin), 1e-5)


_PP_CASES = [
    ("cnn_to_ff", (3, 4, 5), (2, 4, 5, 3)),
    ("ff_to_cnn", (4, 5, 3), (2, 60)),
    ("rnn_to_ff", (), (2, 7, 6)),
    ("ff_to_rnn", (7,), (14, 6)),
    ("cnn_to_rnn", (7,), (14, 2, 3, 4)),
    ("rnn_to_cnn", (2, 3, 4), (2, 7, 24)),
    ("reshape", ((5, 12),), (2, 60)),
    ("flat_to_cnn", (4, 5, 3), (2, 60)),
]


@pytest.mark.parametrize("kind,args,shape", _PP_CASES,
                         ids=[c[0] for c in _PP_CASES])
def test_each_preprocessor_matches_jax(kind, args, shape):
    from deeplearning4j_tpu.nn.conf import serde as jserde
    from deeplearning4j_tpu_torch.nn.conf import serde
    jp = jserde.registry()[kind](*args)
    p = serde.from_dict(jserde.to_dict(jp))
    assert type(p).__name__ == type(jp).__name__
    assert serde.to_dict(p) == jserde.to_dict(jp)
    x = np.random.RandomState(3).randn(*shape)
    np.testing.assert_array_equal(p(torch.as_tensor(x)).numpy(),
                                  np.asarray(jp(jnp.asarray(x))))
    for t in (jin.feed_forward(60), jin.recurrent(24, 7),
              jin.convolutional(2, 3, 4)):
        try:
            want = jp.output_type(t)
        except ValueError:
            continue
        got = p.output_type(serde.from_dict(jserde.to_dict(t)))
        assert serde.to_dict(got) == jserde.to_dict(want)


def _inferred(jax_layers, jax_input, explicit=None):
    b = JaxConf.builder().seed(1).list()
    for layer in jax_layers:
        b.layer(layer)
    for i, p in (explicit or {}).items():
        b.input_preprocessor(i, p)
    return b.set_input_type(jax_input).build()


@pytest.mark.parametrize("case", ["flat_cnn_ff", "rnn_ff", "ff_rnn",
                                  "cnn_rnn", "explicit_ff_cnn"])
def test_shape_inference_inserts_the_jax_preprocessors(case):
    """Built in the port with the port's layers, each configuration equals
    the JAX package's: the same preprocessors at the same indices, the
    same n_in everywhere."""
    from deeplearning4j_tpu_torch.nn.conf import serde
    from deeplearning4j_tpu.nn.conf import serde as jserde
    jax_layers, jax_input, explicit = {
        "flat_cnn_ff": ([jconvl.ConvolutionLayer(n_out=3, kernel_size=(3, 3)),
                         jcore.DenseLayer(n_out=4),
                         jcore.OutputLayer(n_out=2)],
                        jin.convolutional_flat(6, 6, 1), None),
        "rnn_ff": ([jcore.DenseLayer(n_out=4), jcore.OutputLayer(n_out=2)],
                   jin.recurrent(5, 7), None),
        "ff_rnn": ([jcore.DenseLayer(n_out=4), JaxRnnOutput(n_out=2)],
                   jin.feed_forward(5), None),
        "cnn_rnn": ([jconvl.ConvolutionLayer(n_out=3, kernel_size=(3, 3)),
                     JaxRnnOutput(n_out=2)],
                    jin.convolutional(5, 5, 2), None),
        "explicit_ff_cnn": ([jcore.DenseLayer(n_out=48),
                             jconvl.ConvolutionLayer(n_out=2,
                                                     kernel_size=(2, 2)),
                             jcore.OutputLayer(n_out=2)],
                            jin.feed_forward(5),
                            {1: jpp.FeedForwardToCnnPreProcessor(4, 4, 3)}),
    }[case]
    b = NeuralNetConfiguration.builder().seed(1).list()
    for layer in jax_layers:
        b.layer(serde.from_dict(jserde.to_dict(layer)))
    jconf = _inferred(jax_layers, jax_input, explicit)
    for i, p in (explicit or {}).items():
        b.input_preprocessor(i, serde.from_dict(jserde.to_dict(p)))
    conf = b.set_input_type(serde.from_dict(jserde.to_dict(jax_input))) \
        .build()
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    assert set(conf.input_preprocessors) == set(jconf.input_preprocessors)


def test_ff_to_cnn_without_an_explicit_preprocessor_raises():
    b = (NeuralNetConfiguration.builder().list()
         .layer(DenseLayer(n_out=8))
         .layer(ConvolutionLayer(n_out=2, kernel_size=(2, 2)))
         .layer(OutputLayer(n_out=2))
         .set_input_type(inputs.feed_forward(4)))
    with pytest.raises(ValueError, match="ff->cnn"):
        b.build()


def _all_families_cnn(dtype="float32"):
    """Every ported family: conv stride 2 SAME, max and avg SAME pooling,
    BatchNormalization, LRN, GlobalPooling; the CNN of chip_smoke.py
    phase 9 at a smaller image."""
    return (JaxConf.builder().seed(5).dtype(dtype).updater("adam")
            .learning_rate(1e-2).weight_init("xavier").activation("relu")
            .list()
            .layer(jconvl.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                           stride=(2, 2),
                                           convolution_mode="same"))
            .layer(jnorm.BatchNormalization())
            .layer(jconvl.SubsamplingLayer(pooling_type="max",
                                           kernel_size=(3, 3), stride=(2, 2),
                                           convolution_mode="same"))
            .layer(jnorm.LocalResponseNormalization(n=4, alpha=1e-2))
            .layer(jconvl.ConvolutionLayer(n_out=12, kernel_size=(3, 3),
                                           convolution_mode="same"))
            .layer(jconvl.SubsamplingLayer(pooling_type="avg",
                                           kernel_size=(3, 3), stride=(2, 2),
                                           convolution_mode="same"))
            .layer(jpool.GlobalPoolingLayer(pooling_type="avg"))
            .layer(jcore.OutputLayer(n_out=5))
            .set_input_type(jin.convolutional(15, 13, 3))
            .build())


def test_all_families_cnn_forward_and_two_steps_match_jax():
    jnet, pnet = _pair(_all_families_cnn())
    rng = np.random.RandomState(4)
    x = rng.randn(6, 15, 13, 3).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 6)]
    _close(pnet.output(x), jnet.output(x), 1e-5)
    for _ in range(2):
        jnet.fit(JaxDataSet(x, y))
        pnet.fit(DataSet(x, y))
        np.testing.assert_allclose(pnet.score(), float(jnet.score()),
                                   rtol=1e-5)
        _close(pnet.get_flat_params(), jnet.get_flat_params(), 1e-5)
        for key in ("mean", "var"):
            _close(pnet.net_state[1][key], jnet.net_state[1][key], 1e-5)
    _close(pnet.output(x), jnet.output(x), 1e-5)
    assert pnet.iteration == 2


def test_batch_norm_running_stats_are_the_biased_batch_variance():
    """One training forward moves the running stats by (1 - decay) toward
    the batch's mean and biased variance (not torch's unbiased one)."""
    _, pnet = _pair(_all_families_cnn())
    bn = pnet.layers[1]
    x = torch.randn(10, 4, 4, 8, dtype=torch.float32)
    _, state = bn.forward(pnet.params[1], pnet.net_state[1], x, train=True,
                          rng=None)
    flat = x.reshape(-1, 8)
    np.testing.assert_allclose(state["mean"].numpy(),
                               (0.1 * flat.mean(0)).numpy(), atol=1e-6)
    np.testing.assert_allclose(state["var"].numpy(),
                               (0.9 + 0.1 * flat.var(0, unbiased=False))
                               .numpy(), atol=1e-6)


def test_lock_gamma_beta_has_no_params_and_matches_jax():
    conf = (JaxConf.builder().seed(2).updater("sgd").learning_rate(0.1)
            .list()
            .layer(jcore.DenseLayer(n_out=6, activation="tanh"))
            .layer(jnorm.BatchNormalization(lock_gamma_beta=True,
                                            gamma_init=1.5, beta_init=0.25))
            .layer(jcore.OutputLayer(n_out=3))
            .set_input_type(jin.feed_forward(4)).build())
    jnet, pnet = _pair(conf)
    assert pnet.params[1] == {} and pnet.num_params() == jnet.num_params()
    rng = np.random.RandomState(6)
    x = rng.randn(7, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 7)]
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    _close(pnet.get_flat_params(), jnet.get_flat_params(), 1e-5)
    _close(pnet.output(x), jnet.output(x), 1e-5)


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("collapse", [True, False])
def test_global_pooling_matches_jax_cnn_and_masked_rnn(kind, collapse):
    layer = jpool.GlobalPoolingLayer(pooling_type=kind, pnorm=3,
                                     collapse_dimensions=collapse)
    from deeplearning4j_tpu_torch.nn.layers.pooling import GlobalPoolingLayer
    port = GlobalPoolingLayer(pooling_type=kind, pnorm=3,
                              collapse_dimensions=collapse,
                              activation="identity")
    rng = np.random.RandomState(7)
    for x, mask in ((rng.randn(2, 3, 4, 5), None),
                    (rng.randn(3, 6, 4), None),
                    (rng.randn(3, 6, 4),
                     (rng.rand(3, 6) > 0.3).astype(np.float64))):
        want, _ = layer.forward({}, {}, jnp.asarray(x), train=False,
                                mask=None if mask is None
                                else jnp.asarray(mask))
        got, _ = port.forward({}, {}, torch.as_tensor(x), train=False,
                              mask=None if mask is None
                              else torch.as_tensor(mask))
        _close(got, want, 1e-12)


def test_zero_padding_layer_matches_jax():
    from deeplearning4j_tpu_torch.nn.layers.convolution import \
        ZeroPaddingLayer
    x = np.random.RandomState(8).randn(2, 3, 4, 2)
    want, _ = jconvl.ZeroPaddingLayer(padding=(1, 2, 0, 3)).forward(
        {}, {}, jnp.asarray(x), train=False)
    got, _ = ZeroPaddingLayer(padding=(1, 2, 0, 3)).forward(
        {}, {}, torch.as_tensor(x), train=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
