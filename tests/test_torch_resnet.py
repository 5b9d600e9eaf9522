"""ResNet-50 (``models/resnet.py``) in the port against the JAX package's,
cut to 32x32 images and 10 classes at batch 2 (BASELINE.md config #2 at
full width; only the spatial size and the classes are cut): the same
configuration text, the canonical parameter count, the forward pass and
one nesterovs ``fit`` step (the batch-norm running statistics included)
on the JAX network's weights.

The JAX side costs about three quarters of a minute on the CPU (init and
the jitted forward and step, twice), so each network is built once for
the module.

Tolerances.  The forward runs in float32 in inference mode (running
statistics): 53 convolutions and 53 batch norms deep, f32 sums in another
order at every layer (XLA's convolutions against oneDNN's), so the
probabilities (about 0.1 each) at 1e-5 absolute.  The training step is
held in float64, because at 32x32 the last stage is 1x1 and each of its
batch norms normalizes over 2 values per channel: the output is
d / sqrt(d^2 + eps) for half the difference d of the two examples, whose
slope reaches 1/sqrt(eps) = 316 where d is small, so a rounding
difference grows by up to that factor at each of the stage's ten batch
norms, and every layer's gradient passes back through that stage.  In
float64 that leaves a difference well inside 2e-3 of each vertex's
largest param, velocity and running statistic, which a wrong term in any
layer's gradient exceeds; in float32 the chain does not stay near the
reference at all.  The score is held at 1e-5 relative.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.resnet import resnet50 as jax_resnet50
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JaxCG
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.resnet import resnet50
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.jax_weights import load_jax_params

KW = dict(n_classes=10, height=32, width=32)
PROB_ATOL = 1e-5
STEP_RTOL = 2e-3
SCORE_RTOL = 1e-5


def _data(dtype):
    rng = np.random.RandomState(0)
    x = rng.rand(2, 32, 32, 3).astype(dtype)
    y = np.eye(10, dtype=dtype)[rng.randint(0, 10, 2)]
    return x, y


def _pair(dtype: str):
    jconf, pconf = jax_resnet50(**KW), resnet50(**KW)
    jconf.conf.dtype = pconf.conf.dtype = dtype
    jnet = JaxCG(jconf).init()
    pnet = ComputationGraph(pconf, device="cpu").init()
    load_jax_params(pnet, jnet.params)
    return jnet, pnet


@pytest.fixture(scope="module")
def nets():
    return _pair("float32")


@pytest.fixture(scope="module")
def nets64():
    return _pair("float64")


def test_configuration_and_param_count_are_canonical(nets):
    jnet, pnet = nets
    assert pnet.conf.to_json() == jnet.conf.to_json()
    assert pnet.topo == jnet.topo
    # canonical ResNet-50 (25,557,032 at 1000 classes) with a 10-class fc
    assert pnet.num_params() == jnet.num_params() == \
        25_557_032 - 2048 * 990 - 990
    assert len([n for n in pnet._layer_names() if n.endswith("_bn")]) == 53
    assert len([n for n in pnet._layer_names()
                if n.endswith("_conv")]) == 53
    np.testing.assert_array_equal(pnet.get_flat_params(),
                                  np.asarray(jnet.get_flat_params()))


def test_forward_matches_jax(nets):
    jnet, pnet = nets
    x, _ = _data(np.float32)
    got = pnet.output(x).numpy()
    want = np.asarray(jnet.output(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


def test_one_nesterovs_step_matches_jax(nets64):
    jnet, pnet = nets64
    x, y = _data(np.float64)
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    assert pnet.iteration == jnet.iteration == 1
    assert pnet.score() == pytest.approx(float(jnet.score()),
                                         rel=SCORE_RTOL)
    for name in pnet._layer_names():
        for key, want in jnet.params[name].items():
            want = np.asarray(want)
            np.testing.assert_allclose(
                pnet.params[name][key].numpy(), want, rtol=0,
                atol=STEP_RTOL * np.abs(want).max(), err_msg=f"{name} {key}")
            v = np.asarray(jnet.updater_state[name]["v"][key])
            np.testing.assert_allclose(
                pnet.updater_state[name]["v"][key].numpy(), v, rtol=0,
                atol=STEP_RTOL * np.abs(v).max(), err_msg=f"{name} v {key}")
        for key, want in jnet.net_state[name].items():
            want = np.asarray(want)
            np.testing.assert_allclose(
                pnet.net_state[name][key].numpy(), want, rtol=0,
                atol=STEP_RTOL * np.abs(want).max(), err_msg=f"{name} {key}")
    assert list(pnet.net_state) == list(jnet.net_state)
