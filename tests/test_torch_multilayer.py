"""The slice as a whole: a CausalSelfAttention -> RnnOutputLayer network
built in the JAX package, read by the port from its JSON, given the same
weights, and trained 3 steps on both sides in fp32 (the CPU default of
both packages).  Also the modules under it (activations, losses,
updaters, precision policy, weights), each against the JAX package.

Tolerances: 1e-5 relative for scores, 1e-5 of max|param| for params
(f32 sums in another order; the first runs differ by ~3e-7); 1e-5 for
outputs; 1e-6 for the pure elementwise modules.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn import activations as jax_activations
from deeplearning4j_tpu.nn import lossfunctions as jax_losses
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.nn.conf import inputs as jax_inputs
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers.attention import \
    CausalSelfAttention as JaxAttention
from deeplearning4j_tpu.nn.layers.recurrent import \
    RnnOutputLayer as JaxRnnOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import activations, lossfunctions, updaters
from deeplearning4j_tpu_torch.nn import precision, weights
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.jax_weights import load_jax_params
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

SCORE_RTOL, PARAM_TOL, OUT_TOL, ELEM_TOL = 1e-5, 1e-5, 1e-5, 1e-6
N_IN, T, N_OUT = 8, 32, 5


def _jax_conf(updater="adam", lr=0.01, **extra):
    b = JaxConf.builder().seed(3).updater(updater).learning_rate(lr)
    for name, value in extra.items():
        getattr(b, name)(value)
    return (b.list()
            .layer(JaxAttention(n_out=16, n_heads=2, cache_len=T))
            .layer(JaxRnnOutput(n_out=N_OUT, activation="softmax",
                                loss="mcxent"))
            .set_input_type(jax_inputs.recurrent(N_IN, T))
            .build())


def _pair(conf):
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    load_jax_params(pnet, jnet.get_flat_params())
    return jnet, pnet


def _data(seed=0, t=T, masked=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, t, N_IN).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[rng.randint(0, N_OUT, (2, t))]
    mask = None
    if masked:
        mask = np.ones((2, t), np.float32)
        mask[1, t - 7:] = 0.0
    return x, y, mask


def _assert_params_close(jnet, pnet):
    a, b = jnet.get_flat_params(), pnet.get_flat_params()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0,
                               atol=PARAM_TOL * np.abs(a).max())


def test_port_reads_the_jax_conf_json():
    conf = _jax_conf()
    pconf = MultiLayerConfiguration.from_json(conf.to_json())
    assert [type(l).__name__ for l in pconf.layers] == [
        "CausalSelfAttention", "RnnOutputLayer"]
    assert pconf.layers[0].n_in == N_IN and pconf.layers[1].n_in == 16
    assert json.loads(pconf.to_json()) == json.loads(conf.to_json())


@pytest.mark.parametrize("updater,lr", [("adam", 0.01), ("sgd", 0.1),
                                        ("nesterovs", 0.05),
                                        ("rmsprop", 0.01)])
def test_three_fit_steps_match_jax(updater, lr):
    jnet, pnet = _pair(_jax_conf(updater, lr))
    x, y, _ = _data()
    for _ in range(3):
        jnet.fit(JaxDataSet(x, y))
        pnet.fit(DataSet(x, y))
        np.testing.assert_allclose(pnet.score(), float(jnet.score()),
                                   rtol=SCORE_RTOL)
        _assert_params_close(jnet, pnet)
    assert pnet.iteration == 3


def test_fit_with_features_mask_and_l2_matches_jax():
    jnet, pnet = _pair(_jax_conf("adam", 0.01, l2=1e-3))
    x, y, mask = _data(seed=4, masked=True)
    for _ in range(3):
        jnet.fit(JaxDataSet(x, y, features_mask=mask))
        pnet.fit(DataSet(x, y, features_mask=mask))
        np.testing.assert_allclose(pnet.score(), float(jnet.score()),
                                   rtol=SCORE_RTOL)
        _assert_params_close(jnet, pnet)


def test_output_and_score_match_jax_after_training():
    jnet, pnet = _pair(_jax_conf())
    x, y, _ = _data(seed=1)
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    xt, yt, _ = _data(seed=2, t=20)
    np.testing.assert_allclose(pnet.output(xt).numpy(),
                               np.asarray(jnet.output(xt)), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(pnet.score(DataSet(xt, yt)),
                               jnet.score(JaxDataSet(xt, yt)),
                               rtol=SCORE_RTOL)
    np.testing.assert_allclose(pnet.score_examples(DataSet(xt, yt)).numpy(),
                               jnet.score_examples(JaxDataSet(xt, yt)),
                               rtol=SCORE_RTOL)


def test_param_table_and_layer_dict_loading():
    jnet, pnet = _pair(_jax_conf())
    other = MultiLayerNetwork(pnet.conf, device="cpu").init()
    load_jax_params(other, jnet.params)
    np.testing.assert_array_equal(other.get_flat_params(),
                                  jnet.get_flat_params())
    table = pnet.param_table()
    assert list(table) == list(jnet.param_table())
    for name, value in jnet.param_table().items():
        np.testing.assert_array_equal(table[name], value)
    assert pnet.num_params() == jnet.num_params()
    with pytest.raises(ValueError, match="mismatch"):
        pnet.set_flat_params(np.zeros(3, np.float32))


def test_mixed_policy_keeps_fp32_masters(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PRECISION", "mixed_bf16")
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jax_conf().to_json()), device="cpu").init()
    assert net._pol().name == "mixed_bf16"
    assert net.params[0]["Wq"].dtype == torch.bfloat16
    x, y, _ = _data()
    net.fit(DataSet(x, y))
    masters = net.updater_state[0][updaters.MASTER_KEY]
    assert masters["Wq"].dtype == torch.float32
    assert torch.equal(masters["Wq"].to(torch.bfloat16), net.params[0]["Wq"])
    out = net.output(x)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_precision_resolution_follows_the_jax_rules(monkeypatch):
    from deeplearning4j_tpu.nn import precision as jax_precision
    gconf = _jax_conf().conf
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("DL4J_TPU_PRECISION", raising=False)
    assert precision.resolve_policy(gconf, cpu).name == "fp32"
    assert precision.resolve_policy(gconf, cuda).name == "mixed_bf16"
    assert jax_precision.resolve_policy(gconf).name == "fp32"
    for mode in ("fp32", "bf16", "mixed"):
        monkeypatch.setenv("DL4J_TPU_PRECISION", mode)
        assert precision.resolve_policy(gconf, cuda).name == \
            jax_precision.resolve_policy(gconf).name
    monkeypatch.delenv("DL4J_TPU_PRECISION")
    gconf.compute_dtype = "bfloat16"
    pol = precision.resolve_policy(gconf, cuda)
    jpol = jax_precision.resolve_policy(gconf)
    assert (pol.name, pol.master_weights) == (jpol.name, jpol.master_weights)
    assert pol.compute_dtype == torch.bfloat16
    assert pol.param_dtype == torch.float32


@pytest.mark.parametrize("name", activations.available())
def test_activation_matches_jax(name):
    x = np.linspace(-3, 3, 41, dtype=np.float32).reshape(1, 41)
    np.testing.assert_allclose(
        activations.get(name)(torch.from_numpy(x)).numpy(),
        np.asarray(jax_activations.get(name)(jnp.asarray(x))),
        rtol=ELEM_TOL, atol=ELEM_TOL)


@pytest.mark.parametrize("name,activation", [
    ("mcxent", "softmax"), ("mcxent", "sigmoid"), ("xent", "sigmoid"),
    ("mse", "identity"), ("l1", "tanh"), ("mae", "identity"),
    ("mape", "identity"), ("msle", "relu"), ("hinge", "identity"),
    ("squared_hinge", "identity"), ("kl_divergence", "softmax"),
    ("poisson", "softplus"), ("cosine_proximity", "identity")])
def test_loss_matches_jax_with_and_without_mask(name, activation):
    rng = np.random.RandomState(5)
    preout = rng.randn(3, 6, 4).astype(np.float32)
    labels = rng.rand(3, 6, 4).astype(np.float32)
    mask = (rng.rand(3, 6) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = lossfunctions.score(
            name, torch.from_numpy(labels), torch.from_numpy(preout),
            activation, None if m is None else torch.from_numpy(m))
        want = jax_losses.score(name, jnp.asarray(labels),
                                jnp.asarray(preout), activation,
                                None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("name", ["sgd", "adam", "nesterovs", "adagrad",
                                  "rmsprop", "adadelta", "lars"])
def test_updater_rule_matches_jax(name):
    rng = np.random.RandomState(6)
    params = {"W": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    conf_kw = dict(updater=name, learning_rate=0.05,
                   lr_policy="exponential", lr_policy_decay_rate=0.9,
                   lars_weight_decay=0.01)
    pconf = updaters.UpdaterConfig(**conf_kw)
    jconf = jax_updaters.UpdaterConfig(**conf_kw)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pstate = updaters.init_state(pconf, tp)
    jstate = jax_updaters.init_state(jconf, jp)
    for it in range(3):
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
        pu, pstate = updaters.compute_update(
            pconf, {k: torch.from_numpy(v) for k, v in g.items()}, pstate,
            it, params=tp)
        ju, jstate = jax_updaters.compute_update(
            jconf, {k: jnp.asarray(v) for k, v in g.items()}, jstate, it,
            params=jp)
        for k in params:
            np.testing.assert_allclose(pu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["renormalizel2perlayer",
                                  "renormalizel2perparamtype",
                                  "clipelementwiseabsolutevalue",
                                  "clipl2perlayer", "clipl2perparamtype"])
def test_gradient_normalization_matches_jax(mode):
    rng = np.random.RandomState(7)
    g = {"W": 2 * rng.randn(5, 4).astype(np.float32),
         "b": rng.randn(4).astype(np.float32)}
    got = updaters.normalize_gradients(
        {k: torch.from_numpy(v) for k, v in g.items()}, mode, 0.5)
    want = jax_updaters.normalize_gradients(
        {k: jnp.asarray(v) for k, v in g.items()}, mode, 0.5)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scheme,expected_std", [
    ("xavier", np.sqrt(2.0 / (300 + 200))), ("relu", np.sqrt(2.0 / 300)),
    ("uniform", 1.0 / np.sqrt(300) / np.sqrt(3.0))])
def test_weight_init_fan_rules(scheme, expected_std):
    """Values differ from the JAX package's (another generator); the fan
    rules give the same spread."""
    gen = torch.Generator().manual_seed(0)
    w = weights.init_weights(gen, (300, 200), scheme,
                             dtype=torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (300, 200)
    np.testing.assert_allclose(w.float().std().item(), expected_std,
                               rtol=0.03)
