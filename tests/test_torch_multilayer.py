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

import jax
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
from deeplearning4j_tpu.nn.layers.core import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers.core import OutputLayer as JaxOutput
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


# ----------------------------------------------- C7: lr policies in float32
_POLICIES = {
    "none": {},
    "exponential": dict(lr_policy_decay_rate=0.9991),
    "inverse": dict(lr_policy_decay_rate=0.01, lr_policy_power=0.75),
    "step": dict(lr_policy_decay_rate=0.5, lr_policy_steps=100.0),
    "torchstep": dict(lr_policy_decay_rate=0.7, lr_policy_steps=30.0),
    "poly": dict(lr_policy_power=2.0),
    "sigmoid": dict(lr_policy_decay_rate=0.01, lr_policy_steps=500.0),
    "schedule": dict(lr_schedule={0: 0.1, 300: 0.05, 700: 0.01}),
}


@pytest.mark.parametrize("policy", sorted(_POLICIES))
def test_learning_rate_policy_within_2_ulp_of_jax(policy):
    """Every iteration up to ``max_num_iterations``: the JAX package
    traces the policies in float32 (C7)."""
    kw = dict(learning_rate=0.1, lr_policy=policy, max_num_iterations=1000,
              momentum_schedule={0: 0.5, 400: 0.9}, **_POLICIES[policy])
    pconf = updaters.UpdaterConfig(**kw)
    jconf = jax_updaters.UpdaterConfig(**kw)
    its = np.arange(0, 1001)
    want = np.asarray(jax.jit(jax.vmap(
        lambda i: jax_updaters.learning_rate_for(jconf, i)))(its))
    got = np.array([updaters.learning_rate_for(pconf, int(i)) for i in its],
                   np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2, (int(its[ulps.argmax()]), int(ulps.max()))
    mu_want = np.asarray(jax.jit(jax.vmap(
        lambda i: jax_updaters.momentum_for(jconf, i)))(its))
    mu_got = np.array([updaters.momentum_for(pconf, int(i)) for i in its],
                      np.float32)
    np.testing.assert_array_equal(mu_got, mu_want)


# (base lr, policy fields) of the fit test: poly's last steps take 2e-3
# and 1e-3 of the base, so a base of 1e3 (10 for adam, whose step does
# not scale with the gradient) makes its float32 lr error (1.4e-4 at
# iteration 999) show in the step; exponential takes 0.41 of its base
_FIT_POLICIES = {"poly": (1e3, dict(lr_policy_power=1.0)),
                 "exponential": (0.1, dict(lr_policy_decay_rate=0.9991))}


def _dense_pair(updater, policy):
    lr, fields = _FIT_POLICIES[policy]
    if policy == "poly" and updater == "adam":
        lr = 10.0
    b = (JaxConf.builder().seed(4).updater(updater).learning_rate(lr)
         .learning_rate_decay_policy(policy).activation("tanh")
         .weight_init("xavier"))
    for name, value in fields.items():
        getattr(b, name)(value)
    conf = (b.list().layer(JaxDense(n_out=8))
            .layer(JaxOutput(n_out=3))
            .set_input_type(jax_inputs.feed_forward(6)).build())
    for u in {id(conf.conf.updater): conf.conf.updater,
              **{id(l.updater): l.updater for l in conf.layers}}.values():
        u.max_num_iterations = 1000
    return _pair(conf)


@pytest.mark.parametrize("updater", ["sgd", "adam", "nesterovs"])
@pytest.mark.parametrize("policy", ["poly", "exponential"])
def test_fit_near_iteration_1000_matches_jax(updater, policy):
    """Two steps from iteration 998: the step each package takes (new -
    old params) and the params, at rtol 2e-5 / atol 1e-7.  In float64 the
    policy's lr was up to 3e-5 off there (C7)."""
    jnet, pnet = _dense_pair(updater, policy)
    jnet.iteration = pnet.iteration = 998
    rng = np.random.RandomState(9)
    x = rng.randn(16, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]
    for _ in range(2):
        j0, p0 = np.asarray(jnet.get_flat_params()), pnet.get_flat_params()
        jnet.fit(JaxDataSet(x, y))
        pnet.fit(DataSet(x, y))
        j1, p1 = np.asarray(jnet.get_flat_params()), pnet.get_flat_params()
        np.testing.assert_allclose(p1 - p0, j1 - j0, rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(p1, j1, rtol=2e-5, atol=1e-7)
    assert pnet.iteration == jnet.iteration == 1000


# ------------------------------------- the container and configuration API
def _mlp_pair(activation="tanh"):
    conf = (JaxConf.builder().seed(2).updater("sgd").learning_rate(0.1)
            .activation(activation).weight_init("xavier").regularization(True)
            .l2(1e-3).list().layer(JaxDense(n_out=7))
            .layer(JaxDense(n_out=5, activation="relu"))
            .layer(JaxOutput(n_out=3))
            .set_input_type(jax_inputs.feed_forward(6)).build())
    return _pair(conf)


def test_feed_forward_and_predict_match_jax():
    jnet, pnet = _mlp_pair()
    x = np.random.RandomState(3).randn(9, 6).astype(np.float32)
    got, want = pnet.feed_forward(x), jnet.feed_forward(x)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_array_equal(pnet.predict(x).numpy(), jnet.predict(x))
    assert pnet._pretrain_done is False
    assert pnet.clone()._pretrain_done is False


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_yaml_round_trip_matches_jax(container):
    from deeplearning4j_tpu.nn.conf.computation_graph import \
        ComputationGraphConfiguration as JaxCGConf
    from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
        ComputationGraphConfiguration
    if container == "graph":
        jconf = (JaxConf.builder().seed(1).graph_builder().add_inputs("in")
                 .add_layer("d", JaxDense(n_in=4, n_out=5), "in")
                 .add_layer("out", JaxOutput(n_in=5, n_out=2), "d")
                 .set_outputs("out").build())
        pconf = ComputationGraphConfiguration.from_json(jconf.to_json())
        load = ComputationGraphConfiguration.from_yaml
        jload = JaxCGConf.from_yaml
    else:
        jconf = _mlp_pair()[0].conf
        pconf = MultiLayerConfiguration.from_json(jconf.to_json())
        load = MultiLayerConfiguration.from_yaml
        from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
            MultiLayerConfiguration as JaxMLConf
        jload = JaxMLConf.from_yaml
    assert pconf.to_yaml() == jconf.to_yaml()
    assert load(jconf.to_yaml()).to_json() == jconf.to_json()
    assert jload(pconf.to_yaml()).to_json() == pconf.to_json()


def test_registered_activation_resolves_and_survives_json():
    from deeplearning4j_tpu.nn import activations as jact
    from deeplearning4j_tpu_torch.nn import activations as pact
    with pytest.raises(ValueError) as jerr:
        jact.register("relu", lambda x: x)
    with pytest.raises(ValueError) as perr:
        pact.register("ReLU", lambda x: x)
    assert str(perr.value) == str(jerr.value)
    jact.register("Scaled_Tanh", lambda x: 1.7159 * jnp.tanh(2 * x / 3))
    pact.register("Scaled_Tanh", lambda x: 1.7159 * torch.tanh(2 * x / 3))
    try:
        assert pact.get("scaled_tanh") is pact.get("SCALED_TANH")
        assert "scaled_tanh" in pact.available()
        jnet, pnet = _mlp_pair(activation="scaled_tanh")
        again = MultiLayerConfiguration.from_json(pnet.conf.to_json())
        assert again.layers[0].activation == "scaled_tanh"
        x = np.random.RandomState(4).randn(5, 6).astype(np.float32)
        np.testing.assert_allclose(pnet.output(x).numpy(),
                                   np.asarray(jnet.output(x)),
                                   rtol=OUT_TOL, atol=OUT_TOL)
        pact.register("relu", torch.relu, overwrite=True)
        assert pact.get("relu") is torch.relu
    finally:
        jact._ACTIVATIONS.pop("scaled_tanh", None)
        pact._ACTIVATIONS.pop("scaled_tanh", None)
        pact._ACTIVATIONS["relu"] = pact.relu
