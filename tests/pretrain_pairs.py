"""Shared helpers of the pretraining parity tests
(``tests/test_torch_pretrain*.py``): JAX-package networks and their port
twins on the same weights, fed the JAX step's random draws.

:func:`jax_draws` recomputes the JAX step's draws (``fold_in(PRNGKey(
seed), iteration)``, then ``split(rng, 2k+1)`` for the RBM, the key itself
for the AutoEncoder's corruption, ``fold_in(rng, s)`` for the VAE's
samples) and hands them to the port's ``pretrain_draw_source``.  A
Bernoulli draw is ``uniform < p`` in both packages; the AutoEncoder's
uniforms are float64 in the JAX package under the suite's x64 mode (its
``p`` is a Python float), the RBM's and the VAE's take the layer's dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import pretrain as jpre
from deeplearning4j_tpu.nn.layers import variational as jvae
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = {"float64": 1e-10, "float32": 1e-5}
SEED = 5
N, N_IN = 8, 6


# ------------------------------------------------------------ the draws
def jax_layer_draws(layer, rng, specs, dtype):
    """The tensors the JAX package's ``pretrain_grads(params, x, rng)``
    draws, in the port's ``pretrain_draw_specs`` order."""
    name = type(layer).__name__
    if name == "RBM":
        keys = jax.random.split(rng, len(specs))
        return [None if sp is None else np.asarray(
            (jax.random.uniform if sp[0] == "uniform" else jax.random.normal)
            (k, sp[1], dtype)) for k, sp in zip(keys, specs)]
    if name == "AutoEncoder":
        # bernoulli(rng, 1 - c, shape): p is a Python float (float64 here)
        return [np.asarray(jax.random.uniform(rng, sp[1], jnp.float64))
                for sp in specs]
    return [np.asarray(jax.random.normal(jax.random.fold_in(rng, s), sp[1],
                                         dtype))
            for s, sp in enumerate(specs)]


def jax_draws(seed, dtype):
    """A ``pretrain_draw_source`` giving the JAX step's draws."""
    base = jax.random.PRNGKey(seed)

    def source(layer, iteration, specs):
        return jax_layer_draws(layer, jax.random.fold_in(base, iteration),
                               specs, dtype)
    return source


def _jdtype(dtype):
    return jnp.float64 if dtype == "float64" else jnp.float32


# -------------------------------------------------------- the networks
def _builder(dtype="float64", updater="sgd", lr=0.0625, act="tanh",
             seed=SEED, **kw):
    b = (JConf.builder().seed(seed).dtype(dtype).updater(updater)
         .learning_rate(lr).activation(act).weight_init("xavier"))
    for k, v in kw.items():
        getattr(b, k)(v)
    return b


def _port_of(jconf, graph=False):
    cls = ComputationGraphConfiguration if graph else MultiLayerConfiguration
    pconf = cls.from_json(jconf.to_json())
    assert pconf.to_json() == jconf.to_json()
    return (ComputationGraph if graph else MultiLayerNetwork)(
        pconf, device="cpu").init()


def _pair(jconf, graph=False, seed=SEED):
    jnet = (JCG if graph else JNet)(jconf).init()
    pnet = _port_of(jconf, graph)
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    dtype = jconf.conf.dtype
    pnet.pretrain_draw_source = jax_draws(seed, _jdtype(dtype))
    return jnet, pnet


def _data(dtype="float64", n=N, n_in=N_IN, n_cls=3, seed=0, binary=False):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, n_in)
    if binary:
        x = (x > 0.5).astype(np.float64)
    y = np.eye(n_cls)[rng.randint(0, n_cls, n)]
    return x.astype(dtype), y.astype(dtype)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _flat(net):
    return np.asarray(net.get_flat_params(), np.float64)


AE = {
    "dense": dict(corruption_level=0.0),
    "sparse": dict(corruption_level=0.0, sparsity=0.1),
    "corrupted": dict(corruption_level=0.3),
    "sparse_corrupted": dict(corruption_level=0.3, sparsity=0.1),
}
RBM_UNITS = [("binary", "binary"), ("binary", "gaussian"),
             ("rectified", "binary"), ("rectified", "gaussian")]
DISTS = {
    "gaussian": lambda m: m.GaussianReconstructionDistribution(
        activation="identity"),
    "gaussian_tanh": lambda m: m.GaussianReconstructionDistribution(
        activation="tanh"),
    "bernoulli": lambda m: m.BernoulliReconstructionDistribution(),
    "bernoulli_hardsigmoid": lambda m: m.BernoulliReconstructionDistribution(
        activation="hardsigmoid"),
    "exponential": lambda m: m.ExponentialReconstructionDistribution(),
    "loss_wrapper": lambda m: m.LossFunctionWrapper(activation="tanh",
                                                    loss="mse"),
    "composite": lambda m: m.CompositeReconstructionDistribution(parts=(
        (2, m.GaussianReconstructionDistribution(activation="identity")),
        (3, m.BernoulliReconstructionDistribution()),
        (1, m.ExponentialReconstructionDistribution()))),
}


def _layer(kind, case):
    if kind == "ae":
        return jpre.AutoEncoder(n_in=N_IN, n_out=4, activation="sigmoid",
                                **AE[case])
    if kind == "rbm":
        hidden, visible, k = case
        return jpre.RBM(n_in=N_IN, n_out=4, hidden_unit=hidden,
                        visible_unit=visible, k=k)
    return jvae.VariationalAutoencoder(
        n_in=N_IN, n_out=3, encoder_layer_sizes=(5,),
        decoder_layer_sizes=(5, 4), num_samples=2,
        reconstruction_distribution=DISTS[case](jvae))


CASES = ([("ae", c) for c in AE]
         + [("rbm", (h, v, k)) for h, v in RBM_UNITS for k in (1, 2)]
         + [("vae", d) for d in DISTS])


def _ids(case):
    kind, c = case
    return f"{kind}-{'-'.join(map(str, c)) if kind == 'rbm' else c}"


def _stack(kind, case, dtype="float64", updater="sgd", lr=0.0625):
    layer = _layer(kind, case)
    return (_builder(dtype, updater, lr).list().layer(layer)
            .layer(jcore.OutputLayer(n_in=layer.n_out, n_out=3)).build())


def pretrain_conf(graph=False, backprop=True):
    b = _builder(act="sigmoid", lr=0.1)
    ae = jpre.AutoEncoder(n_in=N_IN, n_out=5, corruption_level=0.2)
    rbm = jpre.RBM(n_in=5, n_out=4)
    head = jcore.OutputLayer(n_in=4, n_out=3)
    if graph:
        return (b.graph_builder().add_inputs("in")
                .add_layer("ae", ae, "in").add_layer("rbm", rbm, "ae")
                .add_layer("out", head, "rbm").set_outputs("out")
                .pretrain(True).backprop(backprop).build())
    return (b.list().layer(ae).layer(rbm).layer(head).pretrain(True)
            .backprop(backprop).build())


def check_layer_case(case):
    """f64: the supervised forward, the layer's pretrain score and
    gradients on the same draws, then three ``pretrain_layer`` steps and
    one ``fit`` step through the network, against the JAX package."""
    kind, c = case
    jnet, pnet = _pair(_stack(kind, c))
    x, y = _data(binary=kind == "rbm")
    tol = TOL["float64"]
    _close(pnet.output(x), jnet.output(x), tol)
    jlayer, player = jnet.layers[0], pnet.layers[0]
    rng = jax.random.PRNGKey(11)
    specs = player.pretrain_draw_specs(N)
    draws = [None if d is None else torch.tensor(d)
             for d in jax_layer_draws(jlayer, rng, specs, jnp.float64)]
    jscore, jgrads = jax.jit(jlayer.pretrain_grads)(jnet.params[0],
                                                    jnp.asarray(x), rng)
    pscore, pgrads = player.pretrain_grads(pnet.params[0],
                                           torch.from_numpy(x), draws)
    np.testing.assert_allclose(float(pscore), float(jscore), rtol=tol)
    assert list(pgrads) == list(player.param_order())
    for k in player.param_order():
        _close(pgrads[k], jgrads[k], tol)
    jnet.pretrain_layer(0, JDS(x, y), epochs=3)
    pnet.pretrain_layer(0, DataSet(x, y), epochs=3)
    assert pnet.iteration == jnet.iteration == 3
    np.testing.assert_allclose(float(pnet._score), float(jnet._score),
                               rtol=tol)
    _close(_flat(pnet), _flat(jnet), tol)
    jnet.fit(JDS(x, y))
    pnet.fit(DataSet(x, y))
    _close(_flat(pnet), _flat(jnet), tol)
    np.testing.assert_allclose(pnet.score(), float(jnet.score()), rtol=tol)
