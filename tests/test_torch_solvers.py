"""The line-search solvers of the port (``optimize/solvers.py``) against the
JAX package's: ``optimization_algo`` routes ``fit`` to the solver instead of
the updater, Armijo backtracking accepts the same step, and L-BFGS,
conjugate gradient and line gradient descent move the same weights over
several iterations, frozen layers and batch-norm state included.

Tolerances: float32 params and scores 1e-5 relative (of max|JAX| for
params): the same trials are accepted and the f32 sums of the loss,
gradient and dot products differ only in order.  The line search's step
is a power of 1/2 of its first trial, so equal steps are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import solvers as jsolvers
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iris import iris_dataset
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import solvers

ALGOS = ["lbfgs", "conjugate_gradient", "line_gradient_descent"]
RTOL = 1e-5


def _conf(algo, frozen=False, batchnorm=False, seed=12345):
    """Dense(4 -> 8, tanh) -> Output(3, softmax), SGD lr 0.1, float32;
    optionally the dense layer frozen, or batch norm between the two."""
    b = (JaxConf.builder().seed(seed).optimization_algo(algo)
         .updater("sgd").learning_rate(0.1).activation("tanh")
         .weight_init("xavier").list()
         .layer(jcore.DenseLayer(n_out=8, frozen=frozen)))
    if batchnorm:
        b = b.layer(jnorm.BatchNormalization())
    return (b.layer(jcore.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(jin.feed_forward(4)).build())


def _pair(conf):
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _rows(n=30, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return x, y


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def test_optimization_algo_is_not_ignored():
    """One ``fit`` under ``lbfgs`` takes the solver's step, not the SGD
    updater's: the port's params equal the JAX package's."""
    jnet, pnet = _pair(_conf("lbfgs"))
    x, y = _rows()
    np.testing.assert_allclose(pnet.score(DataSet(x, y)),
                               jnet.score(JaxDataSet(x, y)), rtol=RTOL)
    jnet.fit(JaxDataSet(x, y), ingest="batch")
    pnet.fit(DataSet(x, y))
    _close(pnet.get_flat_params(), jnet.get_flat_params())
    np.testing.assert_allclose(pnet.score(), jnet.score(), rtol=RTOL)
    assert pnet.iteration == jnet.iteration == 1


def test_unknown_optimization_algo_raises():
    _, pnet = _pair(_conf("lbfgs"))
    pnet.conf.conf.optimization_algo = "not_an_algo"
    x, y = _rows()
    with pytest.raises(ValueError, match="not_an_algo"):
        pnet.fit(DataSet(x, y))


def test_solver_with_tbptt_raises():
    conf = (JaxConf.builder().seed(1).optimization_algo("lbfgs").list()
            .layer(jrec.GravesLSTM(n_out=4))
            .layer(jrec.RnnOutputLayer(n_out=2))
            .set_input_type(jin.recurrent(3))
            .backprop_type("tbptt").t_bptt_forward_length(2).build())
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    x = np.zeros((2, 4, 3), np.float32)
    y = np.zeros((2, 4, 2), np.float32)
    y[..., 0] = 1
    with pytest.raises(ValueError, match="tBPTT"):
        pnet.fit(DataSet(x, y))


def _quadratic(w, xp):
    scale = xp.asarray(np.arange(1, 6, dtype=np.float32))
    return (scale * w * w).sum()


@pytest.mark.parametrize("case", ["descent", "ascent", "scaled_start",
                                  "one_trial"])
def test_backtrack_line_search_matches_jax(case):
    """The same accepted step on f(w) = sum(k w_k^2): along -g from a
    unit start (backtracks), along +g (0: not a descent direction), from
    the steepest-descent scale 1/|g|, and with one trial only (fails)."""
    w = np.linspace(-1.0, 2.0, 5).astype(np.float32)
    g = 2.0 * np.arange(1, 6, dtype=np.float32) * w
    d = g if case == "ascent" else -g
    init = (np.float32(1.0 / np.linalg.norm(g)) if case == "scaled_start"
            else 1.0)
    iters = 1 if case == "one_trial" else 10
    tw = torch.as_tensor(w)
    want = jsolvers.backtrack_line_search(
        lambda v: _quadratic(v, jnp), jnp.asarray(w),
        _quadratic(jnp.asarray(w), jnp), jnp.asarray(g), jnp.asarray(d),
        max_iterations=iters, initial_step=jnp.float32(init))
    got = solvers.backtrack_line_search(
        lambda v: _quadratic(v, torch), tw, _quadratic(tw, torch),
        torch.as_tensor(g), torch.as_tensor(d), max_iterations=iters,
        initial_step=torch.tensor(init, dtype=torch.float32))
    assert float(got) == float(want)
    assert got.dtype == torch.float32
    if case == "descent":
        assert 0 < float(got) < 1


@pytest.mark.parametrize("algo", ALGOS)
def test_solver_matches_jax_over_five_iterations(algo):
    """Five ``fit`` calls on iris (one solver iteration each, the search
    state carried between them): params and each pre-step score."""
    jnet, pnet = _pair(_conf(algo, seed=1))
    ds = iris_dataset()
    x, y = np.asarray(ds.features), np.asarray(ds.labels)
    for _ in range(5):
        jnet.fit(JaxDataSet(x, y), ingest="batch")
        pnet.fit(DataSet(x, y))
        np.testing.assert_allclose(pnet.score(), jnet.score(), rtol=RTOL)
        _close(pnet.get_flat_params(), jnet.get_flat_params())
    assert pnet.score(DataSet(x, y)) < pnet.score()   # it descends
    assert pnet._solver.iterations == 5


@pytest.mark.parametrize("algo", ALGOS)
def test_frozen_layer_left_untouched(algo):
    jnet, pnet = _pair(_conf(algo, frozen=True))
    before = pnet.param_table()
    x, y = _rows(40, seed=3)
    for _ in range(3):
        jnet.fit(JaxDataSet(x, y), ingest="batch")
        pnet.fit(DataSet(x, y))
    after = pnet.param_table()
    for name in ("0_W", "0_b"):
        np.testing.assert_array_equal(after[name], before[name])
    assert not np.array_equal(after["1_W"], before["1_W"])
    _close(pnet.get_flat_params(), jnet.get_flat_params())


def test_solver_refreshes_batchnorm_state_like_jax():
    """Each accepted step is followed by one train-mode forward that
    updates the batch-norm running statistics."""
    jnet, pnet = _pair(_conf("lbfgs", batchnorm=True))
    x, y = _rows(32, seed=5)
    for _ in range(2):
        jnet.fit(JaxDataSet(x, y), ingest="batch")
        pnet.fit(DataSet(x, y))
    _close(pnet.get_flat_params(), jnet.get_flat_params())
    for key in ("mean", "var"):
        _close(pnet.net_state[1][key].numpy(),
               np.asarray(jnet.net_state[1][key]))


def test_solver_keeps_the_fp32_masters_equal_to_the_params():
    """Under bf16 params with fp32 masters, the solver's new params are
    also the masters."""
    conf = _conf("conjugate_gradient")
    conf.conf.dtype = "bfloat16"
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    assert pnet._pol().master_weights
    before = pnet.get_flat_params()
    x, y = _rows()
    pnet.fit(DataSet(x, y))
    assert not np.array_equal(pnet.get_flat_params(), before)
    for i, state in enumerate(pnet.updater_state):
        for k, master in state.get("_master", {}).items():
            torch.testing.assert_close(master, pnet.params[i][k].float(),
                                       rtol=0, atol=0)


def test_solver_counts_its_host_reads():
    _, pnet = _pair(_conf("lbfgs"))
    x, y = _rows()
    pnet.fit(DataSet(x, y))
    solver = pnet._solver
    # slope sign, at least one trial, the returned score
    first = solver.host_syncs
    assert first >= 3
    pnet.fit(DataSet(x, y))
    # and now L-BFGS's curvature test as well
    assert solver.host_syncs - first >= 4
