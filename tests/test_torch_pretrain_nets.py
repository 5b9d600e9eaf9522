"""The port's CenterLossOutputLayer (``nn/layers/training.py``) and the
containers' pretraining (``pretrain``, ``pretrain_layer``, the
``pretrain(True)`` branch of ``fit``) against the JAX package's, on the
CPU.

- center loss: scores, per-example scores and steps (f64 SGD at 1e-10,
  f32 Adam at 1e-5, ``gradient_check`` on and off); the ``cL`` update
  equal to the reference delta on every per-step path (batch, the epoch
  cache, windows, ``fit_scan``) and under a line search; a graph output
  vertex;
- pretraining then fine-tuning an AutoEncoder + RBM stack in both
  containers at every ``ingest`` value (1e-10), pretraining alone,
  ``fit_scan`` refusing while pretraining is pending, frozen layers;
- zips holding every new layer crossing both ways byte for byte, a
  transfer from a pretrained stack, and the ``mixed_bf16`` rule: the
  pretrain step updates the fp32 masters (a deliberate difference from
  the JAX package, which leaves them at their init).

Networks and draws: ``tests/pretrain_pairs.py``.
"""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JListIt
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import pretrain as jpre
from deeplearning4j_tpu.nn.layers import training as jtrain
from deeplearning4j_tpu.nn.layers import variational as jvae
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.transfer import TransferLearning as JTL
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import core as pcore
from deeplearning4j_tpu_torch.nn.layers import pretrain as ppre
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.transfer import TransferLearning
from deeplearning4j_tpu_torch.utils import model_serializer as ms
from pretrain_pairs import (DISTS, N, N_IN, TOL, _builder, _close, _data,
                            _flat, _pair, _port_of, pretrain_conf)


# ------------------------------------------------------------ center loss
def _center_stack(dtype="float64", updater="sgd", lr=0.0625, gc=False,
                  **kw):
    return (_builder(dtype, updater, lr).list()
            .layer(jcore.DenseLayer(n_in=4, n_out=5))
            .layer(jtrain.CenterLossOutputLayer(n_in=5, n_out=3, alpha=0.3,
                                                lambda_=0.1,
                                                gradient_check=gc, **kw))
            .build())


def _center_pair(**kw):
    jnet, pnet = _pair(_center_stack(**kw))
    flat = _flat(jnet) + 0.1 * np.random.RandomState(1).randn(
        jnet.get_flat_params().size)
    jnet.set_flat_params(flat)
    pnet.set_flat_params(flat)
    rng = np.random.RandomState(0)
    dtype = kw.get("dtype", "float64")
    x = rng.randn(N, 4).astype(dtype)
    y = np.eye(3)[rng.randint(0, 3, N)].astype(dtype)
    return jnet, pnet, x, y


@pytest.mark.parametrize("dtype,updater", [("float64", "sgd"),
                                           ("float32", "adam")])
@pytest.mark.parametrize("gc", [False, True])
def test_center_loss_score_examples_and_steps_match_jax(dtype, updater, gc):
    jnet, pnet, x, y = _center_pair(dtype=dtype, updater=updater, gc=gc)
    tol = TOL[dtype]
    np.testing.assert_allclose(pnet.score(DataSet(x, y)),
                               float(jnet.score(JDS(x, y))), rtol=tol)
    np.testing.assert_allclose(
        pnet.score_examples(DataSet(x, y)).numpy(),
        np.asarray(jnet.score_examples(JDS(x, y))), rtol=tol)
    _close(pnet.output(x), jnet.output(x), tol)
    for _ in range(3):
        jnet.fit(JDS(x, y))
        pnet.fit(DataSet(x, y))
    _close(_flat(pnet), _flat(jnet), tol)
    assert pnet.get_flat_updater_state().size == \
        np.asarray(jnet.get_flat_updater_state()).size


def _reference_delta(x, cls, before, alpha):
    want = before.copy()
    for c in range(before.shape[0]):
        members = x[cls == c]
        want[c] -= alpha * (before[c] - members).sum(axis=0) \
            / (len(members) + 1)
    return want


@pytest.mark.parametrize("path", ["batch", "cache", "window", "fit_scan"])
def test_center_loss_exact_reference_delta(path):
    """The JAX package's ``test_center_loss_exact_reference_delta`` on
    every per-step path: adam at lr 7 would move cL far from the delta if
    it went through the updater; cL carries no updater state."""
    rng = np.random.RandomState(3)
    # float32 data, so that the epoch cache takes it
    x = rng.randn(8, 4).astype(np.float32)
    cls = np.array([0, 0, 0, 1, 1, 2, 2, 2])
    y = np.eye(3, dtype=np.float32)[cls]
    conf = (_builder(updater="adam", lr=7.0, act="softmax").list()
            .layer(jtrain.CenterLossOutputLayer(n_in=4, n_out=3, alpha=0.3,
                                                lambda_=0.0, loss="mcxent"))
            .build())
    jnet, pnet = _pair(conf)
    before = pnet.params[0]["cL"].numpy().copy()
    jnet.fit(JDS(x, y))
    if path == "batch":
        pnet.fit(DataSet(x, y))
    elif path == "fit_scan":
        pnet.fit_scan([DataSet(x, y)])
    else:
        pnet.fit(ListDataSetIterator(DataSet(x, y), 8), ingest=path)
    after = pnet.params[0]["cL"].numpy()
    np.testing.assert_allclose(
        after, _reference_delta(x.astype(np.float64), cls, before, 0.3),
        atol=1e-12)
    _close(_flat(pnet), _flat(jnet), 1e-10)
    assert all("cL" not in tree.get(k, {})
               for tree in pnet.updater_state for k in tree)


def test_center_loss_under_a_line_search_steps_its_centers_directly():
    """On the solver path cL stays out of the line search and steps by
    the same reference delta; the score falls."""
    rng = np.random.RandomState(3)
    x = rng.randn(8, 4)
    cls = np.array([0, 0, 0, 1, 1, 2, 2, 2])
    y = np.eye(3)[cls]
    conf = (_builder(act="softmax",
                     optimization_algo="line_gradient_descent").list()
            .layer(jtrain.CenterLossOutputLayer(n_in=4, n_out=3, alpha=0.3,
                                                lambda_=0.0))
            .build())
    pnet = _port_of(conf)
    before = pnet.params[0]["cL"].numpy().copy()
    s0 = pnet.score(DataSet(x, y))
    pnet.fit(DataSet(x, y))
    np.testing.assert_allclose(pnet.params[0]["cL"].numpy(),
                               _reference_delta(x, cls, before, 0.3),
                               atol=1e-12)
    assert pnet.score(DataSet(x, y)) < s0


def test_graph_center_loss_vertex_matches_jax():
    conf = (_builder(act="tanh").graph_builder().add_inputs("in")
            .add_layer("h", jcore.DenseLayer(n_in=4, n_out=5), "in")
            .add_layer("out", jtrain.CenterLossOutputLayer(
                n_in=5, n_out=3, alpha=0.2, lambda_=0.05), "h")
            .set_outputs("out").build())
    jnet, pnet = _pair(conf, graph=True)
    rng = np.random.RandomState(2)
    x, y = rng.randn(N, 4), np.eye(3)[rng.randint(0, 3, N)]
    np.testing.assert_allclose(pnet.score(DataSet(x, y)),
                               float(jnet.score(JDS(x, y))), rtol=1e-10)
    np.testing.assert_allclose(pnet.score_examples(DataSet(x, y)).numpy(),
                               np.asarray(jnet.score_examples(JDS(x, y))),
                               rtol=1e-10)
    for _ in range(3):
        jnet.fit(JDS(x, y))
        pnet.fit(DataSet(x, y))
    _close(_flat(pnet), _flat(jnet), 1e-10)


# -------------------------------------------------- pretrain, then fit
@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
@pytest.mark.parametrize("ingest", ["auto", "cache", "window", "batch",
                                    "list", "generator"])
def test_pretrain_then_fit_matches_jax_at_every_ingest(graph, ingest):
    """``pretrain(True)``: the first ``fit`` pretrains each layer once (one
    epoch), then backprops; a second ``fit`` does not pretrain again.  A
    one-shot generator is materialised once (it then trains per batch, as
    in the JAX package)."""
    jnet, pnet = _pair(pretrain_conf(graph), graph=graph)
    x, y = _data("float32", n=16)     # float32: the epoch cache takes it

    def data(side):
        ds_cls, it_cls = (JDS, JListIt) if side == "jax" else \
            (DataSet, ListDataSetIterator)
        if ingest == "list":
            return [ds_cls(x[:8], y[:8]), ds_cls(x[8:], y[8:])]
        if ingest == "generator":
            return (ds_cls(x[i:i + 8], y[i:i + 8]) for i in (0, 8))
        return it_cls(ds_cls(x, y), 8)

    port_ingest = "auto" if ingest in ("list", "generator") else ingest
    jnet.fit(data("jax"), ingest="batch" if ingest != "generator"
             else "auto")
    pnet.fit(data("port"), ingest=port_ingest)
    assert pnet._pretrain_done and jnet._pretrain_done
    assert pnet.iteration == jnet.iteration == 6
    _close(_flat(pnet), _flat(jnet), 1e-10)
    jnet.fit(data("jax"), ingest="batch" if ingest != "generator"
             else "auto")
    pnet.fit(data("port"), ingest=port_ingest)
    assert pnet.iteration == jnet.iteration == 8
    _close(_flat(pnet), _flat(jnet), 1e-10)


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_pretrain_only_and_layer_by_layer_match_jax(graph):
    """``backprop(False)``: fit only pretrains; ``pretrain`` over a list
    runs layer 0 over every batch before layer 1, listeners fire once a
    step and the flag is set."""
    jnet, pnet = _pair(pretrain_conf(graph, backprop=False), graph=graph)
    x, y = _data(n=16)
    seen = []

    class Tap:
        def iteration_done(self, model, iteration):
            seen.append((iteration, float(model._score)))

    pnet.set_listeners(Tap())
    jnet.fit([JDS(x[:8], y[:8]), JDS(x[8:], y[8:])])
    pnet.fit([DataSet(x[:8], y[:8]), DataSet(x[8:], y[8:])])
    assert [i for i, _ in seen] == [1, 2, 3, 4]
    _close(_flat(pnet), _flat(jnet), 1e-10)
    key = "out" if graph else 2
    jnet.pretrain_layer(key, JDS(x, y))     # not pretrainable: skipped
    pnet.pretrain_layer(key, DataSet(x, y))
    assert pnet.iteration == jnet.iteration == 4


def test_fit_scan_raises_while_pretraining_is_pending():
    for graph in (False, True):
        _, pnet = _pair(pretrain_conf(graph), graph=graph)
        x, y = _data(n=16)
        with pytest.raises(ValueError, match="pretrain"):
            pnet.fit_scan([DataSet(x[:8], y[:8])])
        pnet.pretrain(DataSet(x, y))
        pnet.fit_scan([DataSet(x[:8], y[:8]), DataSet(x[8:], y[8:])])


def test_frozen_layer_is_not_pretrained():
    layer = jpre.AutoEncoder(n_in=N_IN, n_out=4, corruption_level=0.0,
                             frozen=True)
    conf = (_builder().list().layer(layer)
            .layer(jcore.OutputLayer(n_in=4, n_out=3)).build())
    jnet, pnet = _pair(conf)
    before = _flat(pnet)
    x, y = _data()
    pnet.pretrain(DataSet(x, y))
    jnet.pretrain(JDS(x, y))
    assert np.array_equal(_flat(pnet), before)
    assert pnet.iteration == jnet.iteration == 0


# --------------------------------------------------------- zips, transfer
def _zip_bytes(writer, net):
    buf = io.BytesIO()
    writer(net, buf)
    return buf.getvalue()


def _entries(data):
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _every_layer_conf():
    dist = DISTS["composite"](jvae)
    return (_builder("float32", "adam", 0.01).list()
            .layer(jvae.VariationalAutoencoder(
                n_in=N_IN, n_out=5, encoder_layer_sizes=(7, 6),
                decoder_layer_sizes=(6,), reconstruction_distribution=dist,
                num_samples=2))
            .layer(jpre.AutoEncoder(n_in=5, n_out=4, corruption_level=0.1,
                                    sparsity=0.05))
            .layer(jpre.RBM(n_in=4, n_out=4, visible_unit="gaussian", k=2))
            .layer(jtrain.CenterLossOutputLayer(n_in=4, n_out=3))
            .pretrain(True).build())


def test_zips_with_every_new_layer_cross_both_ways_byte_for_byte():
    x, y = _data("float32")
    jnet = JNet(_every_layer_conf()).init()
    jnet.fit(JDS(x, y))
    assert jnet._pretrain_done
    jzip = _zip_bytes(jms.write_model, jnet)
    pnet = ms.restore_multi_layer_network(io.BytesIO(jzip), device="cpu")
    assert pnet._pretrain_done and pnet.iteration == jnet.iteration
    _close(pnet.output(x), jnet.output(x), 1e-5)
    a, b = _entries(jzip), _entries(_zip_bytes(ms.write_model, pnet))
    for name in ("configuration.json", "coefficients.bin",
                 "updaterState.bin"):
        assert a[name] == b[name], name
    ja, pa = json.loads(a["manifest.json"]), json.loads(b["manifest.json"])
    for key in ("num_params", "num_updater_values", "iteration",
                "pretrain_done", "entries"):
        assert pa[key] == ja[key], key
    # the port's own fit, written and read back by the JAX package
    pnet2 = _port_of(_every_layer_conf())
    pnet2.fit(DataSet(x, y))
    pnet2.fit(DataSet(x, y))
    pzip = _zip_bytes(ms.write_model, pnet2)
    jnet2 = jms.restore_multi_layer_network(io.BytesIO(pzip))
    assert jnet2._pretrain_done and jnet2.iteration == pnet2.iteration
    c, d = _entries(pzip), _entries(_zip_bytes(jms.write_model, jnet2))
    for name in ("configuration.json", "coefficients.bin",
                 "updaterState.bin"):
        assert c[name] == d[name], name
    # a restored model does not pretrain again
    again = ms.restore_multi_layer_network(io.BytesIO(pzip), device="cpu")
    it = again.iteration
    again.fit(DataSet(x, y))
    assert again.iteration == it + 1


def test_transfer_from_a_pretrained_stack_matches_jax():
    conf = pretrain_conf()
    jnet, pnet = _pair(conf)
    x, y = _data(n=16)
    jnet.pretrain(JDS(x, y))
    pnet.pretrain(DataSet(x, y))
    jnew = (JTL.builder(jnet).fine_tune_learning_rate(0.05)
            .remove_output_layer()
            .add_layer(jcore.OutputLayer(n_in=4, n_out=2)).build())
    pnew = (TransferLearning.builder(pnet).fine_tune_learning_rate(0.05)
            .remove_output_layer()
            .add_layer(pcore.OutputLayer(n_in=4, n_out=2)).build())
    assert pnew._pretrain_done and jnew._pretrain_done
    assert pnew.conf.to_json() == jnew.conf.to_json()
    pnew.set_flat_params(np.asarray(jnew.get_flat_params()))
    y2 = np.eye(2)[np.random.RandomState(4).randint(0, 2, 16)]
    for _ in range(2):
        jnew.fit(JDS(x, y2))
        pnew.fit(DataSet(x, y2))
    assert pnew.iteration == jnew.iteration
    _close(_flat(pnew), _flat(jnew), 1e-10)


# ------------------------------------------------------ the masters rule
@pytest.mark.parametrize("updater", ["sgd", "adam"])
@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_mixed_bf16_pretrain_keeps_the_pretrained_weights(
        updater, graph, monkeypatch):
    """Under ``mixed_bf16`` the pretrain step updates the fp32 masters and
    re-derives the bf16 params, so the updater state keeps the tree of a
    fresh net and the first fine-tune step starts from the pretrained
    weights (the JAX package's step leaves the masters at their init: its
    first fit step lands back near the init)."""
    monkeypatch.setenv("DL4J_TPU_PRECISION", "mixed_bf16")
    b = (NeuralNetConfiguration.builder().seed(1).updater(updater)
         .learning_rate(0.5 if updater == "sgd" else 0.05)
         .activation("sigmoid"))
    ae = ppre.AutoEncoder(n_in=8, n_out=6, corruption_level=0.0)
    head = pcore.OutputLayer(n_in=6, n_out=2)
    if graph:
        conf = (b.graph_builder().add_inputs("in").add_layer("ae", ae, "in")
                .add_layer("out", head, "ae").set_outputs("out").build())
        net = ComputationGraph(conf, device="cpu").init()
        key = "ae"
    else:
        net = MultiLayerNetwork(b.list().layer(ae).layer(head).build(),
                                device="cpu").init()
        key = 0
    assert net._pol().master_weights
    fresh_tree = {k: sorted(v) if isinstance(v, dict) else None
                  for k, v in net.updater_state[key].items()}
    init_w = net.params[key]["W"].float().clone()
    rng = np.random.RandomState(0)
    x = rng.rand(32, 8).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 32)]
    net.pretrain_layer(key, DataSet(x, y), epochs=20)
    state = net.updater_state[key]
    assert {k: sorted(v) if isinstance(v, dict) else None
            for k, v in state.items()} == fresh_tree
    masters = state["_master"]
    for k in ("W", "b", "vb"):
        assert torch.equal(net.params[key][k],
                           masters[k].to(torch.bfloat16))
    pre_w = net.params[key]["W"].float().clone()
    moved = (pre_w - init_w).abs().max().item()
    assert moved > 0.1
    net.fit(DataSet(x, y))
    step = (net.params[key]["W"].float() - pre_w).abs().max().item()
    assert step < 0.2 * moved


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_jax_param_trees_load_for_the_new_keys(graph):
    """``load_jax_params`` takes the JAX network's per-layer (per-vertex)
    dicts with the new keys (``vb``, the VAE's, ``cL``) in each layer's
    ``param_order``, as the flat vector does."""
    from deeplearning4j_tpu.nn.computation_graph import ComputationGraph \
        as JCG
    from deeplearning4j_tpu_torch.nn.jax_weights import load_jax_params
    if graph:
        jconf = (_builder().graph_builder().add_inputs("in")
                 .add_layer("vae", jvae.VariationalAutoencoder(
                     n_in=N_IN, n_out=4, encoder_layer_sizes=(5,),
                     decoder_layer_sizes=(5,)), "in")
                 .add_layer("rbm", jpre.RBM(n_in=4, n_out=3), "vae")
                 .add_layer("out", jtrain.CenterLossOutputLayer(
                     n_in=3, n_out=2), "rbm")
                 .set_outputs("out").build())
        jnet = JCG(jconf).init()
    else:
        jconf = _every_layer_conf()
        jnet = JNet(jconf).init()
    pnet = _port_of(jconf, graph)
    load_jax_params(pnet, jnet.params)
    np.testing.assert_array_equal(pnet.get_flat_params(),
                                  np.asarray(jnet.get_flat_params()))
    assert pnet.get_flat_updater_state().size == \
        np.asarray(jnet.get_flat_updater_state()).size
