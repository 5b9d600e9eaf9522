"""The port's transfer learning (``nn/transfer.py``) against the JAX
package's.

- both builders give the JAX package's configuration JSON, and after 5
  fine-tune steps from the same weights, through ``fit(DataSet)`` and
  through ``fit(iterator)``'s default (the port's epoch cache; the JAX
  side per batch, ``shuffle=False``), the same params at the JAX ingest
  tests' tolerance (rtol 2e-5, atol 1e-7: f32 sums in another order),
  with the frozen params bitwise unchanged in both;
- ``build()`` is repeatable and leaves the source conf alone, every
  validation error of the JAX builders is raised with the same type, and
  the frozen flag crosses a port zip that the JAX package restores;
- a frozen param stays bitwise on every fit route (per batch, the epoch
  cache, windows, ``fit_scan``, tBPTT, the line-search solvers), and a
  frozen trunk's params stay out of autograd unless the health vector
  reads their gradients, with bitwise the same results;
- under ``DL4J_TPU_PRECISION=mixed_bf16`` the fp32 masters follow the
  transferred weights: one step at lr 1e-6 leaves the kept params within
  one bf16 ulp of the source (the JAX package's first step goes back to
  the fresh init's masters: ROADMAP C, the deliberate difference).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JaxList
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.transfer import TransferLearning as JaxTL
from deeplearning4j_tpu.utils.model_serializer import \
    restore_multi_layer_network as jax_restore
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    ExistingDataSetIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.monitor import health
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import inputs as pin
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import core as pcore
from deeplearning4j_tpu_torch.nn.layers.recurrent import (GravesLSTM,
                                                          RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.transfer import TransferLearning
from deeplearning4j_tpu_torch.utils.model_serializer import write_model

RTOL, ATOL = 2e-5, 1e-7
BF16_ULP = 2.0 ** -7          # one bf16 ulp relative to the value


def _arrays(n=40, n_in=6, n_classes=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, n_in).astype(np.float32)
    y = np.eye(n_classes, dtype=np.float32)[rng.randint(0, n_classes, n)]
    return x, y


def _conf(pkg, container, updater="nesterovs", n_in=6):
    """The same configuration through each package's own builder (a
    builder shares the global updater conf with the layers that inherit
    it, which a transfer's fine-tune override then reaches)."""
    Conf, core, inp = ((JaxConf, jcore, jin) if pkg == "jax"
                       else (NeuralNetConfiguration, pcore, pin))
    b = (Conf.builder().seed(5).updater(updater).learning_rate(0.05)
         .activation("tanh").weight_init("xavier"))
    if container == "graph":
        return (b.graph_builder().add_inputs("in")
                .add_layer("d1", core.DenseLayer(n_out=8), "in")
                .add_layer("d2", core.DenseLayer(n_out=6), "d1")
                .add_layer("out", core.OutputLayer(n_out=3), "d2")
                .set_input_types(inp.feed_forward(n_in))
                .set_outputs("out").build())
    return (b.list().layer(core.DenseLayer(n_out=8))
            .layer(core.DenseLayer(n_out=6))
            .layer(core.OutputLayer(n_out=3))
            .set_input_type(inp.feed_forward(n_in)).build())


def _pair(container, **kw):
    jconf, pconf = _conf("jax", container, **kw), _conf("port", container,
                                                         **kw)
    assert pconf.to_json() == jconf.to_json()
    if container == "graph":
        jnet = JaxCG(jconf).init()
        pnet = ComputationGraph(pconf, device="cpu").init()
    else:
        jnet = JaxNet(jconf).init()
        pnet = MultiLayerNetwork(pconf, device="cpu").init()
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _transfer(pkg, container, net):
    """Freeze the first dense layer, swap the 3-class head for a 2-class
    one, fine-tune with adam at lr 0.02."""
    core = jcore if pkg == "jax" else pcore
    TL = JaxTL if pkg == "jax" else TransferLearning
    if container == "graph":
        return (TL.graph_builder(net).fine_tune_learning_rate(0.02)
                .fine_tune_updater("adam").set_feature_extractor("d1")
                .replace_output_layer("out", core.OutputLayer(n_out=2))
                .build())
    return (TL.builder(net).fine_tune_learning_rate(0.02)
            .fine_tune_updater("adam").set_feature_extractor(0)
            .remove_output_layer().add_layer(core.OutputLayer(n_in=6,
                                                              n_out=2))
            .build())


def _frozen(net, container):
    key = "d1" if container == "graph" else 0
    return {k: v.detach().clone() if isinstance(v, torch.Tensor)
            else np.asarray(v).copy() for k, v in net.params[key].items()}


@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("route", ["dataset", "iterator"])
def test_fine_tune_matches_jax(container, route):
    x, y3 = _arrays()
    y2 = np.eye(2, dtype=np.float32)[(x[:, 0] > 0).astype(int)]
    jsrc, psrc = _pair(container)
    if container == "graph":
        jsrc.fit(JaxMDS([x], [y3]))
        psrc.fit(MultiDataSet([x], [y3]))
    else:
        jsrc.fit(JaxDataSet(x, y3))
        psrc.fit(DataSet(x, y3))
    jnew, pnew = _transfer("jax", container, jsrc), \
        _transfer("port", container, psrc)
    assert pnew.conf.to_json() == jnew.conf.to_json()
    assert pnew.device == psrc.device
    # the kept layers carry the source's weights; the head's fresh init
    # differs between the packages, so the JAX one is loaded
    np.testing.assert_allclose(pnew.get_flat_params()[:6 * 8 + 8 + 8 * 6 + 6],
                               psrc.get_flat_params()[:6 * 8 + 8 + 8 * 6 + 6],
                               rtol=0, atol=0)
    pnew.set_flat_params(np.asarray(jnew.get_flat_params()))
    jfrozen, pfrozen = _frozen(jnew, container), _frozen(pnew, container)
    if route == "dataset":
        for i in range(5):
            rows = slice(8 * i, 8 * i + 8)
            jnew.fit(JaxDataSet(x[rows], y2[rows]))
            pnew.fit(DataSet(x[rows], y2[rows]))
    else:
        jnew.fit(JaxList(JaxDataSet(x, y2), 8), ingest="batch")
        pnew.fit(ListDataSetIterator(DataSet(x, y2), 8))
    assert pnew.iteration == jnew.iteration == 5
    np.testing.assert_allclose(pnew.get_flat_params(),
                               np.asarray(jnew.get_flat_params()),
                               rtol=RTOL, atol=ATOL)
    for k, v in _frozen(pnew, container).items():
        assert torch.equal(v, pfrozen[k])
        np.testing.assert_array_equal(np.asarray(jnew.params[
            "d1" if container == "graph" else 0][k]), jfrozen[k])


def test_builder_is_repeatable_and_validates_as_jax():
    jsrc, psrc = _pair("mln", updater="sgd")
    b = TransferLearning.builder(psrc).remove_output_layer() \
        .add_layer(pcore.OutputLayer(n_in=6, n_out=4))
    n1, n2 = b.build(), b.build()
    assert n1.conf.to_json() == n2.conf.to_json()
    assert len(n1.layers) == 3 and n1.params[2]["W"].shape == (6, 4)
    assert psrc.conf.to_json() == jsrc.conf.to_json()   # source untouched
    first = TransferLearning.builder(psrc).set_feature_extractor(0).build()
    second = (TransferLearning.builder(first).remove_output_layer()
              .add_layer(pcore.OutputLayer(n_in=6, n_out=4)).build())
    assert second.layers[0].frozen and not second.layers[1].frozen
    tuned = (TransferLearning.builder(psrc).fine_tune_learning_rate(1e-3)
             .set_feature_extractor(0).build())
    assert tuned.layers[1].updater.learning_rate == pytest.approx(1e-3)
    assert tuned.layers[0].updater.learning_rate == pytest.approx(0.05)

    cases = [
        lambda TL, core, net: TL.builder(net).remove_layers_from(7),
        lambda TL, core, net: TL.builder(net).set_feature_extractor(5)
        .build(),
        lambda TL, core, net: TL.builder(net).remove_layers_from(0).build(),
        lambda TL, core, net: (TL.builder(net).remove_output_layer()
                               .set_feature_extractor(2)
                               .add_layer(core.OutputLayer(n_in=6, n_out=4))
                               .build()),
        lambda TL, core, net: TL.graph_builder(net),
    ]
    for case in cases:
        with pytest.raises(Exception) as jerr:
            case(JaxTL, jcore, jsrc)
        with pytest.raises(Exception) as perr:
            case(TransferLearning, pcore, psrc)
        assert perr.type is jerr.type
        assert str(perr.value) == str(jerr.value)


def test_graph_builder_validates_as_jax_and_infers_the_head():
    jsrc, psrc = _pair("graph")
    cases = [
        lambda TL, core, net: TL.graph_builder(net)
        .set_feature_extractor("nope"),
        lambda TL, core, net: TL.graph_builder(net).replace_output_layer(
            "in", core.OutputLayer(n_out=2)),
        lambda TL, core, net: TL.graph_builder(net).replace_output_layer(
            "d2", core.OutputLayer(n_out=2)),
        lambda TL, core, net: (TL.graph_builder(net)
                               .set_feature_extractor("out")
                               .replace_output_layer(
                                   "out", core.OutputLayer(n_out=4))
                               .build()),
        lambda TL, core, net: TL.builder(net),
    ]
    for case in cases:
        with pytest.raises(Exception) as jerr:
            case(JaxTL, jcore, jsrc)
        with pytest.raises(Exception) as perr:
            case(TransferLearning, pcore, psrc)
        assert perr.type is jerr.type
        assert str(perr.value) == str(jerr.value)
    psrc._pretrain_done = True
    new = (TransferLearning.graph_builder(psrc).set_feature_extractor("d2")
           .replace_output_layer("out", pcore.OutputLayer(n_out=5)).build())
    assert new._pretrain_done
    assert new.vertices["out"].layer.n_in == 6          # inferred
    assert new.vertices["d1"].layer.frozen and new.vertices["d2"].layer.frozen


def test_frozen_flag_crosses_a_port_zip_into_jax(tmp_path):
    _, psrc = _pair("mln")
    new = TransferLearning.builder(psrc).set_feature_extractor(0).build()
    p = str(tmp_path / "tl.zip")
    write_model(new, p)
    again = jax_restore(p)
    assert again.layers[0].frozen and not again.layers[1].frozen
    np.testing.assert_array_equal(np.asarray(again.get_flat_params()),
                                  new.get_flat_params())


# ------------------------------------------------- frozen on every route
def _lstm_net():
    conf = (NeuralNetConfiguration.builder().seed(3).updater("sgd")
            .learning_rate(0.1).list()
            .layer(GravesLSTM(n_in=3, n_out=5, activation="tanh"))
            .layer(RnnOutputLayer(n_in=5, n_out=2))
            .backprop_type("tbptt").t_bptt_forward_length(4)
            .t_bptt_backward_length(4).build())
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.mark.parametrize("route", ["batch", "cache", "window", "fit_scan",
                                   "tbptt", "lbfgs", "health"])
def test_frozen_params_are_bitwise_on_every_route(route):
    x, y = _arrays(n=32)
    y2 = np.eye(2, dtype=np.float32)[(x[:, 0] > 0).astype(int)]
    if route == "tbptt":
        src = _lstm_net()
        rng = np.random.RandomState(1)
        xs = rng.randn(4, 10, 3).astype(np.float32)
        ys = np.eye(2, dtype=np.float32)[rng.randint(0, 2, (4, 10))]
        new = TransferLearning.builder(src).set_feature_extractor(0).build()
    else:
        _, src = _pair("mln")
        if route == "lbfgs":
            src.conf.conf.optimization_algo = "lbfgs"
        new = (TransferLearning.builder(src).set_feature_extractor(1)
               .remove_output_layer()
               .add_layer(pcore.OutputLayer(n_in=6, n_out=2)).build())
    if route == "health":
        health.enable()
    before = [{k: v.clone() for k, v in new.params[i].items()}
              for i in range(len(new.layers) - 1)]
    head = new.params[-1]["W"].clone()
    batches = [DataSet(x[i:i + 8], y2[i:i + 8]) for i in range(0, 32, 8)]
    if route in ("batch", "lbfgs", "health"):
        for ds in batches:
            new.fit(ds)
    elif route == "cache":
        new.fit(ListDataSetIterator(DataSet(x, y2), 8), ingest="cache")
    elif route == "window":
        new.fit(ExistingDataSetIterator(batches), ingest="window", window=2)
    elif route == "fit_scan":
        new.fit_scan(batches)
    else:
        new.fit(DataSet(xs, ys))
    for i, tree in enumerate(before):
        for k, v in tree.items():
            assert torch.equal(new.params[i][k], v), (route, i, k)
    health.reset()
    assert not torch.equal(new.params[-1]["W"], head)


def test_a_frozen_trunk_stays_out_of_autograd(monkeypatch):
    """Nothing but the health vector reads a frozen layer's gradient, so
    the step leaves the trunk out of autograd, with bitwise the same
    results as the step that differentiates it (health on, nothing
    flagged)."""
    x, y = _arrays(n=16)
    y2 = np.eye(2, dtype=np.float32)[(x[:, 0] > 0).astype(int)]
    _, src = _pair("mln")

    def tuned():
        return (TransferLearning.builder(src).set_feature_extractor(1)
                .remove_output_layer()
                .add_layer(pcore.OutputLayer(n_in=6, n_out=2)).build())

    seen = []
    grad = torch.autograd.grad

    def spy(outputs, inputs, *a, **kw):
        seen.append(len(inputs))
        return grad(outputs, inputs, *a, **kw)

    lean, full = tuned(), tuned()
    full.set_flat_params(lean.get_flat_params())
    monkeypatch.setattr(torch.autograd, "grad", spy)
    for _ in range(3):
        lean.fit(DataSet(x, y2))
    assert seen == [2, 2, 2]                      # the head's W and b
    health.enable()
    try:
        for _ in range(3):
            full.fit(DataSet(x, y2))
    finally:
        health.reset()
    assert seen[3:] == [6, 6, 6]
    assert np.array_equal(lean.get_flat_params(), full.get_flat_params())


# --------------------------------------------------- mixed_bf16 masters
@pytest.mark.parametrize("container", ["mln", "graph"])
def test_mixed_bf16_fine_tune_starts_from_the_transferred_weights(
        container, monkeypatch):
    """A 10-32-16-4 net trained 20 sgd steps; drop the head, add a new
    one, one step at lr 1e-6: the kept layers stay within one bf16 ulp of
    the source (without the master sync they jump back to their init)."""
    monkeypatch.setenv("DL4J_TPU_PRECISION", "mixed_bf16")
    rng = np.random.RandomState(0)
    x = rng.randn(32, 10).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 32)]
    b = (NeuralNetConfiguration.builder().seed(1).updater("sgd")
         .learning_rate(0.1).activation("tanh").weight_init("xavier"))
    if container == "graph":
        conf = (b.graph_builder().add_inputs("in")
                .add_layer("d1", pcore.DenseLayer(n_out=32), "in")
                .add_layer("d2", pcore.DenseLayer(n_out=16), "d1")
                .add_layer("out", pcore.OutputLayer(n_out=4), "d2")
                .set_input_types(pin.feed_forward(10))
                .set_outputs("out").build())
        src = ComputationGraph(conf, device="cpu").init()
        data = MultiDataSet([x], [y])
    else:
        conf = (b.list().layer(pcore.DenseLayer(n_out=32))
                .layer(pcore.DenseLayer(n_out=16))
                .layer(pcore.OutputLayer(n_out=4))
                .set_input_type(pin.feed_forward(10)).build())
        src = MultiLayerNetwork(conf, device="cpu").init()
        data = DataSet(x, y)
    assert src._pol().master_weights
    for _ in range(20):
        src.fit(data)
    if container == "graph":
        new = (TransferLearning.graph_builder(src)
               .fine_tune_learning_rate(1e-6)
               .replace_output_layer("out", pcore.OutputLayer(n_out=4))
               .build())
        kept = ["d1", "d2"]
    else:
        new = (TransferLearning.builder(src).fine_tune_learning_rate(1e-6)
               .remove_output_layer()
               .add_layer(pcore.OutputLayer(n_in=16, n_out=4)).build())
        kept = [0, 1]
    new.fit(data)
    for key in kept:
        for k, v in src.params[key].items():
            ref = v.float()
            got = new.params[key][k].float()
            assert got.dtype == torch.float32
            assert torch.all((got - ref).abs()
                             <= BF16_ULP * ref.abs() + 1e-30), (key, k)
