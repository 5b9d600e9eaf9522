"""The port's ModelSerializer (``utils/model_serializer.py``) against the
JAX package's: the regression goldens restore and predict in the port
(the ``graph_merge_nesterovs`` golden through
``restore_computation_graph``), a zip crosses between the packages in
both directions with the same bytes (MultiLayerNetworks and
ComputationGraphs, ``state.bin`` included), every malformed zip raises
``ModelSerializationError`` in both, and every serde type of the JAX
package is ported or raises ``NotImplementedError`` naming its ROADMAP
item.  The LSTM golden was saved after a tBPTT fit of 6 steps in windows
of 4, so it holds iteration 2 and a resumed fit adds 2.

Tolerances: goldens at the JAX package's own rtol 1e-6, atol 1e-7
(``tests/test_regression_goldens.py``); the resumed step against the JAX
package's at 1e-5 of max|param| (f32 sums in another order); zip payloads
byte for byte.
"""

import hashlib
import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import convolution as jconvl
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import model_serializer as ms

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "regression")
PAYLOAD = ("configuration.json", "coefficients.bin", "updaterState.bin")


def _fixture(name):
    return os.path.join(FIXTURES, name)


def _labels_for(out, seed=3):
    """The labels ``tests/test_regression_goldens.py`` trains with: one
    class per example, or per timestep for a sequence output."""
    rng = np.random.RandomState(seed)
    return np.eye(out.shape[-1])[rng.randint(0, out.shape[-1],
                                             out.shape[:-1])].astype(
        np.float32)


# windows a fit takes on each golden's input: one, or T=6 / tBPTT 4
GOLDENS = {"mlp_sgd": 1, "cnn_adam": 1, "lstm_rmsprop_tbptt": 2,
           "graph_merge_nesterovs": 1}


def _restore(name, pkg="port", source=None):
    """A golden (or ``source``) restored by the package's restore for
    its family: graphs through ``restore_computation_graph``."""
    path = _fixture(f"{name}.zip") if source is None else source
    graph = name.startswith("graph")
    if pkg == "jax":
        return (jms.restore_computation_graph(path) if graph
                else jms.restore_multi_layer_network(path))
    return (ms.restore_computation_graph(path, device="cpu") if graph
            else ms.restore_multi_layer_network(path, device="cpu"))


@pytest.mark.parametrize("name", list(GOLDENS))
def test_golden_restores_and_predicts_identically(name):
    golden = np.load(_fixture(f"{name}_golden.npz"))
    net = _restore(name)
    assert net.iteration == int(golden["iteration"]) and net.epoch == 1
    pred = net.output(golden["input"]).numpy()
    np.testing.assert_allclose(pred.astype(np.float64), golden["prediction"],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", list(GOLDENS))
def test_golden_resumes_training_like_jax(name):
    golden = np.load(_fixture(f"{name}_golden.npz"))
    x = golden["input"].astype(np.float32)
    net, jnet = _restore(name), _restore(name, "jax")
    np.testing.assert_array_equal(net.get_flat_updater_state(),
                                  np.asarray(jnet.get_flat_updater_state()))
    y = _labels_for(golden["prediction"])
    net.fit(DataSet(x, y))
    jnet.fit(JaxDataSet(x, y))
    assert net.iteration == jnet.iteration == \
        int(golden["iteration"]) + GOLDENS[name]
    assert np.isfinite(net.score())
    if name != "mlp_sgd":   # mlp_sgd trains with dropout: other masks
        a, b = np.asarray(jnet.get_flat_params()), net.get_flat_params()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=1e-5)


def _conf(kind):
    b = (JaxConf.builder().seed(9).updater("adam").learning_rate(0.01)
         .activation("relu").list())
    if kind == "mlp":
        return (JaxConf.builder().seed(9).updater("sgd").learning_rate(0.1)
                .activation("tanh").list()
                .layer(jcore.DenseLayer(n_out=6, l2=1e-4))
                .layer(jcore.OutputLayer(n_out=3))
                .set_input_type(jin.feed_forward(4)).build())
    if kind == "lstm":
        return (JaxConf.builder().seed(9).updater("rmsprop")
                .learning_rate(0.05).list()
                .layer(jrec.GravesLSTM(n_out=6, activation="tanh"))
                .layer(jrec.GravesBidirectionalLSTM(n_out=4,
                                                    activation="tanh"))
                .layer(jrec.RnnOutputLayer(n_out=3))
                .set_input_type(jin.recurrent(4, 5)).build())
    if kind == "cnn":
        return (b.layer(jconvl.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                                stride=(2, 2),
                                                convolution_mode="same"))
                .layer(jconvl.SubsamplingLayer(kernel_size=(2, 2)))
                .layer(jcore.OutputLayer(n_out=3))
                .set_input_type(jin.convolutional(7, 7, 2)).build())
    return (b.layer(jconvl.ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
            .layer(jnorm.BatchNormalization())
            .layer(jnorm.LocalResponseNormalization(n=3))
            .layer(jcore.DenseLayer(n_out=5))
            .layer(jnorm.BatchNormalization(decay=0.8))
            .layer(jcore.OutputLayer(n_out=3))
            .set_input_type(jin.convolutional(6, 6, 1)).build())


def _data(kind):
    rng = np.random.RandomState(11)
    shape = {"mlp": (5, 4), "cnn": (5, 7, 7, 2), "bn": (5, 6, 6, 1),
             "lstm": (5, 5, 4)}[kind]
    x = rng.randn(*shape).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.randint(
        0, 3, shape[:2] if kind == "lstm" else 5)]


def _entries(data: bytes) -> dict:
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _zip_bytes(writer, net) -> bytes:
    buf = io.BytesIO()
    writer(net, buf)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["mlp", "cnn", "bn", "lstm"])
def test_jax_zip_restores_in_the_port_and_writes_back_the_same_bytes(kind):
    jnet = JaxNet(_conf(kind)).init()
    x, y = _data(kind)
    jnet.fit(JaxDataSet(x, y))
    jzip = _zip_bytes(jms.write_model, jnet)
    net = ms.restore_multi_layer_network(io.BytesIO(jzip), device="cpu")
    assert net.iteration == 1
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=1e-5,
                               atol=1e-6)
    a, b = _entries(jzip), _entries(_zip_bytes(ms.write_model, net))
    names = PAYLOAD + (("state.bin",) if kind == "bn" else ())
    assert set(a) == set(b) == set(names) | {"manifest.json"}
    for name in names:
        assert a[name] == b[name], name
    ja, pa = json.loads(a["manifest.json"]), json.loads(b["manifest.json"])
    for key in ("num_params", "num_updater_values", "iteration", "epoch",
                "state", "entries"):
        assert pa[key] == ja[key], key


@pytest.mark.parametrize("kind", ["mlp", "cnn", "bn", "lstm"])
def test_port_zip_restores_in_jax_and_writes_back_the_same_bytes(kind,
                                                                 tmp_path):
    conf = _conf(kind)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    x, y = _data(kind)
    net.fit(DataSet(x, y))
    net.fit(DataSet(x, y))
    path = tmp_path / "port.zip"
    ms.write_model(net, str(path))
    assert [p.name for p in tmp_path.iterdir()] == ["port.zip"]
    jnet = jms.restore_multi_layer_network(str(path))
    assert jnet.iteration == 2
    np.testing.assert_allclose(np.asarray(jnet.output(x)),
                               net.output(x).numpy(), rtol=1e-5, atol=1e-6)
    if kind == "bn":
        for i in (1, 4):
            for key in ("mean", "var"):
                np.testing.assert_array_equal(
                    np.asarray(jnet.net_state[i][key]),
                    net.net_state[i][key].numpy())
    a = _entries(path.read_bytes())
    b = _entries(_zip_bytes(jms.write_model, jnet))
    for name in PAYLOAD + (("state.bin",) if kind == "bn" else ()):
        assert a[name] == b[name], name


def test_state_manifest_uses_the_jax_leaf_paths():
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _conf("bn").to_json()), device="cpu").init()
    manifest = json.loads(_entries(_zip_bytes(ms.write_model, net))
                          ["manifest.json"])
    assert [(e["layer"], e["path"], e["shape"], e["offset"])
            for e in manifest["state"]] == [
        (1, "mean", [4], 0), (1, "var", [4], 4),
        (4, "mean", [5], 8), (4, "var", [5], 13)]


def _rewrite(src: bytes, change, manifest_change=None, drop_digests=True):
    """A copy of a zip with ``change(name, data) -> data`` applied to each
    entry and ``manifest_change(manifest)`` to the manifest."""
    entries = _entries(src)
    manifest = json.loads(entries.pop("manifest.json"))
    if drop_digests:
        manifest.pop("entries")
    if manifest_change:
        manifest_change(manifest)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, data in entries.items():
            zf.writestr(name, change(name, data))
        zf.writestr("manifest.json", json.dumps(manifest))
    return buf.getvalue()


def _grow(name, by):
    return lambda n, d: d + b"\0" * by if n == name else d


def _cut(name, by):
    return lambda n, d: d[:-by] if n == name else d


def _add(key, by):
    return lambda m: m.__setitem__(key, m[key] + by)


_BAD = {
    "not_a_zip": (None, "not a valid model zip"),
    "partial_float": ((_grow("coefficients.bin", 2), None, True),
                      "whole number"),
    "params_vs_manifest": ((_grow("coefficients.bin", 4), None, True),
                           "manifest records"),
    "params_vs_net": ((_grow("coefficients.bin", 4),
                       _add("num_params", 1), True),
                      "architectures differ"),
    "digest": ((lambda n, d: (bytes([d[0] ^ 1]) + d[1:]
                              if n == "coefficients.bin" else d),
                None, False), "sha256"),
    "size_vs_digest": ((_grow("coefficients.bin", 4), None, False),
                       "bytes; manifest"),
    "updater_partial_float": ((_grow("updaterState.bin", 3), None, True),
                              "whole number"),
    "updater_vs_manifest": ((_cut("updaterState.bin", 4), None, True),
                            "manifest records"),
    "state_truncated": ((_cut("state.bin", 8), None, True), "truncated"),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_malformed_zip_raises_in_both_packages(case):
    spec, match = _BAD[case]
    jnet = JaxNet(_conf("bn")).init()
    x, y = _data("bn")
    jnet.fit(JaxDataSet(x, y))
    good = _zip_bytes(jms.write_model, jnet)
    bad = b"PK\x03\x04 not a zip" if spec is None else _rewrite(good, *spec)
    with pytest.raises(ms.ModelSerializationError, match=match):
        ms.restore_multi_layer_network(io.BytesIO(bad), device="cpu")
    with pytest.raises(jms.ModelSerializationError):
        jms.restore_multi_layer_network(io.BytesIO(bad))


def test_updater_state_of_another_architecture_raises():
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _conf("cnn").to_json()), device="cpu").init()
    good = _zip_bytes(ms.write_model, net)
    bad = _rewrite(good, _grow("updaterState.bin", 8),
                   _add("num_updater_values", 2))
    with pytest.raises(ms.ModelSerializationError, match="updater state"):
        ms.restore_multi_layer_network(io.BytesIO(bad), device="cpu")


def test_an_old_zip_without_digests_still_restores():
    raw = open(_fixture("cnn_adam.zip"), "rb").read()
    assert "entries" not in json.loads(_entries(raw)["manifest.json"])
    net = ms.restore_multi_layer_network(io.BytesIO(raw), device="cpu")
    digest = hashlib.sha256(_entries(raw)["coefficients.bin"]).hexdigest()
    manifest = json.loads(_entries(_zip_bytes(ms.write_model, net))
                          ["manifest.json"])
    assert manifest["entries"]["coefficients.bin"]["sha256"] == digest


def test_graph_golden_zip_crosses_both_ways_byte_for_byte():
    raw = open(_fixture("graph_merge_nesterovs.zip"), "rb").read()
    net, jnet = _restore("graph_merge_nesterovs"), _restore(
        "graph_merge_nesterovs", "jax")
    assert isinstance(net, ComputationGraph)
    assert net.topo == jnet.topo == ["d1", "d2", "merge", "out"]
    np.testing.assert_array_equal(net.get_flat_updater_state(),
                                  np.asarray(jnet.get_flat_updater_state()))
    # the golden's params and updater state cross as they were written
    port_zip = _zip_bytes(ms.write_model, net)
    golden, b = _entries(raw), _entries(port_zip)
    for name in PAYLOAD[1:]:
        assert golden[name] == b[name], name
    # (its configuration.json predates fields the packages write today)
    jax_zip = _zip_bytes(jms.write_model, jnet)
    a = _entries(jax_zip)
    for name in PAYLOAD:
        assert a[name] == b[name], name
    back = _entries(_zip_bytes(jms.write_model, _restore(
        "graph_merge_nesterovs", "jax", io.BytesIO(port_zip))))
    forth = _entries(_zip_bytes(ms.write_model, _restore(
        "graph_merge_nesterovs", "port", io.BytesIO(jax_zip))))
    for name in PAYLOAD:
        assert back[name] == forth[name] == b[name], name
    with pytest.raises(ValueError, match="not a multi_layer_conf"):
        ms.restore_multi_layer_network(io.BytesIO(raw), device="cpu")


def _bn_graph_conf(first="bn_a", second="bn_b"):
    """conv -> BN -> dense -> BN -> softmax, its BN vertices named
    ``first`` and ``second`` in topological order."""
    return (JaxConf.builder().seed(9).updater("nesterovs")
            .learning_rate(0.05).activation("relu").graph_builder()
            .add_inputs("img")
            .add_layer("conv", jconvl.ConvolutionLayer(
                n_out=3, kernel_size=(3, 3), convolution_mode="same"), "img")
            .add_layer(first, jnorm.BatchNormalization(), "conv")
            .add_layer("dense", jcore.DenseLayer(n_out=4), first)
            .add_layer(second, jnorm.BatchNormalization(decay=0.8), "dense")
            .add_layer("out", jcore.OutputLayer(n_out=3), second)
            .set_outputs("out").set_input_types(jin.convolutional(5, 5, 2))
            .build())


def _graph_data():
    rng = np.random.RandomState(12)
    x = rng.randn(6, 5, 5, 2).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.randint(0, 3, 6)]


def test_jax_graph_zip_restores_in_the_port_and_writes_back_the_same_bytes():
    jnet = JaxCG(_bn_graph_conf()).init()
    x, y = _graph_data()
    jnet.fit(JaxDataSet(x, y))
    jzip = _zip_bytes(jms.write_model, jnet)
    net = ms.restore_computation_graph(io.BytesIO(jzip), device="cpu")
    assert net.iteration == 1 and net.epoch == 1
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=1e-5,
                               atol=1e-6)
    a, b = _entries(jzip), _entries(_zip_bytes(ms.write_model, net))
    names = PAYLOAD + ("state.bin",)
    assert set(a) == set(b) == set(names) | {"manifest.json"}
    for name in names:
        assert a[name] == b[name], name
    ja, pa = json.loads(a["manifest.json"]), json.loads(b["manifest.json"])
    for key in ("num_params", "num_updater_values", "iteration", "epoch",
                "state", "entries"):
        assert pa[key] == ja[key], key
    assert [e["layer"] for e in pa["state"]] == ["bn_a"] * 2 + ["bn_b"] * 2


def test_port_graph_zip_restores_in_jax_and_writes_back_the_same_bytes(
        tmp_path):
    conf = ComputationGraphConfiguration.from_json(
        _bn_graph_conf().to_json())
    net = ComputationGraph(conf, device="cpu").init()
    x, y = _graph_data()
    net.fit(DataSet(x, y))
    net.fit(DataSet(x, y))
    path = tmp_path / "graph.zip"
    ms.write_model(net, str(path))
    jnet = jms.restore_computation_graph(str(path))
    assert jnet.iteration == 2
    np.testing.assert_allclose(np.asarray(jnet.output(x)),
                               net.output(x).numpy(), rtol=1e-5, atol=1e-6)
    for name in ("bn_a", "bn_b"):
        for key in ("mean", "var"):
            np.testing.assert_array_equal(
                np.asarray(jnet.net_state[name][key]),
                net.net_state[name][key].numpy())
    a = _entries(path.read_bytes())
    b = _entries(_zip_bytes(jms.write_model, jnet))
    for name in PAYLOAD + ("state.bin",):
        assert a[name] == b[name], name


def test_graph_state_manifest_orders_vertices_as_jax_does():
    """After init or a restore the state walks the vertices in
    topological order; after a fit step in sorted order (the JAX
    package's jitted step returns its dicts with sorted keys).  With BN
    vertices whose names sort against the topological order, both
    packages write the same manifest at each point."""
    conf = _bn_graph_conf("zbn", "abn")
    jnet = JaxCG(conf).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    net.set_flat_params(np.asarray(jnet.get_flat_params()))

    def layers(writer, n):
        manifest = json.loads(_entries(_zip_bytes(writer, n))
                              ["manifest.json"])
        return [(e["layer"], e["path"], e["offset"])
                for e in manifest["state"]]

    assert layers(ms.write_model, net) == layers(jms.write_model, jnet) == [
        ("zbn", "mean", 0), ("zbn", "var", 3), ("abn", "mean", 6),
        ("abn", "var", 10)]
    x, y = _graph_data()
    net.fit(DataSet(x, y))
    jnet.fit(JaxDataSet(x, y))
    assert layers(ms.write_model, net) == layers(jms.write_model, jnet) == [
        ("abn", "mean", 0), ("abn", "var", 4), ("zbn", "mean", 8),
        ("zbn", "var", 11)]
    again = ms.restore_computation_graph(io.BytesIO(_zip_bytes(
        ms.write_model, net)), device="cpu")
    assert list(again.net_state)[:2] == ["conv", "zbn"]
    for name in ("zbn", "abn"):
        for key in ("mean", "var"):
            assert torch.equal(again.net_state[name][key],
                               net.net_state[name][key])


def test_every_jax_serde_type_is_ported_or_named():
    """Each type the JAX package's serde registry knows is registered in
    the port (the reconstruction distributions included): nothing is left
    to name a ROADMAP item."""
    from deeplearning4j_tpu.nn.conf import serde as jserde
    from deeplearning4j_tpu_torch.nn.conf import serde
    from deeplearning4j_tpu_torch.nn.conf import neural_net_configuration as N
    import deeplearning4j_tpu.nn.conf.computation_graph  # noqa: F401
    import deeplearning4j_tpu.nn.layers.pretrain  # noqa: F401
    import deeplearning4j_tpu.nn.layers.training  # noqa: F401
    import deeplearning4j_tpu.nn.layers.variational  # noqa: F401
    ported = set(serde.registry())
    missing = {k for k, cls in jserde.registry().items()
               if k not in ported
               and cls.__module__.startswith("deeplearning4j_tpu.")}
    assert missing == set(N._NOT_PORTED) == set()
    assert "is not ported yet" in str(N.not_ported("x"))
    assert {"dense", "output", "loss", "activation", "dropout_layer",
            "embedding", "convolution", "subsampling", "zero_padding",
            "global_pooling", "batch_norm", "lrn", "cnn_to_ff", "ff_to_cnn",
            "rnn_to_ff", "ff_to_rnn", "cnn_to_rnn", "rnn_to_cnn", "reshape",
            "flat_to_cnn", "graves_lstm", "graves_bidirectional_lstm",
            "rnn_output", "computation_graph_conf", "vertex_layer",
            "vertex_merge", "vertex_elementwise", "vertex_subset",
            "vertex_stack", "vertex_unstack", "vertex_scale", "vertex_shift",
            "vertex_preprocessor", "vertex_l2", "vertex_l2_normalize",
            "vertex_last_time_step",
            "vertex_duplicate_to_time_series", "autoencoder", "rbm",
            "variational_autoencoder", "center_loss_output",
            "gaussian_reconstruction", "bernoulli_reconstruction",
            "exponential_reconstruction", "loss_wrapper_reconstruction",
            "composite_reconstruction"} <= ported


def test_atomic_write_replaces_whole_or_not_at_all(tmp_path):
    from deeplearning4j_tpu_torch.utils.fileio import atomic_write
    path = tmp_path / "model.zip"
    path.write_bytes(b"old")
    with pytest.raises(RuntimeError):
        with atomic_write(str(path)) as fh:
            fh.write(b"partial")
            raise RuntimeError("crash mid-write")
    assert path.read_bytes() == b"old"
    with atomic_write(str(path)) as fh:
        fh.write(b"new")
    assert path.read_bytes() == b"new"
    assert [p.name for p in tmp_path.iterdir()] == ["model.zip"]
    with pytest.raises(ValueError, match="write mode"):
        with atomic_write(str(path), "rb"):
            pass


def test_an_fp32_zip_restores_under_the_mixed_policy(monkeypatch):
    """The card's default policy keeps fp32 masters that an fp32 zip does
    not hold: its m and v load, the masters follow the params, and the
    golden holds at the bf16 limit of chip_smoke.py (5e-3)."""
    from deeplearning4j_tpu_torch.nn import updaters
    golden = np.load(_fixture("cnn_adam_golden.npz"))
    ref = ms.restore_multi_layer_network(_fixture("cnn_adam.zip"),
                                         device="cpu")
    monkeypatch.setenv("DL4J_TPU_PRECISION", "mixed_bf16")
    net = ms.restore_multi_layer_network(_fixture("cnn_adam.zip"),
                                         device="cpu")
    assert net._pol().name == "mixed_bf16"
    state = net.updater_state[0]
    assert torch.equal(state[updaters.MASTER_KEY]["W"],
                       net.params[0]["W"].float())
    for key in ("m", "v"):
        assert torch.equal(state[key]["W"], ref.updater_state[0][key]["W"])
    np.testing.assert_allclose(net.output(golden["input"]).numpy(),
                               golden["prediction"], rtol=0, atol=5e-3)
    with pytest.raises(ValueError, match="size mismatch"):
        net.set_flat_updater_state(np.zeros(229, np.float32))
