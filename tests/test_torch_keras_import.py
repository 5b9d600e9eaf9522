"""The port's Keras 1.x import and VGG-16 path (``keras/``) against the
JAX package's.

Each test writes the Keras-1-layout h5 of its twin in
``tests/test_keras_import.py`` (same writer, same weights) and imports it
with both packages: the same configuration JSON, bitwise equal flat
params (and layer state), and outputs within the JAX test's tolerance of
the JAX network's.  ``vgg16()`` gives the JAX configuration JSON and
138,357,544 params; ``load_vgg16`` reads th and tf files to the JAX
loader's params bit for bit.  Under ``mixed_bf16`` an imported network's
first step starts from the imported weights (its fp32 masters are
re-derived after the write)."""

import os
import unittest.mock as mock

import h5py
import numpy as np
import pytest
import torch

from test_keras_import import REAL_FIXTURE, _rng, _seq_config, \
    _write_keras1_h5

import deeplearning4j_tpu.keras.trained_models as jtm
import deeplearning4j_tpu_torch.keras.trained_models as ptm
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.keras import keras_model_import as jki
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.keras import keras_model_import as pki
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

BF16_ULP = 2.0 ** -7


def _imported(path, functional=False):
    """(JAX net, port net) of one h5, with the same JSON and params."""
    if functional:
        jnet = jki.import_keras_model_and_weights(path)
        pnet = pki.import_keras_model_and_weights(path, device="cpu")
    else:
        jnet = jki.import_keras_sequential_model_and_weights(path)
        pnet = pki.import_keras_sequential_model_and_weights(path,
                                                             device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    np.testing.assert_array_equal(pnet.get_flat_params(),
                                  np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _outputs_close(jnet, pnet, x, atol):
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=atol)


def _mlp_h5(tmp_path, activation="softmax"):
    r = _rng(1)
    layers = [
        {"class_name": "Dense",
         "config": {"name": "dense_1", "output_dim": 16,
                    "activation": "tanh", "batch_input_shape": [None, 8]}},
        {"class_name": "Dropout", "config": {"name": "dropout_1", "p": 0.5}},
        {"class_name": "Dense",
         "config": {"name": "dense_2", "output_dim": 3,
                    "activation": activation}},
    ]
    if activation == "linear":
        layers.append({"class_name": "Activation",
                       "config": {"name": "act", "activation": "softmax"}})
    path = str(tmp_path / "mlp.h5")
    _write_keras1_h5(path, _seq_config(layers), {
        "dense_1": {"W": r.randn(8, 16), "b": r.randn(16)},
        "dense_2": {"W": r.randn(16, 3), "b": r.randn(3)}})
    return path, r


@pytest.mark.parametrize("activation", ["softmax", "linear"])
def test_sequential_mlp_matches_jax(tmp_path, activation):
    """A trailing Activation folds into the Dense before it (``linear``)."""
    path, r = _mlp_h5(tmp_path, activation)
    jnet, pnet = _imported(path)
    x = r.randn(5, 8).astype(np.float32)
    _outputs_close(jnet, pnet, x, 1e-5)
    again = pki.KerasModelImport.import_keras_sequential_model_and_weights(
        path, device="cpu")
    assert torch.equal(again.output(x), pnet.output(x))


@pytest.mark.parametrize("ordering", ["tf", "th"])
def test_conv_dim_ordering_matches_jax(tmp_path, ordering):
    """th kernels are rotated and transposed, and the Dense after a th
    Flatten has its rows permuted, exactly as in the JAX importer."""
    r = _rng(2)
    W_tf = r.randn(3, 3, 2, 4).astype(np.float32)
    b = r.randn(4).astype(np.float32)
    W = W_tf if ordering == "tf" else W_tf.transpose(3, 2, 0, 1)
    shape = [None, 6, 6, 2] if ordering == "tf" else [None, 2, 6, 6]
    conf = _seq_config([
        {"class_name": "Convolution2D",
         "config": {"name": "conv", "nb_filter": 4, "nb_row": 3,
                    "nb_col": 3, "activation": "relu",
                    "border_mode": "valid", "subsample": [1, 1],
                    "dim_ordering": ordering, "batch_input_shape": shape}},
        {"class_name": "Flatten", "config": {"name": "flat"}},
        {"class_name": "Dense",
         "config": {"name": "out", "output_dim": 2,
                    "activation": "softmax"}},
    ])
    W2 = r.randn(4 * 4 * 4, 2).astype(np.float32)
    W_file = W[:, :, ::-1, ::-1] if ordering == "th" else W
    path = str(tmp_path / f"conv_{ordering}.h5")
    _write_keras1_h5(path, conf, {"conv": {"W": W_file, "b": b},
                                  "out": {"W": W2, "b": r.randn(2)}})
    jnet, pnet = _imported(path)
    np.testing.assert_array_equal(pnet.params[0]["W"].numpy(), W_tf)
    _outputs_close(jnet, pnet, r.randn(3, 6, 6, 2).astype(np.float32), 1e-4)


def test_lstm_gate_order_matches_jax(tmp_path):
    r = _rng(3)
    I, H, T = 5, 7, 6
    gates = {}
    for gate in ("i", "f", "c", "o"):
        gates[f"W_{gate}"] = r.randn(I, H)
        gates[f"U_{gate}"] = r.randn(H, H)
        gates[f"b_{gate}"] = r.randn(H)
    conf = _seq_config([
        {"class_name": "LSTM",
         "config": {"name": "lstm_1", "output_dim": H, "activation": "tanh",
                    "inner_activation": "hard_sigmoid",
                    "return_sequences": False,
                    "batch_input_shape": [None, T, I]}},
        {"class_name": "Dense",
         "config": {"name": "out", "output_dim": 2,
                    "activation": "softmax"}},
    ])
    path = str(tmp_path / "lstm.h5")
    _write_keras1_h5(path, conf, {"lstm_1": gates, "out": {
        "W": r.randn(H, 2), "b": r.randn(2)}})
    jnet, pnet = _imported(path)
    # [c|f|o|i] with three zero peephole columns
    rw = pnet.params[0]["RW"].numpy()
    assert rw.shape == (H, 4 * H + 3) and not rw[:, 4 * H:].any()
    np.testing.assert_array_equal(rw[:, :H], np.float32(gates["U_c"]))
    _outputs_close(jnet, pnet, r.randn(4, T, I).astype(np.float32), 1e-4)


def test_batchnorm_running_stats_match_jax(tmp_path):
    r = _rng(4)
    var = r.rand(6) + 0.2
    conf = _seq_config([
        {"class_name": "Dense",
         "config": {"name": "dense_1", "output_dim": 6,
                    "activation": "linear", "batch_input_shape": [None, 4]}},
        {"class_name": "BatchNormalization",
         "config": {"name": "bn_1", "mode": 0, "epsilon": 1e-5}},
    ])
    path = str(tmp_path / "bn.h5")
    _write_keras1_h5(path, conf, {
        "dense_1": {"W": r.randn(4, 6), "b": r.randn(6)},
        "bn_1": {"gamma": r.rand(6) + 0.5, "beta": r.randn(6),
                 "running_mean": r.randn(6), "running_std": var}})
    jnet, pnet = _imported(path)
    for k in ("mean", "var"):
        np.testing.assert_array_equal(pnet.net_state[1][k].numpy(),
                                      np.asarray(jnet.net_state[1][k]))
    np.testing.assert_array_equal(pnet.net_state[1]["var"].numpy(),
                                  np.float32(var))
    _outputs_close(jnet, pnet, r.randn(3, 4).astype(np.float32), 1e-4)


@pytest.mark.parametrize("mode", ["concat", "sum"])
def test_functional_model_with_merge_matches_jax(tmp_path, mode):
    r = _rng(5)
    width = 16 if mode == "concat" else 8
    layers = [
        {"class_name": "InputLayer", "name": "input_1",
         "config": {"name": "input_1", "batch_input_shape": [None, 4]},
         "inbound_nodes": []},
        {"class_name": "Dense", "name": "branch_a",
         "config": {"name": "branch_a", "output_dim": 8,
                    "activation": "relu"},
         "inbound_nodes": [[["input_1", 0, 0]]]},
        {"class_name": "Dense", "name": "branch_b",
         "config": {"name": "branch_b", "output_dim": 8,
                    "activation": "tanh"},
         "inbound_nodes": [[["input_1", 0, 0]]]},
        {"class_name": "Merge", "name": "merge_1",
         "config": {"name": "merge_1", "mode": mode},
         "inbound_nodes": [[["branch_a", 0, 0], ["branch_b", 0, 0]]]},
        {"class_name": "Dense", "name": "out",
         "config": {"name": "out", "output_dim": 3,
                    "activation": "softmax"},
         "inbound_nodes": [[["merge_1", 0, 0]]]},
    ]
    conf = {"class_name": "Model", "config": {
        "name": "model_1", "layers": layers,
        "input_layers": [["input_1", 0, 0]],
        "output_layers": [["out", 0, 0]]}}
    path = str(tmp_path / "func.h5")
    _write_keras1_h5(path, conf, {
        "branch_a": {"W": r.randn(4, 8), "b": r.randn(8)},
        "branch_b": {"W": r.randn(4, 8), "b": r.randn(8)},
        "out": {"W": r.randn(width, 3), "b": r.randn(3)}})
    jcg, pcg = _imported(path, functional=True)
    _outputs_close(jcg, pcg, r.randn(6, 4).astype(np.float32), 1e-4)


def test_imported_model_trains_as_jax(tmp_path):
    """Three fits from the imported weights: the JAX package's params at
    rtol 2e-5 / atol 1e-7, and the score falls over 30 epochs."""
    r = _rng(6)
    conf = _seq_config([
        {"class_name": "Dense",
         "config": {"name": "d1", "output_dim": 16, "activation": "tanh",
                    "batch_input_shape": [None, 4]}},
        {"class_name": "Dense",
         "config": {"name": "d2", "output_dim": 3,
                    "activation": "softmax"}},
    ])
    path = str(tmp_path / "train.h5")
    _write_keras1_h5(path, conf, {
        "d1": {"W": r.randn(4, 16), "b": np.zeros(16)},
        "d2": {"W": r.randn(16, 3), "b": np.zeros(3)}})
    jnet, pnet = _imported(path)
    X = r.randn(64, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(X[:, 0] > 0).astype(int)]
    for _ in range(3):
        jnet.fit(JaxDataSet(X, y))
        pnet.fit(DataSet(X, y))
    np.testing.assert_allclose(pnet.get_flat_params(),
                               np.asarray(jnet.get_flat_params()),
                               rtol=2e-5, atol=1e-7)
    s0 = pnet.score(DataSet(X, y))
    pnet.fit(DataSet(X, y), epochs=30)
    assert pnet.score(DataSet(X, y)) < s0 * 0.7


def test_imported_mixed_bf16_step_starts_from_the_file(tmp_path,
                                                       monkeypatch):
    """Under mixed_bf16 the masters follow the imported weights: one step
    at lr 1e-6 stays within one bf16 ulp of the file's values."""
    monkeypatch.setenv("DL4J_TPU_PRECISION", "mixed_bf16")
    path, r = _mlp_h5(tmp_path)
    net = pki.import_keras_sequential_model_and_weights(path, device="cpu")
    assert net.params[0]["W"].dtype == torch.bfloat16
    before = [{k: v.float().clone() for k, v in t.items()}
              for t in net.params]
    for u in [net.conf.conf.updater] + [l.updater for l in net.layers]:
        u.learning_rate = 1e-6
    net.fit(DataSet(r.randn(8, 8).astype(np.float32),
                    np.eye(3, dtype=np.float32)[r.randint(0, 3, 8)]))
    for tree, old in zip(net.params, before):
        for k, v in tree.items():
            assert torch.all((v.float() - old[k]).abs()
                             <= BF16_ULP * old[k].abs() + 1e-30), k


# ------------------------------------------------------------- VGG-16
def test_vgg16_architecture_matches_jax():
    conf = ptm.vgg16()
    assert conf.to_json() == jtm.vgg16().to_json()
    assert ptm.vgg16(n_classes=10, include_top=False, height=64, width=64,
                     compute_dtype="bfloat16").to_json() == jtm.vgg16(
        n_classes=10, include_top=False, height=64, width=64,
        compute_dtype="bfloat16").to_json()
    assert len(conf.layers) == 21
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert net.num_params() == 138_357_544


def test_vgg16_image_preprocessor_and_labels_match_jax(tmp_path):
    img = np.random.RandomState(0).rand(2, 4, 4, 3).astype(np.float32) * 255
    pre, jpre = ptm.VGG16ImagePreProcessor(), jtm.VGG16ImagePreProcessor()
    np.testing.assert_array_equal(pre.transform(img), jpre.transform(img))
    np.testing.assert_array_equal(pre(img), jpre(img))
    ds = DataSet(img, np.zeros((2, 10), np.float32))
    pre.preprocess(ds)
    np.testing.assert_array_equal(np.asarray(ds.features),
                                  jpre.transform(img))
    p = np.array([[0.1, 0.6, 0.05, 0.25], [0.7, 0.1, 0.1, 0.1]])
    assert (ptm.ImageNetLabels(n_classes=4).decode_predictions(p, top=2)
            == jtm.ImageNetLabels(n_classes=4).decode_predictions(p, top=2))
    f = tmp_path / "labels.txt"
    f.write_text("cat\ndog\nfox\nowl\n")
    lab = ptm.ImageNetLabels(labels_path=str(f))
    assert lab.decode_predictions(p[0], top=1) == [[("dog", 0.6)]]
    assert lab.label(3) == "owl"
    with pytest.raises(ValueError, match="labels"):
        lab.decode_predictions(np.zeros((1, 7)))


def _write_vgg_h5(path, weights, ordering):
    """The JAX test's writer: tf (HWIO, HWC flatten) or th (OIHW rotated
    180 degrees, CHW flatten) files with ``layer_names`` in file order."""
    last_c = None
    with h5py.File(path, "w") as f:
        names = []
        for n, (W, b) in enumerate(weights):
            name = f"layer_{n:02d}"
            names.append(name.encode())
            Wf = W
            if W.ndim == 4:
                last_c = W.shape[-1]
                if ordering == "th":
                    Wf = W.transpose(3, 2, 0, 1)[:, :, ::-1, ::-1]
            elif W.ndim == 2 and last_c is not None:
                s = int(round((W.shape[0] / last_c) ** 0.5))
                if ordering == "th" and s * s * last_c == W.shape[0]:
                    Wf = (W.reshape(s, s, last_c, W.shape[1])
                          .transpose(2, 0, 1, 3).reshape(W.shape))
                last_c = None
            lg = f.create_group(name)
            wn = [f"{name}_W".encode(), f"{name}_b".encode()]
            lg.create_dataset(wn[0].decode(), data=Wf)
            lg.create_dataset(wn[1].decode(), data=b)
            lg.attrs["weight_names"] = wn
        f.attrs["layer_names"] = names


def test_vgg16_th_and_tf_files_load_as_jax(tmp_path):
    """The 64x64 variant (five pools leave 2x2, so the th dense-row
    permutation is a real one): the th file loads to the JAX loader's
    params bit for bit, the tf file verbatim, and th and tf give the same
    outputs."""
    jv, pv = jtm.vgg16, ptm.vgg16
    small_j = lambda **kw: jv(n_classes=5, height=64, width=64)  # noqa
    small_p = lambda **kw: pv(n_classes=5, height=64, width=64)  # noqa
    probe = MultiLayerNetwork(small_p(), device="cpu").init()
    rng = np.random.RandomState(0)
    weights = [tuple((rng.randn(*tree[k].shape) * 0.05).astype(np.float32)
                     for k in ("W", "b"))
               for tree in probe.params if tree]
    nets = {}
    for ordering in ("tf", "th"):
        path = str(tmp_path / f"vgg_{ordering}.h5")
        _write_vgg_h5(path, weights, ordering)
        with mock.patch.object(ptm, "vgg16", small_p):
            nets[ordering] = ptm.load_vgg16(path, n_classes=5, device="cpu")
    # the JAX loader on the th file (the tf file loads verbatim, below)
    with mock.patch.object(jtm, "vgg16", small_j):
        jnet = jtm.load_vgg16(path, n_classes=5)
    assert nets["th"].conf.to_json() == jnet.conf.to_json()
    np.testing.assert_array_equal(nets["th"].get_flat_params(),
                                  np.asarray(jnet.get_flat_params()))
    np.testing.assert_array_equal(nets["tf"].params[0]["W"].numpy(),
                                  weights[0][0])
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    np.testing.assert_allclose(nets["th"].output(x).numpy(),
                               nets["tf"].output(x).numpy(), atol=1e-5)


@pytest.mark.skipif(not os.path.isdir(REAL_FIXTURE),
                    reason="reference fixture not mounted")
class TestRealKerasFixture:
    """The JAX tier's real Keras 1.1.2 file (theano ordering): the port's
    import equals the JAX package's, params and outputs."""

    def test_import_matches_jax(self):
        jnet, pnet = _imported(os.path.join(REAL_FIXTURE, "model.h5"))
        with h5py.File(os.path.join(REAL_FIXTURE, "features",
                                    "batch_0.h5"), "r") as f:
            x = np.asarray(f["data"], np.float32).transpose(0, 2, 3, 1)
        _outputs_close(jnet, pnet, x, 2e-4)
