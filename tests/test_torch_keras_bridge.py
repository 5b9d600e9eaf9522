"""The port's Keras bridge (``deeplearning4j_tpu_torch/keras/bridge.py``)
against the JAX package's: twins of every test of
``tests/test_keras_bridge.py`` on the port's classes (on the CPU, asked
for), plus:

- ``sequential_fit`` of the same Keras h5 on the same HDF5 minibatch files
  scores within 1e-5 (relative) of the JAX bridge, and ``predict`` of the
  fitted handle agrees within 1e-5 (float32 on the CPU; the packages sum
  in another order);
- one client drives both servers through the same calls and gets the same
  replies: handles, keys and error replies equal, numbers within 1e-5;
- a network registered in process (``KerasBridgeServer.register``) serves
  ``predict`` over the wire equal to its ``output()`` bitwise, and ``save``
  over the wire restores to the same params bytewise;
- without ``h5py`` the module imports, and ``import_model`` answers an
  error that names ``h5py``.
"""

import json
import os
import socket
import subprocess
import sys

import h5py
import numpy as np
import pytest

from deeplearning4j_tpu.keras.bridge import \
    KerasBridgeEntryPoint as JaxEntryPoint
from deeplearning4j_tpu.keras.bridge import KerasBridgeServer as JaxServer
from deeplearning4j_tpu_torch.keras.bridge import (
    HDF5MiniBatchDataSetIterator, KerasBridgeClient, KerasBridgeEntryPoint,
    KerasBridgeServer)
from deeplearning4j_tpu_torch.utils.model_serializer import \
    restore_multi_layer_network
from serving_pairs import dense_conf, port_net

RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_keras1_h5(path, model_config, layer_weights):
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config).encode()
        g = f.create_group("model_weights")
        for layer_name, weights in layer_weights.items():
            lg = g.create_group(layer_name)
            names = []
            for wname, arr in weights.items():
                full = f"{layer_name}_{wname}"
                lg.create_dataset(full, data=np.asarray(arr, np.float32))
                names.append(full.encode())
            lg.attrs["weight_names"] = names


def _mlp_h5(path, seed=0, n_in=4, hidden=8, n_out=3):
    r = np.random.RandomState(seed)
    conf = {"class_name": "Sequential", "config": [
        {"class_name": "Dense",
         "config": {"name": "dense_1", "output_dim": hidden,
                    "activation": "tanh",
                    "batch_input_shape": [None, n_in]}},
        {"class_name": "Dense",
         "config": {"name": "dense_2", "output_dim": n_out,
                    "activation": "softmax"}},
    ]}
    _write_keras1_h5(path, conf, {
        "dense_1": {"W": r.randn(n_in, hidden) * 0.3, "b": np.zeros(hidden)},
        "dense_2": {"W": r.randn(hidden, n_out) * 0.3, "b": np.zeros(n_out)},
    })
    return path


def _minibatch_dir(tmp_path, n_batches=4, batch=16, n_in=4, n_out=3,
                   seed=1):
    d = tmp_path / "batches"
    d.mkdir()
    r = np.random.RandomState(seed)
    for i in range(n_batches):
        X = r.randn(batch, n_in).astype(np.float32)
        y = np.eye(n_out, dtype=np.float32)[
            (X[:, 0] > 0).astype(int) + (X[:, 1] > 0).astype(int)]
        with h5py.File(d / f"batch_{i:04d}.h5", "w") as f:
            f.create_dataset("features", data=X)
            f.create_dataset("labels", data=y)
    return str(d)


# ---------------------------------------------------------------- iterator

def test_hdf5_minibatch_iterator(tmp_path):
    d = _minibatch_dir(tmp_path, n_batches=3, batch=8)
    it = HDF5MiniBatchDataSetIterator(d)
    assert it.batch() == 8
    batches = list(it)
    assert len(batches) == 3
    assert batches[0].features.shape == (8, 4)
    it.reset()
    assert len(list(it)) == 3


def test_hdf5_iterator_empty_dir_raises(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError):
        HDF5MiniBatchDataSetIterator(str(tmp_path / "empty"))


# -------------------------------------------------------------- entry point

def test_entry_point_sequential_fit_and_predict(tmp_path):
    model = _mlp_h5(str(tmp_path / "m.h5"))
    data = _minibatch_dir(tmp_path)
    entry = KerasBridgeEntryPoint(device="cpu")
    out = entry.sequential_fit(model, data, nb_epoch=2)
    assert "model_id" in out and np.isfinite(out["score"])
    pred = entry.predict(out["model_id"], [[0.1, 0.2, 0.3, 0.4]])
    assert len(pred["output"][0]) == 3
    ev = entry.evaluate(out["model_id"], data)
    assert 0.0 <= ev["accuracy"] <= 1.0


def test_entry_point_unknown_model_raises():
    entry = KerasBridgeEntryPoint(device="cpu")
    with pytest.raises(KeyError):
        entry.predict("model_99", [[1.0]])


def test_sequential_fit_scores_like_the_jax_bridge(tmp_path):
    model = _mlp_h5(str(tmp_path / "m.h5"))
    data = _minibatch_dir(tmp_path)
    port = KerasBridgeEntryPoint(device="cpu")
    jax = JaxEntryPoint()
    p = port.sequential_fit(model, data, nb_epoch=2)
    j = jax.sequential_fit(model, data, nb_epoch=2)
    assert p["model_id"] == j["model_id"]
    np.testing.assert_allclose(p["score"], j["score"], rtol=RTOL)
    x = np.random.RandomState(5).randn(6, 4).astype(np.float32).tolist()
    np.testing.assert_allclose(port.predict(p["model_id"], x)["output"],
                               jax.predict(j["model_id"], x)["output"],
                               rtol=RTOL, atol=1e-7)
    pe, je = port.evaluate(p["model_id"], data), jax.evaluate(
        j["model_id"], data)
    assert pe["accuracy"] == je["accuracy"]


# ------------------------------------------------------------------- server

def test_bridge_server_end_to_end(tmp_path):
    model = _mlp_h5(str(tmp_path / "m.h5"))
    data = _minibatch_dir(tmp_path)
    with KerasBridgeServer(port=0, device="cpu") as server:
        client = KerasBridgeClient(server.host, server.port)
        try:
            imp = client.call("import_model", path=model)
            mid = imp["model_id"]
            fit = client.call("fit", model_id=mid, train_dir=data,
                              nb_epoch=2)
            assert np.isfinite(fit["score"])
            pred = client.call("predict", model_id=mid,
                               features=[[0.0, 0.1, -0.2, 0.3]])
            np.testing.assert_allclose(np.sum(pred["output"][0]), 1.0,
                                       rtol=1e-4)
            client.call("save", model_id=mid,
                        path=str(tmp_path / "saved.zip"))
            assert (tmp_path / "saved.zip").exists()
            # protocol errors surface as RuntimeError, connection survives
            with pytest.raises(RuntimeError):
                client.call("no_such_method")
            with pytest.raises(RuntimeError):
                client.call("predict", model_id="nope", features=[[1.0]])
            pred2 = client.call("predict", model_id=mid,
                                features=[[0.0, 0.0, 0.0, 0.0]])
            assert len(pred2["output"]) == 1
        finally:
            client.close()


def test_bridge_rejects_private_methods(tmp_path):
    with KerasBridgeServer(port=0, device="cpu") as server:
        client = KerasBridgeClient(server.host, server.port)
        try:
            with pytest.raises(RuntimeError, match="unknown method"):
                client.call("_register")
            with pytest.raises(RuntimeError, match="unknown method"):
                client.call("register", net=None)   # server-side only
        finally:
            client.close()


def test_bridge_malformed_json_gets_error_response():
    """A non-JSON line must produce an error reply, not a dropped
    connection; the connection stays usable."""
    with KerasBridgeServer(port=0, device="cpu") as server:
        with socket.create_connection((server.host, server.port),
                                      timeout=10) as s:
            fh = s.makefile("rwb")
            fh.write(b"this is not json\n")
            fh.flush()
            resp = json.loads(fh.readline())
            assert "error" in resp and resp["id"] is None
            fh.write((json.dumps({"id": 7, "method": "import_model",
                                  "params": {"path": "/nope.h5"}})
                      + "\n").encode())
            fh.flush()
            resp2 = json.loads(fh.readline())
            assert resp2["id"] == 7 and "error" in resp2


def test_bridge_concurrent_imports_get_unique_handles(tmp_path):
    from concurrent.futures import ThreadPoolExecutor
    model = _mlp_h5(str(tmp_path / "m.h5"))
    with KerasBridgeServer(port=0, device="cpu") as server:
        def one_import(_):
            c = KerasBridgeClient(server.host, server.port)
            try:
                return c.call("import_model", path=model)["model_id"]
            finally:
                c.close()

        with ThreadPoolExecutor(max_workers=6) as pool:
            handles = list(pool.map(one_import, range(6)))
    assert len(set(handles)) == 6


# ------------------------------------------- one client, both servers

def _raw(fh, req):
    fh.write((json.dumps(req) + "\n").encode("utf-8"))
    fh.flush()
    return json.loads(fh.readline())


def _same(a, b):
    """Equal replies: equal keys, ids and strings; numbers within RTOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-7)
    else:
        assert a == b


def test_one_client_gets_the_same_replies_from_both_servers(tmp_path):
    model = _mlp_h5(str(tmp_path / "m.h5"))
    data = _minibatch_dir(tmp_path)
    x = np.random.RandomState(6).randn(3, 4).astype(np.float32).tolist()
    script = [
        {"method": "import_model", "params": {"path": model}},
        {"method": "fit", "params": {"model_id": "model_0",
                                     "train_dir": data, "nb_epoch": 2}},
        {"method": "predict", "params": {"model_id": "model_0",
                                         "features": x}},
        {"method": "evaluate", "params": {"model_id": "model_0",
                                          "data_dir": data}},
        {"method": "predict", "params": {"model_id": "nope",
                                         "features": x}},
        {"method": "no_such_method", "params": {}},
        {"method": "_register", "params": {"net": None}},
        {"method": "import_model",
         "params": {"path": model, "model_type": "recurrent"}},
        {"method": "import_model",
         "params": {"path": str(tmp_path / "missing.h5")}},
        {"method": "sequential_fit",
         "params": {"model_file_path": model, "train_dir": data}},
    ]
    replies = {}
    for side, server in (("jax", JaxServer(port=0)),
                         ("port", KerasBridgeServer(port=0, device="cpu"))):
        with server:
            with socket.create_connection((server.host, server.port),
                                          timeout=30) as s:
                fh = s.makefile("rwb")
                replies[side] = [_raw(fh, dict(req, id=i))
                                 for i, req in enumerate(script)]
    for j, p in zip(replies["jax"], replies["port"]):
        _same(j, p)
    assert sum("error" in r for r in replies["port"]) == 5


# -------------------------------------- the card's half: no h5 file needed

def test_a_registered_net_serves_predict_and_save_over_the_wire(tmp_path):
    net = port_net(dense_conf())
    x = np.random.RandomState(7).randn(32, 4).astype(np.float32)
    with KerasBridgeServer(port=0, device="cpu") as server:
        mid = server.register(net)
        client = KerasBridgeClient(server.host, server.port)
        try:
            got = np.asarray(client.call("predict", model_id=mid,
                                         features=x.tolist())["output"],
                             np.float32)
            path = str(tmp_path / "net.zip")
            assert client.call("save", model_id=mid, path=path) == \
                {"path": path}
        finally:
            client.close()
    assert np.array_equal(got, net.output(x).numpy())
    back = restore_multi_layer_network(path, device="cpu")
    assert back.get_flat_params().tobytes() == \
        net.get_flat_params().tobytes()


_NO_H5PY = """
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "h5py":
            raise ImportError("No module named 'h5py'")
        return None

sys.meta_path.insert(0, Block())
from deeplearning4j_tpu_torch.keras.bridge import (KerasBridgeClient,
                                                   KerasBridgeServer)
with KerasBridgeServer(port=0, device="cpu") as server:
    c = KerasBridgeClient(server.host, server.port)
    try:
        c.call("import_model", path="model.h5")
    except RuntimeError as e:
        print("h5py" in str(e))
    c.close()
"""


def test_without_h5py_import_model_answers_an_error_naming_it():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _NO_H5PY], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"
