"""The port's ``ui/`` against the JAX package's: both ``UIServer``s in one
process, each over an engine, a registry and a rollout controller on the
same weights (``tests/serving_pairs.py``), answer every route with the
same status, ``Retry-After`` and content type and the same top-level body
keys; ``POST /predict`` agrees within 1e-5 (float32 on the CPU; the
JAX package's XLA dot sums in another order).  Also: the sqlite stats
files read across the packages, the port's ``StatsListener`` reports
(the keys of the JAX listener's, ``torch_version`` in place of
``jax_version``), the dashboard and remote-router flows of
``tests/test_ui.py``, and ``examples/ui_dashboard.py``'s flow through the
port.  The port's own contract: an ill-shaped request answers 400 on the
bucket and session paths of both containers (ROADMAP C9), an embedding
net still serves its indices, an unexpected fault answers 500, and
connections wait while the accept loop is busy (C10).
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.deploy import RolloutController as JaxRollout
from deeplearning4j_tpu.deploy import VersionedWeightStore as JaxStore
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.serving import engine as jengine
from deeplearning4j_tpu.serving.engine import InferenceEngine as JaxEngine
from deeplearning4j_tpu.serving.fleet import FleetRouter as JaxRouter
from deeplearning4j_tpu.serving.registry import ModelRegistry as JaxRegistry
from deeplearning4j_tpu_torch import monitor, ui
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.deploy import (RolloutController,
                                             VersionedWeightStore)
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.jax_weights import load_jax_params
from deeplearning4j_tpu_torch.serving import engine as pengine
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
from deeplearning4j_tpu_torch.serving.fleet import FleetRouter
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.ui.stats_listener import TYPE_ID
from serving_pairs import CONFS, dense_conf, inputs_for, pair, port_net
from test_torch_deploy import _corrupt_entry, _zip_path

X = np.random.RandomState(3).randn(2, 4).astype(np.float32)


def _fake_fleet(router):
    class _Worker:
        def __init__(self, rank):
            self.rank, self.name = rank, f"w{rank}"
            self.healthy, self.route_fraction = True, 1.0
            self.served = self.fail_streak = self.generation = 0

        def view(self):
            return {"name": self.name, "healthy": self.healthy}

    for rank in range(2):
        h = _Worker(rank)
        router._workers[h.name] = h
        router._ring.add(h.name)
    router._forward = lambda w, p: (429, {"error": "worker full"},
                                    {"Retry-After": "3"})
    return router


def _servers(side, net, tmp):
    """(main, bare, front) servers of one package: ``main`` fronts an
    engine, a registry and a rollout controller over a store holding a
    good version 1 and a corrupt version 2; ``bare`` has nothing
    attached; ``front`` fronts a fake fleet whose workers answer 429."""
    jax = side == "jax"
    Engine, Registry, Store, Rollout, Server, Router = (
        (JaxEngine, JaxRegistry, JaxStore, JaxRollout, jui.UIServer,
         JaxRouter) if jax else
        (InferenceEngine, ModelRegistry, VersionedWeightStore,
         RolloutController, ui.UIServer, FleetRouter))
    eng = Engine(net, max_batch_size=4, max_latency_ms=1.0, name="m")
    reg = Registry()
    reg.register("m", eng, pinned=True)
    store = Store(str(tmp / side))
    flat = np.asarray(net.get_flat_params())
    store.publish(flat)
    bad = store.publish(flat)
    _corrupt_entry(_zip_path(tmp / side, bad))
    main = Server(port=0).attach_registry(reg).attach_inference(eng)
    main.attach_deployment(Rollout(reg, "m", store))
    router = Router(k=2, model="mlp") if jax else FleetRouter(
        k=2, model="mlp", device="cpu")
    front = Server(port=0).attach_fleet(_fake_fleet(router))
    return [s.start() for s in (main, Server(port=0), front)], reg


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ui")
    jnet, pnet = pair(dense_conf())
    out = {"jax": _servers("jax", jnet, tmp),
           "port": _servers("port", pnet, tmp)}
    yield out
    for srv, reg in out.values():
        for s in srv:
            s.stop()
        reg.stop_all()


def _call(base, method, path, body=None):
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _shape(status, headers, raw):
    ctype = headers.get("Content-Type")
    keys = None
    if ctype == "application/json":
        doc = json.loads(raw.decode())
        keys = sorted(doc) if isinstance(doc, dict) else type(doc).__name__
    return {"status": status, "retry_after": headers.get("Retry-After"),
            "content_type": ctype,
            "trace_dropped": "X-Trace-Dropped" in headers, "keys": keys}


_RAISE = {
    "queue_full": lambda m: m.QueueFull("serving queue at capacity", 2.4),
    "slo_shed": lambda m: m.SloShed("shed", slo_p99_ms=20.0,
                                    observed_p99_ms=41.5, tenant="free"),
    "serving_error": lambda m: m.ServingError("engine not started"),
}

# (id, server index, method, path, body, registry.predict raises)
CASES = [
    ("healthz", 0, "GET", "/healthz", None, None),
    ("health", 0, "GET", "/health", None, None),
    ("alerts", 0, "GET", "/alerts", None, None),
    ("models", 0, "GET", "/models", None, None),
    ("tenants", 0, "GET", "/tenants", None, None),
    ("metrics", 0, "GET", "/metrics", None, None),
    ("trace", 0, "GET", "/trace", None, None),
    ("trace_chrome", 0, "GET", "/trace?format=chrome", None, None),
    ("trace_bad_limit", 0, "GET", "/trace?limit=x", None, None),
    ("fleet_stub", 1, "GET", "/fleet", None, None),
    ("fleet", 2, "GET", "/fleet", None, None),
    ("deploy", 0, "GET", "/deploy", None, None),
    ("sessions", 0, "GET", "/train/sessions", None, None),
    ("overview", 0, "GET", "/train/overview/data?sid=x", None, None),
    ("page", 0, "GET", "/", None, None),
    ("unknown_get", 0, "GET", "/nope", None, None),
    ("predict", 0, "POST", "/predict", {"model": "m",
                                         "features": X.tolist()}, None),
    ("predict_engine", 0, "POST", "/predict", {"engine": "m",
                                                "features": X.tolist()},
     None),
    ("predict_unknown_model", 0, "POST", "/predict",
     {"model": "zz", "features": X.tolist()}, None),
    ("predict_bad_shape", 0, "POST", "/predict",
     {"model": "m", "features": [[1.0, 2.0]]}, None),
    ("predict_no_features", 0, "POST", "/predict", {"model": "m"}, None),
    ("predict_not_json", 0, "POST", "/predict", b"{oops", None),
    ("predict_session_dense", 0, "POST", "/predict",
     {"model": "m", "session": "s", "features": X[:1].tolist()}, None),
    ("predict_queue_full", 0, "POST", "/predict",
     {"model": "m", "features": X.tolist()}, "queue_full"),
    ("predict_slo_shed", 0, "POST", "/predict",
     {"model": "m", "features": X.tolist()}, "slo_shed"),
    ("predict_serving_error", 0, "POST", "/predict",
     {"model": "m", "features": X.tolist()}, "serving_error"),
    ("predict_no_engine", 1, "POST", "/predict", {"features": X.tolist()},
     None),
    ("predict_fleet_passthrough", 2, "POST", "/predict",
     {"features": X.tolist()}, None),
    ("deploy_unknown", 0, "POST", "/deploy/zz", {"action": "push"}, None),
    ("deploy_corrupt", 0, "POST", "/deploy/m",
     {"action": "push", "version": 2}, None),
    ("deploy_bad_action", 0, "POST", "/deploy/m", {"action": "bogus"},
     None),
    ("deploy_promote_idle", 0, "POST", "/deploy/m", {"action": "promote"},
     None),
    ("deploy_push", 0, "POST", "/deploy/m", {"action": "push",
                                             "version": 1}, None),
    ("deploy_status", 0, "GET", "/deploy", None, None),
    ("deploy_rollback", 0, "POST", "/deploy/m", {"action": "rollback"},
     None),
    ("remote", 1, "POST", "/remote",
     {"kind": "update", "record": {"session_id": "s", "type_id": TYPE_ID,
                                   "worker_id": "w", "timestamp": 1.0,
                                   "data": {"iteration": 1,
                                            "score": 0.5}}}, None),
    ("remote_bad", 1, "POST", "/remote", {"record": {}}, None),
    ("unknown_post", 0, "POST", "/nope", {}, None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_route_matches_the_jax_server(servers, case, tmp_path, monkeypatch):
    """One route on both servers: status, headers and body keys equal."""
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    name, idx, method, path, body, raises = case
    got = {}
    for side, module in (("jax", jengine), ("port", pengine)):
        srv, reg = servers[side]
        if raises:
            def predict(*a, _exc=_RAISE[raises](module), **k):
                raise _exc
            monkeypatch.setattr(reg, "predict", predict)
        status, headers, raw = _call(f"http://127.0.0.1:{srv[idx].port}",
                                     method, path, body)
        got[side] = (_shape(status, headers, raw), raw)
    assert got["port"][0] == got["jax"][0]
    if name.startswith("predict") and got["jax"][0]["status"] == 200:
        want = np.asarray(json.loads(got["jax"][1])["output"])
        np.testing.assert_allclose(
            np.asarray(json.loads(got["port"][1])["output"]), want,
            rtol=1e-5, atol=1e-6)
        assert want.shape[1] == 3
    expected = {"deploy_corrupt": 400, "deploy_promote_idle": 409,
                "deploy_unknown": 404, "predict_unknown_model": 404,
                "predict_bad_shape": 400, "predict_queue_full": 429,
                "predict_slo_shed": 503, "predict_no_engine": 503,
                "predict_fleet_passthrough": 429, "unknown_get": 404,
                "deploy_push": 200, "predict": 200}
    if name in expected:
        assert got["port"][0]["status"] == expected[name]


def test_engine_refuses_an_ill_shaped_request_as_jax_does():
    """A request whose last axis cannot feed the first layer raises an
    error the server answers 400 (``TypeError`` or ``ValueError``) in
    both engines (JAX: XLA's shape check when the bucket is lowered,
    ``dot_general``'s TypeError or the LSTM einsum's ValueError; the
    port: the same check when the bucket callable is made), not torch's
    RuntimeError, which dropped the connection."""
    for kind in ("dense", "lstm"):
        jnet, pnet = pair(CONFS[kind]())
        x = inputs_for(kind, 2)[..., :-1]
        for Engine, net in ((JaxEngine, jnet), (InferenceEngine, pnet)):
            eng = Engine(net, max_batch_size=4, max_latency_ms=1.0).start()
            try:
                with pytest.raises((TypeError, ValueError)):
                    eng.predict(x)
            finally:
                eng.stop()


def _lstm_graph_pair():
    """A one-input LSTM ComputationGraph in both packages, same weights."""
    conf = (JaxConf.builder().seed(7).graph_builder().add_inputs("in")
            .add_layer("lstm", jrec.GravesLSTM(n_in=3, n_out=8), "in")
            .add_layer("out", jrec.RnnOutputLayer(
                n_in=8, n_out=3, activation="softmax", loss="mcxent"),
                "lstm")
            .set_outputs("out").build())
    jnet = JaxCG(conf).init()
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    load_jax_params(pnet, np.asarray(jnet.get_flat_params()))
    return jnet, pnet


@pytest.mark.parametrize("net", ["mln", "cg"])
def test_ill_shaped_requests_answer_400_on_both_paths(net):
    """A sequence whose last axis cannot feed the LSTM, sent as a bucket
    request and as a session step to each package's ``UIServer``: 400
    from both (JAX: the LSTM einsum's ValueError; the port: the width
    check both paths share), where the port's session step raised
    torch's RuntimeError and the connection dropped.  The same
    well-shaped requests answer 200 afterwards."""
    jnet, pnet = (pair(CONFS["lstm"]()) if net == "mln"
                  else _lstm_graph_pair())
    x = inputs_for("lstm", 2)
    for Engine, model, Server in ((JaxEngine, jnet, jui.UIServer),
                                  (InferenceEngine, pnet, ui.UIServer)):
        eng = Engine(model, max_batch_size=4, max_latency_ms=1.0).start()
        srv = Server(port=0).attach_inference(eng).start()
        base = f"http://127.0.0.1:{srv.port}"
        try:
            for body in ({"features": x[..., :-1].tolist()},
                         {"session": "s",
                          "features": x[:, 0, :-1].tolist()}):
                status, _, raw = _call(base, "POST", "/predict", body)
                assert status == 400, (Server.__module__, body.keys(), raw)
            for body in ({"features": x.tolist()},
                         {"session": "s", "features": x[:, 0].tolist()}):
                assert _call(base, "POST", "/predict", body)[0] == 200
        finally:
            srv.stop()
            eng.stop()


def test_the_width_check_lets_an_embedding_net_serve_its_indices():
    """An embedding's ``n_in`` is its vocabulary, not a width: a net
    that starts with one (no input type) serves ``(batch, 1)`` indices
    as the JAX engine does."""
    from deeplearning4j_tpu.nn.layers import core as jcore
    conf = (JaxConf.builder().seed(7).list()
            .layer(jcore.EmbeddingLayer(n_in=10, n_out=4))
            .layer(jcore.OutputLayer(n_in=4, n_out=3)).build())
    jnet, pnet = pair(conf)
    x = np.array([[1.0], [7.0]], np.float32)
    got = []
    for Engine, net in ((JaxEngine, jnet), (InferenceEngine, pnet)):
        with Engine(net, max_batch_size=4, max_latency_ms=1.0) as eng:
            got.append(np.asarray(eng.predict(x, timeout=30)))
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5, atol=1e-6)


def test_an_unexpected_fault_answers_500_not_a_dropped_connection(
        servers, monkeypatch):
    """A fault outside the serving errors answers 500 with its name (a
    deliberate difference: the JAX server drops the connection, which a
    FleetRouter reads as a dead worker)."""
    srv, reg = servers["port"]

    def predict(*a, **k):
        raise RuntimeError("device fault")
    monkeypatch.setattr(reg, "predict", predict)
    status, _, raw = _call(f"http://127.0.0.1:{srv[0].port}", "POST",
                           "/predict", {"model": "m",
                                        "features": X.tolist()})
    assert status == 500
    assert json.loads(raw) == {"error": "RuntimeError: device fault"}


def test_connections_wait_while_the_accept_loop_is_busy():
    """C10: with its accept loop stopped, the port's server still queues
    64 connections and answers each once the loop runs again
    (socketserver's default backlog of 5 queued 6; the rest timed out,
    and under load were reset)."""
    srv = ui.UIServer(port=0).start()
    srv._httpd.shutdown()        # the socket keeps listening
    socks = []
    try:
        for _ in range(64):
            s = socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=2.0)
            socks.append(s)
        threading.Thread(target=srv._httpd.serve_forever,
                         daemon=True).start()
        for s in socks:
            s.settimeout(10.0)
            s.sendall(b"GET /healthz HTTP/1.0\r\nHost: x\r\n\r\n")
            assert s.recv(64).startswith(b"HTTP/1.0 200")
    finally:
        for s in socks:
            s.close()
        srv.stop()


def test_healthz_names_the_torch_backend(servers):
    srv, _ = servers["port"]
    _, _, raw = _call(f"http://127.0.0.1:{srv[0].port}", "GET", "/healthz")
    doc = json.loads(raw)
    assert doc["backend"] == "cpu" and doc["device_count"] == 1
    assert doc["status"] == "ok"


# ---- storage ---------------------------------------------------------------

def _fill(storage):
    storage.put_static_info(ui.Persistable("s1", "T", "w0", 1.0, {"a": 1}))
    for t in (2.0, 3.0, 4.0):
        storage.put_update(ui.Persistable("s1", "T", "w0", t, {"t": t}))
    storage.put_update(ui.Persistable("s2", "U", "w1", 9.0, {"t": [9.0]}))
    storage.close()


def _read(storage):
    out = (storage.list_session_ids(), storage.list_type_ids("s1"),
           storage.list_worker_ids("s1"), storage.list_worker_ids("s2", "U"),
           storage.get_static_info("s1", "T", "w0").to_json(),
           [u.to_json() for u in storage.get_all_updates("s1", "T", "w0")],
           storage.get_latest_update("s2", "U", "w1").to_json(),
           storage.num_update_records("s1"))
    storage.close()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sqlite_stats_files_read_across_packages(writer, tmp_path):
    path = str(tmp_path / "stats.db")
    write, other = ((jui.FileStatsStorage, ui.FileStatsStorage)
                    if writer == "jax" else
                    (ui.FileStatsStorage, jui.FileStatsStorage))
    _fill(write(path))
    assert _read(other(path)) == _read(write(path))
    assert _read(other(path))[0] == ["s1", "s2"]


def test_in_memory_storage_equals_the_jax_storage():
    a, b = ui.InMemoryStatsStorage(), jui.InMemoryStatsStorage()
    events = {id(a): [], id(b): []}
    for s in (a, b):
        s.register_listener(lambda e, s=s: events[id(s)].append(
            e.event_type))
    for s in (a, b):
        s.put_static_info(ui.Persistable("s1", "T", "w0", 1.0, {"a": 1}))
        s.put_update(ui.Persistable("s1", "T", "w0", 2.0, {"t": 2}))
    for q in ("list_session_ids", "num_update_records"):
        args = () if q == "list_session_ids" else ("s1",)
        assert getattr(a, q)(*args) == getattr(b, q)(*args)
    assert a.list_worker_ids("s1", "T") == b.list_worker_ids("s1", "T")
    assert events[id(a)] == events[id(b)] == [
        "new_session", "post_static", "post_update"]
    assert a.get_all_updates_after("s1", "T", "w0", 1.5)[0].data == {"t": 2}


# ---- StatsListener ----------------------------------------------------------

def _data(n=32):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return x, y


def test_stats_listener_reports_the_jax_listeners_keys():
    """Both listeners on the same net and data: the same records, the
    same report keys (``torch_version`` for ``jax_version``), the same
    iterations, learning rates and param names; scores within 1e-5."""
    jnet, pnet = pair(dense_conf())
    x, y = _data()
    reports = {}
    for side, net, mod, ds in (("jax", jnet, jui, JaxDataSet(x, y)),
                               ("port", pnet, ui, DataSet(x, y))):
        storage = mod.InMemoryStatsStorage()
        listener = mod.StatsListener(storage, update_frequency=2)
        net.add_listener(listener)
        net.fit(ds, epochs=6)
        sid = listener.session_id
        reports[side] = (storage.get_static_info(sid, TYPE_ID, "worker_0"),
                         storage.get_all_updates(sid, TYPE_ID, "worker_0"))
    (jstatic, jups), (pstatic, pups) = reports["jax"], reports["port"]
    jkeys = set(jstatic.data) - {"jax_version"} | {"torch_version"}
    assert set(pstatic.data) == jkeys
    assert pstatic.data["backend"] == "cpu"
    assert pstatic.data["num_params"] == jstatic.data["num_params"]
    assert pstatic.data["model_config_json"] == \
        jstatic.data["model_config_json"]
    assert len(pups) == len(jups) == 3
    for p, j in zip(pups, jups):
        assert set(p.data) == set(j.data)
        assert p.data["iteration"] == j.data["iteration"]
        assert p.data["learning_rates"] == j.data["learning_rates"]
        assert set(p.data["param_mean_magnitudes"]) == \
            set(j.data["param_mean_magnitudes"])
        assert p.data["score"] == pytest.approx(j.data["score"], rel=1e-5)


def test_dashboard_and_remote_router_flow():
    """``tests/test_ui.py``'s end-to-end and remote cases on the port:
    the overview, model and system data of a listener's session, once
    stored in process and once posted through the remote router."""
    storage = ui.InMemoryStatsStorage()
    server = ui.UIServer(storage, port=0).start()
    remote = ui.UIServer(port=0).start()
    try:
        x, y = _data()
        net = port_net(dense_conf())
        listener = ui.StatsListener(storage, update_frequency=1)
        router = ui.RemoteStatsStorageRouter(
            f"http://127.0.0.1:{remote.port}")
        net.set_listeners(listener, ui.StatsListener(router,
                                                     update_frequency=2))
        net.fit(DataSet(x, y), epochs=4)
        router.flush()
        base = f"http://127.0.0.1:{server.port}"
        sid = listener.session_id
        page = urllib.request.urlopen(base + "/train/overview").read()
        assert b"Training Dashboard" in page
        ov = json.loads(urllib.request.urlopen(
            base + f"/train/overview/data?sid={sid}").read())
        assert len(ov["score_vs_iter"]) == 4
        assert ov["static"]["model_class"] == "MultiLayerNetwork"
        md = json.loads(urllib.request.urlopen(
            base + f"/train/model/data?sid={sid}").read())
        assert md["params"]["0_W"]["histogram"] is not None
        sd = json.loads(urllib.request.urlopen(
            base + f"/train/system/data?sid={sid}").read())
        hw = sd["workers"]["worker_0"]["hardware"]
        assert hw["backend"] == "cpu" and hw["torch_version"]
        flow = json.loads(urllib.request.urlopen(
            base + f"/flow/data?sid={sid}").read())
        assert [n["name"] for n in flow["nodes"]][0] == "input"
        rsid = remote.storage.list_session_ids()
        assert len(rsid) == 1 and remote.storage.num_update_records(
            rsid[0]) == 2
    finally:
        server.stop()
        remote.stop()


def test_ui_dashboard_example_flow_through_the_port():
    """``examples/ui_dashboard.py`` with the port's modules (20 of its 200
    iterations, on the CPU): the server answers and the score falls."""
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.core import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    storage = ui.InMemoryStatsStorage()
    server = ui.UIServer(storage, port=0).start()
    try:
        conf = (NeuralNetConfiguration.builder()
                .seed(1).updater("adam").learning_rate(0.01)
                .activation("relu").weight_init("xavier").list()
                .layer(DenseLayer(n_out=32))
                .layer(OutputLayer(n_out=5))
                .set_input_type(inputs.feed_forward(20))
                .build())
        net = MultiLayerNetwork(conf, device="cpu").init()
        net.set_listeners(ui.StatsListener(storage, update_frequency=5))
        rng = np.random.RandomState(0)
        x = rng.randn(512, 20).astype(np.float32)
        y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 512)]
        scores = []
        for _ in range(20):
            net.fit(DataSet(x, y))
            scores.append(net.score())
        assert scores[-1] < scores[0]
        sids = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/train/sessions").read())
        assert len(sids) == 1
        assert storage.num_update_records(sids[0]) == 4
    finally:
        server.stop()
