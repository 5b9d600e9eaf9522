"""The port's deployment control plane (``deploy/``) against the JAX
package's, the cases of ``tests/test_deploy.py``: the versioned weight
store's round trip, monotonic versions, pruning and stamp (not filename)
ordering; zips that cross between the packages in both directions with
``flat.bin`` and its manifest digest byte for byte; corruption raised
before any engine change; ``tree_from_flat`` giving the JAX package's
leaves; ``DeploymentListener``'s cadence; ``ParamServerPoller`` over a
fake client; and the rollout controller's state machine (push, probe,
promote, rollback with its bundle and quarantine, a gating alert blocking
a promote).
"""

import io
import json
import os
import shutil
import zipfile

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.deploy import VersionedWeightStore as JaxStore
from deeplearning4j_tpu.deploy import tree_from_flat as jax_tree_from_flat
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.deploy import (DeploymentListener,
                                             ParamServerPoller,
                                             RolloutController,
                                             RolloutError,
                                             VersionedWeightStore,
                                             WeightStoreCorruptError,
                                             tree_from_flat)
from deeplearning4j_tpu_torch.serving import InferenceEngine, ModelRegistry
from serving_pairs import CONFS, dense_conf, host, pair

WAIT = 60.0


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("DL4J_TPU_FLIGHT_MIN_INTERVAL_S", "0")
    monitor.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    jmonitor.reset()


def _corrupt_entry(path, name="flat.bin"):
    """Rewrite one entry's bytes under the (now stale) manifest."""
    with zipfile.ZipFile(path) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    data = bytearray(entries[name])
    data[len(data) // 2] ^= 0xFF
    entries[name] = bytes(data)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for n, b in entries.items():
            zf.writestr(n, b)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def _zip_path(d, v):
    return os.path.join(str(d), "weights-v%010d.zip" % v)


# ---- VersionedWeightStore --------------------------------------------------

def test_store_round_trip_versions_and_pruning(tmp_path):
    store = VersionedWeightStore(str(tmp_path), keep_last=3)
    assert store.latest() is None
    flat = np.arange(24, dtype=np.float32)
    assert store.publish(flat, step=5, source="test", meta={"k": "v"}) == 1
    snap = store.load(1)
    np.testing.assert_array_equal(snap.flat, flat)
    assert (snap.step, snap.source, snap.meta) == (5, "test", {"k": "v"})
    assert store.verify(1)
    assert store.publish(flat, version=7) == 7
    for bad in (7, 3):
        with pytest.raises(ValueError):
            store.publish(flat, version=bad)
    store.publish(flat)
    store.publish(flat)
    assert store.versions() == [7, 8, 9]
    with pytest.raises(KeyError):
        store.load(1)
    with pytest.raises(ValueError):
        VersionedWeightStore(str(tmp_path), keep_last=0)


def test_store_orders_by_stamp_not_filename(tmp_path):
    store = VersionedWeightStore(str(tmp_path))
    store.publish(np.full(4, 1.0, np.float32))
    store.publish(np.full(4, 2.0, np.float32))
    shutil.copy(_zip_path(tmp_path, 1), _zip_path(tmp_path, 9))
    assert store.latest() == 2
    assert store.load(store.latest()).flat[0] == 2.0


def test_store_detects_corruption(tmp_path):
    store = VersionedWeightStore(str(tmp_path))
    v = store.publish(np.arange(16, dtype=np.float32))
    _corrupt_entry(_zip_path(tmp_path, v))
    assert not store.verify(v)
    with pytest.raises(WeightStoreCorruptError):
        store.load(v)
    with open(_zip_path(tmp_path, 2), "wb") as f:
        f.write(b"not a zip")
    with pytest.raises(WeightStoreCorruptError):
        store.load(2)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_zips_cross_between_the_packages(tmp_path, writer):
    jnet, pnet = pair(dense_conf(seed=3))
    flat = pnet.get_flat_params()
    np.testing.assert_array_equal(flat, np.asarray(jnet.get_flat_params()))
    stores = {"port": VersionedWeightStore(str(tmp_path / "p")),
              "jax": JaxStore(str(tmp_path / "j"))}
    nets = {"port": pnet, "jax": jnet}
    for name, store in stores.items():
        store.publish_model(nets[name], version=4)
    reader = "jax" if writer == "port" else "port"
    os.makedirs(tmp_path / "x")
    shutil.copy(_zip_path(tmp_path / writer[0], 4),
                _zip_path(tmp_path / "x", 4))
    cls = JaxStore if reader == "jax" else VersionedWeightStore
    snap = cls(str(tmp_path / "x")).load(4)
    np.testing.assert_array_equal(snap.flat, flat)

    def entries(path):
        with zipfile.ZipFile(path) as zf:
            return {n: zf.read(n) for n in zf.namelist()}

    mine, theirs = (entries(_zip_path(tmp_path / d, 4)) for d in "pj")
    assert mine["flat.bin"] == theirs["flat.bin"]
    m1, m2 = (json.loads(e["manifest.json"]) for e in (mine, theirs))
    assert m1["entries"]["flat.bin"] == m2["entries"]["flat.bin"]
    assert {k: v for k, v in m1.items() if k != "entries"} == \
        {k: v for k, v in m2.items() if k != "entries"}
    v1, v2 = (json.loads(e["version.json"]) for e in (mine, theirs))
    assert {k: v for k, v in v1.items() if k != "wall_time"} == \
        {k: v for k, v in v2.items() if k != "wall_time"}


@pytest.mark.parametrize("kind", sorted(CONFS))
def test_tree_from_flat_gives_the_jax_leaves(kind):
    jnet, pnet = pair(CONFS[kind]())
    flat = np.random.RandomState(1).randn(
        pnet.num_params()).astype(np.float32)
    before = pnet.get_flat_params()
    tree = tree_from_flat(pnet, flat)
    want = jax_tree_from_flat(jnet, flat)
    got_leaves = jax.tree.leaves(host(tree))
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(pnet.get_flat_params(), before)
    with pytest.raises(ValueError):
        tree_from_flat(pnet, flat[:-1])
    with pytest.raises(ValueError):
        tree_from_flat(pnet, np.zeros(flat.size + 1, np.float32))


def test_tree_from_flat_of_a_graph_equals_jax():
    from test_torch_computation_graph import _all_vertex_conf, _pair
    jnet, pnet = _pair(_all_vertex_conf())
    flat = np.random.RandomState(2).randn(
        pnet.num_params()).astype(np.float32)
    got = host(tree_from_flat(pnet, flat))
    want = jax_tree_from_flat(jnet, flat)
    assert sorted(got) == sorted(want)
    for name in want:
        assert sorted(got[name]) == sorted(want[name])
        for p in want[name]:
            np.testing.assert_array_equal(
                got[name][p], np.asarray(want[name][p], got[name][p].dtype))


# ---- publishers ------------------------------------------------------------

def test_deployment_listener_cadence(tmp_path):
    store = VersionedWeightStore(str(tmp_path))
    _, net = pair(dense_conf(seed=5))
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, size=64)]
    listener = DeploymentListener(store, every_n_iterations=2)
    net.set_listeners(listener)
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    net.fit(ListDataSetIterator(DataSet(x, y), 16), epochs=2,
            ingest="batch")
    # 8 iterations: 4 on the cadence, and one at each epoch end
    sources = [store.load(v).source for v in store.versions()]
    assert store.versions() == listener.published
    assert sources.count("fit") == 4 and sources.count("fit_epoch") == 2
    snap = store.load(store.latest())
    np.testing.assert_array_equal(snap.flat, net.get_flat_params())
    assert snap.step == net.iteration == 8


class _FakeClient:
    def __init__(self):
        self.v, self.pulls = 0, 0

    def version(self):
        return self.v

    def pull(self):
        self.pulls += 1
        return np.full(6, float(self.v), np.float64)

    def pull_coded(self):
        self.pulls += 1
        return np.full(6, -float(self.v), np.float32)


@pytest.mark.parametrize("coded", [False, True])
def test_param_server_poller_publishes_on_advance(tmp_path, coded):
    client = _FakeClient()
    store = VersionedWeightStore(str(tmp_path))
    poller = ParamServerPoller(client, store, prefer_coded=coded)
    assert poller.poll_once() == 1        # first probe always publishes
    assert poller.poll_once() is None and client.pulls == 1
    client.v = 3
    v = poller.poll_once()
    snap = store.load(v)
    assert snap.step == 3 and snap.meta == {"server_version": 3}
    np.testing.assert_array_equal(snap.flat, np.full(
        6, -3.0 if coded else 3.0, np.float32))
    poller.interval_s = 0.01
    assert poller.start() is poller
    poller.stop()


# ---- RolloutController -----------------------------------------------------

def _registry_with(net, name="m"):
    reg = ModelRegistry()
    reg.register(name, InferenceEngine(net, max_batch_size=16,
                                       max_latency_ms=0.5, name=name),
                 warmup_shape=(4,))
    return reg


def _eval_set(net, n=32, seed=0):
    x = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    y = net.output(x).numpy()
    return x, np.eye(y.shape[1], dtype=np.float32)[np.argmax(y, -1)]


def test_rollout_push_probe_promote(tmp_path):
    _, net = pair(dense_conf(seed=1))
    reg = _registry_with(net)
    try:
        store = VersionedWeightStore(str(tmp_path / "s"))
        store.publish(net.get_flat_params())
        xe, ye = _eval_set(net)
        ctl = RolloutController(reg, "m", store, eval_features=xe,
                                eval_labels=ye, min_probe_rounds=2)
        assert ctl.step() == "push" and ctl.state == "canary"
        with pytest.raises(RolloutError):
            ctl.push()
        assert ctl.step() == "probe"
        assert ctl.step() == "promote" and ctl.state == "idle"
        assert reg.get("m").active_version == 1
        assert ctl.step() == "noop"
        assert [h["action"] for h in ctl.status()["history"]] == \
            ["push", "promote"]
        assert monitor.counter("deploy_promotions_total").value(
            model="m") == 1
    finally:
        reg.stop_all()


def test_rollout_bad_update_rolls_back_with_a_bundle(tmp_path):
    _, net = pair(dense_conf(seed=1))
    reg = _registry_with(net)
    try:
        store = VersionedWeightStore(str(tmp_path / "s"))
        n = net.num_params()
        bad = store.publish(np.random.RandomState(9).randn(n).astype(
            np.float32) * 100.0, source="bad")
        xe, ye = _eval_set(net)
        ctl = RolloutController(reg, "m", store, eval_features=xe,
                                eval_labels=ye, min_probe_rounds=1)
        assert ctl.step() == "push"
        verdict = ctl.evaluate()
        assert not verdict["pass"] and verdict["canary_acc"] < 0.9
        assert ctl.step() == "rollback"
        assert reg.get("m").active_version == 0 and bad in ctl.quarantined
        assert ctl.last_bundle and os.path.isdir(ctl.last_bundle)
        assert "_rollout_rollback_" in ctl.last_bundle
        assert ctl.step() == "noop"
        with pytest.raises(RolloutError):
            ctl.push(bad)
    finally:
        reg.stop_all()


def test_rollout_refuses_a_corrupt_snapshot_before_any_change(tmp_path):
    _, net = pair(dense_conf(seed=1))
    reg = _registry_with(net)
    try:
        store = VersionedWeightStore(str(tmp_path / "s"))
        v = store.publish(net.get_flat_params())
        _corrupt_entry(_zip_path(tmp_path / "s", v))
        ctl = RolloutController(reg, "m", store)
        with pytest.raises(WeightStoreCorruptError):
            ctl.push(v)
        eng = reg.get("m")
        assert ctl.state == "idle" and eng.versions() == [0]
        assert (eng.active_version, eng.canary_version) == (0, None)
    finally:
        reg.stop_all()


def test_a_gating_alert_blocks_the_promote(tmp_path):
    _, net = pair(dense_conf(seed=1))
    reg = _registry_with(net)
    try:
        store = VersionedWeightStore(str(tmp_path / "s"))
        store.publish(net.get_flat_params())
        xe, ye = _eval_set(net)
        ctl = RolloutController(reg, "m", store, eval_features=xe,
                                eval_labels=ye, min_probe_rounds=1)
        monitor.gauge("train_health_state").set(1.0)
        monitor.alerts.engine(interval_s=60.0).evaluate_once()
        assert ctl.step() == "push"
        verdict = ctl.evaluate()
        assert not verdict["pass"]
        assert verdict["alerts_firing"] == ["train_divergence"]
        assert ctl.step() == "rollback"
        assert reg.get("m").active_version == 0
    finally:
        reg.stop_all()
