"""The port's flight recorder (``monitor/flight_recorder.py``) against the
JAX package's: a bundle has the same file set and the same keys, the
per-kind rate limit and the pruning to ``DL4J_TPU_FLIGHT_KEEP`` behave
the same, ``DL4J_TPU_FLIGHT_DISABLE`` turns it off, and the incidents the
port now wires leave their bundles on disk: ``divergence`` from the
health guard and ``checkpoint_corrupt`` from checkpoint verification
(``queue_full`` and ``slo_shed`` are in ``test_torch_admission.py``,
``rollout_rollback`` in ``test_torch_deploy.py``).
"""

import json
import os

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.monitor import flight_recorder as jflight
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.monitor import flight_recorder, health
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.checkpoint import (
    CheckpointCorruptError, CheckpointManager, verify_checkpoint)
from serving_pairs import dense_conf, pair

FILES = ["health.json", "meta.json", "metrics.json", "spans.json"]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_FLIGHT_DISABLE", raising=False)
    monitor.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    jmonitor.reset()


def _bundles(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def _load(bundle):
    return {f: json.load(open(os.path.join(bundle, f))) for f in FILES}


def test_bundle_layout_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_MIN_INTERVAL_S", "0")
    for mod, mon, sub in ((flight_recorder, monitor, "port"),
                          (jflight, jmonitor, "jax")):
        monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / sub))
        mon.counter("c_total", "c").inc(3, engine="e")
        with mon.span("outer", rows=2):
            path = mod.record_incident("queue_full", {"engine": "e"},
                                       config={"k": 1})
        assert path is not None and mod.incident_dir() == str(
            tmp_path / sub)
    port = _load(os.path.join(tmp_path / "port",
                              _bundles(tmp_path / "port")[0]))
    ref = _load(os.path.join(tmp_path / "jax",
                             _bundles(tmp_path / "jax")[0]))
    assert sorted(os.listdir(os.path.dirname(
        os.path.join(tmp_path / "port", _bundles(tmp_path / "port")[0],
                     "x")))) == FILES
    assert sorted(port["meta.json"]) == sorted(ref["meta.json"])
    for key in ("kind", "detail", "config"):
        assert port["meta.json"][key] == ref["meta.json"][key]
    assert port["meta.json"]["trace_id"] is not None
    assert sorted(port["spans.json"]) == ["active", "complete"]
    assert [s["name"] for s in port["spans.json"]["active"]] == \
        [s["name"] for s in ref["spans.json"]["active"]] == ["outer"]
    assert sorted(port["spans.json"]["active"][0]) == \
        sorted(ref["spans.json"]["active"][0])
    assert port["metrics.json"]["c_total"]["values"] == \
        ref["metrics.json"]["c_total"]["values"]
    assert sorted(port["health.json"]) == sorted(ref["health.json"])
    assert monitor.counter("flight_recorder_incidents_total").value(
        kind="queue_full") == 1


def test_rate_limit_pruning_and_disable_behave_like_jax(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_KEEP", "3")
    monkeypatch.setenv("DL4J_TPU_FLIGHT_MIN_INTERVAL_S", "3600")
    trails = []
    for mod, sub in ((flight_recorder, "port"), (jflight, "jax")):
        monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / sub))
        mod.reset_rate_limit()
        got = [mod.record_incident(k) is not None
               for k in ("a", "a", "b", "c", "d", "b")]
        kinds = [n.split("_", 1)[1].rsplit("_", 1)[0]
                 for n in _bundles(tmp_path / sub)]
        trails.append((got, kinds))
    assert trails[0] == trails[1]
    assert trails[0][0] == [True, False, True, True, True, False]
    assert len(trails[0][1]) == 3 and "a" not in trails[0][1]
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DISABLE", "1")
    flight_recorder.reset_rate_limit()
    assert flight_recorder.record_incident("e") is None


def test_the_recorder_never_raises(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(blocker))
    monkeypatch.setenv("DL4J_TPU_FLIGHT_MIN_INTERVAL_S", "0")
    assert flight_recorder.record_incident("x", {"y": object()}) is None


def test_divergence_leaves_a_bundle(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path))
    health.enable("abort")
    _, net = pair(dense_conf(seed=3))
    x = np.full((32, 4), np.nan, np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(32) % 3]
    with pytest.raises(health.TrainingDivergedError) as err:
        net.fit(ListDataSetIterator(DataSet(x, y), 16))
    (name,) = _bundles(tmp_path)
    assert "_divergence_" in name
    meta = _load(os.path.join(tmp_path, name))["meta.json"]
    assert meta["detail"]["step"] == err.value.step
    assert meta["detail"]["layer"] == err.value.layer
    assert meta["detail"]["policy"] == "abort"
    assert _load(os.path.join(tmp_path, name))["health.json"]["state"] \
        == "diverged"


def test_checkpoint_corruption_leaves_a_bundle(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    _, net = pair(dense_conf(seed=3))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_write=False)
    path = mgr.save(net)
    verify_checkpoint(path)
    assert _bundles(tmp_path / "flight") == []
    faults.corrupt_file(path)
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(path)
    (name,) = _bundles(tmp_path / "flight")
    assert "_checkpoint_corrupt_" in name
    meta = _load(os.path.join(tmp_path / "flight", name))["meta.json"]
    assert meta["detail"]["path"] == path
