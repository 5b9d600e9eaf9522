"""The port's step-time attributor (``monitor/attribution.py``) against
the JAX package's: the same scripted registry updates give the same
per-interval records (components, per-step ms, EWMA, threshold, anomaly)
bitwise, the same ``train_step_anomalies_total{component}`` counts and
``slow_step`` bundles; ``breakdown`` of one snapshot is the same dict in
both; and the port's ``AlertEngine`` now builds and ticks an attributor by
default, so ``slow_step_anomalies`` fires as in the JAX package.
"""

import os

import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.monitor import attribution as jattribution
from deeplearning4j_tpu.monitor.alerts import AlertEngine as JaxAlertEngine
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import attribution
from deeplearning4j_tpu_torch.monitor.alerts import AlertEngine


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("DL4J_TPU_FLIGHT_MIN_INTERVAL_S", "0")
    monitor.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    jmonitor.reset()


#: per tick: (steps, ms a step of dispatch, data, listener, checkpoint,
#: compile); ticks 9 and 12 are slow (compile, then data dominated)
SCRIPT = [(4, 10.0, 2.0, 1.0, 0.0, 0.0)] * 8 + [
    (4, 10.0, 2.0, 1.0, 0.0, 120.0),
    (4, 10.5, 2.0, 1.0, 0.0, 0.0),
    (0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (4, 10.0, 60.0, 1.0, 30.0, 0.0),
    (4, 9.5, 2.0, 1.0, 0.0, 0.0),
    (2, 11.0, 2.5, 0.5, 0.0, 0.0),
]


def _feed(mon, row):
    steps, step_ms, data_ms, listener_ms, ckpt_ms, compile_ms = row
    reg = mon.registry()
    for _ in range(steps):
        reg.histogram("phase_step_ms").observe(step_ms)
        reg.histogram("phase_data_ms").observe(data_ms)
        reg.histogram("phase_listener_ms").observe(listener_ms)
    if ckpt_ms:
        reg.histogram("checkpoint_write_ms").observe(ckpt_ms)
    if compile_ms:
        reg.histogram("jit_compile_ms").observe(compile_ms, fn="mln.output")


def _run(mon, attr_mod):
    att = attr_mod.StepAttributor(k=4.0, alpha=0.3, warmup_ticks=5)
    records = [att.tick(now=1000.0)]
    for i, row in enumerate(SCRIPT):
        _feed(mon, row)
        rec = att.tick(now=1001.0 + i)
        if rec is not None:
            rec = dict(rec)
            bundle = rec.pop("bundle", None)
            rec["has_bundle"] = bundle is not None and os.path.isdir(bundle)
        records.append(rec)
    anomalies = mon.snapshot().get("train_step_anomalies_total",
                                   {}).get("values", {})
    return records, anomalies, att.anomalies


def test_attributor_records_bitwise_the_jax_attributor():
    got = _run(monitor, attribution)
    want = _run(jmonitor, jattribution)
    assert got == want
    records, anomalies, n = got
    assert n == 2
    assert anomalies == {'{component="compile"}': 1.0,
                         '{component="data"}': 1.0}
    slow = [r for r in records if r and r["anomaly"]]
    assert [r["dominant"] for r in slow] == ["compile", "data"]
    assert all(r["has_bundle"] for r in slow)
    assert records[11] is None                  # a tick with no step


def test_breakdown_of_one_snapshot_is_the_jax_breakdown():
    for row in SCRIPT[7:10]:
        _feed(jmonitor, row)
    since = jmonitor.snapshot()
    for row in SCRIPT[10:]:
        _feed(jmonitor, row)
    snap = jmonitor.snapshot()
    for args in ((None, snap), (since, snap)):
        assert attribution.breakdown(*args) == jattribution.breakdown(*args)
    assert set(attribution.COMPONENTS) == set(jattribution.COMPONENTS)


def test_alert_engine_ticks_an_attributor_by_default():
    """Both engines with their default rules: the attributor exists, and
    three slow intervals fire ``slow_step_anomalies`` in both."""
    engines = {"port": (monitor, AlertEngine(interval_s=1.0)),
               "jax": (jmonitor, JaxAlertEngine(interval_s=1.0))}
    assert isinstance(engines["port"][1].attributor,
                      attribution.StepAttributor)
    states = {}
    for side, (mon, eng) in engines.items():
        seq = []
        # the attributor ticks after the rules: the third anomaly is
        # seen by the pass after it
        rows = SCRIPT[:8] + [(4, 90.0, 2.0, 1.0, 0.0, 0.0)] * 3 + [
            SCRIPT[10]]
        eng.evaluate_once(now=2000.0)
        for i, row in enumerate(rows):
            _feed(mon, row)
            eng.evaluate_once(now=2001.0 + i)
            seq.append(eng.status()["rules"][[
                r["name"] for r in eng.status()["rules"]].index(
                    "slow_step_anomalies")]["state"])
        states[side] = (seq, eng.attributor.anomalies,
                        eng.attributor.last["ewma_ms"])
    assert states["port"] == states["jax"]
    assert states["port"][0][-1] == "firing"
    assert states["port"][1] == 3
