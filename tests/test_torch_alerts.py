"""The port's alert engine (``monitor/alerts.py``) against the JAX
package's: the same metric updates at the same ``now`` values give the
same rule transitions, values and reasons for every default rule kind
(threshold, increase, burn rate, absence) with their hysteresis; a rule
entering ``firing`` leaves an ``alert_<rule>`` bundle; the global engine's
``gating_alerts`` and ``status`` behave the same; and the rule sets are
the JAX package's.
"""

import os

import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.monitor import alerts as jalerts
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import alerts


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("DL4J_TPU_FLIGHT_MIN_INTERVAL_S", "0")
    monitor.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    jmonitor.reset()


T0 = 1_700_000_000.0


def _steps():
    """(now, [metric updates]) of a scripted incident and its recovery;
    an update is (kind, name, value, labels)."""
    return [
        (T0, []),
        (T0 + 5, [("gauge", "train_health_state", 1.0, {}),
                  ("counter", "serving_shed_total", 6.0,
                   {"engine": "e"}),
                  ("gauge", "serving_tenant_unfairness", 2.0,
                   {"engine": "e"}),
                  ("gauge", "train_health_last_dispatch_ts", T0 - 400.0,
                   {})]),
        (T0 + 10, [("hist", "serving_version_latency_ms", 120.0,
                    {"model": "m", "version": "1"})] * 30
         + [("hist", "serving_tenant_latency_ms", 80.0,
             {"model": "m", "tenant": "free"})] * 25),
        (T0 + 15, [("counter", "serving_rejected_total", 5.0,
                    {"engine": "e"}),
                   ("counter", "checkpoint_corrupt_skipped_total", 1.0,
                    {})]),
        (T0 + 20, [("gauge", "train_health_state", 0.0, {}),
                   ("gauge", "serving_tenant_unfairness", 0.0,
                    {"engine": "e"}),
                   ("gauge", "train_health_last_dispatch_ts", T0 + 19.0,
                    {})]),
        (T0 + 90, [("hist", "serving_version_latency_ms", 2.0,
                    {"model": "m", "version": "1"})] * 200),
        (T0 + 400, []),
        (T0 + 700, []),
        (T0 + 1400, []),
    ]


def _apply(mon, updates):
    for kind, name, value, labels in updates:
        if kind == "gauge":
            mon.gauge(name, "").set(value, **labels)
        elif kind == "counter":
            mon.counter(name, "").inc(value, **labels)
        else:
            mon.histogram(name, "").observe(value, **labels)


def _run(mon, engine):
    trail = []
    for now, updates in _steps():
        _apply(mon, updates)
        trail.append([(r["name"], r["state"], r["value"], r["reason"],
                       r["breach_streak"], r["transitions"])
                      for r in engine.evaluate_once(now=now)])
    return trail


def test_transitions_equal_jax():
    got = _run(monitor, alerts.AlertEngine(interval_s=60.0))
    want = _run(jmonitor, jalerts.AlertEngine(interval_s=60.0))
    assert got == want
    fired = {name for step in got for name, state, *_ in step
             if state == "firing"}
    assert {"train_divergence", "serving_shed_storm", "tenant_unfairness",
            "serving_slo_burn", "tenant_slo_burn",
            "serving_queue_saturation", "checkpoint_corruption",
            "train_dispatch_stall"} <= fired
    # the three rules whose series the port does not emit stay quiet
    quiet = {"sanitizer_violation", "lockgraph_cycle",
             "slow_step_anomalies"}
    assert not fired & quiet
    final = {name: state for name, state, *_ in got[-1]}
    assert final["train_divergence"] == final["serving_shed_storm"] == \
        final["tenant_unfairness"] == final["serving_slo_burn"] == "ok"


def test_firing_leaves_a_bundle_and_counts_transitions(tmp_path):
    eng = alerts.AlertEngine(rules=[alerts.Rule(
        "hot", "threshold", "temp", op=">", threshold=1.0,
        for_intervals=2, clear_intervals=1, gate_deploy=True)],
        interval_s=60.0)
    monitor.gauge("temp").set(5.0)
    assert eng.evaluate_once(now=T0)[0]["state"] == "pending"
    st = eng.evaluate_once(now=T0 + 1)[0]
    assert st["state"] == "firing" and os.path.isdir(st["bundle"])
    assert "_alert_hot_" in st["bundle"]
    assert eng.firing() == eng.firing(gate_only=True) == ["hot"]
    monitor.gauge("temp").set(0.0)
    assert eng.evaluate_once(now=T0 + 2)[0]["state"] == "ok"
    assert monitor.counter(alerts.TRANSITIONS_TOTAL).value(
        rule="hot", state="firing") == 1
    assert monitor.gauge(alerts.FIRING_GAUGE).value(rule="hot") == 0


def test_global_engine_gates_like_jax():
    assert alerts.gating_alerts() == [] and alerts.get_engine() is None
    assert alerts.status() == jalerts.status()
    eng = alerts.engine(interval_s=60.0)
    assert alerts.engine() is eng
    monitor.gauge("train_health_state").set(1.0)
    eng.evaluate_once(now=T0)
    assert alerts.gating_alerts() == ["train_divergence"]
    assert alerts.status()["firing"] == ["train_divergence"]
    eng.start()
    assert eng.running
    alerts.reset()
    assert not eng.running and alerts.get_engine() is None


def test_rule_sets_and_specs_equal_jax():
    for mine, theirs in ((alerts.default_rules(), jalerts.default_rules()),
                         (alerts.fleet_rules(), jalerts.fleet_rules())):
        assert [r.spec() for r in mine] == [r.spec() for r in theirs]
    with pytest.raises(ValueError):
        alerts.Rule("x", "nope", "m")
    with pytest.raises(ValueError):
        alerts.AlertEngine(rules=[alerts.Rule("a", "threshold", "m"),
                                  alerts.Rule("a", "threshold", "m")])
