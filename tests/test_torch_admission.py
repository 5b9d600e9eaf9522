"""The port's SLO admission (``serving/admission.py`` and the engine's
``SloShed`` path) against the JAX package's controller: the same latency
observations, arrivals and ``now=`` values give the same shed decisions
(bitwise: the observed p99 each shed reports), offenders, unfairness and
tenant snapshots; tenant labels normalize the same way; and the engine
sheds with its own counter, an ``SloShed`` payload and an ``slo_shed``
incident, as ``tests/test_serving.py`` checks for the JAX engine.
"""

import os

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.serving import admission as jadm
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.serving import (InferenceEngine, QueueFull,
                                              SloShed, admission)
from serving_pairs import dense_conf, pair

WAIT = 30.0


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("DL4J_TPU_FLIGHT_MIN_INTERVAL_S", "0")
    monitor.reset()
    jmonitor.reset()
    admission.reset_tenant_labels()
    jadm.reset_tenant_labels()
    yield
    monitor.reset()
    jmonitor.reset()
    admission.reset_tenant_labels()
    jadm.reset_tenant_labels()


TENANTS = {"gold": {"slo_p99_ms": 30.0, "share": 2.0},
           "free": {"share": 1.0}}


def _script(seed, n=3000):
    """A seeded overload: ``free`` bursts at ~4x the others' rate while
    latencies climb past the SLO, then everyone backs off and latencies
    recover.  Events are (kind, tenant, latency_ms, now)."""
    rng = np.random.RandomState(seed)
    events, now = [], 0.0
    for i in range(n):
        now += float(rng.exponential(0.004))
        phase = i / n
        tenant = rng.choice(["gold", "free", "free", "free", "public"]
                            if 0.2 < phase < 0.7 else
                            ["gold", "free", "public"])
        hot = 0.25 < phase < 0.65
        lat = float(rng.gamma(4.0, (18.0 if hot else 4.0)))
        events.append(("arrive", str(tenant), None, now))
        if rng.rand() < 0.8:
            events.append(("observe", str(tenant), lat, now + lat / 1e3))
    return events


def _drive(ctl, events, every=50):
    decisions, probes = [], []
    for i, (kind, tenant, lat, now) in enumerate(events):
        if kind == "arrive":
            decisions.append(ctl.should_shed(tenant, now=now))
        else:
            ctl.observe(lat, tenant=tenant, now=now)
        if i % every == 0:
            probes.append((ctl.offender(now=now), ctl.unfairness(now=now),
                           ctl.tenant_snapshot(now=now),
                           ctl.window_p99(now=now),
                           ctl.tenant_p99("gold", now=now),
                           ctl.tenant_slow_threshold_ms("free", now=now)))
    return decisions, probes


@pytest.mark.parametrize("fair,enforce,seed", [
    (True, True, 0), (True, True, 1), (False, True, 2), (True, False, 3)])
def test_decisions_equal_jax(fair, enforce, seed):
    kw = dict(window_s=1.0, min_samples=20, refresh_s=0.05,
              tenants=TENANTS, fair=fair, enforce=enforce)
    got = _drive(admission.SloAdmissionController(20.0, **kw),
                 _script(seed))
    want = _drive(jadm.SloAdmissionController(20.0, **kw), _script(seed))
    assert got == want
    sheds = sum(d is not None for d in got[0])
    assert (sheds > 0) == enforce
    assert any(unfair["breached"] for _, unfair, *_ in got[1])
    if fair and enforce:
        # the offender's excess goes first: free is shed more than gold
        snap_shed = {t: 0 for t in ("gold", "free")}
        for (kind, tenant, _, _), d in zip(
                [e for e in _script(seed) if e[0] == "arrive"], got[0]):
            if tenant in snap_shed and d is not None:
                snap_shed[tenant] += 1
        assert snap_shed["free"] > snap_shed["gold"]


def test_controller_sheds_and_self_heals_on_its_window():
    ctl = admission.SloAdmissionController(10.0, window_s=0.2,
                                           min_samples=5, refresh_s=0.0)
    assert ctl.should_shed(now=0.0) is None     # cold start: admit
    for i in range(20):
        ctl.observe(50.0, now=0.01 * i)
    assert ctl.should_shed(now=0.2) == 50.0
    assert ctl.snapshot()["window_samples"] >= 0
    assert ctl.should_shed(now=0.6) is None     # hot samples aged out
    with pytest.raises(ValueError):
        admission.SloAdmissionController(0.0)
    with pytest.raises(ValueError):
        ctl.configure_tenant("x", share=0.0)


def test_tenant_labels_normalize_like_jax(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_TENANT_MAX_LABELS", "3")
    ids = [None, "", "  ", "gold", "a", "b", "c", "d", "a", 7, " gold "]
    got = [admission.normalize_tenant(t, known=("gold",)) for t in ids]
    want = [jadm.normalize_tenant(t, known=("gold",)) for t in ids]
    assert got == want
    assert "other" in got and got[0] == admission.DEFAULT_TENANT


def test_engine_sheds_with_its_own_metric_payload_and_incident(tmp_path):
    _, pnet = pair(dense_conf(seed=3))
    rng = np.random.RandomState(11)
    with InferenceEngine(pnet, max_batch_size=4, max_latency_ms=1.0,
                         name="slo-eng", slo_p99_ms=0.0001) as eng:
        eng.warmup((4,))
        shed = None
        for _ in range(200):
            try:
                eng.predict(rng.randn(1, 4), timeout=WAIT, tenant="gold")
            except SloShed as e:
                shed = e
                break
        assert shed is not None, "engine never shed under impossible SLO"
        assert shed.slo_p99_ms == 0.0001 == eng.slo_p99_ms
        assert shed.observed_p99_ms > shed.slo_p99_ms
        assert shed.tenant == "gold"
        assert monitor.counter("serving_shed_total").value(
            engine="slo-eng") == 1
        assert monitor.counter("serving_tenant_shed_total").value(
            engine="slo-eng", tenant="gold") == 1
        admitted = monitor.counter("serving_tenant_admitted_total").value(
            engine="slo-eng", tenant="gold")
        assert monitor.counter("serving_tenant_requests_total").value(
            engine="slo-eng", tenant="gold") == admitted + 1
        with pytest.raises(SloShed):
            eng.predict_session("s", rng.randn(1, 4))
        stats = eng.stats()
        assert stats["admission"]["slo_p99_ms"] == 0.0001
        assert "gold" in stats["tenants"]
    bundles = os.listdir(tmp_path / "flight")
    assert any("_slo_shed_" in b for b in bundles)


def test_queue_full_carries_retry_after_and_an_incident(tmp_path):
    _, pnet = pair(dense_conf(seed=3))
    eng = InferenceEngine(pnet, max_batch_size=2, queue_capacity=2,
                          max_latency_ms=1000.0, name="retry")
    eng._running = True           # accept submits without starting threads
    try:
        x = np.zeros((1, 4))
        for _ in range(2):
            eng.predict_async(x, block=False)
        with pytest.raises(QueueFull) as e:
            eng.predict_async(x, block=False)
        assert 1.0 <= e.value.retry_after_s <= 60.0
        assert monitor.counter("serving_rejected_total").value(
            engine="retry") == 1
    finally:
        eng._running = False
    bundles = os.listdir(tmp_path / "flight")
    assert len(bundles) == 1 and "_queue_full_" in bundles[0]


def test_publish_tenant_telemetry_matches_jax():
    kw = dict(window_s=1.0, min_samples=5, refresh_s=0.0, tenants=TENANTS)
    p = admission.SloAdmissionController(20.0, **kw)
    j = jadm.SloAdmissionController(20.0, **kw)
    for ctl in (p, j):
        for i in range(40):
            ctl.should_shed("gold")
            ctl.observe(40.0 + i, tenant="gold")
    got = admission.publish_tenant_telemetry(p, "tel")
    want = jadm.publish_tenant_telemetry(j, "tel")
    drop = ("window_p50_ms", "window_p99_ms", "baseline_p99_ms",
            "inflation_x", "penalized")
    strip = {t: {k: v for k, v in row.items() if k not in drop}
             for t, row in got.items()}
    assert strip == {t: {k: v for k, v in row.items() if k not in drop}
                     for t, row in want.items()}
    for name in ("serving_tenant_shed_rate", "serving_tenant_unfairness"):
        assert monitor.snapshot()[name]["values"] == \
            jmonitor.snapshot()[name]["values"]
