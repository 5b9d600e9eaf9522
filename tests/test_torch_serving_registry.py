"""The port's paging and ``ModelRegistry`` (``serving/registry.py`` and the
engine's paging primitives) against the JAX package's, the cases of
``tests/test_serving_registry.py``: lossless page-out and page-in with no
new bucket callable, LRU paging under a byte budget, pinned models,
unregister, a staged canary surviving a page-out, swap accounting, and
the concurrent page-in contracts.  The same requests and budgets give the
same eviction sequence in both packages (float32 nets: equal
``model_bytes``), and the answers agree within 1e-6.
"""

import threading

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.serving import InferenceEngine as JaxEngine
from deeplearning4j_tpu.serving import ModelRegistry as JaxRegistry
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                              ModelRegistry, UnknownModel)
from serving_pairs import compiles, dense_conf, pair

TOL = 1e-6
WAIT = 60.0
X = np.random.RandomState(3).randn(2, 4).astype(np.float32)


@pytest.fixture(autouse=True)
def _isolated():
    monitor.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    jmonitor.reset()


def _engines(seed, name=None, **kw):
    """The same dense net behind a JAX engine and a port engine."""
    jnet, pnet = pair(dense_conf(seed=seed, hidden=8))
    name = name or f"m{seed}"
    return (JaxEngine(jnet, max_batch_size=4, max_latency_ms=1.0,
                      name=name, **kw),
            InferenceEngine(pnet, max_batch_size=4, max_latency_ms=1.0,
                            name=name, **kw))


def _engine(seed, **kw):
    return _engines(seed, **kw)[1]


def _per_model():
    return _engine(99).model_bytes()


def _resident(reg):
    return {n: m["resident"] for n, m in reg.stats()["models"].items()}


def _counts(mon, name):
    vals = mon.snapshot().get(name, {}).get("values", {})
    return {k: v for k, v in sorted(vals.items())}


def test_model_bytes_equal_jax():
    je, pe = _engines(1)
    assert pe.model_bytes() == je.model_bytes() > 0


def test_page_out_and_back_is_lossless_and_makes_no_callable():
    with _engine(1, name="pager") as eng:
        eng.warmup((4,))
        ref = eng.predict(X, timeout=WAIT)
        assert eng.is_resident()
        c0 = compiles(monitor, "pager")
        assert eng.release_device_buffers() == eng.model_bytes()
        assert not eng.is_resident() and eng.resident_bytes() == 0
        np.testing.assert_array_equal(eng.predict(X, timeout=WAIT), ref)
        assert eng.is_resident()
        assert compiles(monitor, "pager") == c0


def test_registry_unknown_model_and_duplicate():
    reg = ModelRegistry()
    reg.register("a", _engine(1))
    try:
        with pytest.raises(UnknownModel):
            reg.get("nope")
        with pytest.raises(UnknownModel):
            reg.predict("nope", X)
        with pytest.raises(ValueError):
            reg.register("a", _engine(2))
        with pytest.raises(ValueError):
            ModelRegistry(hbm_budget_bytes=0)
    finally:
        reg.stop_all()


def test_lru_eviction_sequence_equals_jax():
    """3 models under a 2.5-model budget, then traffic in a fixed order:
    after every step the resident set, and at the end the eviction and
    page-in counters, equal the JAX registry's; answers agree."""
    per = _per_model()
    budget = 2 * per + per // 2
    regs = [JaxRegistry(hbm_budget_bytes=budget),
            ModelRegistry(hbm_budget_bytes=budget)]
    order = ["m1", "m2", "m3", "m1", "m3", "m2", "m2", "m1", "m3"]
    trail = [[], []]
    outs = [[], []]
    try:
        for s in (1, 2, 3):
            je, pe = _engines(s)
            regs[0].register(f"m{s}", je)
            regs[1].register(f"m{s}", pe)
            for i in range(2):
                trail[i].append(_resident(regs[i]))
        for name in order:
            for i in range(2):
                outs[i].append(np.asarray(regs[i].predict(
                    name, X, timeout=WAIT)))
                trail[i].append(_resident(regs[i]))
                assert regs[i].resident_bytes() <= budget
        assert trail[1] == trail[0]
        assert trail[1][2] == {"m1": False, "m2": True, "m3": True}
        for got, want in zip(outs[1], outs[0]):
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        for metric in ("serving_model_evictions_total",
                       "serving_model_pageins_total"):
            assert _counts(monitor, metric) == _counts(jmonitor, metric)
        assert sum(_counts(monitor, "serving_model_evictions_total")
                   .values()) >= 2
    finally:
        for reg in regs:
            reg.stop_all()


def test_pinned_model_survives_pressure():
    per = _per_model()
    reg = ModelRegistry(hbm_budget_bytes=per + per // 2)
    try:
        reg.register("pinned", _engine(1), pinned=True)
        reg.register("b", _engine(2))
        reg.register("c", _engine(3))
        st = reg.stats()["models"]
        assert st["pinned"]["resident"] and st["pinned"]["pinned"]
    finally:
        reg.stop_all()


def test_no_budget_keeps_everything_resident_and_unregister_releases():
    reg = ModelRegistry()
    try:
        engines = [reg.register(f"m{s}", _engine(s)) for s in (1, 2, 3)]
        assert all(_resident(reg).values())
        assert len(reg) == 3 and "m2" in reg and reg.names() == \
            ["m1", "m2", "m3"]
        reg.unregister("m2")
        assert not engines[1].is_resident() and "m2" not in reg
        assert monitor.gauge("serving_model_residency").value(
            model="m2") == 0
        with pytest.raises(UnknownModel):
            reg.unregister("m2")
    finally:
        reg.stop_all()


def test_staged_canary_counts_double_and_survives_a_page_out():
    per = _per_model()
    reg = ModelRegistry(hbm_budget_bytes=int(2.5 * per))
    try:
        a = reg.register("ma", _engine(41, name="ma"))
        _, donor = pair(dense_conf(seed=42, hidden=8))
        ref_active = reg.predict("ma", X, timeout=WAIT)
        cv = a.stage_weights(donor.params, net_state=donor.net_state)
        assert a.model_bytes() == 2 * per
        a.set_canary(cv, fraction=0.0)
        reg.register("mb", _engine(43, name="mb"))
        reg.register("mc", _engine(44, name="mc"))
        assert not _resident(reg)["ma"] and a.canary_version == cv
        c0 = compiles(monitor, "ma")
        np.testing.assert_allclose(
            reg.predict("ma", X, timeout=WAIT, version=cv),
            donor.output(X).numpy(), rtol=0, atol=TOL)
        assert compiles(monitor, "ma") == c0
        assert _resident(reg)["ma"]
        assert reg.resident_bytes() <= int(2.5 * per)
        np.testing.assert_array_equal(
            reg.predict("ma", X, timeout=WAIT, version=0), ref_active)
    finally:
        reg.stop_all()


def test_registry_swap_keeps_the_budget_accounting():
    reg = ModelRegistry()
    try:
        eng = reg.register("sw", _engine(51, name="sw"))
        _, donor = pair(dense_conf(seed=52, hidden=8))
        reg.predict("sw", X, timeout=WAIT)
        c0 = compiles(monitor, "sw")
        v = reg.swap_weights("sw", donor.params, net_state=donor.net_state)
        assert eng.active_version == v
        np.testing.assert_allclose(reg.predict("sw", X, timeout=WAIT),
                                   donor.output(X).numpy(), rtol=0,
                                   atol=TOL)
        assert compiles(monitor, "sw") == c0
        assert reg.stats()["models"]["sw"]["version"] == v
        assert eng.model_bytes() == eng.resident_bytes()
    finally:
        reg.stop_all()


def _race(n, target):
    gate = threading.Barrier(n)
    errs = []

    def run(i):
        try:
            gate.wait(10)
            target(i)
        except Exception as e:           # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "a thread hung"
    assert not errs, errs


def test_engine_concurrent_ensure_resident_single_copy():
    eng = _engine(91)
    try:
        per = eng.model_bytes()
        eng.ensure_resident()
        eng.release_device_buffers()
        _race(6, lambda i: eng.ensure_resident())
        assert eng.resident_bytes() == per
    finally:
        eng.stop()


def test_registry_concurrent_page_in_same_model_under_budget():
    per = _per_model()
    budget = 2 * per + per // 2
    reg = ModelRegistry(hbm_budget_bytes=budget)
    try:
        for s in (1, 2, 3):
            reg.register(f"m{s}", _engine(s))
        assert not _resident(reg)["m1"]

        def hit(i):
            for _ in range(5):
                reg.predict("m1", X, timeout=WAIT)
                assert reg.resident_bytes() <= budget

        _race(8, hit)
        assert reg.get("m1").resident_bytes() == per
        assert reg.resident_bytes() <= budget
    finally:
        reg.stop_all()


def test_registry_concurrent_pressure_never_evicts_pinned():
    per = _per_model()
    reg = ModelRegistry(hbm_budget_bytes=2 * per + per // 2)
    try:
        reg.register("keep", _engine(1, name="keep"), pinned=True)
        reg.register("b", _engine(2, name="b"))
        reg.register("c", _engine(3, name="c"))

        def churn(i):
            for _ in range(4):
                reg.predict("b" if i % 2 else "c", X, timeout=WAIT)

        _race(8, churn)
        assert _resident(reg)["keep"]
        assert not any("keep" in k for k in _counts(
            monitor, "serving_model_evictions_total"))
    finally:
        reg.stop_all()
