"""The port's runtime analyzers (``deeplearning4j_tpu_torch/analyze``)
against the JAX package's ``tools/analyze``:

- the dispatch sanitizer: twins of ``tests/test_sanitizer.py``'s cases
  other than the donation audit (torch has no buffer donation), with the
  port's ``WatchedCall`` where the JAX tests use ``watched_jit``: each
  contract seeded with a real violation and caught, the off switch and
  strict mode;
- the lock graph: twins of the lockgraph unit tests of
  ``tests/test_analyze.py`` (a seeded A->B / B->A cycle between two
  threads, RLock reentry, nested names, the ``make_lock`` factory), long
  holds and blocked acquires, the four metric names in the port's
  registry, and the engine plus the TCP parameter server armed and
  acyclic;
- product wiring: the epoch-cache fit (a tail batch, and fused epochs)
  and a decode session across a cache-len bucket hop record the JAX
  package's dispatch count in every scenario occurrence, with the JAX
  units and extras, and stay inside their budgets;
- the default alert rules ``sanitizer_violation`` and ``lockgraph_cycle``
  fire on a seeded violation and a seeded cycle.

Every comparison is exact: counts, names and graph edges.
"""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JaxList
from deeplearning4j_tpu.serving import SessionCache as JaxSessionCache
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.analyze import lockgraph, sanitizer
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.monitor import alerts, locks
from deeplearning4j_tpu_torch.monitor.jit_watch import WatchedCall
from deeplearning4j_tpu_torch.serving import SessionCache
from serving_pairs import CONFS, dense_conf, lstm_conf, pair
from tools.analyze import sanitizer as jsanitizer


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_SANITIZE", "1")
    monkeypatch.delenv("DL4J_TPU_SANITIZE_STRICT", raising=False)
    monkeypatch.delenv("DL4J_TPU_SANITIZE_BUDGETS", raising=False)
    sanitizer.reset()
    jsanitizer.reset()
    monitor.reset()
    jmonitor.reset()
    yield
    sanitizer.reset()
    jsanitizer.reset()
    monitor.reset()
    jmonitor.reset()


def _kinds():
    return sorted(v["kind"] for v in sanitizer.violations())


def _x(n):
    return torch.ones((n,), dtype=torch.float32)


# ------------------------------------------------------------ unarmed

def test_unarmed_is_inert(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_SANITIZE", raising=False)
    sanitizer.reset()
    assert not sanitizer.enabled()
    assert isinstance(monitor.sanitize_scenario("x"),
                      contextlib.nullcontext)
    f = WatchedCall(lambda x: x * 2, name="san_off")
    f(_x(2))
    sanitizer.end_warmup()          # end_warmup alone never violates
    f(_x(3))                        # recompile, but nobody is watching
    assert sanitizer.violation_count() == 0


# --------------------------------------- seeded recompile after warmup

def test_recompile_after_warmup_is_caught(armed):
    f = WatchedCall(lambda x: x * 2, name="san_recompile")
    f(_x(2))
    monitor.sanitize_end_warmup()
    f(_x(2))                        # cache hit: fine
    assert sanitizer.violation_count() == 0
    f(_x(3))                        # seeded shape churn
    assert _kinds() == ["recompile_after_warmup"]
    assert sanitizer.violations()[0]["fn"] == "san_recompile"
    assert monitor.counter(sanitizer.RECOMPILES_TOTAL, "").value(
        fn="san_recompile") == 1
    assert monitor.counter(sanitizer.VIOLATIONS_TOTAL, "").value(
        kind="recompile_after_warmup") == 1


def test_recompile_before_end_warmup_is_free(armed):
    f = WatchedCall(lambda x: x + 1, name="san_warm")
    f(_x(2))
    f(_x(3))                        # warmup churn is expected
    assert sanitizer.violation_count() == 0


def test_a_build_inside_a_dispatch_after_warmup_is_caught(armed):
    """A site that brackets its work with ``jit_watch.dispatching`` (the
    epoch-cache fit, a session step) reports the builds made inside it:
    a further signature of a built function after warmup violates."""
    from deeplearning4j_tpu_torch.monitor import jit_watch
    with jit_watch.dispatching("t.step"):
        with jit_watch.compiling("t.step", "a"):
            pass
    monitor.sanitize_end_warmup()
    with jit_watch.dispatching("t.step"):
        with jit_watch.compiling("t.step", "b", recompile=True):
            pass
    assert _kinds() == ["recompile_after_warmup"]
    assert sanitizer.violations()[0]["fn"] == "t.step"


# ---------------------------------------- seeded over-budget dispatch

def test_dispatch_budget_exceeded_is_caught(armed, monkeypatch, tmp_path):
    budgets = tmp_path / "budgets.json"
    budgets.write_text(json.dumps(
        {"t.unit": {"max_dispatches_per_unit": 1}}))
    monkeypatch.setenv("DL4J_TPU_SANITIZE_BUDGETS", str(budgets))
    f = WatchedCall(lambda x: x * 2, name="san_budget")
    x = _x(2)

    with monitor.sanitize_scenario("t.unit"):
        f(x); f(x); f(x)            # first occurrence = warmup: free
    assert sanitizer.violation_count() == 0

    with monitor.sanitize_scenario("t.unit"):
        f(x)                        # within budget
    assert sanitizer.violation_count() == 0

    with monitor.sanitize_scenario("t.unit"):
        f(x); f(x)                  # seeded: fused path degraded
    assert _kinds() == ["dispatch_budget"]
    v = sanitizer.violations()[0]
    assert v["scenario"] == "t.unit"
    assert v["dispatches"] == 2 and v["ceiling"] == 1
    assert monitor.counter(sanitizer.BUDGET_EXCEEDED_TOTAL, "").value(
        scenario="t.unit") == 1


def test_units_and_extra_raise_the_ceiling(armed, monkeypatch, tmp_path):
    budgets = tmp_path / "budgets.json"
    budgets.write_text(json.dumps(
        {"t.fused": {"max_dispatches_per_unit": 1}}))
    monkeypatch.setenv("DL4J_TPU_SANITIZE_BUDGETS", str(budgets))
    f = WatchedCall(lambda x: x * 2, name="san_units")
    x = _x(2)
    with monitor.sanitize_scenario("t.fused", units=3, extra=1):
        f(x)                        # warmup occurrence
    with monitor.sanitize_scenario("t.fused", units=3, extra=1):
        for _ in range(4):          # 3 units + 1 tail: exactly at ceiling
            f(x)
    assert sanitizer.violation_count() == 0


def test_unbudgeted_scenario_never_violates(armed):
    f = WatchedCall(lambda x: x * 2, name="san_nobudget")
    x = _x(2)
    for _ in range(2):
        with monitor.sanitize_scenario("no.such.budget"):
            f(x); f(x); f(x)
    assert sanitizer.violation_count() == 0


def test_budgets_name_the_jax_scenarios():
    """The port's budgets.json keeps the JAX file's scenarios and
    ceilings."""
    assert {k: v["max_dispatches_per_unit"]
            for k, v in sanitizer.load_budgets().items()} == \
        {k: v["max_dispatches_per_unit"]
         for k, v in jsanitizer.load_budgets().items()}


# ------------------------------------------------------ strict mode

def test_strict_mode_raises_at_detection_site(armed, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_SANITIZE_STRICT", "1")
    f = WatchedCall(lambda x: x * 2, name="san_strict")
    f(_x(2))
    sanitizer.end_warmup()
    with pytest.raises(sanitizer.SanitizerViolation,
                       match="recompile_after_warmup"):
        f(_x(3))


# ----------------------------------------- product wiring: serving step

def test_serving_step_scenario_stays_within_budget(armed):
    """The real ``SessionCache.step`` path runs armed: one dispatch per
    RNN step, three steps past warmup, zero violations, and the scenario
    was genuinely entered (not vacuous)."""
    _, pnet = pair(lstm_conf(n_in=4))
    cache = SessionCache(pnet, name="san")
    rng = np.random.RandomState(0)
    for _ in range(3):
        cache.step("s1", rng.randn(2, 4))
    assert sanitizer.state()._seen_scenarios.get("serving.rnn_step",
                                                 0) == 3
    assert sanitizer.violation_count() == 0


# --------------------------------- dispatch counts equal the JAX package's

def _recorder(monkeypatch, mod):
    """Record ``(scenario, units, extra, dispatches)`` of every scenario
    occurrence the sanitizer module ``mod`` closes."""
    seen = []
    exit_ = mod.Sanitizer._exit

    def _exit(self, scen):
        seen.append((scen.name, scen.units, scen.extra, scen.dispatches))
        return exit_(self, scen)

    monkeypatch.setattr(mod.Sanitizer, "_exit", _exit)
    return seen


@pytest.mark.parametrize("n,epochs", [(70, 2), (64, 3)],
                         ids=["tail", "fused"])
def test_epoch_cache_fit_records_the_jax_dispatch_counts(armed, monkeypatch,
                                                         n, epochs):
    """70 rows at batch 16 (a tail batch: a group and its tail a
    scenario) and 64 rows (no tail, no listener: the epochs fuse into one
    group): the same scenarios, units, extras and dispatch counts."""
    seen = {"jax": _recorder(monkeypatch, jsanitizer),
            "port": _recorder(monkeypatch, sanitizer)}
    rng = np.random.RandomState(0)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    jnet, pnet = pair(dense_conf())
    for _ in range(2):      # the second fit's scenarios are enforced
        jnet.fit(JaxList(JaxDataSet(x, y), 16), epochs=epochs,
                 ingest="cache")
        pnet.fit(ListDataSetIterator(DataSet(x, y), 16), epochs=epochs,
                 ingest="cache")
    assert seen["port"] == seen["jax"]
    assert seen["port"] and all(s[0] == "fit.epoch_cache"
                                for s in seen["port"])
    assert sanitizer.violation_count() == 0


def test_decode_session_across_a_bucket_hop_records_the_jax_counts(
        armed, monkeypatch):
    """The attention net's session decodes 9 tokens one a step, hopping
    up the cache-len ladder (1, 2, 4, 8, 16) four times; after this warm
    session and ``sanitize_end_warmup`` a second session does the same:
    every step is one model step, a hop one growth more, in both
    packages."""
    seen = {"jax": _recorder(monkeypatch, jsanitizer),
            "port": _recorder(monkeypatch, sanitizer)}
    jnet, pnet = pair(CONFS["attention"](cache_len=32))
    x = np.random.RandomState(1).randn(2, 8).astype(np.float32)
    for cache, mon in ((JaxSessionCache(jnet, name="a"), jmonitor),
                       (SessionCache(pnet, name="a"), monitor)):
        for sid in ("warm", "s"):
            for _ in range(9):
                cache.step(sid, x)
            if sid == "warm":
                mon.sanitize_end_warmup()
    assert seen["port"] == seen["jax"]
    hops = [s for s in seen["port"] if s[2] == 1]
    assert len(hops) == 8 and all(s[3] == 2 for s in hops)
    assert all(s[:2] == ("serving.decode_step", 1) for s in seen["port"])
    assert sanitizer.violation_count() == 0
    assert jsanitizer.violation_count() == 0
    # all but the first occurrence enforced: 17 steps, 8 of them hops
    assert sanitizer.state().enforced() == {"serving.decode_step": {
        "occurrences": 17, "dispatches": 25, "ceilings": 25}}


# ------------------------------------------------------- lockgraph unit

@pytest.fixture
def clean_graph():
    lockgraph.reset()
    monitor.reset()
    yield lockgraph.graph()
    lockgraph.reset()
    monitor.reset()


def test_seeded_ab_ba_cycle_detected(clean_graph):
    A = lockgraph.instrumented_lock("t.A")
    B = lockgraph.instrumented_lock("t.B")

    def ab():
        with A:
            with B:
                pass

    def ba():
        with B:
            with A:
                pass

    t1 = threading.Thread(target=ab)
    t1.start(); t1.join()
    t2 = threading.Thread(target=ba)
    t2.start(); t2.join()

    g = clean_graph
    assert g.edges()[("t.A", "t.B")] == 1
    assert g.edges()[("t.B", "t.A")] == 1
    assert len(g.cycles()) == 1
    with pytest.raises(AssertionError, match="t.A"):
        g.assert_acyclic()
    # rotation-invariant dedup: re-running the same interleaving does
    # not report a second cycle
    t3 = threading.Thread(target=ab)
    t3.start(); t3.join()
    assert len(g.cycles()) == 1
    assert monitor.counter("lockgraph_cycles_total").value() == 1
    assert monitor.gauge("lockgraph_edges").value() == 2


def test_rlock_reentry_is_not_an_edge(clean_graph):
    R = lockgraph.instrumented_lock("t.R", rlock=True)
    with R:
        with R:
            pass
    assert clean_graph.edges() == {}
    clean_graph.assert_acyclic()


def test_nested_distinct_names_make_one_edge(clean_graph):
    A = lockgraph.instrumented_lock("t.A")
    B = lockgraph.instrumented_lock("t.B")
    for _ in range(3):
        with A:
            with B:
                pass
    assert clean_graph.edges() == {("t.A", "t.B"): 3}
    clean_graph.assert_acyclic()


def test_factory_is_plain_lock_when_disabled(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_LOCK_DEBUG", raising=False)
    lock = locks.make_lock("t.off")
    assert isinstance(lock, type(threading.Lock()))
    assert isinstance(locks.make_lock("t.off", rlock=True),
                      type(threading.RLock()))
    monkeypatch.setenv("DL4J_TPU_LOCK_DEBUG", "1")
    lock = locks.make_lock("t.on")
    assert isinstance(lock, lockgraph.InstrumentedLock)
    assert lock.name == "t.on"


def test_long_holds_and_blocked_acquires_are_counted(clean_graph,
                                                     monkeypatch):
    monkeypatch.setenv("DL4J_TPU_LOCK_HOLD_MS", "20")
    A = lockgraph.instrumented_lock("t.hold")
    B = lockgraph.instrumented_lock("t.contended")
    with A:
        time.sleep(0.05)            # a long hold of t.hold
    taken = threading.Event()

    def holder():
        with B:
            taken.set()
            time.sleep(0.08)

    t = threading.Thread(target=holder)
    t.start()
    taken.wait()
    with A:
        with B:                     # waits ~80 ms while holding t.hold
            pass
    t.join()
    holds = monitor.counter("lockgraph_long_holds_total")
    assert holds.value(lock="t.hold") >= 1
    assert holds.value(lock="t.contended") >= 1
    assert monitor.counter("lockgraph_blocked_acquires_total").value(
        lock="t.contended") == 1


def test_the_four_lockgraph_metric_names(clean_graph, monkeypatch):
    """The JAX names, in the port's registry (not the JAX package's)."""
    monkeypatch.setenv("DL4J_TPU_LOCK_HOLD_MS", "1")
    A = lockgraph.instrumented_lock("t.A")
    B = lockgraph.instrumented_lock("t.B")
    for first, second in ((A, B), (B, A)):
        with first:
            with second:
                time.sleep(0.005)
    stall = threading.Event()

    def holder():
        with B:
            stall.set()
            time.sleep(0.02)

    t = threading.Thread(target=holder)
    t.start()
    stall.wait()
    with A:
        with B:
            pass
    t.join()
    names = {"lockgraph_cycles_total", "lockgraph_edges",
             "lockgraph_long_holds_total",
             "lockgraph_blocked_acquires_total"}
    assert names <= set(monitor.snapshot())
    assert not names & set(jmonitor.snapshot())


def test_serving_plus_param_server_smoke_stays_acyclic(monkeypatch,
                                                       clean_graph):
    """The port's inference engine and TCP parameter server run together
    with every lock instrumented (armed before they are built); the
    observed graph has nested holds and no cycle."""
    monkeypatch.setenv("DL4J_TPU_LOCK_DEBUG", "1")
    from deeplearning4j_tpu_torch.scaleout.param_server import (
        ParameterServer, TcpParameterServer, TcpParameterServerClient)
    from deeplearning4j_tpu_torch.serving import InferenceEngine

    _, model = pair(dense_conf(n_in=4, hidden=8, n_out=3))
    server = TcpParameterServer(ParameterServer(np.zeros(64)))
    errors = []

    def worker(seed):
        try:
            client = TcpParameterServerClient(server.host, server.port)
            rng = np.random.RandomState(seed)
            for _ in range(5):
                client.push(rng.randn(64) * 1e-3)
                client.pull()
            client.close()
        except Exception as exc:          # pragma: no cover
            errors.append(exc)

    rng = np.random.RandomState(3)
    with InferenceEngine(model, max_batch_size=4,
                         max_latency_ms=1.0) as eng:
        eng.warmup((4,))

        def caller():
            try:
                for _ in range(5):
                    eng.predict(rng.randn(2, 4), timeout=60.0)
            except Exception as exc:      # pragma: no cover
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(s,))
                   for s in (1, 2)]
        threads += [threading.Thread(target=caller) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    server.close()

    assert errors == []
    g = clean_graph
    assert ("scaleout.tcp.dedup", "scaleout.server.chunk") in g.edges()
    g.assert_acyclic()


# ------------------------------------------------- the two alert rules

def _rule_state(engine, name):
    return next(r for r in engine.status()["rules"]
                if r["name"] == name)["state"]


def test_sanitizer_violation_rule_fires_on_a_seeded_recompile(armed):
    engine = alerts.AlertEngine(alerts.default_rules())
    engine.evaluate_once(now=1000.0)
    f = WatchedCall(lambda x: x * 2, name="san_alert")
    f(_x(2))
    monitor.sanitize_end_warmup()
    f(_x(5))                                  # a recompile after warmup
    assert monitor.counter(sanitizer.VIOLATIONS_TOTAL).value(
        kind="recompile_after_warmup") == 1
    assert _rule_state(engine, "sanitizer_violation") == "ok"
    engine.evaluate_once(now=1005.0)
    assert _rule_state(engine, "sanitizer_violation") == "firing"


def test_lockgraph_cycle_rule_fires_on_a_seeded_cycle(clean_graph):
    engine = alerts.AlertEngine(alerts.default_rules())
    engine.evaluate_once(now=1000.0)
    A = lockgraph.instrumented_lock("t.A")
    B = lockgraph.instrumented_lock("t.B")
    with A:
        with B:
            pass
    with B:
        with A:
            pass
    assert monitor.counter("lockgraph_cycles_total").value() == 1
    engine.evaluate_once(now=1005.0)
    assert _rule_state(engine, "lockgraph_cycle") == "firing"
