"""The port's serving fleet (``serving/fleet.py``, ``compile_cache.py``,
``deploy/rollout.py`` ``FleetCanary``) against the JAX package's, the
cases of ``tests/test_fleet.py``: the hash ring's failover order bitwise,
minimal remap and return home, the router's pick sequence and
``handle_predict`` failover over scripted fake workers, the build-cache
namespace, ``build_fleet_conf``'s JSON, the canary's actions on a
scripted trace; and one live CPU fleet of two ``lstm-small`` worker
processes warmed from a store the JAX package published (affinity, an
ill-shaped session step answered 400 with every worker still healthy, a
SIGKILL failed over with no 5xx, the victim back at its rank, answers
equal to the JAX engine's within 1e-5: float32 LSTM sums in another
order, each cleanly stopped worker's exit line).
"""

import json
import os
import signal
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.deploy import FleetCanary as JaxCanary
from deeplearning4j_tpu.deploy.store import VersionedWeightStore as JaxStore
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.serving import fleet as jfleet
from deeplearning4j_tpu.serving.engine import InferenceEngine as JaxEngine
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.deploy import FleetCanary
from deeplearning4j_tpu_torch.ops import kernel_build
from deeplearning4j_tpu_torch.ops.attention import LAUNCHES
from deeplearning4j_tpu_torch.serving import compile_cache
from deeplearning4j_tpu_torch.serving import fleet
from deeplearning4j_tpu_torch.serving.bucketing import BucketPolicy

#: bound on every wait of the live fleet
WAIT = 60.0


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monitor.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    jmonitor.reset()


def _rings(nodes, vnodes=64):
    rings = (fleet.HashRing(vnodes=vnodes), jfleet.HashRing(vnodes=vnodes))
    for ring in rings:
        for n in nodes:
            ring.add(n)
    return rings


# ---- hash ring -------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_ring_preference_bitwise_the_jax_ring(k):
    ring, jring = _rings([f"w{i}" for i in range(k)])
    keys = [f"conv-{i}" for i in range(2000)]
    assert [ring.preference(s) for s in keys] == \
        [jring.preference(s) for s in keys]
    assert ring._keys == jring._keys
    assert [ring.lookup(s, skip=("w0",)) for s in keys] == \
        [jring.lookup(s, skip=("w0",)) for s in keys]


def test_ring_minimal_remap_and_return_home():
    ring, jring = _rings(["w0", "w1", "w2"])
    keys = [f"conv-{i}" for i in range(1000)]
    before = {s: ring.lookup(s) for s in keys}
    for r in (ring, jring):
        r.remove("w1")
    after = {s: ring.lookup(s) for s in keys}
    assert after == {s: jring.lookup(s) for s in keys}
    assert all(after[s] == before[s] for s in keys if before[s] != "w1")
    assert sum(before[s] == "w1" for s in keys) > 0
    for r in (ring, jring):
        r.add("w1")
    assert {s: ring.lookup(s) for s in keys} == before


# ---- router over fake workers -----------------------------------------------

class _FakeWorker:
    def __init__(self, rank):
        self.rank = rank
        self.name = f"w{rank}"
        self.healthy = True
        self.route_fraction = 1.0
        self.served = 0
        self.fail_streak = 0
        self.generation = 0

    def view(self):
        return {"name": self.name, "healthy": self.healthy}


def _with_fakes(router, n):
    for rank in range(n):
        h = _FakeWorker(rank)
        router._workers[h.name] = h
        router._ring.add(h.name)
    return router


def _routers(n=3):
    return (_with_fakes(fleet.FleetRouter(k=n, model="mlp", device="cpu"), n),
            _with_fakes(jfleet.FleetRouter(k=n, model="mlp"), n))


def _scripted_picks(router):
    """1,000 picks: sessions and sessionless traffic, route fractions,
    a worker down and back, a ring member removed, tried lists."""
    out = []
    for i in range(1000):
        if i == 150:
            router.set_route_fraction("w1", 0.25)
        elif i == 300:
            router._workers["w2"].healthy = False
        elif i == 450:
            router.set_route_fraction("w0", 0.0)
        elif i == 600:
            router._workers["w2"].healthy = True
        elif i == 750:
            router._ring.remove("w1")
        elif i == 900:
            router._ring.add("w1")
            router.set_route_fraction("w0", 0.6)
        session = f"s{i % 17}" if i % 3 == 0 else None
        tried = ("w0",) if i % 11 == 0 else ()
        h = router.pick(session, tried)
        out.append(None if h is None else h.name)
    return out


def test_pick_sequence_equals_the_jax_router():
    router, jrouter = _routers()
    picks = _scripted_picks(router)
    assert picks == _scripted_picks(jrouter)
    assert {"w0", "w1", "w2"} <= set(picks)


def _scripted_forward(script):
    calls = []

    def forward(worker, payload):
        calls.append(worker.name)
        return script[min(len(calls), len(script)) - 1]
    return forward, calls


@pytest.mark.parametrize("case", ["failover", "passthrough", "exhausted"])
def test_handle_predict_failover_equals_the_jax_router(case):
    script = {
        "failover": [(None, None, {}), (200, {"ok": True}, {})],
        "passthrough": [(429, {"error": "full"}, {"Retry-After": "2"})],
        "exhausted": [(None, None, {})],
    }[case]
    payload = {"session": "conv-1", "features": [[0.0]]}
    results = []
    for router in _routers():
        router._forward, calls = _scripted_forward(script)
        code, body, headers = router.handle_predict(payload)
        results.append((code, body, headers, calls,
                        sorted(n for n, h in router._workers.items()
                               if not h.healthy)))
    assert results[0] == results[1]
    code, body, headers, calls, down = results[0]
    if case == "failover":
        assert code == 200 and len(calls) == 2 and down == [calls[0]]
    elif case == "passthrough":
        assert code == 429 and headers == {"Retry-After": "2"}
    else:
        assert code == 503 and sorted(body["tried"]) == ["w0", "w1", "w2"]
        assert "Retry-After" in headers


def test_route_fraction_unknown_worker_raises_keyerror():
    router, _ = _routers(2)
    with pytest.raises(KeyError):
        router.set_route_fraction("nope", 0.5)


# ---- build cache ------------------------------------------------------------

def test_signature_deterministic_and_policy_sensitive():
    conf, kw, _ = fleet.build_fleet_conf("mlp")
    pol = BucketPolicy(kw["max_batch_size"], kw["timestep_buckets"])
    wide = BucketPolicy(kw["max_batch_size"] * 2, kw["timestep_buckets"])
    sig = compile_cache.signature(conf, pol, "cpu")
    assert sig == compile_cache.signature(fleet.build_fleet_conf("mlp")[0],
                                          pol, "cpu")
    assert len(sig) == 16 and sig != compile_cache.signature(conf, wide,
                                                             "cpu")
    other, okw, _ = fleet.build_fleet_conf("lstm-small")
    assert sig != compile_cache.signature(
        other, BucketPolicy(okw["max_batch_size"], okw["timestep_buckets"]),
        "cpu")
    assert compile_cache.device_kind("cpu") == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            compile_cache.signature(conf, pol)


def test_compile_cache_enable_disable_and_stats(tmp_path):
    root = str(tmp_path / "cache")
    try:
        d = compile_cache.enable(root, "abc123")
        assert d == compile_cache.cache_dir_for(root, "abc123")
        assert os.path.isdir(d) and compile_cache.enabled_dir() == d
        assert kernel_build.BUILD_DIR == kernel_build.Path(d) / "kernels"
        assert compile_cache.stats(d)["entries"] == 0
        # the kernel library lands in the namespace; a second build of it
        # (a respawned worker's) is a cache hit, no nvcc
        lib = kernel_build.library_path("flash_attention.cu")
        assert lib.parent == kernel_build.BUILD_DIR
        lib.parent.mkdir(parents=True)
        lib.write_bytes(b"x" * 10)
        (lib.parent / "notes.txt").write_text("not a library")
        assert kernel_build.build("flash_attention.cu") == lib
        s = compile_cache.stats(d)
        assert (s["entries"], s["bytes"]) == (1, 10)
        assert monitor.snapshot()["jit_cache_hits_total"]["values"] == {
            '{fn="kernels.build"}': 1.0}
    finally:
        compile_cache.disable()
    assert compile_cache.enabled_dir() is None
    assert kernel_build.BUILD_DIR == kernel_build.DEFAULT_BUILD_DIR


def test_compile_cache_enable_unset_env_is_noop(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_CACHE_DIR, raising=False)
    assert compile_cache.enable(None, "sig") is None
    assert kernel_build.BUILD_DIR == kernel_build.DEFAULT_BUILD_DIR


# ---- fleet model spec -------------------------------------------------------

@pytest.mark.parametrize("spec", sorted(fleet.FLEET_SPECS))
def test_build_fleet_conf_identical_json(spec):
    conf, kw, warm = fleet.build_fleet_conf(spec, seed=11)
    jconf, jkw, jwarm = jfleet.build_fleet_conf(spec, seed=11)
    assert conf.to_json() == jconf.to_json()
    assert (kw, warm) == (jkw, jwarm)
    assert fleet.FLEET_SPECS[spec] == jfleet.FLEET_SPECS[spec]


# ---- fleet canary -----------------------------------------------------------

def _canary_trace(canary_cls, router):
    """Scripted health and p99: the same actions and fractions."""
    out = []
    c = canary_cls(router, "w1", schedule=(0.05, 0.25, 1.0),
                   max_p99_ms=50.0)
    for _ in range(5):
        out.append((c.step(), router._workers["w1"].route_fraction))
    out.append(c.status()["state"])
    c2 = canary_cls(router, "w1", schedule=(0.2, 1.0), max_p99_ms=50.0)
    out.append(c2.step())
    router._latency_window.extend([100.0] * 10)        # p99 breach
    out.append((c2.step(), router._workers["w1"].route_fraction))
    out.append(c2.step())                               # pinned aborted
    c3 = canary_cls(router, "w2", schedule=(0.5,))
    router._workers["w2"].healthy = False
    out.append((c3.step(), c3.status()["state"], c3.history))
    return out


def test_fleet_canary_actions_equal_the_jax_canary():
    router, jrouter = _routers()
    trace = _canary_trace(FleetCanary, router)
    assert trace == _canary_trace(JaxCanary, jrouter)
    assert [a for a, _ in trace[:4]] == ["ramp", "ramp", "ramp", "done"]
    assert trace[7][0] == "abort" and trace[8] == "abort"


# ---- live CPU fleet ---------------------------------------------------------

def _post(url, payload, timeout=20.0):
    req = urllib.request.Request(
        url + "/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.getcode(), json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def _wait(cond, what):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    pytest.fail(f"timed out waiting for {what}")


def test_live_cpu_fleet_from_a_jax_store(tmp_path):
    """Two ``lstm-small`` workers (``--device cpu``) warmed from weights
    the JAX package published: sessions stay home, a SIGKILL of a
    session's home costs no 5xx, the victim respawns at its rank and the
    session returns; answers equal the JAX engine's on the same store."""
    spec = fleet.FLEET_SPECS["lstm-small"]
    jconf, jkw, _ = jfleet.build_fleet_conf("lstm-small", seed=3)
    store = JaxStore(str(tmp_path / "store"))
    version = store.publish_model(JaxNet(jconf).init(), source="jax")
    jeng = JaxEngine(JaxNet(jfleet.build_fleet_conf("lstm-small")[0]).init(),
                     max_latency_ms=1.0, name="jax-ref", **jkw).start()
    jeng.warm_from_store(store)
    rng = np.random.RandomState(0)
    x = rng.randn(1, 4, spec["n_in"]).astype(np.float32)
    steps = rng.randn(3, 1, spec["n_in"]).astype(np.float32)
    want = np.asarray(jeng.predict(x))
    want_steps = [np.asarray(jeng.predict_session("ref", s)) for s in steps]
    jeng.stop()

    router = fleet.FleetRouter(2, model="lstm-small", device="cpu",
                               store_dir=str(tmp_path / "store"),
                               cache_root=str(tmp_path / "cache"),
                               health_interval_s=0.2, spawn_timeout_s=WAIT)
    router.start()
    ui = router.serve()
    url = f"http://127.0.0.1:{ui.port}"
    try:
        assert router.status()["healthy"] == 2
        assert {h.ready["device"] for h in router._workers.values()} == \
            {"cpu"}
        code, body = _post(url, {"model": "fleet", "features": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(np.asarray(body["output"]), want,
                                   rtol=1e-5, atol=1e-6)
        # an ill-shaped session step answers 400 and no worker is marked
        # down: the router passes the status through and fails over on
        # transport errors only
        code, body = _post(url, {"model": "fleet", "session": "bad",
                                 "features": x[:, 0, :-1].tolist()})
        assert code == 400 and "cannot feed" in body["error"]
        assert router.status()["healthy"] == 2
        assert all(h.healthy and h.fail_streak == 0
                   for h in router._workers.values())
        assert monitor.counter("fleet_retries_total").value(
            worker=router.pick("bad").name) == 0
        sid = "conv-live"
        home = router.pick(sid).name
        for s, w in zip(steps, want_steps):
            code, body = _post(url, {"model": "fleet", "session": sid,
                                     "features": s.tolist()})
            assert code == 200 and router.pick(sid).name == home
            np.testing.assert_allclose(np.asarray(body["output"]), w,
                                       rtol=1e-5, atol=1e-6)

        victim = router._workers[home]
        os.kill(victim.proc.pid, signal.SIGKILL)
        codes = [_post(url, {"model": "fleet", "session": sid,
                             "features": steps[0].tolist()})[0]
                 for _ in range(10)]
        assert codes == [200] * 10
        _wait(lambda: (router._workers.get(home) is not None
                       and router._workers[home].generation > 0
                       and router._workers[home].healthy), "the respawn")
        assert router._workers[home].ready["store_version"] == version
        assert router.pick(sid).name == home
        assert _post(url, {"model": "fleet", "session": sid,
                           "features": steps[0].tolist()})[0] == 200
        assert router.status()["healthy"] == 2
    finally:
        ui.stop()
        pids = [h.proc for h in router._workers.values()]
        router.stop()
    assert all(p.poll() is not None for p in pids)
    # each worker stopped cleanly reports its hand-kernel launches (none
    # on this model); the SIGKILLed one cannot
    assert sorted(r["pid"] for r in router.exit_reports) == \
        sorted(p.pid for p in pids)
    assert all(set(r["launches"]) == set(LAUNCHES)
               and not any(r["launches"].values())
               for r in router.exit_reports)


def test_worker_without_device_cpu_fails_to_start(tmp_path):
    """No CPU fallback: with no card, a worker left at its default device
    exits, and ``wait_ready`` raises ``FleetError``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = fleet.spawn_worker(0, model="mlp",
                              cache_root=str(tmp_path / "cache"))
    with pytest.raises(fleet.FleetError, match="CUDA"):
        fleet.wait_ready(proc, timeout=WAIT)
    assert proc.poll() is not None


def test_worker_admission_starts_empty_after_warmup(tmp_path):
    """A worker with an SLO serves its first request from empty
    admission windows: it calls ``InferenceEngine.end_warmup`` after its
    warm session step and first reply (the JAX worker keeps their
    latencies; ROADMAP C)."""
    proc = fleet.spawn_worker(0, model="lstm-small", slo_p99_ms=50.0,
                              cache_root=str(tmp_path / "cache"),
                              device="cpu")
    handle = fleet.WorkerHandle(0, proc, fleet.wait_ready(proc,
                                                          timeout=WAIT))
    handle.start_drains()
    try:
        with urllib.request.urlopen(handle.url + "/models",
                                    timeout=WAIT) as resp:
            doc = json.loads(resp.read().decode())
        adm = doc["engines"]["fleet-w0"]["admission"]
        assert (adm["slo_p99_ms"], adm["window_samples"]) == (50.0, 0)
        assert handle.ready["session_warmup_s"] is not None
    finally:
        handle.terminate()
    assert proc.poll() is not None
