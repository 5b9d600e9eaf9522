"""The port's serving engine (``serving/engine.py``), its bucketing and its
metrics registry, mirroring ``tests/test_serving.py`` and
``tests/test_serving_sessions.py``: bucket math and ``assemble_batch``
equal to the JAX package's (both are numpy), concurrent clients served
their own rows, timestep buckets with the mask, warmup accounting,
backpressure, shutdown and the session route.  The network is the decode
network of ``tests/test_torch_decode.py`` in float64 on the CPU; a
request's rows must equal ``output()`` of that request alone within
1e-12 (padding rows and padded steps never reach a real row: batch rows
are independent and causal queries never see later keys; float64 sums
of another batch shape may round apart in the last bits).

Every wait has its own timeout, so no test can hang the suite.
"""

import threading

import numpy as np
import pytest

from deeplearning4j_tpu.serving import bucketing as jax_bucketing
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.nn.conf import inputs
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers.attention import CausalSelfAttention
from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import (BucketPolicy, InferenceEngine,
                                              QueueFull, ServingError,
                                              assemble_batch, batch_ladder)

TOL = 1e-12
N_IN, N_OUT = 8, 4
WAIT = 60.0


def _model(seed=5, cache_len=32, attention=True):
    b = (NeuralNetConfiguration.builder().seed(seed).dtype("float64")
         .list())
    if attention:
        b = b.layer(CausalSelfAttention(n_out=16, n_heads=4,
                                        cache_len=cache_len))
    conf = (b.layer(RnnOutputLayer(n_out=N_OUT, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(inputs.recurrent(N_IN, 16)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _total(name, **labels):
    metric = monitor.registry().get(name)
    return 0.0 if metric is None else metric.value(**labels)


def _run_threads(targets):
    threads = [threading.Thread(target=t, daemon=True) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "a client hung"


# ---- bucket ladder / padding math (numpy in both packages) ---------------

@pytest.mark.parametrize("n", [1, 3, 24, 32])
def test_batch_ladder_matches_jax(n):
    assert batch_ladder(n) == jax_bucketing.batch_ladder(n)
    assert batch_ladder(n)[-1] == n


def test_bucket_policy_rounding_and_rejection():
    p = BucketPolicy(max_batch_size=8, timestep_buckets=(8, 4))
    j = jax_bucketing.BucketPolicy(max_batch_size=8, timestep_buckets=(8, 4))
    assert p.timestep_buckets == (4, 8) and p.describe() == j.describe()
    for n in range(1, 9):
        assert p.batch_bucket(n) == j.batch_bucket(n)
        assert p.time_bucket(n) == j.time_bucket(n)
    assert p.bucket_count(1) == j.bucket_count(1) == 8
    for bad in (lambda: p.batch_bucket(9), lambda: p.time_bucket(9),
                lambda: p.batch_bucket(0), lambda: BucketPolicy(2, (0,))):
        with pytest.raises(ValueError):
            bad()
    assert BucketPolicy(4).time_bucket(7) == 7


def test_assemble_batch_matches_jax():
    a = np.arange(30.0).reshape(2, 3, 5)
    b = np.ones((1, 2, 5)) * 2
    got = assemble_batch([a, b], 4, time_bucket=4)
    want = jax_bucketing.assemble_batch([a, b], 4, time_bucket=4)
    padded, mask, rows, waste = got
    assert padded.shape == (4, 4, 5) and mask.shape == (4, 4)
    np.testing.assert_array_equal(mask[0], [1, 1, 1, 0])
    np.testing.assert_array_equal(mask[2], [1, 1, 0, 0])
    np.testing.assert_array_equal(mask[3], [0, 0, 0, 0])
    assert rows == 3 and 0.0 < waste < 1.0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    dense = assemble_batch([np.ones((3, 2))], 4)
    assert dense[1] is None and dense[0].shape == (4, 2)


# ---- metrics registry ------------------------------------------------------

def test_metrics_registry_counts_and_exposes():
    reg = monitor.MetricsRegistry()
    reg.counter("c_total", "a counter").inc(2, engine="e")
    reg.gauge("g", "a gauge").set(5, model="m")
    reg.gauge("g").dec(1, model="m")
    h = reg.histogram("h_ms", "a histogram")
    for v in range(1, 1001):
        h.observe(float(v), model="m")
    assert reg.counter("c_total").value(engine="e") == 2
    assert reg.gauge("g").value(model="m") == 4
    st = h.stats(model="m")
    assert (st["count"], st["min"], st["max"]) == (1000, 1.0, 1000.0)
    assert st["p50"] == 501.0 and st["p99"] == 990.0 and st["p999"] == 999.0
    assert sum(st["buckets"]) == 1000
    with pytest.raises(TypeError):
        reg.gauge("c_total")
    text = reg.prometheus_text()
    assert 'c_total{engine="e"} 2' in text
    assert 'h_ms{model="m",quantile="0.999"} 999' in text
    assert 'h_ms_bucket{model="m",le="+Inf"} 1000' in text
    assert reg.snapshot()["g"]["values"] == {'{model="m"}': 4.0}
    reg.clear()
    assert reg.snapshot() == {}
    assert monitor.counter("x") is monitor.registry().counter("x")


# ---- padded parity, concurrency -------------------------------------------

def test_concurrent_clients_get_their_own_rows():
    """Concurrent callers with distinct inputs and lengths each get back
    exactly their rows, equal to ``output()`` of their request alone, and
    the batcher coalesces them."""
    model = _model()
    rng = np.random.RandomState(3)
    xs = [rng.randn(rng.randint(1, 3), rng.randint(3, 17), N_IN)
          for _ in range(16)]
    refs = [model.output(x).numpy() for x in xs]
    outs, errs = [None] * len(xs), []
    b0 = _total("serving_batches_total", engine="conc")
    with InferenceEngine(model, max_batch_size=8, max_latency_ms=20.0,
                         timestep_buckets=(8, 16), name="conc") as eng:
        eng.warmup((16, N_IN))

        def client(i):
            try:
                outs[i] = eng.predict(xs[i], timeout=WAIT)
            except Exception as e:     # surfaced after join
                errs.append((i, e))

        _run_threads([lambda i=i: client(i) for i in range(len(xs))])
    assert not errs
    for got, ref in zip(outs, refs):
        assert isinstance(got, np.ndarray) and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert 0 < _total("serving_batches_total", engine="conc") - b0 < len(xs)


def test_timestep_bucket_parity_with_mask():
    model = _model()
    rng = np.random.RandomState(1)
    with InferenceEngine(model, max_batch_size=4, timestep_buckets=(4, 8),
                         max_latency_ms=1.0, name="tbuckets") as eng:
        for n, t in ((1, 3), (2, 4), (3, 6), (4, 8)):
            x = rng.randn(n, t, N_IN)
            got = eng.predict(x, timeout=WAIT)
            ref = model.output(x).numpy()
            assert got.shape == ref.shape      # time axis unpadded back
            np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
        with pytest.raises(ValueError):
            eng.predict(np.zeros((1, 9, N_IN)), timeout=WAIT)
        with pytest.raises(ValueError, match="max_batch_size"):
            eng.predict(np.zeros((5, 2, N_IN)), timeout=WAIT)
    snap = monitor.registry().snapshot()
    for metric in ("serving_batch_fill_ratio", "serving_padding_waste_ratio",
                   "serving_request_latency_ms"):
        assert '{model="tbuckets"}' in snap[metric]["values"], metric


def test_warmup_makes_every_bucket_and_traffic_adds_none():
    model = _model()
    before = _total("serving_bucket_compiles_total", engine="recount")
    with InferenceEngine(model, max_batch_size=4, timestep_buckets=(4, 8),
                         max_latency_ms=1.0, name="recount") as eng:
        warmed = eng.warmup((8, N_IN))
        assert warmed == len(batch_ladder(4)) * 2 == 6
        assert eng.warmup((8, N_IN)) == 0
        rng = np.random.RandomState(4)
        for n in (1, 2, 3, 4):
            eng.predict(rng.randn(n, 5, N_IN), timeout=WAIT)
        assert _total("serving_bucket_compiles_total",
                      engine="recount") - before == warmed
        assert len(eng.bucket_keys()) == warmed
        assert eng.stats()["executables"] == warmed
        assert monitor.gauge("serving_bucket_executables").value(
            engine="recount") == warmed


def test_one_weight_copy_per_worker_device():
    """A ``devices`` list places one copy of the weights per worker, each
    with its own bucket callables; a later change of the network's
    weights does not reach the copies."""
    model = _model()
    x = np.random.RandomState(5).randn(3, 6, N_IN)
    ref = model.output(x).numpy()
    with InferenceEngine(model, max_batch_size=4, timestep_buckets=(8,),
                         devices=["cpu", "cpu"],
                         name="two-workers") as eng:
        assert eng.warmup((8, N_IN)) == 2 * len(batch_ladder(4))
        assert eng.stats()["workers"] == 2
        placed = [eng._placed_params(w)[0][0]["Wq"] for w in range(2)]
        assert placed[0] is not placed[1]
        assert placed[0] is not model.params[0]["Wq"]
        model.params[0]["Wq"] = model.params[0]["Wq"] * 0.0
        outs = [eng.predict(x, timeout=WAIT) for _ in range(4)]
    for got in outs:
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_bucket_callable_checks_its_shape():
    model = _model()
    fn = model.compile_output((2, 4, N_IN), mask_shape=(2, 4))
    x, m = np.zeros((2, 4, N_IN)), np.ones((2, 4))
    assert tuple(fn(model.params, model.net_state, x, m).shape) == (2, 4,
                                                                     N_OUT)
    with pytest.raises(ValueError, match="bucket"):
        fn(model.params, model.net_state, np.zeros((2, 5, N_IN)), m)
    with pytest.raises(ValueError, match="bucket"):
        fn(model.params, model.net_state, x, None)


def test_warmup_decode_counts_new_shapes_once():
    model = _model(cache_len=16)
    with InferenceEngine(model, max_batch_size=4, name="dec-warm") as eng:
        # batch buckets 1, 2, 4 x the cache ladder 1..16 (5 entries), plus
        # 4-token chunks where the ring holds them (4, 8, 16)
        assert eng.warmup_decode((N_IN,), chunk_lens=(1, 4)) == 3 * (5 + 3)
        assert eng.warmup_decode((N_IN,), chunk_lens=(1, 4)) == 0
        assert eng.warmup_decode((N_IN,), chunk_lens=(2,)) == 3 * 4
    with InferenceEngine(_model(attention=False), name="no-ring") as eng:
        with pytest.raises(ServingError, match="KV-ring"):
            eng.warmup_decode((N_IN,))


# ---- backpressure and shutdown --------------------------------------------

def test_queue_full_carries_retry_after():
    """With no batcher draining (threads never started), a bounded queue
    rejects non-blocking submits with QueueFull and a Retry-After."""
    eng = InferenceEngine(_model(), max_batch_size=2, queue_capacity=3,
                          max_latency_ms=1000.0, name="full")
    eng._running = True           # accept submits without starting threads
    rejected0 = _total("serving_rejected_total", engine="full")
    try:
        x = np.zeros((1, 2, N_IN))
        for _ in range(3):
            eng.predict_async(x, block=False)
        with pytest.raises(QueueFull) as e:
            eng.predict_async(x, block=False)
        assert 1.0 <= e.value.retry_after_s <= 60.0
        with pytest.raises(QueueFull):
            eng.predict_async(x, block=True, timeout=0.05)
    finally:
        eng._running = False
    assert _total("serving_rejected_total", engine="full") - rejected0 == 2
    assert InferenceEngine._retry_after(10, 2.0) == 5.0
    assert InferenceEngine._retry_after(10, 0.0) == 1.0


def test_predict_after_stop_raises_and_queued_requests_fail():
    eng = InferenceEngine(_model(), max_batch_size=2, name="stopped")
    with pytest.raises(ServingError, match="not started"):
        eng.predict(np.zeros((1, 2, N_IN)), timeout=WAIT)
    eng._running = True           # accept a submit without threads
    fut = eng.predict_async(np.zeros((1, 2, N_IN)))
    eng.stop()
    with pytest.raises(ServingError, match="stopped"):
        fut.result(WAIT)
    eng.start()
    eng.stop()
    with pytest.raises(ServingError):
        eng.predict(np.zeros((1, 2, N_IN)), timeout=WAIT)
    with pytest.raises(ServingError):
        eng.predict_session("s", np.zeros((1, N_IN)))


# ---- the session route ----------------------------------------------------

def test_predict_session_route_matches_output():
    model = _model(seed=23)
    xs = np.random.RandomState(8).randn(2, 12, N_IN)
    full = model.output(xs).numpy()
    outs, errs = {}, []
    with InferenceEngine(model, max_batch_size=4, name="sess-eng") as eng:
        eng.warmup_decode((N_IN,))

        def session(sid, x):
            try:
                chunk = eng.predict_session(sid, x[:, :5])
                steps = [eng.predict_session(sid, x[:, t])[:, None]
                         for t in range(5, 12)]
                outs[sid] = np.concatenate([chunk] + steps, 1)
            except Exception as e:
                errs.append(e)

        _run_threads([lambda: session("a", xs[:1]),
                      lambda: session("b", xs[1:])])
        assert not errs
        np.testing.assert_allclose(np.concatenate([outs["a"], outs["b"]]),
                                   full, rtol=0, atol=1e-15)
        st = eng.stats()["sessions"]
        assert st["sessions"] == 2 and st["total_steps"] == 16
        assert {eng.sessions._sessions[sid].version
                for sid in "ab"} == {eng.active_version} == {0}
        assert eng.sessions.session_capacity("a") == 16


def test_sessions_without_a_ring_step_the_rnn_path():
    model = _model(attention=False)
    assert not model.has_kv_ring()
    xs = np.random.RandomState(14).randn(2, 6, N_IN)
    full = model.output(xs).numpy()
    with InferenceEngine(model, name="rnn-sess") as eng:
        stepped = np.stack([eng.predict_session("s", xs[:, t])
                            for t in range(6)], 1)
        np.testing.assert_allclose(stepped, full, rtol=0, atol=1e-15)
        assert eng.sessions.session_capacity("s") == 0


def test_concurrent_steps_of_shared_sessions_lose_no_update():
    """16 threads, 4 per session, each sending 5 single tokens, with a
    short switch interval: every session must hold exactly the 20 tokens
    sent to it (a step that raced another of its session would lose
    one)."""
    import sys
    model = _model()
    errs = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with InferenceEngine(model, name="stress") as eng:
            def client(sid, seed):
                try:
                    rng = np.random.RandomState(seed)
                    for _ in range(5):
                        eng.predict_session(sid, rng.randn(1, N_IN))
                except Exception as e:
                    errs.append(e)

            _run_threads([lambda i=i: client(f"s{i % 4}", i)
                          for i in range(16)])
            cache = eng.sessions
            assert not errs
            for i in range(4):
                assert cache.session_position(f"s{i}") == 20
                assert cache.get_carries(f"s{i}")[0][2] == 20
            assert cache.stats()["total_steps"] == 80
            assert cache.session_capacity("s0") == 32
    finally:
        sys.setswitchinterval(old)
