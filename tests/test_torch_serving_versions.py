"""The port engine's weight versions against the JAX package's engine, the
cases of ``tests/test_deploy.py``: swap, stage + canary + promote,
rollback, stale versions refused, a hot swap refused under int8, and
session pinning across a promote with the retired tree purged when the
last pinned session closes.  Outputs agree with the JAX engine's within
1e-6 (float32 nets; 1e-12 for the float64 LSTM sessions); the canary
route sequence of 1,000 requests is the JAX package's exactly; no weight
operation makes a bucket callable.
"""

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.serving import InferenceEngine as JaxEngine
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.serving import InferenceEngine, ServingError
from serving_pairs import compiles, dense_conf, host, lstm_conf, pair

TOL = 1e-6
WAIT = 60.0


@pytest.fixture(autouse=True)
def _isolated():
    monitor.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    jmonitor.reset()


def _x(n=4, seed=0):
    return np.random.RandomState(seed).randn(n, 4).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def test_swap_serves_new_weights_without_a_callable():
    (j1, p1), (j2, p2) = pair(dense_conf(seed=1)), pair(dense_conf(seed=2))
    x = _x()
    with InferenceEngine(p1, max_batch_size=4, max_latency_ms=0.5,
                         name="swap") as pe, \
            JaxEngine(j1, max_batch_size=4, max_latency_ms=0.5,
                      name="swap") as je:
        pe.warmup((4,))
        je.warmup((4,))
        _close(pe.predict(x), je.predict(x))
        c0 = compiles(monitor, "swap")
        v = pe.swap_weights(p2.params, net_state=p2.net_state)
        jv = je.swap_weights(j2.params, net_state=j2.net_state)
        assert v == jv == 1 == pe.active_version
        _close(pe.predict(x), je.predict(x))
        _close(pe.predict(x), p2.output(x).numpy())
        assert compiles(monitor, "swap") == c0
        assert monitor.histogram("deploy_swap_seconds").stats(
            model="swap")["count"] == 1
        assert monitor.gauge("deploy_version").value(model="swap") == 1


def test_canary_routes_a_fraction_then_promotes():
    (j1, p1), (j2, p2) = pair(dense_conf(seed=1)), pair(dense_conf(seed=2))
    x = _x(2)
    ref_old, ref_new = p1.output(x).numpy(), p2.output(x).numpy()
    with InferenceEngine(p1, max_batch_size=4, max_latency_ms=0.5,
                         name="canary") as pe:
        pe.warmup((4,))
        c0 = compiles(monitor, "canary")
        v = pe.stage_weights(p2.params, net_state=p2.net_state)
        assert pe.model_bytes() == 2 * pe.resident_bytes()
        pe.set_canary(v, fraction=0.5)
        hits = [np.allclose(pe.predict(x), ref_new, rtol=0, atol=TOL)
                for _ in range(20)]
        assert sum(hits) == 10 and hits[1::2] == [True] * 10
        _close(pe.predict(x, version=v), ref_new)
        pe.promote(v)
        assert (pe.active_version, pe.canary_version) == (v, None)
        _close(pe.predict(x), ref_new)
        with pytest.raises(ValueError):
            pe.predict(x, version=0)       # the retired tree is gone
        assert pe.versions() == [v]
        assert compiles(monitor, "canary") == c0
        assert pe.model_bytes() == pe.resident_bytes()
        _close(ref_old, j1.output(x))


def test_rollback_restores_the_active_version():
    (_, p1), (_, p2) = pair(dense_conf(seed=1)), pair(dense_conf(seed=2))
    x = _x(2)
    with InferenceEngine(p1, max_batch_size=4, name="rb") as pe:
        ref = pe.predict(x)
        v = pe.stage_weights(p2.params, net_state=p2.net_state)
        pe.set_canary(v, fraction=1.0)
        assert pe.rollback() == v
        assert (pe.active_version, pe.canary_version) == (0, None)
        _close(pe.predict(x), ref, 0.0)
        assert pe.rollback() is None


def test_a_staged_numpy_tree_serves_like_its_tensors():
    (_, p1), (_, p2) = pair(dense_conf(seed=1)), pair(dense_conf(seed=2))
    x = _x(3)
    with InferenceEngine(p1, max_batch_size=4, name="numpy-tree") as pe:
        pe.swap_weights(host(p2.params), net_state=host(p2.net_state))
        _close(pe.predict(x), p2.output(x).numpy(), 0.0)


def test_stale_versions_and_unknown_canaries_are_refused():
    (_, p1), (_, p2) = pair(dense_conf(seed=1)), pair(dense_conf(seed=2))
    with InferenceEngine(p1, max_batch_size=4, name="stale") as pe:
        v = pe.stage_weights(p2.params, net_state=p2.net_state, version=5)
        for bad in (5, 2):
            with pytest.raises(ValueError):
                pe.stage_weights(p2.params, version=bad)
        with pytest.raises(ValueError):
            pe.set_canary(7)
        with pytest.raises(ValueError):
            pe.set_canary(0)               # already active
        assert pe.versions() == [0, 5]
        pe.promote(v)
        assert pe.versions() == [5]


def test_int8_refuses_a_hot_swap():
    (_, p1), (_, p2) = pair(dense_conf(seed=1)), pair(dense_conf(seed=2))
    with InferenceEngine(p1, max_batch_size=4, quantize="int8",
                         name="swap-int8") as pe:
        for op in (lambda: pe.stage_weights(p2.params),
                   lambda: pe.swap_weights(p2.params),
                   lambda: pe.promote(0)):
            with pytest.raises(ServingError):
                op()


@pytest.mark.parametrize("fraction", [0.1, 0.25, 0.5])
def test_route_sequence_equals_jax(fraction):
    (j1, p1), (j2, p2) = pair(dense_conf(seed=1)), pair(dense_conf(seed=2))
    pe = InferenceEngine(p1, max_batch_size=4, name="route")
    je = JaxEngine(j1, max_batch_size=4, name="route")
    pv = pe.stage_weights(p2.params, net_state=p2.net_state)
    jv = je.stage_weights(j2.params, net_state=j2.net_state)
    pe.set_canary(pv, fraction)
    je.set_canary(jv, fraction)
    got = [pe._route_version() for _ in range(1000)]
    want = [je._route_version() for _ in range(1000)]
    assert got == want
    assert sum(v == pv for v in got) == int(1000 * fraction)


def test_sessions_stay_pinned_across_a_promote_then_purge():
    """A session opened on version 0 keeps stepping version 0's weights
    after a promote, bit for bit as an engine that never swaps (the
    ``serving_session_version_pinned`` gauge counts it); a new session
    binds to the new version; when the pinned session closes, the next
    weight operation purges the retired tree."""
    (j1, p1) = pair(lstm_conf(seed=1, dtype="float64"))
    (j2, p2) = pair(lstm_conf(seed=2, dtype="float64"))
    xs = np.random.RandomState(0).randn(2, 6, 3)
    with InferenceEngine(p1, max_batch_size=4, name="pin") as pe, \
            JaxEngine(j1, max_batch_size=4, name="pin-ref") as je, \
            InferenceEngine(p2, max_batch_size=4, name="pin-new") as ne:
        _close(pe.predict_session("s", xs[:, 0]),
               je.predict_session("s", xs[:, 0]), 1e-12)
        v = pe.swap_weights(p2.params, net_state=p2.net_state)
        gauge = monitor.gauge("serving_session_version_pinned")
        assert gauge.value(model="pin") == 1
        for t in range(1, 6):
            _close(pe.predict_session("s", xs[:, t]),
                   je.predict_session("s", xs[:, t]), 1e-12)
        assert pe.sessions.session_version("s") == 0
        assert pe.sessions.pinned_versions() == {0}
        assert 0 in pe._session_pins
        for t in range(3):
            _close(pe.predict_session("fresh", xs[:, t]),
                   ne.predict_session("fresh", xs[:, t]), 1e-12)
        assert pe.sessions.session_version("fresh") == v
        assert pe.sessions.clear("s")
        assert gauge.value(model="pin") == 0
        pe.rollback()                      # any weight op purges
        assert pe._session_pins == {}
        assert pe.sessions.stats()["pinned_versions"] == [v]


def test_warm_from_store_serves_the_store_head(tmp_path):
    from deeplearning4j_tpu_torch.deploy import VersionedWeightStore
    (_, p1), (_, p2) = pair(dense_conf(seed=1)), pair(dense_conf(seed=2))
    store = VersionedWeightStore(str(tmp_path))
    x = _x(2)
    with InferenceEngine(p1, max_batch_size=4, name="warm") as pe:
        assert pe.warm_from_store(store) is None
        store.publish(p2.get_flat_params(), version=7)
        assert pe.warm_from_store(store) == 7 == pe.active_version
        _close(pe.predict(x), p2.output(x).numpy())
