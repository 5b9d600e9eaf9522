"""The port's compile watch (``monitor/jit_watch.py``) against the JAX
package's: ``abstract_signature`` gives the same string on the same
arguments (numpy and torch leaves alike), a watched build counts one
compile per signature and cache hits after it, ``engine.warmup`` counts
one ``mln.output`` compile per bucket in both packages, the decode path's
growth counts as ``mln.decode_grow`` in both, and ``phase_breakdown`` and
the attributor's ``compile`` component read the builds, while eager train
steps count none.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.monitor import jit_watch as jjit_watch
from deeplearning4j_tpu.serving.engine import InferenceEngine as JaxEngine
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.monitor import attribution, jit_watch
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
from serving_pairs import CONFS, pair


@pytest.fixture(autouse=True)
def _isolated():
    monitor.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    jmonitor.reset()


def _counts(mon, name):
    snap = mon.snapshot()
    out = {}
    for metric in (jit_watch.COMPILES_TOTAL, jit_watch.CACHE_HITS_TOTAL):
        out[metric] = snap.get(metric, {}).get("values", {}).get(
            f'{{fn="{name}"}}', 0.0)
    return out


CALLS = [
    ((np.zeros((2, 3), np.float32), 3, 2.0, True), {}, ()),
    ((np.zeros((2, 3), np.float32), 3, 2.0, True), {}, (1,)),
    (([np.zeros(4, np.int64), None], {"b": np.zeros((1,), np.float16),
                                      "a": (1, 2.5)}), {}, ()),
    (((np.zeros((), np.float64),),), {"k": (1, 2), "j": None}, ()),
    (({},), {"mask": [np.ones((2, 5), bool)]}, ()),
    ((("s", 7),), {}, (0,)),
]


@pytest.mark.parametrize("i", range(len(CALLS)))
def test_abstract_signature_equals_the_jax_signature(i):
    args, kwargs, static = CALLS[i]
    assert jit_watch.abstract_signature(args, kwargs, static) == \
        jjit_watch.abstract_signature(args, kwargs, static)


def test_torch_leaves_spell_as_numpy_leaves():
    t = (torch.zeros(2, 3), [torch.zeros(4, dtype=torch.int64)])
    n = (np.zeros((2, 3), np.float32), [np.zeros(4, np.int64)])
    assert jit_watch.abstract_signature(t, {}) == \
        jjit_watch.abstract_signature(n, {})
    assert "bfloat16[3]" in jit_watch.abstract_signature(
        (torch.zeros(3, dtype=torch.bfloat16),), {})


def test_watched_counts_one_compile_per_signature():
    calls = []
    fn = jit_watch.WatchedCall(
        lambda x, n: calls.append(n) or x.shape[0] * n, name="t.fn",
        static_argnums=(1,))
    x2, x3 = torch.zeros(2, 4), torch.zeros(3, 4)
    assert [fn(x2, 5), fn(x2, 5), fn(x3, 5), fn(x2, 6)] == [10, 10, 15, 12]
    assert calls == [5, 5, 5, 6] and fn.compile_count == 3
    assert _counts(monitor, "t.fn") == {"jit_compiles_total": 3.0,
                                        "jit_cache_hits_total": 1.0}
    spans = monitor.tracer().events(name="jit/compile/t.fn")
    assert len(spans) == 3
    assert [s["attrs"]["recompile"] for s in spans] == [False, True, True]
    assert "static1=6" in spans[-1]["attrs"]["signature"]


def test_a_build_that_raises_is_not_counted():
    with pytest.raises(ValueError):
        with jit_watch.compiling("t.bad", signature="x"):
            raise ValueError("no")
    assert _counts(monitor, "t.bad")["jit_compiles_total"] == 0.0


@pytest.mark.parametrize("kind", ["dense", "lstm"])
def test_warmup_counts_one_output_compile_per_bucket_in_both(kind):
    jnet, pnet = pair(CONFS[kind]())
    buckets = (4, 8) if kind == "lstm" else None
    shape = (8, 3) if kind == "lstm" else (4,)
    made = {}
    for side, Engine, net, mon in (("jax", JaxEngine, jnet, jmonitor),
                                   ("port", InferenceEngine, pnet, monitor)):
        eng = Engine(net, max_batch_size=4, max_latency_ms=1.0,
                     timestep_buckets=buckets)
        made[side] = (eng.warmup(shape),
                      _counts(mon, "mln.output")["jit_compiles_total"])
    n = 3 * (2 if kind == "lstm" else 1)          # batch buckets 1, 2, 4
    assert made["port"] == made["jax"] == (n, float(n))
    bd = monitor.phase_breakdown()
    assert bd["recompiles"] == n and bd["compile_ms"] > 0.0
    assert attribution.breakdown()["components_ms"]["compile"] == \
        pytest.approx(bd["compile_ms"], abs=1e-3)


def test_decode_growth_counts_as_decode_grow_in_both():
    """The attention net's session decode across the cache-len ladder:
    each growth shape builds once, as each JAX grow function compiles
    once."""
    jnet, pnet = pair(CONFS["attention"](cache_len=32))
    counts = {}
    for side, Engine, net, mon in (("jax", JaxEngine, jnet, jmonitor),
                                   ("port", InferenceEngine, pnet, monitor)):
        eng = Engine(net, max_batch_size=2, max_latency_ms=1.0).start()
        try:
            eng.warmup_decode((8,))
            first = _counts(mon, "mln.decode_grow")
            x = np.random.RandomState(0).randn(1, 8).astype(np.float32)
            for _ in range(20):
                eng.predict_session("s", x)
            counts[side] = (first["jit_compiles_total"],
                            _counts(mon, "mln.decode_grow")[
                                "jit_compiles_total"])
        finally:
            eng.stop()
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] >= 1


def test_eager_train_steps_count_no_compile():
    _, pnet = pair(CONFS["dense"]())
    rng = np.random.RandomState(0)
    x = rng.randn(16, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]
    pnet.fit(DataSet(x, y), epochs=3)
    assert jit_watch.COMPILES_TOTAL not in monitor.snapshot()
    assert monitor.phase_breakdown()["recompiles"] == 0
    assert monitor.phase_breakdown()["steps"] == 3
