"""The port's int8 weights (``serving/quantize.py`` and the int8 engine)
against the JAX package's ``serving/quantize.py``: the uint8 leaves and
decode specs bitwise on float32 trees of a dense net, a small CNN, an
LSTM and the attention layer; the plain decode bitwise the host twin; the
int8 engine's ``predict`` and its int8 decode sessions within 1e-6 of the
JAX int8 engine's (the same uint8 weights decode to the same float32
weights; the forwards differ by float32 summation order); the iris
accuracy gate of ``tests/test_serving_registry.py``; and the deliberate
difference under ``mixed_bf16``, where the JAX package quantizes nothing.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.iris import iris_dataset as jax_iris
from deeplearning4j_tpu.serving import InferenceEngine as JaxEngine
from deeplearning4j_tpu.serving import quantize as jq
from deeplearning4j_tpu_torch.datasets.iris import iris_dataset
from deeplearning4j_tpu_torch.serving import InferenceEngine
from deeplearning4j_tpu_torch.serving import quantize as pq
from serving_pairs import (CONFS, attention_conf, dense_conf, host,
                           inputs_for, pair, port_net)

TOL = 1e-6
WAIT = 60.0


@pytest.mark.parametrize("kind", sorted(CONFS))
def test_quantize_tree_is_bitwise_jax(kind):
    jnet, pnet = pair(CONFS[kind]())
    jq_tree, jspecs = jq.quantize_tree(jnet.params)
    pq_tree, pspecs = pq.quantize_tree(pnet.params)
    assert pspecs == jspecs
    assert any(s is not None for s in pspecs)
    jleaves = [np.asarray(l) for l in jax.tree.leaves(jq_tree)]
    pleaves = [np.asarray(l) for l in pq._leaves(host(pq_tree))]
    assert len(jleaves) == len(pleaves)
    for got, want in zip(pleaves, jleaves):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert pq.tree_nbytes(pq_tree) == jq.tree_nbytes(jq_tree)


@pytest.mark.parametrize("kind", sorted(CONFS))
def test_plain_decode_is_bitwise_the_host_twin(kind):
    jnet, pnet = pair(CONFS[kind]())
    qtree, specs = pq.quantize_tree(pnet.params)
    dev = pq._leaves(host(pq.dequantize_tree(qtree, specs)))
    twin = pq._leaves(pq.dequantize_host(qtree, specs))
    jtwin = jax.tree.leaves(jq.dequantize_host(*jq.quantize_tree(
        jnet.params)))
    for got, want, jwant in zip(dev, twin, jtwin):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(jwant))


def test_quantize_leaf_round_trip_bound_and_edge_cases():
    w = np.random.RandomState(0).randn(32, 16).astype(np.float32) * 3.0
    q, wf = pq.quantize_leaf(w)
    jqq, jwf = jq.quantize_leaf(w)
    np.testing.assert_array_equal(q, jqq)
    assert wf.as_tuple() == jwf.as_tuple()
    step = (w.max() - w.min()) / 255.0
    assert float(np.abs(wf.decode_host(q) - w).max()) <= step / 2 + 1e-6
    q, wf = pq.quantize_leaf(np.full((8, 8), 2.5, np.float32))
    np.testing.assert_allclose(wf.decode_host(q), 2.5, atol=1e-6)
    with pytest.raises(ValueError):
        pq.quantize_leaf(np.array([[np.nan, 1.0]], np.float32))


@pytest.mark.parametrize("kind", ["dense", "cnn", "lstm"])
def test_int8_engine_predict_matches_jax(kind):
    jnet, pnet = pair(CONFS[kind]())
    x = inputs_for(kind, 3, seed=2)
    with JaxEngine(jnet, max_batch_size=4, quantize="int8",
                   name=f"jq-{kind}") as je, \
            InferenceEngine(pnet, max_batch_size=4, quantize="int8",
                            name=f"pq-{kind}") as pe:
        want = np.asarray(je.predict(x, timeout=WAIT))
        got = pe.predict(x, timeout=WAIT)
        assert pe.model_bytes() == je.model_bytes()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_int8_decode_sessions_match_jax():
    jnet, pnet = pair(attention_conf())
    xs = inputs_for("attention", 2, seed=3)
    with JaxEngine(jnet, max_batch_size=2, quantize="int8",
                   name="jq-dec") as je, \
            InferenceEngine(pnet, max_batch_size=2, quantize="int8",
                            name="pq-dec") as pe:
        assert pe.warmup_decode((xs.shape[2],)) > 0
        for t in range(6):
            want = np.asarray(je.predict_session("s", xs[:, t]))
            got = pe.predict_session("s", xs[:, t])
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        # a chunk continues the same ring
        want = np.asarray(je.predict_session("s", xs[:, 6:10]))
        got = pe.predict_session("s", xs[:, 6:10])
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        # and the int8 step decodes the uint8 tree, not the live weights
        pnet.params[0]["Wq"] = pnet.params[0]["Wq"] * 0.0
        np.testing.assert_allclose(pe.predict_session("s", xs[:, 10]),
                                   np.asarray(je.predict_session(
                                       "s", xs[:, 10])), rtol=0, atol=TOL)


def _fit_iris(net, ds, epochs=20):
    net.fit(ds, epochs=epochs)
    return net


def test_int8_matches_f32_top1_on_iris():
    """The port of the JAX package's gate: on the full iris eval, top-1
    accuracy delta <= 2% against the f32 engine, top-1 agreement >= 97%,
    softmax outputs within 0.02 absolute, resident bytes < 0.7x."""
    ds = iris_dataset()
    model = _fit_iris(port_net(dense_conf(seed=5, hidden=16, n_out=3)), ds)
    x = np.asarray(ds.features)
    labels = np.argmax(np.asarray(ds.labels), axis=1)
    p32, p8 = [], []
    with InferenceEngine(model, max_batch_size=32, max_latency_ms=1.0,
                         name="iris-f32") as e32, \
            InferenceEngine(model, max_batch_size=32, max_latency_ms=1.0,
                            name="iris-i8", quantize="int8") as e8:
        for i in range(0, len(x), 32):
            p32.append(e32.predict(x[i:i + 32], timeout=WAIT))
            p8.append(e8.predict(x[i:i + 32], timeout=WAIT))
        assert e8.model_bytes() < 0.7 * e32.model_bytes()
    y32, y8 = np.concatenate(p32), np.concatenate(p8)
    acc32 = float(np.mean(np.argmax(y32, 1) == labels))
    acc8 = float(np.mean(np.argmax(y8, 1) == labels))
    assert abs(acc32 - acc8) <= 0.02
    assert float(np.mean(np.argmax(y32, 1) == np.argmax(y8, 1))) >= 0.97
    assert float(np.abs(y32 - y8).max()) < 0.02
    # the iris features are the JAX package's, row for row
    np.testing.assert_array_equal(x, np.asarray(jax_iris().features))


def test_mixed_bf16_quantizes_where_jax_does_not(monkeypatch):
    """The deliberate difference: under ``mixed_bf16`` the port's int8
    engine quantizes the rank >= 2 leaves from their f32 upcast and keeps
    uint8 resident (its model_bytes fall), and its output passes the
    JAX package's gates against the port's own bf16 engine.  The JAX
    package's quantize_tree leaves the same bf16 tree unquantized."""
    monkeypatch.setenv("DL4J_TPU_PRECISION", "mixed_bf16")
    ds = iris_dataset()
    model = _fit_iris(port_net(dense_conf(seed=5, hidden=32, n_out=3)),
                      ds, epochs=40)
    assert model.params[0]["W"].dtype == torch.bfloat16
    _, specs = pq.quantize_tree(model.params)
    quantized = [s for s in specs if s is not None]
    assert len(quantized) == 2
    assert all(s.dtype == torch.bfloat16 for s in quantized)
    x = np.asarray(ds.features)
    with InferenceEngine(model, max_batch_size=32, name="bf16") as eb, \
            InferenceEngine(model, max_batch_size=32, name="bf16-i8",
                            quantize="int8") as e8:
        yb = np.concatenate([eb.predict(x[i:i + 32], timeout=WAIT)
                             for i in range(0, len(x), 32)])
        y8 = np.concatenate([e8.predict(x[i:i + 32], timeout=WAIT)
                             for i in range(0, len(x), 32)])
        assert e8.model_bytes() < 0.7 * eb.model_bytes()
        placed = e8._placed_params(0)[0]
        assert placed[0]["W"].dtype == torch.uint8
    labels = np.argmax(np.asarray(ds.labels), axis=1)
    assert abs(float(np.mean(np.argmax(yb, 1) == labels))
               - float(np.mean(np.argmax(y8, 1) == labels))) <= 0.02
    assert float(np.mean(np.argmax(yb, 1) == np.argmax(y8, 1))) >= 0.97
    assert float(np.abs(yb - y8).max()) < 0.02
    # the reference-side caveat: ml_dtypes.bfloat16 is not np.floating
    import ml_dtypes
    bf16_tree = jax.tree.map(lambda a: np.asarray(a, ml_dtypes.bfloat16),
                             [{"W": np.ones((32, 4), np.float32)}])
    assert jq.quantize_tree(bf16_tree)[1] == (None,)


def test_decode_keeps_the_wire_op_order():
    """Three separately rounded float32 ops: a value where an FMA or a
    reciprocal multiply would round differently decodes as numpy does."""
    q = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    spec = pq.QuantSpec(255.0, 0.7000000476837158, -0.3333333432674408)
    got = pq._decode_leaf(q, spec).numpy()
    want = (q.numpy().astype(np.float32) / np.float32(255.0)
            * np.float32(spec[1]) + np.float32(spec[2]))
    np.testing.assert_array_equal(got, want)
    assert spec == (255.0, 0.7000000476837158, -0.3333333432674408)


def test_quantized_output_and_decode_match_the_jax_callables():
    """The counterparts of ``quantized_output_jit`` and
    ``quantized_decode_jit`` called directly (no engine), on the same
    uint8 trees, within 1e-6."""
    jnet, pnet = pair(attention_conf())
    x = inputs_for("attention", 2, seed=4)
    jq_tree, jspecs = jq.quantize_tree(jnet.params)
    pq_tree, pspecs = pq.quantize_tree(pnet.params)
    want = jq.quantized_output_jit(jnet, jspecs, name="t.out_int8")(
        jq_tree, jnet.net_state, x, None)
    got = pq.quantized_output(pnet, pspecs)(pq_tree, pnet.net_state, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    jdec = jq.quantized_decode_jit(jnet, jspecs, name="t.dec_int8")
    pdec = pq.quantized_decode(pnet, pspecs)
    jc, pc = jnet._init_carries(2), pnet._init_carries(2)
    for t in range(4):
        jo, jc = jdec(jq_tree, jnet.net_state, jc, x[:, t:t + 1])
        po, pc = pdec(pq_tree, pnet.net_state, pc, x[:, t:t + 1])
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=0,
                                   atol=TOL)
