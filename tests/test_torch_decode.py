"""Autoregressive decode in the port: ``MultiLayerNetwork.decode_step``,
``grow_decode_carries``, ``rnn_time_step`` and ``serving.SessionCache``
over the KV ring of ``CausalSelfAttention``, held against the JAX package
on the same weights and inputs, and against the port's own ``output()``
(the contracts of ``tests/test_decode.py`` and
``tests/test_serving_sessions.py``).

Size: n_in 8, hidden 16, 4 heads, cache_len 32, T 16, float64 unless
stated.  The JAX network's weights are rounded to float32 first, so both
packages hold the same float64 values (the flat vector crosses as
float32).  Tolerances: 1e-12 against the JAX package (float64 sums in
another order); against the port's own ``output()`` rtol 0, atol 1e-15 in
float64 (a single-token step multiplies a row where the full sequence
multiplies a matrix, which may round the last bit apart), 1e-6 under the
fp32 policy and 2e-2 on probabilities under mixed_bf16, as the JAX tests
hold them.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import inputs as jax_inputs
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers.attention import \
    CausalSelfAttention as JaxAttention
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.layers.recurrent import \
    RnnOutputLayer as JaxRnnOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.serving.sessions import SessionCache as JaxCache
from deeplearning4j_tpu.serving.sessions import \
    SessionStateError as JaxStateError
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.jax_weights import load_jax_params
from deeplearning4j_tpu_torch.nn.layers.attention import CausalSelfAttention
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.attention import kv_ring_update
from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                              SessionCache, SessionError,
                                              SessionStateError,
                                              batch_ladder)

JAX_TOL, ULP_TOL, F32_TOL, BF16_TOL = 1e-12, 1e-15, 1e-6, 2e-2
N_IN, HIDDEN, HEADS, N_OUT, T = 8, 16, 4, 4, 16


def _conf(seed=5, cache_len=32, dtype="float64"):
    return (JaxConf.builder().seed(seed).dtype(dtype).list()
            .layer(JaxAttention(n_out=HIDDEN, n_heads=HEADS,
                                cache_len=cache_len))
            .layer(JaxRnnOutput(n_out=N_OUT, activation="softmax",
                                loss="mcxent"))
            .set_input_type(jax_inputs.recurrent(N_IN, T))
            .build())


def _pair(**kw):
    """The same network in both packages, on the same weights."""
    conf = _conf(**kw)
    jnet = JaxNet(conf).init()
    jnet.set_flat_params(jnet.get_flat_params().astype(np.float32))
    pnet = _port(conf)
    load_jax_params(pnet, jnet.get_flat_params())
    return jnet, pnet


def _port(conf):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()


def _net(**kw):
    return _pair(**kw)[1]


def _x(b, t, seed):
    return np.random.RandomState(seed).randn(b, t, N_IN)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _assert_carries_match(pc, jc):
    assert len(pc) == len(jc)
    (pk, pv, pcur), (jk, jv, jcur) = pc[0], jc[0]
    _close(pk.numpy(), jk, JAX_TOL)
    _close(pv.numpy(), jv, JAX_TOL)
    assert pcur == int(jcur)
    assert pc[1] == () and jc[1] == ()


# ---- against the JAX package ---------------------------------------------

def test_decode_step_matches_jax_single_tokens_and_chunk():
    """16 single-token decode_step calls, then one 16-token chunk from a
    fresh carry: outputs and the rings they leave equal the JAX
    package's."""
    jnet, pnet = _pair()
    xs = _x(2, T, 1)
    jc, pc = None, None
    for t in range(T):
        jout, jc = jnet.decode_step(jc, xs[:, t:t + 1])
        pout, pc = pnet.decode_step(pc, xs[:, t:t + 1])
        _close(pout.numpy(), jout, JAX_TOL)
    _assert_carries_match(pc, jc)
    jout, jc = jnet.decode_step(jnet._init_carries(2, cache_len=16), xs)
    pout, pc = pnet.decode_step(pnet._init_carries(2, cache_len=16), xs)
    _close(pout.numpy(), jout, JAX_TOL)
    _assert_carries_match(pc, jc)


def test_session_single_tokens_match_jax():
    jnet, pnet = _pair()
    jcache, pcache = JaxCache(jnet, name="jax-tok"), SessionCache(
        pnet, name="port-tok")
    xs = _x(2, T, 2)
    for t in range(T):
        got = pcache.step("s", xs[:, t])
        assert got.shape == (2, N_OUT)
        _close(got, jcache.step("s", xs[:, t]), JAX_TOL)
        assert pcache.session_capacity("s") == \
            jcache.session_capacity("s")
    assert pcache.session_position("s") == jcache.session_position("s") == T


def test_session_chunked_10_plus_6_matches_jax():
    jnet, pnet = _pair()
    jcache, pcache = JaxCache(jnet, name="jax-ch"), SessionCache(
        pnet, name="port-ch")
    xs = _x(3, T, 3)
    _close(pcache.step("s", xs[:, :10]), jcache.step("s", xs[:, :10]),
           JAX_TOL)
    assert pcache.session_capacity("s") == jcache.session_capacity("s") \
        == 16
    for t in range(10, T):
        _close(pcache.step("s", xs[:, t]), jcache.step("s", xs[:, t]),
               JAX_TOL)
    assert pcache.session_capacity("s") == jcache.session_capacity("s")


def test_state_bytes_and_leaf_paths_match_jax():
    jnet, pnet = _pair()
    jcache, pcache = JaxCache(jnet, name="jax-bytes"), SessionCache(
        pnet, name="port-bytes")
    xs = _x(2, 5, 4)
    for cache in (jcache, pcache):
        cache.step("s", xs)                       # capacity 8
        cache.step("s", xs[:, 0])                 # 6 tokens
        cache.step("r", xs[:1, :3])               # capacity 4, batch 1
    assert pcache.state_bytes() == jcache.state_bytes() > 0
    errors = []
    for cache, err in ((jcache, JaxStateError), (pcache, SessionStateError)):
        with pytest.raises(err) as ei:
            cache.step("s", _x(3, 1, 5)[:, 0])
        errors.append(ei.value.leaf_path)
        with cache._lock:
            sess = cache._sessions["r"]
            sess.carries = sess.carries[:1]      # drop the head's carry
        with pytest.raises(err) as ei:
            cache.step("r", xs[:1, 0])
        errors.append(ei.value.leaf_path)
    assert errors[:2] == errors[2:] == ["[0][0]", "<structure>"]


def test_grow_decode_carries_matches_jax():
    jnet, pnet = _pair()
    xs = _x(2, 5, 6)
    _, jc = jnet.decode_step(jnet._init_carries(2, cache_len=8), xs)
    _, pc = pnet.decode_step(pnet._init_carries(2, cache_len=8), xs)
    jg, pg = jnet.grow_decode_carries(jc, 32), pnet.grow_decode_carries(pc,
                                                                        32)
    assert pg[0][0].shape == (2, HEADS, 32, HIDDEN // HEADS)
    _assert_carries_match(pg, jg)
    assert pnet.grow_decode_carries(pc, 8)[0] is pc[0]
    with pytest.raises(ValueError, match="shrink"):
        pnet.grow_decode_carries(pc, 4)
    # the grown ring decodes on as the JAX one does
    x1 = _x(2, 1, 7)
    _close(pnet.decode_step(pg, x1)[0].numpy(), jnet.decode_step(jg, x1)[0],
           JAX_TOL)


def test_forked_carry_matches_jax():
    """Stepping twice from one carry must not fork it: the second step
    from ``c0`` may not land in the ring the first step returned.  The
    ring write used to update the caller's tensors in place, which made
    the last output here differ from the JAX package's by 12.4."""
    jl = JaxAttention(n_in=N_IN, n_out=HIDDEN, n_heads=HEADS, cache_len=32)
    pl = CausalSelfAttention(n_in=N_IN, n_out=HIDDEN, n_heads=HEADS,
                             cache_len=32)
    rng = np.random.RandomState(8)
    p = {name: rng.randn(*shape) for name, shape in (
        ("Wq", (N_IN, HIDDEN)), ("Wk", (N_IN, HIDDEN)),
        ("Wv", (N_IN, HIDDEN)), ("Wo", (HIDDEN, HIDDEN)), ("b", (HIDDEN,)))}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    prefill, xa, xb, xc = (rng.randn(1, t, N_IN) for t in (4, 1, 1, 1))

    def run(layer, params, carry, conv):
        _, c0 = layer.forward_seq(params, conv(prefill), carry, train=False)
        out_a, ca = layer.forward_seq(params, conv(xa), c0, train=False)
        out_b, _ = layer.forward_seq(params, conv(xb), c0, train=False)
        out_c, _ = layer.forward_seq(params, conv(xc), ca, train=False)
        return [np.asarray(o) for o in (out_a, out_b, out_c)]

    want = run(jl, jp, jl.init_carry(1, jnp.float64), jnp.asarray)
    got = run(pl, tp, pl.init_carry(1, torch.float64, torch.device("cpu")),
              torch.from_numpy)
    for g, w in zip(got, want):
        _close(g, w, JAX_TOL)


def test_kv_ring_update_leaves_its_arguments_unchanged():
    rng = np.random.RandomState(9)
    k, v = (torch.from_numpy(rng.randn(1, 2, 8, 4)) for _ in range(2))
    k0, v0 = k.clone(), v.clone()
    nk, nv = kv_ring_update(k, v, 3, torch.ones(1, 2, 2, 4),
                            torch.ones(1, 2, 2, 4))
    assert torch.equal(k, k0) and torch.equal(v, v0)
    assert torch.equal(nk[:, :, 3:5], torch.ones(1, 2, 2, 4))
    assert torch.equal(nk[:, :, :3], k0[:, :, :3])
    assert torch.equal(nv[:, :, 5:], v0[:, :, 5:])


# ---- against the port's own output() --------------------------------------

@pytest.mark.parametrize("cap", [16, 32, 64])
def test_decode_chunk_is_capacity_independent(cap):
    """Masked ring slots contribute exact zeros: a decode chunk equals
    output() at any ring capacity (bitwise here; torch groups the softmax
    sum and the P V reduction over the capacity, and in float64 on the
    CPU those groupings leave the result unchanged at these sizes)."""
    net = _net()
    xs = _x(2, T, 0)
    full = net.output(xs)
    out, _ = net.decode_step(net._init_carries(2, cache_len=cap), xs)
    assert torch.equal(out, full)


def test_single_token_steps_match_output_f64():
    net = _net()
    cache = SessionCache(net, name="dec-parity")
    xs = _x(2, T, 1)
    full = net.output(xs).numpy()
    stepped = np.stack([cache.step("s", xs[:, t]) for t in range(T)], 1)
    _close(stepped, full, ULP_TOL)
    assert cache.session_position("s") == T
    assert cache.session_capacity("s") == 16


def test_chunked_session_matches_output():
    net = _net()
    cache = SessionCache(net, name="dec-chunks")
    xs = _x(3, T, 2)
    full = net.output(xs).numpy()
    outs = [cache.step("s", xs[:, :10])]
    outs += [cache.step("s", xs[:, t])[:, None] for t in range(10, T)]
    _close(np.concatenate(outs, 1), full, ULP_TOL)


def test_decode_parity_fp32_policy():
    net = _net(dtype="float32")
    assert net._pol().name == "fp32"
    cache = SessionCache(net, name="dec-f32")
    xs = _x(2, 12, 3).astype(np.float32)
    full = net.output(xs).numpy()
    stepped = np.stack([cache.step("s", xs[:, t]) for t in range(12)], 1)
    assert stepped.dtype == np.float32
    _close(stepped, full, F32_TOL)


def test_decode_parity_mixed_bf16_policy(monkeypatch):
    """Under mixed_bf16 the head's fp32 logits branch comes before the
    carries branch, so decode steps keep the fp32-logits contract."""
    monkeypatch.setenv("DL4J_TPU_PRECISION", "mixed_bf16")
    net = _port(_conf(dtype="float32"))
    assert net._pol().name == "mixed_bf16"
    cache = SessionCache(net, name="dec-bf16")
    xs = _x(2, 12, 4).astype(np.float32)
    full = net.output(xs).numpy()
    stepped = np.stack([cache.step("s", xs[:, t]) for t in range(12)], 1)
    assert full.dtype == stepped.dtype == np.float32
    assert cache.get_carries("s")[0][0].dtype == torch.bfloat16
    _close(stepped, full, BF16_TOL)
    np.testing.assert_allclose(stepped.sum(-1), 1.0, atol=1e-5)


def test_rnn_time_step_matches_output_and_keeps_its_slot():
    net = _net()
    xs = _x(2, T, 5)
    full = net.output(xs).numpy()
    outs = [net.rnn_time_step(xs[:, t]).numpy() for t in range(6)]
    outs.append(net.rnn_time_step(xs[:, 6:]).numpy())
    _close(np.concatenate([np.stack(outs[:6], 1), outs[6]], 1), full,
           ULP_TOL)
    assert net.rnn_get_previous_state(0)[2] == T
    with pytest.raises(ValueError, match="batch size"):
        net.rnn_time_step(xs[:1, 0])
    ring = net.rnn_get_previous_state(0)
    net.rnn_clear_previous_state()
    assert net.rnn_get_previous_state(0) is None
    with pytest.raises(ValueError, match="rnn_time_step first"):
        net.rnn_set_previous_state(0, ring)
    net.rnn_time_step(xs[:1, 0])
    net.rnn_set_previous_state(1, ())


def test_stateless_step_matches_decode_step_and_takes_weights():
    net = _net()
    xs = _x(2, 6, 6)
    a, ca = net.rnn_stateless_step(None, xs)
    b, cb = net.decode_step(None, xs)
    assert torch.equal(a, b) and ca[0][2] == cb[0][2] == 6
    other = [{k: v * 0.5 for k, v in tree.items()} for tree in net.params]
    c, _ = net.decode_step(None, xs, params=other)
    assert not torch.allclose(c, b)
    with pytest.raises(ValueError, match="batch, time, features"):
        net.decode_step(None, xs[:, 0])


# ---- session management ----------------------------------------------------

def test_session_past_cache_len_raises_and_clear_recovers():
    net = _net(cache_len=8)
    cache = SessionCache(net, name="dec-over")
    rng = np.random.RandomState(9)
    for _ in range(8):
        cache.step("s", rng.randn(1, N_IN))
    with pytest.raises(SessionError, match="cache_len"):
        cache.step("s", rng.randn(1, N_IN))
    assert cache.session_position("s") == 8
    assert cache.clear("s")
    cache.step("s", rng.randn(1, N_IN))
    assert cache.session_position("s") == 1


def test_ttl_eviction_frees_ring_bytes():
    net = _net()
    cache = SessionCache(net, name="dec-ttl", ttl_s=0.05)
    rng = np.random.RandomState(11)
    cache.step("s", rng.randn(2, N_IN))
    held = cache.state_bytes()
    assert held > 0
    time.sleep(0.1)
    cache.step("other", rng.randn(1, N_IN))     # the sweep runs on acquire
    assert cache.get_carries("s") is None
    assert cache.state_bytes() < held
    snap = monitor.registry().snapshot()
    evictions = snap["serving_session_evictions_total"]["values"]
    assert any('reason="ttl"' in k and 'model="dec-ttl"' in k
               for k in evictions)
    gauge = snap["serving_session_state_bytes"]["values"]
    assert gauge['{model="dec-ttl"}'] == cache.state_bytes()


def test_capacity_lru_eviction():
    net = _net()
    cache = SessionCache(net, name="dec-lru", max_sessions=2, ttl_s=3600)
    rng = np.random.RandomState(6)
    cache.step("a", rng.randn(1, N_IN))
    cache.step("b", rng.randn(1, N_IN))
    cache.step("a", rng.randn(1, N_IN))         # touch: b is now LRU
    cache.step("c", rng.randn(1, N_IN))         # evicts b
    assert len(cache) == 2
    assert cache.get_carries("b") is None
    assert cache.get_carries("a") is not None
    assert monitor.counter("serving_session_evictions_total").value(
        model="dec-lru", reason="capacity") == 1


def test_batch_change_raises_and_clear_recovers():
    net = _net()
    cache = SessionCache(net, name="dec-guard")
    rng = np.random.RandomState(12)
    cache.step("s", rng.randn(2, N_IN))
    before = cache.get_carries("s")
    with pytest.raises(SessionStateError) as ei:
        cache.step("s", rng.randn(3, N_IN))
    assert ei.value.leaf_path == "[0][0]" and "[0][0]" in str(ei.value)
    assert cache.get_carries("s") is before     # stored state untouched
    assert cache.clear("s")
    cache.step("s", rng.randn(3, N_IN))


def test_failed_step_leaves_the_session_as_it_was():
    """A step that raises moves nothing: not the ring, the position or
    the bucket."""
    net = _net()
    cache = SessionCache(net, name="dec-fail")
    xs = _x(1, 4, 13)
    cache.step("s", xs)
    ring = cache.get_carries("s")[0][0].clone()
    with pytest.raises(RuntimeError):
        cache.step("s", np.zeros((1, 1, N_IN + 1)))   # wrong width
    assert cache.session_position("s") == 4
    assert cache.session_capacity("s") == 4
    assert torch.equal(cache.get_carries("s")[0][0], ring)


def test_cache_ladder_is_batch_ladder_over_cache_len():
    net = _net(cache_len=48)
    cache = SessionCache(net, name="dec-ladder")
    assert net.max_cache_len() == 48 and net.has_kv_ring()
    assert cache._cache_ladder == batch_ladder(48)
    assert cache._cache_ladder[-1] == 48


def test_layer_refuses_overflow_and_shrink():
    layer = CausalSelfAttention(n_in=N_IN, n_out=HIDDEN, n_heads=HEADS,
                                cache_len=4)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="cache_len"):
        layer.init_carry(1, torch.float64, cpu, cache_len=0)
    carry = layer.init_carry(1, torch.float64, cpu, cache_len=8)
    with pytest.raises(ValueError, match="shrink"):
        layer.grow_carry(carry, 4)
    assert layer.grow_carry(carry, 8) is carry
    net = _net(cache_len=4)
    with pytest.raises(ValueError, match="capacity"):
        net.decode_step(net._init_carries(1, cache_len=4),
                        np.zeros((1, 8, N_IN)))


# ---- LSTM sessions (the rnn_stateless_step route) ------------------------

def _lstm_pair(bidirectional=False):
    first = (jrec.GravesBidirectionalLSTM if bidirectional
             else jrec.GravesLSTM)(n_out=HIDDEN, activation="tanh")
    conf = (JaxConf.builder().seed(5).dtype("float64").list()
            .layer(first)
            .layer(jrec.GravesLSTM(n_out=8, activation="tanh"))
            .layer(JaxRnnOutput(n_out=N_OUT, activation="softmax",
                                loss="mcxent"))
            .set_input_type(jax_inputs.recurrent(N_IN, T)).build())
    jnet = JaxNet(conf).init()
    pnet = _port(conf)
    load_jax_params(pnet, np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def test_lstm_sessions_match_jax_leaf_paths_and_state_bytes():
    """The (h, c) leaves walk as ``jax.tree_util`` walks them: the same
    outputs, state bytes and offending leaf paths as the JAX package."""
    jnet, pnet = _lstm_pair()
    jcache, pcache = JaxCache(jnet, name="jax-lstm"), SessionCache(
        pnet, name="port-lstm")
    xs = _x(2, 5, 11)
    for chunk in (xs, xs[:, 0]):
        _close(pcache.step("s", chunk), jcache.step("s", chunk), JAX_TOL)
    _close(pcache.step("r", xs[:1, :3]), jcache.step("r", xs[:1, :3]),
           JAX_TOL)
    assert pcache.state_bytes() == jcache.state_bytes() == \
        (2 + 1) * 2 * (HIDDEN + 8) * 8
    assert pcache.session_capacity("s") == jcache.session_capacity("s") == 0
    errors = []
    for cache, err in ((jcache, JaxStateError), (pcache, SessionStateError)):
        with pytest.raises(err) as ei:
            cache.step("s", _x(3, 1, 12)[:, 0])
        errors.append(ei.value.leaf_path)
        with cache._lock:
            sess = cache._sessions["r"]
            sess.carries = [sess.carries[0][:1]] + list(sess.carries[1:])
        with pytest.raises(err) as ei:
            cache.step("r", xs[:1, 0])
        errors.append(ei.value.leaf_path)
    assert errors[:2] == errors[2:]
    assert errors[0] == "[0][0]"


def test_lstm_session_single_steps_match_output():
    """Two concurrent sessions through ``predict_session``: a 6-step
    prefill, then single steps, against ``output()`` of the whole
    sequence."""
    _, pnet = _lstm_pair()
    xs = _x(2, T, 13)
    full = pnet.output(xs).numpy()
    with InferenceEngine(pnet, name="lstm-sess") as eng:
        for row in range(2):
            sid, x = f"s{row}", xs[row:row + 1]
            outs = [eng.predict_session(sid, x[:, :6])]
            outs += [eng.predict_session(sid, x[:, t])[:, None]
                     for t in range(6, T)]
            _close(np.concatenate(outs, 1), full[row:row + 1], JAX_TOL)
        assert eng.sessions.session_position("s0") == T


def test_bidirectional_lstm_is_refused_by_sessions():
    jnet, pnet = _lstm_pair(bidirectional=True)
    for cache, net in ((JaxCache, jnet), (SessionCache, pnet)):
        with pytest.raises(ValueError, match="SessionCache"):
            cache(net)
