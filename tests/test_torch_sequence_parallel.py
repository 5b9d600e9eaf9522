"""The port's sequence parallelism (ring, Ulysses and ring flash attention
over a list of shards) held against the JAX package's ``shard_map``
versions on 4 virtual CPU devices.

The port runs its 4-shard ring on ``devices=["cpu"] * 4``, where the
kernel wrappers take their plain versions; the JAX side runs the Pallas
kernels in interpret mode, as ``tests/test_flash_attention.py`` runs them.
Inputs come from a numpy seed and go to both.  Tolerances: 2e-5 for f32
outputs and 1e-4 for f32 gradients (those of
``tests/test_flash_attention.py``: both sides accumulate in f32, in
another order), 2e-2 (about two bf16 ulps at |out| < 2) for bf16 outputs
of both packages on the same bf16 inputs.  The ring LSTM scan is held in
float64 at 1e-10 and with bf16 inputs and f32 weights (f32 compute) at
1e-5, against the JAX ring and against the port's one-device
``lstm_scan``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.ops.compat import shard_map as _shard_map
from deeplearning4j_tpu.parallel.sequence import (
    SequenceParallel as JaxSequenceParallel, _full_attention as jax_full,
    ring_flash_attention as jax_ring_flash, ring_lstm_scan as jax_ring_lstm)
from deeplearning4j_tpu_torch.nn import activations as act
from deeplearning4j_tpu_torch.nn.layers.recurrent import lstm_scan
from deeplearning4j_tpu_torch.ops import attention as A
from deeplearning4j_tpu_torch.parallel import sequence as S

N = 4
F32_FWD, F32_GRAD, BF16 = 2e-5, 1e-4, 2e-2


def _qkv(b=2, t=32, h=2, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _cpu_ring():
    return S.SequenceParallel(devices=["cpu"] * N)


def _jax_ring_flash(causal):
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(N), ("seq",))
    return _shard_map(
        functools.partial(jax_ring_flash, axis_name="seq", causal=causal,
                          block_q=8, block_k=8),
        mesh=mesh, in_specs=(P(None, "seq"),) * 3,
        out_specs=P(None, "seq"))


def _port_grads(fn, q, k, v):
    tq, tk, tv = _t(q, k, v, grad=True)
    (fn(tq, tk, tv) ** 2).sum().backward()
    return tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_forward_matches_jax(causal):
    q, k, v = _qkv()
    ref = jax.jit(_jax_ring_flash(causal))(*map(jnp.asarray, (q, k, v)))
    got = _cpu_ring().attention(*_t(q, k, v), causal=causal,
                                impl="ring_flash")
    assert got.shape == q.shape and got.dtype == torch.float32
    _close(got.detach(), ref, F32_FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_gradients_match_jax(causal):
    """The fused ring backward (q packages travelling, K2/K3 in segment
    form) against JAX's custom VJP of the same ring."""
    q, k, v = _qkv(t=16, d=8)
    rf = _jax_ring_flash(causal)
    ref = jax.jit(jax.grad(lambda q, k, v: jnp.sum(rf(q, k, v) ** 2),
                           argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    sp = _cpu_ring()
    got = _port_grads(lambda q, k, v: sp.attention(
        q, k, v, causal=causal, impl="ring_flash"), q, k, v)
    for a, b in zip(got, ref):
        _close(a, b, F32_GRAD)


def test_ring_flash_bf16_matches_jax():
    q, k, v = _qkv()
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    ref = jax.jit(_jax_ring_flash(True))(*jb)
    tb = [torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
          for a in jb]
    got = _cpu_ring().attention(*tb, causal=True, impl="ring_flash")
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(ref, np.float32), BF16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_ring_and_ulysses_match_jax(impl, causal):
    q, k, v = _qkv(t=32, h=4, d=8)
    jsp = JaxSequenceParallel(devices=jax.devices()[:N])
    jargs = list(map(jnp.asarray, (q, k, v)))
    ref = jsp.attention(*jargs, causal=causal, impl=impl)
    ref_grads = jax.grad(lambda q, k, v: jnp.sum(
        jsp.attention(q, k, v, causal=causal, impl=impl) ** 2),
        argnums=(0, 1, 2))(*jargs)
    sp = _cpu_ring()
    fn = lambda q, k, v: sp.attention(q, k, v, causal=causal, impl=impl)
    _close(fn(*_t(q, k, v)), ref, F32_FWD)
    for a, b in zip(_port_grads(fn, q, k, v), ref_grads):
        _close(a, b, F32_GRAD)


def test_flash_impl_matches_jax():
    q, k, v = _qkv(t=48)
    got = _cpu_ring().attention(*_t(q, k, v), causal=True, impl="flash")
    _close(got, jax_full(*map(jnp.asarray, (q, k, v)), causal=True),
           F32_FWD)


@pytest.mark.parametrize("causal,steps", [(True, 10), (False, 16)])
def test_ring_flash_schedule(monkeypatch, causal, steps):
    """One 4-shard fwd+bwd runs K4 and the segment backward once per ring
    step that sees a key, and skips the rest: causal, 4 diagonal steps
    plus 6 fully visible ones (the 6 masked ones launch nothing)."""
    calls = {"partial": [], "bwd": []}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name].append(kw["causal"])
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(S, "flash_attention_partial",
                        counted("partial", S.flash_attention_partial))
    monkeypatch.setattr(S, "flash_attention_bwd",
                        counted("bwd", S.flash_attention_bwd))
    q, k, v = _t(*_qkv(t=16, d=8), grad=True)
    _cpu_ring().attention(q, k, v, causal=causal,
                          impl="ring_flash").sum().backward()
    for name in calls:
        assert len(calls[name]) == steps
        assert sum(calls[name]) == (N if causal else 0)


def test_cpu_ring_launches_no_kernel():
    A.reset_launches()
    q, k, v = _t(*_qkv(t=16, d=8), grad=True)
    _cpu_ring().attention(q, k, v, causal=True,
                          impl="ring_flash").sum().backward()
    assert set(A.LAUNCHES.values()) == {0}


def test_sequence_parallel_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        S.SequenceParallel()
    with pytest.raises(RuntimeError, match="CUDA"):
        S.SequenceParallel(devices=["cuda"] * 2)


def test_sequence_parallel_rejects_bad_calls():
    sp = _cpu_ring()
    q = torch.zeros(1, 30, 4, 8)
    with pytest.raises(ValueError, match="not divisible by 4 seq shards"):
        sp.attention(q, q, q, impl="ring_flash")
    with pytest.raises(ValueError, match="unknown impl"):
        sp.attention(q, q, q, impl="tree")
    q = torch.zeros(1, 32, 2, 8)
    with pytest.raises(ValueError, match="heads=2 not divisible"):
        sp.attention(q, q, q, impl="ulysses")
    with pytest.raises(ValueError, match="one q, k and v shard"):
        S.ring_flash_attention([q], [q, q], [q])


# ------------------------------------------------------------ ring LSTM
LSTM_F64, LSTM_F32 = 1e-10, 1e-5


def _close_lstm(got, want, tol):
    """Within ``tol`` of max|want|, compared in float64."""
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _lstm_inputs(b, t, n_in, H, seed, dtype=np.float64, carry=True):
    rng = np.random.RandomState(seed)
    W = (rng.randn(n_in, 4 * H) * 0.3).astype(dtype)
    RW = (rng.randn(H, 4 * H + 3) * 0.3).astype(dtype)
    bias = (rng.randn(4 * H) * 0.1).astype(dtype)
    x = rng.randn(b, t, n_in).astype(dtype)
    hc = [(rng.randn(b, H) if carry else np.zeros((b, H))).astype(dtype)
          for _ in range(2)]
    return W, RW, bias, x, hc, rng


def _jax_ring_lstm(masked=False):
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(N), ("seq",))
    in_specs = (P(), P(), P(), P(None, "seq"), P())
    return _shard_map(
        functools.partial(jax_ring_lstm, afn=jact.get("tanh"),
                          gate_fn=jact.get("sigmoid"), axis_name="seq"),
        mesh=mesh, in_specs=in_specs + ((P(None, "seq"),) if masked else ()),
        out_specs=(P(None, "seq"), P()))


def _port_ring_lstm(W, RW, bias, x, hc, mask=None):
    masks = None if mask is None else list(mask.chunk(N, 1))
    outs, finals = S.ring_lstm_scan(
        W, RW, bias, list(x.chunk(N, 1)), tuple(hc), masks,
        afn=act.get("tanh"), gate_fn=act.get("sigmoid"))
    return torch.cat(outs, 1), finals


def _serial(W, RW, bias, x, hc, mask=None):
    return lstm_scan(W, RW, bias, x, tuple(hc), afn=act.get("tanh"),
                     gate_fn=act.get("sigmoid"), mask=mask)


@pytest.mark.parametrize("masked", [False, True])
def test_ring_lstm_scan_matches_jax_and_serial(masked):
    """4 shards of a 24-step sequence from a nonzero carry: outputs and
    the global final (h, c), returned on every shard, against the JAX
    ring and the one-device scan; masked steps hold state and emit
    zeros."""
    W, RW, bias, x, hc, rng = _lstm_inputs(3, 24, 5, 7, seed=1)
    mask = (rng.rand(3, 24) > 0.3).astype(np.float64) if masked else None
    jargs = [jnp.asarray(a) for a in (W, RW, bias, x)] + \
        [tuple(jnp.asarray(a) for a in hc)]
    if masked:
        jargs.append(jnp.asarray(mask))
    jout, jfinal = jax.jit(_jax_ring_lstm(masked))(*jargs)
    targs = _t(W, RW, bias, x)
    tmask = None if mask is None else torch.from_numpy(mask)
    out, finals = _port_ring_lstm(*targs, _t(*hc), tmask)
    ref_out, ref_final = _serial(*targs, _t(*hc), tmask)
    _close_lstm(out, jout, LSTM_F64)
    np.testing.assert_array_equal(out.numpy(), ref_out.numpy())
    assert len(finals) == N
    for final in finals:
        for got, jwant, want in zip(final, jfinal, ref_final):
            _close_lstm(got, jwant, LSTM_F64)
            assert torch.equal(got, want)
    if masked:
        assert np.all(out.numpy()[mask == 0] == 0.0)


def test_ring_lstm_scan_mixed_precision():
    """bf16 inputs and carry with f32 weights: the carry is promoted to
    f32 once, in both packages, and the ring agrees with the one-device
    scan."""
    W, RW, bias, x, _, _ = _lstm_inputs(2, 16, 4, 6, seed=4, carry=False,
                                        dtype=np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    zeros = (jnp.zeros((2, 6), jnp.bfloat16),) * 2
    jout, _ = jax.jit(_jax_ring_lstm())(jnp.asarray(W), jnp.asarray(RW),
                                        jnp.asarray(bias), xb, zeros)
    tx = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    tzeros = [torch.zeros(2, 6, dtype=torch.bfloat16)] * 2
    out, finals = _port_ring_lstm(*_t(W, RW, bias), tx, tzeros)
    ref_out, _ = _serial(*_t(W, RW, bias), tx, tzeros)
    assert out.dtype == finals[0][0].dtype == torch.float32
    _close_lstm(out, jout, LSTM_F32)
    _close_lstm(out, ref_out, LSTM_F32)


def test_ring_lstm_grads_match_jax_and_serial():
    """Backprop through the ring (each shard's chain recomputed in the
    backward pass) equals the JAX ring's gradients and the one-device
    scan's."""
    W, RW, bias, x, hc, _ = _lstm_inputs(2, 8, 3, 4, seed=3, carry=False)
    ring = _jax_ring_lstm()
    jx, jhc = jnp.asarray(x), tuple(jnp.asarray(a) for a in hc)
    jgrads = jax.jit(jax.grad(
        lambda W, RW, b: jnp.sum(ring(W, RW, b, jx, jhc)[0] ** 2),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (W, RW, bias)))
    params = _t(W, RW, bias, grad=True)
    out, _ = _port_ring_lstm(*params, *_t(x), _t(*hc))
    grads = torch.autograd.grad((out ** 2).sum(), params)
    ref_out, _ = _serial(*params, *_t(x), _t(*hc))
    ref_grads = torch.autograd.grad((ref_out ** 2).sum(), params)
    for got, jwant, want in zip(grads, jgrads, ref_grads):
        _close_lstm(got, jwant, LSTM_F64)
        _close_lstm(got, want, LSTM_F64)


def test_ring_lstm_scan_needs_a_mask_per_shard():
    W, RW, bias, x, hc, _ = _lstm_inputs(1, 8, 3, 4, seed=0)
    xs = list(torch.from_numpy(x).chunk(N, 1))
    with pytest.raises(ValueError, match="one mask per shard"):
        S.ring_lstm_scan(*_t(W, RW, bias), xs, _t(*hc),
                         [torch.ones(1, 2)] * 3, afn=act.get("tanh"),
                         gate_fn=act.get("sigmoid"))
