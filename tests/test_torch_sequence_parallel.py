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
of both packages on the same bf16 inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from deeplearning4j_tpu.ops.compat import shard_map as _shard_map
from deeplearning4j_tpu.parallel.sequence import (
    SequenceParallel as JaxSequenceParallel, _full_attention as jax_full,
    ring_flash_attention as jax_ring_flash)
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
