"""The port's flash attention (K1 forward in both modes, K2 dK/dV, K3 dQ,
and the autograd Function around them) held against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs the real Pallas kernel bodies in interpret mode, exactly as
``tests/test_flash_attention.py`` runs them.  Inputs come from a numpy
seed and go to both.  Tolerances: 2e-5 for the f32 forward and 1e-4 for
f32 gradients (the ones ``tests/test_flash_attention.py`` uses; both
sides accumulate in f32 in another order), 0.1 for bf16 inputs against
the f32 oracle, 2e-2 (about two bf16 ulps at |out| < 2) for bf16 against
the JAX kernel on the same bf16 inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.attention import (_flash_forward,
                                              flash_attention as jax_flash,
                                              flash_attention_bwd as jax_bwd)
from deeplearning4j_tpu.parallel.sequence import _full_attention
from deeplearning4j_tpu_torch.ops import attention as port

F32_FWD, F32_GRAD, BF16_ORACLE, BF16_KERNEL = 2e-5, 1e-4, 0.1, 2e-2


def _qkv(b=1, t=64, h=2, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_pallas_kernel(causal, with_lse):
    q, k, v = _qkv()
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    ref = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal, scale, 32, 32, True, None,
                         with_lse=with_lse)
    got = port.flash_forward(*_t(q, k, v), causal=causal, sm_scale=scale,
                             with_lse=with_lse)
    if with_lse:
        _close(got[0], ref[0], F32_FWD)
        _close(got[1], ref[1], F32_FWD)
        assert got[1].dtype == torch.float32
        assert tuple(got[1].shape) == q.shape[:3]
    else:
        _close(got, ref, F32_FWD)


@pytest.mark.parametrize("block", [32, 64])
def test_forward_ragged_length(block):
    """T=50 with 32-blocks on the JAX side: the port's k-blocks of
    ``block`` slice the ragged tail instead of padding it."""
    q, k, v = _qkv(t=50)
    ref = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                    block_q=32, block_k=32)
    got = port.flash_forward_plain(*_t(q, k, v), True,
                                   float(1.0 / np.sqrt(16)), False,
                                   block=block)
    _close(got, ref, F32_FWD)


def test_forward_head_dim_24():
    q, k, v = _qkv(t=32, d=24)
    ref = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), block_q=16,
                    block_k=16)
    got = port.flash_attention(*_t(q, k, v), device="cpu")
    _close(got, ref, F32_FWD)


def test_forward_bf16_inputs():
    q, k, v = _qkv(t=32)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = port.flash_attention(qb, kb, vb, causal=True, device="cpu")
    assert got.dtype == torch.bfloat16
    oracle = _full_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=True)
    _close(got.float(), oracle, BF16_ORACLE)
    jb = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (qb, kb, vb)]
    kernel = jax_flash(*jb, causal=True, block_q=16, block_k=16)
    _close(got.float(), np.asarray(kernel, np.float32), BF16_KERNEL)


@pytest.mark.parametrize("t", [32, 50])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_kernels_match_pallas(causal, t):
    """K2 (dK/dV) and K3 (dQ) vs the fused Pallas backward, on the JAX
    forward's own out and logsumexp."""
    q, k, v = _qkv(t=t, d=8)
    g = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    scale = float(1.0 / np.sqrt(8))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out, lse = _flash_forward(jq, jk, jv, causal, scale, 16, 16, True, None,
                              with_lse=True)
    ref = jax_bwd(jq, jk, jv, out, lse, jnp.asarray(g), causal=causal,
                  sm_scale=scale, block_q=16, block_k=16)
    tq, tk, tv, tg = _t(q, k, v, g)
    tout = torch.from_numpy(np.array(out))
    tlse = torch.from_numpy(np.array(lse))
    Drow = (tg * tout).sum(-1)
    dk, dv = port.flash_dkdv(tq, tk, tv, tg, tlse, Drow, causal=causal,
                             sm_scale=scale)
    dq = port.flash_dq(tq, tk, tv, tg, tlse, Drow, causal=causal,
                       sm_scale=scale)
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == torch.float32
        _close(got, want, F32_GRAD)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad(causal):
    q, k, v = _qkv(t=32, d=8)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, block_q=16,
                                 block_k=16) ** 2)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    loss = (port.flash_attention(tq, tk, tv, causal=causal,
                                 device="cpu") ** 2).sum()
    loss.backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        _close(got, want, F32_GRAD)


def test_autograd_bf16_casts_grads_to_input_dtype():
    q, k, v = _qkv(t=32, d=8)
    tq, tk, tv = (x.to(torch.bfloat16).requires_grad_() for x in _t(q, k, v))
    port.flash_attention(tq, tk, tv, causal=True,
                         device="cpu").float().sum().backward()
    assert all(x.grad.dtype == torch.bfloat16 for x in (tq, tk, tv))
    ref = jax.grad(lambda q, k, v: jnp.sum(_full_attention(
        q, k, v, causal=True)), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        _close(got.float(), want, BF16_ORACLE)


def test_no_grad_forward_is_normalized_mode():
    """Without a gradient the wrapper runs K1's plain normalized mode;
    it equals the lse mode's output."""
    q, k, v = _t(*_qkv(t=40))
    plain = port.flash_attention(q, k, v, causal=True, device="cpu")
    out, _ = port.flash_forward(q, k, v, causal=True, sm_scale=0.25,
                                with_lse=True)
    torch.testing.assert_close(plain, out, rtol=0, atol=0)


def test_cpu_path_counts_no_launch():
    port.reset_launches()
    q, k, v = (x.requires_grad_() for x in _t(*_qkv(t=16, d=8)))
    port.flash_attention(q, k, v, causal=True, device="cpu").sum().backward()
    assert port.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                             "flash_bwd_dq": 0}


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    refuses what it cannot launch instead of falling back."""
    q = torch.empty((1, 16, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        port.flash_forward(q, q, q, causal=True, sm_scale=0.3,
                           with_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        port.flash_dq(q, q, q, q, q[..., 0], q[..., 0], causal=True,
                      sm_scale=0.3)
