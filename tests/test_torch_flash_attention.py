"""The port's flash attention (K1 forward in both modes, K4 partials, K2
dK/dV and K3 dQ in full and segment form, and the autograd Function around
them) held against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs the real Pallas kernel bodies in interpret mode, exactly as
``tests/test_flash_attention.py`` runs them.  Inputs come from a numpy
seed and go to both.  Tolerances: 2e-5 for the f32 forward and 1e-4 for
f32 gradients (the ones ``tests/test_flash_attention.py`` uses; both
sides accumulate in f32 in another order), 0.1 for bf16 inputs against
the f32 oracle, 2e-2 (about two bf16 ulps at |out| < 2) for bf16 against
the JAX kernel on the same bf16 inputs.

The plain twins also take ``operand_dtype=torch.bfloat16``, which rounds P
(and dS in K2/K3) as the tensor-core kernels do; those tests are the
port's own and state their tolerances.  Against the JAX package, whose
interpret-mode kernels run in exact f32, the rounded forward twin is held
at ``TC_F32_GAP``: one round-to-nearest moves each P element by at most
2^-8 of itself, independently, so an output element (a sum of such terms)
moves by about 2^-8/sqrt(3) = 2.3e-3 of its own size, and 1e-2 of the
largest element leaves a factor of 4 for the tail.  (The TPU kernel itself
rounds P to bf16 for its P V dot at its default precision on the MXU.)
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.attention import (
    _flash_forward, flash_attention as jax_flash,
    flash_attention_bwd as jax_bwd,
    flash_attention_partial as jax_partial)
from deeplearning4j_tpu.parallel.sequence import _full_attention
from deeplearning4j_tpu_torch.ops import attention as port
from deeplearning4j_tpu_torch.ops import kernel_build

F32_FWD, F32_GRAD, BF16_ORACLE, BF16_KERNEL = 2e-5, 1e-4, 0.1, 2e-2
TC_F32_GAP = 1e-2


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
                                   float(1.0 / np.sqrt(16)), "normalized",
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
    assert port.LAUNCHES == {"flash_fwd": 0, "flash_fwd_partials": 0,
                             "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}


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


# ------------------------------------------------------------ K4, segments
def _np(x):
    return np.array(x, np.float32)


@pytest.mark.parametrize("tq,tk", [(32, 16), (50, 24)])
@pytest.mark.parametrize("causal", [False, True])
def test_partial_matches_pallas_kernel(causal, tq, tk):
    """K4's plain version against the Pallas ``partials`` mode: acc, m and
    l of q against one K/V segment with Tk != Tq (ragged in both)."""
    rng = np.random.RandomState(3)
    q = rng.randn(1, tq, 2, 16).astype(np.float32)
    k, v = (rng.randn(1, tk, 2, 16).astype(np.float32) for _ in range(2))
    ref = jax_partial(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                      block_q=16, block_k=16)
    got = port.flash_attention_partial(*_t(q, k, v), causal=causal)
    for g, want in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == want.shape
        _close(g, want, F32_FWD)


def test_partial_merges_to_full():
    """Partials over two K/V halves merged by log-sum-exp equal full
    attention (the port's counterpart of the JAX test of that name)."""
    q, k, v = _qkv(t=32)
    tq, tk, tv = _t(q, k, v)
    o1, m1, l1 = port.flash_attention_partial(tq, tk[:, :16], tv[:, :16])
    o2, m2, l2 = port.flash_attention_partial(tq, tk[:, 16:], tv[:, 16:])
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    o = o1 * a1[..., None] + o2 * a2[..., None]
    l = l1 * a1 + l2 * a2
    ref = _full_attention(*(jnp.asarray(a) for a in (q, k, v)))
    _close(o / l[..., None], ref, F32_FWD)


def _global_stats(tq, tk, tv, tg):
    """The global logsumexp and D = rowsum(dO * out) from K4's partials
    over the whole sequence, as the ring forward leaves them."""
    acc, m, l = port.flash_attention_partial(tq, tk, tv)
    l_safe = torch.clamp_min(l, 1e-30)
    out = acc / l_safe[..., None]
    return m + torch.log(l_safe), (tg * out).sum(-1)


def test_segment_contributions_sum():
    """The segment backward over two K/V halves with the GLOBAL L and D
    sums to the full backward, and each segment matches the JAX package's
    segment backward (the port's counterpart of
    ``test_flash_bwd_segment_contributions_sum``)."""
    q, k, v = _qkv(t=32)
    g = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    tq, tk, tv, tg = _t(q, k, v, g)
    L, D = _global_stats(tq, tk, tv, tg)
    jq, jk, jv, jg, jL, jD = (jnp.asarray(_np(a))
                              for a in (q, k, v, g, L, D))
    kw = dict(causal=False, sm_scale=0.25)
    full = port.flash_attention_bwd(tq, tk, tv, None, L, tg, D_row=D, **kw)
    segs = [port.flash_attention_bwd(tq, tk[:, s], tv[:, s], None, L, tg,
                                     D_row=D, **kw)
            for s in (slice(0, 16), slice(16, 32))]
    _close(segs[0][0] + segs[1][0], full[0], F32_FWD)
    for j in (1, 2):
        _close(torch.cat([segs[0][j], segs[1][j]], dim=1), full[j], F32_FWD)
    for s, seg in zip((slice(0, 16), slice(16, 32)), segs):
        ref = jax_bwd(jq, jk[:, s], jv[:, s], None, jL, jg, block_q=16,
                      block_k=16, D_row=jD, **kw)
        for got, want in zip(seg, ref):
            _close(got, want, F32_FWD)


@pytest.mark.parametrize("tq,tk", [(32, 16), (24, 40)])
def test_segment_backward_local_causal(tq, tk):
    """Causal segment backward with Tk != Tq masks by local positions, as
    the Pallas ``_bwd_tile`` does."""
    rng = np.random.RandomState(4)
    q, g = (rng.randn(1, tq, 2, 8).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, tk, 2, 8).astype(np.float32) for _ in range(2))
    tq_, tk_, tv_, tg_ = _t(q, k, v, g)
    acc, m, l = port.flash_attention_partial(tq_, tk_, tv_, causal=True)
    L, D = m + torch.log(l), (tg_ * acc / l[..., None]).sum(-1)
    got = port.flash_attention_bwd(tq_, tk_, tv_, None, L, tg_,
                                   causal=True, sm_scale=0.3, D_row=D)
    ref = jax_bwd(*(jnp.asarray(_np(a)) for a in (q, k, v)), None,
                  jnp.asarray(_np(L)), jnp.asarray(g), causal=True,
                  sm_scale=0.3, block_q=8, block_k=8,
                  D_row=jnp.asarray(_np(D)))
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        _close(a, b, F32_GRAD)


def test_backward_keeps_an_f32_cotangent_with_bf16_inputs():
    """bf16 q/k/v with an f32 cotangent: D and the kernels' dO use g in
    f32, as the JAX package's ``g.astype(f32)`` does.  Rounding g to bf16
    first, as an earlier version did, misses 1e-4 by an order of
    magnitude."""
    q, k, v = _qkv(t=32, d=8)
    g = np.random.RandomState(5).randn(*q.shape).astype(np.float32)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    out, lse = _flash_forward(*jb, True, float(8 ** -0.5), 16, 16, True,
                              None, with_lse=True)
    ref = jax_bwd(*jb, out, lse, jnp.asarray(g), causal=True,
                  sm_scale=float(8 ** -0.5), block_q=16, block_k=16)
    tb = [torch.from_numpy(_np(a)).to(torch.bfloat16) for a in jb]
    tout = torch.from_numpy(_np(out)).to(torch.bfloat16)
    got = port.flash_attention_bwd(*tb, tout, torch.from_numpy(_np(lse)),
                                   torch.from_numpy(g), causal=True,
                                   sm_scale=float(8 ** -0.5))
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        _close(a, b, F32_GRAD)


def test_backward_needs_out_or_d_row():
    q = torch.zeros(1, 8, 1, 4)
    with pytest.raises(ValueError, match="D_row"):
        port.flash_attention_bwd(q, q, q, None, q[..., 0], q, causal=False,
                                 sm_scale=0.5)


def test_partial_rejects_mismatched_segments():
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="k/v shapes differ"):
        port.flash_attention_partial(q, q[:, :4], q)
    with pytest.raises(ValueError, match="batch/heads/d"):
        port.flash_attention_partial(q, q[:, :, :1], q[:, :, :1])


# ------------------------------------------- the twins' bf16 operands
def _grid(rng, shape):
    """Normal values on a grid of 1/8 in [-4, 4]: exact in bf16, and every
    S = Q K^T and dP = dO V^T sum exact in f32 whatever the order."""
    return (np.clip(np.round(rng.randn(*shape) * 8), -32, 32) / 8
            ).astype(np.float32)


def _twins_before_operand_rounding(q, k, v, g, L, D, causal, scale):
    """The plain K2/K3 arithmetic as it stood before ``operand_dtype``
    (64-key blocks, f32 throughout), op for op."""
    qf, kf, vf, dof = (x.float().permute(0, 2, 1, 3) for x in (q, k, v, g))
    Lr, Dr = (x.permute(0, 2, 1).unsqueeze(-1) for x in (L, D))
    dks, dvs, dq = [], [], torch.zeros_like(qf)
    for k0 in range(0, k.shape[1], 64):
        kb, vb = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        p = torch.exp((qf @ kb.transpose(-1, -2)) * scale - Lr)
        if causal:
            q_pos = torch.arange(qf.shape[2])[:, None]
            k_pos = torch.arange(k0, k0 + kb.shape[2])[None, :]
            p = torch.where(q_pos >= k_pos, p, 0.0)
        ds = p * (dof @ vb.transpose(-1, -2) - Dr) * scale
        dvs.append(p.transpose(-1, -2) @ dof)
        dks.append(ds.transpose(-1, -2) @ qf)
        dq = dq + ds @ kb
    back = lambda x: x.permute(0, 2, 1, 3).contiguous()
    return back(torch.cat(dks, dim=2)), back(torch.cat(dvs, dim=2)), back(dq)


def _segment_case(tq, tk, causal, seed, dtype=torch.float32, d=16):
    """Grid-valued q, k, v, dO (B=2, H=2) with the segment's own L and D
    from K4's plain partials; scale 0.3."""
    rng = np.random.RandomState(seed)
    q, g = (_grid(rng, (2, tq, 2, d)) for _ in range(2))
    k, v = (_grid(rng, (2, tk, 2, d)) for _ in range(2))
    tq_, tk_, tv_, tg_ = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    acc, m, l = port.flash_attention_partial(tq_, tk_, tv_, causal=causal,
                                             sm_scale=0.3)
    L = m + torch.log(l)
    D = (tg_.float() * acc / l[..., None]).sum(-1)
    return tq_, tk_, tv_, tg_, L, D


def _plain_twins(q, k, v, g, L, D, causal, scale, operand_dtype,
                 dq_block=64):
    dk, dv = port.flash_dkdv_plain(q, k, v, g, L, D, causal, scale,
                                   operand_dtype=operand_dtype)
    dq = port.flash_dq_plain(q, k, v, g, L, D, causal, scale,
                             block=dq_block, operand_dtype=operand_dtype)
    return dk, dv, dq


@pytest.mark.parametrize("tq,tk", [(50, 50), (50, 24), (37, 70)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_twins_default_operands_unchanged(causal, tq, tk):
    """``operand_dtype=None`` (the default) leaves the f32 twins bit for bit
    what they were, so the parity tests against the JAX package hold
    as before."""
    case = _segment_case(tq, tk, causal, seed=10)
    got = _plain_twins(*case, causal, 0.3, None)
    for a, b in zip(got, _twins_before_operand_rounding(*case, causal, 0.3)):
        assert torch.equal(a, b)


def _bf16_midpoint_ulp(x, rel=1e-5):
    """One bf16 ulp of each float64 element that lies within ``rel`` of a
    bf16 rounding midpoint, else 0: where a value computed in f32 (off by
    ~1e-6) may round to the neighbouring bf16."""
    mant, exp = torch.frexp(x.abs())           # |x| = mant * 2^exp
    r = mant * 256.0                           # |x| in bf16 ulps, [128, 256)
    near = (r - r.floor() - 0.5).abs() <= rel * r
    return torch.where(near & (x != 0), torch.ldexp(torch.ones_like(x),
                                                    exp - 8), 0.0)


def _float64_bwd_bf16_operands(q, k, v, g, L, D, causal, scale):
    """Dense float64 dK, dV, dQ with P and dS rounded to bf16, and for each
    the slack that the midpoint elements of P and dS allow (one bf16 ulp
    times the absolute other operand, summed)."""
    qd, kd, vd, gd = (x.double().permute(0, 2, 1, 3) for x in (q, k, v, g))
    Ld, Dd = (x.double().permute(0, 2, 1).unsqueeze(-1) for x in (L, D))
    p = torch.exp((qd @ kd.transpose(-1, -2)) * scale - Ld)
    if causal:
        tq, tk = p.shape[-2:]
        p = torch.where(torch.arange(tq)[:, None] >= torch.arange(tk)[None, :],
                        p, 0.0)
    ds = p * (gd @ vd.transpose(-1, -2) - Dd) * scale
    pb, dsb = (x.to(torch.bfloat16).double() for x in (p, ds))
    sp, sds = _bf16_midpoint_ulp(p), _bf16_midpoint_ulp(ds)
    back = lambda x: x.permute(0, 2, 1, 3)
    grads = (dsb.transpose(-1, -2) @ qd, pb.transpose(-1, -2) @ gd, dsb @ kd)
    slack = (sds.transpose(-1, -2) @ qd.abs(), sp.transpose(-1, -2) @ gd.abs(),
             sds @ kd.abs())
    return [back(x) for x in grads], [back(x) for x in slack]


@pytest.mark.parametrize("tq,tk", [(50, 50), (50, 24), (37, 70)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dq_block", [64, 128])
def test_plain_twins_bf16_operands_match_float64(dq_block, causal, tq, tk):
    """``operand_dtype=torch.bfloat16``: the twins equal dense float64 math
    with P and dS rounded to bf16, element by element within 1e-6 of
    max|ref| (f32 sums) plus the midpoint slack, ragged and Tk != Tq, with
    dQ summed over the key tiles of both bf16 K3 bodies at d <= 64 (64:
    mma.sync, 128: the Hopper body).  The f32 twins sit further away (the
    rounding is real) but within the 1e-2 of max|f32 twin| that the
    tensor-core kernels are held to."""
    case = _segment_case(tq, tk, causal, seed=12, dtype=torch.bfloat16)
    got = _plain_twins(*case, causal, 0.3, torch.bfloat16, dq_block)
    f32 = _plain_twins(*case, causal, 0.3, None, dq_block)
    ref, slack = _float64_bwd_bf16_operands(*case, causal, 0.3)
    for a, f, want, s in zip(got, f32, ref, slack):
        bound = 1e-6 * want.abs().max() + s
        assert ((a.double() - want).abs() <= bound).all()
        gap = (f.double() - want).abs()
        assert (gap > bound).any()
        assert (a - f).abs().max() <= 1e-2 * f.abs().max()


# ------------------------------------- the forward twin's bf16 operands
_MODES = ("normalized", "normalized_lse", "partials")


def _forward_case(tq, tk, seed, d=16):
    """q (2, tq, 2, d) and k, v (2, tk, 2, d) float32 on the grid of 1/8
    in [-4, 4]: exact in bf16, and every S sum exact in f32."""
    rng = np.random.RandomState(seed)
    q = _grid(rng, (2, tq, 2, d))
    k, v = (_grid(rng, (2, tk, 2, d)) for _ in range(2))
    return [torch.from_numpy(x) for x in (q, k, v)]


def _forward_before_operand_rounding(q, k, v, causal, scale, mode):
    """The plain K1/K4 arithmetic as it stood before ``operand_dtype``
    (64-key blocks, f32 throughout), op for op."""
    B, Tq, H, D = q.shape
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    m = torch.full((B, H, Tq, 1), -1e30)
    l = torch.zeros((B, H, Tq, 1))
    acc = torch.zeros((B, H, Tq, D))
    q_pos = torch.arange(Tq)[:, None]
    for k0 in range(0, k.shape[1], 64):
        kb, vb = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        s = (qf @ kb.transpose(-1, -2)) * scale
        if causal:
            k_pos = torch.arange(k0, k0 + kb.shape[2])[None, :]
            s = torch.where(q_pos >= k_pos, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alive = m_new > -1e30 / 2
        p = torch.where(alive, torch.exp(s - m_new), 0.0)
        corr = torch.where(alive, torch.exp(m - m_new), 0.0)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ vb
        m = m_new
    rows = lambda x: x[..., 0].permute(0, 2, 1).contiguous()
    if mode == "partials":
        return acc.permute(0, 2, 1, 3).contiguous(), rows(m), rows(l)
    denom = torch.clamp_min(l, 1e-30)
    out = (acc / denom).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return out if mode == "normalized" else (out, rows(m + torch.log(denom)))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("tq,tk", [(50, 50), (130, 130), (37, 70)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", _MODES)
def test_plain_forward_default_operands_unchanged(mode, causal, tq, tk):
    """``operand_dtype=None`` (the default) leaves the forward twin bit for
    bit what it was in all three modes, so the parity tests against the
    JAX package hold as before."""
    rng = np.random.RandomState(13)
    q = torch.from_numpy(rng.randn(2, tq, 2, 16).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(2, tk, 2, 16).astype(np.float32))
            for _ in range(2))
    got = port.flash_forward_plain(q, k, v, causal, 0.3, mode)
    want = _forward_before_operand_rounding(q, k, v, causal, 0.3, mode)
    for a, b in zip(_as_tuple(got), _as_tuple(want)):
        assert torch.equal(a, b)


def _float64_forward_bf16_operands(q, k, v, causal, scale, block):
    """Float64 streaming softmax over ``block``-key tiles with P rounded to
    bf16 (from the same running max) as the operand of P V, and the slack
    that the midpoint elements of P allow in acc (one bf16 ulp times |v|,
    carried through the same corrections).  (acc, m, l, slack) in the
    twin's layouts: (B, Tq, H, d) and (B, Tq, H)."""
    qd, kd, vd = (x.double().permute(0, 2, 1, 3) for x in (q, k, v))
    B, H, Tq, D = qd.shape
    m = torch.full((B, H, Tq, 1), -1e30, dtype=torch.float64)
    l = torch.zeros((B, H, Tq, 1), dtype=torch.float64)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float64)
    slack = torch.zeros_like(acc)
    for k0 in range(0, kd.shape[2], block):
        kb, vb = kd[:, :, k0:k0 + block], vd[:, :, k0:k0 + block]
        s = (qd @ kb.transpose(-1, -2)) * scale
        if causal:
            k_pos = torch.arange(k0, k0 + kb.shape[2])[None, :]
            s = torch.where(torch.arange(Tq)[:, None] >= k_pos, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alive = m_new > -1e30 / 2
        p = torch.where(alive, torch.exp(s - m_new), 0.0)
        corr = torch.where(alive, torch.exp(m - m_new), 0.0)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).double() @ vb
        slack = slack * corr + _bf16_midpoint_ulp(p) @ vb.abs()
        m = m_new
    rows = lambda x: x[..., 0].permute(0, 2, 1)
    return (acc.permute(0, 2, 1, 3), rows(m), rows(l),
            slack.permute(0, 2, 1, 3))


@pytest.mark.parametrize("tq,tk", [(50, 50), (130, 130), (37, 70),
                                   (150, 100)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [64, 128])
def test_plain_forward_bf16_operands_match_float64(block, causal, tq, tk):
    """``operand_dtype=torch.bfloat16``: acc, m, l (partials), out and lse
    (normalized_lse) and out (normalized) equal a float64 streaming
    softmax that rounds P to bf16 from the same running max, element by
    element within 1e-6 of max|ref| (f32 sums) plus the slack of P
    elements within 1e-5 of a bf16 rounding midpoint, ragged and Tk != Tq,
    over the key tiles of both bf16 kernel bodies (64: mma.sync, 128: the
    Hopper body).  The f32 twin sits further away (the rounding is real)
    but within ``TC_F32_GAP`` of its largest element."""
    q, k, v = _forward_case(tq, tk, seed=14)
    acc, m, l, slack = _float64_forward_bf16_operands(q, k, v, causal, 0.25,
                                                      block)
    denom = torch.clamp_min(l, 1e-30)[..., None]
    out, lse = acc / denom, m + torch.log(denom[..., 0])
    refs = {"partials": ((acc, slack), (m, 0.0), (l, 0.0)),
            "normalized_lse": ((out, slack / denom), (lse, 0.0)),
            "normalized": ((out, slack / denom),)}
    for mode, ref in refs.items():
        got = _as_tuple(port.flash_forward_plain(
            q, k, v, causal, 0.25, mode, block=block,
            operand_dtype=torch.bfloat16))
        f32 = _as_tuple(port.flash_forward_plain(q, k, v, causal, 0.25,
                                                 mode, block=block))
        for a, (want, s) in zip(got, ref):
            assert a.dtype == torch.float32 and a.shape == want.shape
            bound = 1e-6 * want.abs().max() + s
            assert ((a.double() - want).abs() <= bound).all(), mode
        gap = (f32[0].double() - ref[0][0]).abs()
        assert (gap > 1e-6 * ref[0][0].abs().max() + ref[0][1]).any()
        assert (got[0] - f32[0]).abs().max() <= \
            TC_F32_GAP * f32[0].abs().max()


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_bf16_operands_within_gap_of_pallas(causal):
    """The rounded forward twin against the Pallas kernels in interpret
    mode (exact f32): out and acc within ``TC_F32_GAP`` of max|ref|; lse,
    m and l, which rounding P does not touch, at the f32 tolerance.  K1 at
    T=100 (two 64-key tiles on the port's side, four 32-key tiles on the
    JAX side), K4 against a 70-key segment."""
    q, k, v = _qkv(t=100, seed=15)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out, lse = port.flash_forward_plain(*_t(q, k, v), causal, 0.25,
                                        "normalized_lse",
                                        operand_dtype=torch.bfloat16)
    ref_out, ref_lse = _flash_forward(jq, jk, jv, causal, 0.25, 32, 32,
                                      True, None, with_lse=True)
    ref_out = np.asarray(ref_out)
    assert np.abs(out.numpy() - ref_out).max() <= \
        TC_F32_GAP * np.abs(ref_out).max()
    _close(lse, ref_lse, F32_FWD)
    acc, m, l = port.flash_forward_plain(*_t(q, k[:, :70], v[:, :70]),
                                         causal, 0.25, "partials",
                                         operand_dtype=torch.bfloat16)
    r_acc, r_m, r_l = (np.asarray(x) for x in jax_partial(
        jq, jk[:, :70], jv[:, :70], causal=causal, sm_scale=0.25,
        block_q=32, block_k=32))
    assert np.abs(acc.numpy() - r_acc).max() <= \
        TC_F32_GAP * np.abs(r_acc).max()
    _close(m, r_m, F32_FWD)
    _close(l, r_l, F32_FWD)


# ------------------------------------------------- the kernels' bodies
_CSRC = Path(port.__file__).resolve().parent / "csrc"


def _constexpr(source: str, name: str) -> str:
    text = (_CSRC / source).read_text()
    found = re.findall(rf"constexpr int {name} = ([^;]+);", text)
    assert len(found) == 1, (source, name, found)
    return found[0]


def test_key_tiles_agree_with_the_cuda_sources():
    """``fwd_key_tile`` and ``bwd_key_tile`` (the ``block`` of the K1/K4
    and K3 twins) are the key tiles each body streams in the CUDA sources,
    read from their constexprs, so the twins and the kernels cannot drift
    apart; and the route codes the library returns (``FwdRoute``,
    ``BwdRoute``) index ``FWD_BODIES`` in order."""
    tile = int(_constexpr("flash_attention.cu", "TILE"))
    assert _constexpr("flash_attention.cu", "FWD_BK") == "TILE"
    sm90 = int(_constexpr("flash_fwd_sm90.cuh", "SM90_BK"))
    assert port.TILE == tile
    for d in (8, 32, 64, 96, 128):
        assert port.fwd_key_tile(d, "scalar") == tile
        assert port.fwd_key_tile(d, "tc") == tile
        assert port.fwd_key_tile(d, "sm90") == sm90 == 128
    # K3: the scalar body's TILE, the mma.sync body's TcCfg::BS and the
    # Hopper body's SM90_DQ_BK_D64 / _D128, by the d <= 64 and d = 128
    # buckets (the d <= 32 bucket runs the d <= 64 tiles)
    assert _constexpr("flash_attention.cu", "BS") == "DM <= 64 ? 64 : 32"
    dq_cfg = re.search(r"struct Sm90DqCfg \{.*?constexpr int BK = ([^;]+);",
                       (_CSRC / "flash_bwd_sm90.cuh").read_text(), re.S)
    assert dq_cfg.group(1) == "DM <= 64 ? SM90_DQ_BK_D64 : SM90_DQ_BK_D128"
    hopper = [int(_constexpr("flash_bwd_sm90.cuh", f"SM90_DQ_BK_D{dm}"))
              for dm in (64, 128)]
    for d, bucket in ((8, 0), (32, 0), (64, 0), (96, 1), (128, 1)):
        assert port.bwd_key_tile(d, "scalar") == tile
        assert port.bwd_key_tile(d, "tc") == (64, 32)[bucket]
        assert port.bwd_key_tile(d, "sm90") == hopper[bucket]
    assert hopper == [128, 64]
    text = (_CSRC / "flash_attention.cu").read_text()
    for enum, prefix in (("FwdRoute", "FWD"), ("BwdRoute", "BWD")):
        codes = re.search(rf"enum {enum} \{{([^}}]*)\}}", text).group(1)
        pairs = re.findall(rf"{prefix}_(\w+) = (\d+)", codes)
        assert {name.lower(): int(n) for name, n in pairs} == \
            {body: i for i, body in enumerate(port.FWD_BODIES)}
    for bad in (0, 129):
        with pytest.raises(ValueError):
            port.fwd_key_tile(bad, "sm90")
        with pytest.raises(ValueError):
            port.bwd_key_tile(bad, "sm90")


def test_reset_launches_zeroes_the_body_counts():
    port.BODY_LAUNCHES["flash_fwd"]["sm90"] = 3
    port.BODY_LAUNCHES["flash_fwd_partials"]["tc"] = 1
    port.BODY_LAUNCHES["flash_bwd_dkdv"]["sm90"] = 2
    port.BODY_LAUNCHES["flash_bwd_dq"]["scalar"] = 1
    port.LAUNCHES["flash_fwd"] = 3
    port.LAUNCHES["flash_bwd_dq"] = 1
    port.reset_launches()
    assert port.BODY_LAUNCHES == {
        name: {"scalar": 0, "tc": 0, "sm90": 0}
        for name in ("flash_fwd", "flash_fwd_partials", "flash_bwd_dkdv",
                     "flash_bwd_dq")}
    assert set(port.LAUNCHES.values()) == {0}


def test_library_hash_covers_every_csrc_file_and_the_flags(tmp_path,
                                                            monkeypatch):
    """An edited header under ``csrc/`` (not only the source nvcc is given)
    or other flags name another library, so a stale one is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text("// v1\n")
    monkeypatch.setattr(kernel_build, "CSRC", csrc)
    first = kernel_build.library_path("k.cu")
    assert first.name.startswith("k-") and first.suffix == ".so"
    assert kernel_build.library_path("k.cu") == first
    (csrc / "k.cuh").write_text("// v2\n")
    second = kernel_build.library_path("k.cu")
    assert second != first
    (csrc / "extra.cuh").write_text("// new\n")
    assert kernel_build.library_path("k.cu") != second
    third = kernel_build.library_path("k.cu")
    monkeypatch.setattr(kernel_build, "NVCC_FLAGS",
                        kernel_build.NVCC_FLAGS + ("-lineinfo",))
    assert kernel_build.library_path("k.cu") != third
