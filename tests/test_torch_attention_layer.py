"""The port's CausalSelfAttention (training tier on flash attention,
inference tier on the KV ring) and its ring ops, held against the JAX
package on the same params and inputs (numpy seed, float32 unless
stated).  Tolerances: 2e-5 for f32 forwards and 1e-4 for f32 gradients,
as in ``tests/test_flash_attention.py``; 1e-12 for the float64 ring
(f64 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers.attention import \
    CausalSelfAttention as JaxAttention
from deeplearning4j_tpu.ops.attention import (
    kv_ring_attention as jax_ring_attention, kv_ring_update as jax_ring_update)
from deeplearning4j_tpu_torch.nn.layers.attention import CausalSelfAttention
from deeplearning4j_tpu_torch.ops.attention import (kv_ring_attention,
                                                    kv_ring_update)

F32_FWD, F32_GRAD, F64 = 2e-5, 1e-4, 1e-12


def _layers(n_in=8, n_out=16, heads=2, cache_len=64):
    kw = dict(n_in=n_in, n_out=n_out, n_heads=heads, cache_len=cache_len,
              activation="identity")
    return JaxAttention(**kw), CausalSelfAttention(**kw)


def _params(layer, seed=1):
    rng = np.random.RandomState(seed)
    shapes = {"Wq": (layer.n_in, layer.n_out), "Wk": (layer.n_in, layer.n_out),
              "Wv": (layer.n_in, layer.n_out),
              "Wo": (layer.n_out, layer.n_out), "b": (layer.n_out,)}
    return {k: (0.3 * rng.randn(*s)).astype(np.float32)
            for k, s in shapes.items()}


def _x(b=2, t=40, n_in=8, seed=2):
    return np.random.RandomState(seed).randn(b, t, n_in).astype(np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("train", [True, False])
def test_forward_tiers_match_jax(train):
    jl, pl = _layers()
    p = _params(jl)
    x = _x()
    want, _ = jl.forward({k: jnp.asarray(v) for k, v in p.items()}, {},
                         jnp.asarray(x), train=train)
    got, _ = pl.forward({k: torch.from_numpy(v) for k, v in p.items()}, {},
                        torch.from_numpy(x), train=train)
    _close(got, want, F32_FWD)


def test_training_tier_gradients_match_jax():
    jl, pl = _layers()
    p = _params(jl)
    x = _x(t=33)

    def jloss(params, x):
        out, _ = jl.forward(params, {}, x, train=True)
        return jnp.sum(out ** 2)

    want = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = pl.forward(tp, {}, tx, train=True)
    (out ** 2).sum().backward()
    for name in p:
        _close(tp[name].grad, want[0][name], F32_GRAD)
    _close(tx.grad, want[1], F32_GRAD)


def test_masked_trailing_steps_are_zeroed_like_jax():
    jl, pl = _layers()
    p = _params(jl)
    x = _x(t=24)
    mask = np.ones((2, 24), np.float32)
    mask[1, 17:] = 0.0
    want, _ = jl.forward({k: jnp.asarray(v) for k, v in p.items()}, {},
                         jnp.asarray(x), train=True, mask=jnp.asarray(mask))
    got, _ = pl.forward({k: torch.from_numpy(v) for k, v in p.items()}, {},
                        torch.from_numpy(x), train=True,
                        mask=torch.from_numpy(mask))
    _close(got, want, F32_FWD)
    assert torch.all(got[1, 17:] == 0)


def test_chunked_forward_seq_matches_jax_and_full_sequence():
    """Two chunks through the ring carry = one full-sequence pass, in both
    packages."""
    jl, pl = _layers(cache_len=48)
    p = _params(jl)
    x = _x(t=40)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    carry = pl.init_carry(2, torch.float32, torch.device("cpu"))
    a, carry = pl.forward_seq(tp, torch.from_numpy(x[:, :25]), carry,
                              train=False)
    b, carry = pl.forward_seq(tp, torch.from_numpy(x[:, 25:]), carry,
                              train=False)
    assert carry[2] == 40
    jcarry = jl.init_carry(2, jnp.float32)
    ja, jcarry = jl.forward_seq(jp, jnp.asarray(x[:, :25]), jcarry,
                                train=False)
    jb, _ = jl.forward_seq(jp, jnp.asarray(x[:, 25:]), jcarry, train=False)
    _close(torch.cat([a, b], 1), np.concatenate([ja, jb], 1), F32_FWD)
    full, _ = pl.forward(tp, {}, torch.from_numpy(x), train=False)
    _close(torch.cat([a, b], 1), full, F32_FWD)


@pytest.mark.parametrize("cursor", [0, 5, 20])
def test_kv_ring_matches_jax_float64(cursor):
    rng = np.random.RandomState(cursor)
    B, H, C, d, t = 2, 2, 32, 8, 6
    k_cache, v_cache = (rng.randn(B, H, C, d) for _ in range(2))
    k_new, v_new = (rng.randn(B, H, t, d) for _ in range(2))
    q = rng.randn(B, t, H, d)
    jk, jv = jax_ring_update(jnp.asarray(k_cache), jnp.asarray(v_cache),
                             cursor, jnp.asarray(k_new), jnp.asarray(v_new))
    want = jax_ring_attention(jnp.asarray(q), jk, jv, cursor)
    tk, tv = kv_ring_update(torch.from_numpy(k_cache.copy()),
                            torch.from_numpy(v_cache.copy()), cursor,
                            torch.from_numpy(k_new), torch.from_numpy(v_new))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    got = kv_ring_attention(torch.from_numpy(q), tk, tv, cursor)
    assert got.dtype == torch.float64
    _close(got, want, F64)


def test_kv_ring_masked_slots_are_exact_zeros():
    """Stale values in slots past the cursor never reach the result: the
    -1e30 sentinel exps to exactly 0.0, so garbage there changes nothing,
    bit for bit."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(1, 4, 2, 8))
    k, v = (torch.from_numpy(rng.randn(1, 2, 16, 8)) for _ in range(2))
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 8:] = 1e3
    v2[:, :, 8:] = -1e3
    a = kv_ring_attention(q, k, v, 4)
    b = kv_ring_attention(q, k2, v2, 4)
    assert torch.equal(a, b)


def test_kv_ring_update_refuses_overflow():
    k = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="capacity"):
        kv_ring_update(k, k.clone(), 6, torch.ones(1, 1, 3, 4),
                       torch.ones(1, 1, 3, 4))
