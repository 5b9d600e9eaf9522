"""The convolution primitives of the port (``ops/convolution.py``) against
the JAX package's, on the same seeded numpy inputs: conv2d over kernel,
stride, dilation and the three modes (odd inputs with stride 2 included),
every pooling kind x mode, batch norm forward and backward (against
``jax.grad`` of the JAX ``batch_norm_train``) in f32 and bf16, LRN at
n = 4 and 5, and the HWIO fans of the weight initializer.

Tolerances: f64 1e-10 relative to max|JAX| (the same arithmetic summed in
another order); f32 1e-5 of max|JAX|; bf16 inputs: 2^-7 relative plus
1e-2 of max|JAX| (both sides round to bf16 once per result, and a
one-ulp flip of a bf16 output is 2^-8 of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import weights as jax_weights
from deeplearning4j_tpu.ops import convolution as jconv
from deeplearning4j_tpu_torch.nn import weights
from deeplearning4j_tpu_torch.ops import convolution as conv

TOL = {np.float64: 1e-10, np.float32: 1e-5}


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _rand(shape, seed, dtype=np.float64):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode,kernel,stride,padding,dilation,hw", [
    ("truncate", (3, 3), (1, 1), (0, 0), (1, 1), (8, 8)),
    ("truncate", (5, 3), (2, 1), (1, 2), (1, 1), (11, 9)),
    ("truncate", (3, 3), (1, 1), (1, 1), (2, 2), (9, 10)),
    ("same", (3, 3), (1, 1), (0, 0), (1, 1), (8, 8)),
    ("same", (3, 3), (2, 2), (0, 0), (1, 1), (7, 9)),
    ("same", (4, 2), (2, 3), (0, 0), (1, 1), (9, 11)),
    ("same", (3, 3), (1, 1), (0, 0), (2, 2), (7, 7)),
    ("same", (1, 1), (2, 2), (0, 0), (1, 1), (5, 5)),
    ("strict", (3, 3), (2, 2), (1, 1), (1, 1), (9, 9)),
])
def test_conv2d_matches_jax(dtype, mode, kernel, stride, padding, dilation,
                            hw):
    x = _rand((2,) + hw + (3,), 0, dtype)
    k = _rand(kernel + (3, 4), 1, dtype)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(k), stride, padding,
                        mode, dilation)
    got = conv.conv2d(torch.as_tensor(x), torch.as_tensor(k), stride,
                      padding, mode, dilation)
    _close(got, want, TOL[dtype])
    assert tuple(got.shape[1:3]) == tuple(
        conv.conv_output_size(hw[i], kernel[i], stride[i], padding[i], mode,
                              dilation[i]) for i in range(2))


def test_conv2d_gradients_match_jax():
    x, k = _rand((2, 7, 9, 3), 2), _rand((3, 3, 3, 4), 3)
    g = _rand((2, 4, 5, 4), 4)
    args = ((2, 2), (0, 0), "same", (1, 1))
    jdx, jdk = jax.grad(lambda a, b: jnp.sum(
        jconv.conv2d(a, b, *args) * g), argnums=(0, 1))(jnp.asarray(x),
                                                        jnp.asarray(k))
    tx, tk = (torch.tensor(a, requires_grad=True) for a in (x, k))
    (conv.conv2d(tx, tk, *args) * torch.as_tensor(g)).sum().backward()
    _close(tx.grad, jdx, 1e-10)
    _close(tk.grad, jdk, 1e-10)


def test_conv2d_bf16_rounds_once_like_jax():
    x = _rand((2, 9, 9, 3), 5, np.float32)
    k = _rand((3, 3, 3, 8), 6, np.float32)
    want = jconv.conv2d(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(k, jnp.bfloat16), (2, 2), (0, 0), "same")
    got = conv.conv2d(torch.as_tensor(x).bfloat16(),
                      torch.as_tensor(k).bfloat16(), (2, 2), (0, 0), "same")
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-2 * np.abs(want).max())


def test_conv_output_size_strict_raises_like_jax():
    with pytest.raises(ValueError, match="Strict"):
        conv.conv_output_size(10, 3, 2, 0, "strict")
    with pytest.raises(ValueError, match="Strict"):
        jconv.conv_output_size(10, 3, 2, 0, "strict")
    for args in [(9, 3, 2, 0, "strict"), (10, 3, 2, 0, "same"),
                 (10, 3, 3, 1, "truncate", 2)]:
        assert conv.conv_output_size(*args) == jconv.conv_output_size(*args)


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("mode,window,stride,padding,hw", [
    ("truncate", (2, 2), (2, 2), (0, 0), (8, 8)),
    ("truncate", (3, 2), (2, 1), (1, 1), (9, 7)),
    ("same", (2, 2), (2, 2), (0, 0), (7, 9)),
    ("same", (3, 3), (2, 2), (0, 0), (9, 9)),
    ("same", (3, 3), (1, 1), (0, 0), (6, 5)),
])
def test_pool2d_matches_jax(kind, mode, window, stride, padding, hw):
    x = _rand((2,) + hw + (3,), 7)
    want = jconv.pool2d(jnp.asarray(x), kind, window, stride, padding, mode,
                        pnorm=3)
    got = conv.pool2d(torch.as_tensor(x), kind, window, stride, padding,
                      mode, pnorm=3)
    _close(got, want, 1e-10)


@pytest.mark.parametrize("kind", ["max", "avg", "pnorm"])
def test_pool2d_gradients_match_jax(kind):
    x, g = _rand((2, 7, 9, 3), 8), _rand((2, 4, 5, 3), 9)
    args = (kind, (3, 3), (2, 2), (0, 0), "same", 2)
    want = jax.grad(lambda a: jnp.sum(jconv.pool2d(a, *args) * g))(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    (conv.pool2d(tx, *args) * torch.as_tensor(g)).sum().backward()
    _close(tx.grad, want, 1e-10)


def _bn_inputs(dtype, seed=10, shape=(4, 5, 6, 3)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    gamma = rng.rand(shape[-1]).astype(np.float32) + 0.5
    beta = rng.randn(shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    wm, wv = rng.randn(2, shape[-1]).astype(np.float32)
    return x, gamma, beta, g, wm, wv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_forward_and_backward_match_jax(dtype):
    x, gamma, beta, g, wm, wv = _bn_inputs(dtype)
    axes = (0, 1, 2)
    jdt = jnp.dtype(dtype)

    def jloss(a, ga, be):
        out, mean, var = jconv.batch_norm_train(a, ga, be, axes, 1e-5)
        return (jnp.sum(out.astype(jnp.float32) * g) + jnp.sum(mean * wm)
                + jnp.sum(var * wv)), (out, mean, var)

    jargs = (jnp.asarray(x, jdt), jnp.asarray(gamma, jdt),
             jnp.asarray(beta, jdt))
    (_, (jout, jmean, jvar)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*jargs)
    tdt = getattr(torch, dtype)
    targs = [torch.tensor(a).to(tdt).requires_grad_()
             for a in (x, gamma, beta)]
    out, mean, var = conv.batch_norm_train(*targs, axes, 1e-5)
    assert out.dtype == tdt and mean.dtype == var.dtype == torch.float32
    ((out.float() * torch.as_tensor(g)).sum()
     + (mean * torch.as_tensor(wm)).sum()
     + (var * torch.as_tensor(wv)).sum()).backward()
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    if dtype == "float32":
        for got, want in [(out, jout), (mean, jmean), (var, jvar)] + list(
                zip([t.grad for t in targs], jgrads)):
            _close(got.detach(), f32(want), 1e-5)
        return
    _close(mean.detach(), f32(jmean), 1e-6)
    _close(var.detach(), f32(jvar), 1e-6)
    for got, want in [(out, jout)] + list(zip([t.grad for t in targs],
                                              jgrads)):
        assert got.dtype == torch.bfloat16
        want = f32(want)
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=2.0 ** -7,
                                   atol=1e-2 * np.abs(want).max())


def test_batch_norm_scalar_gamma_beta_collapse_like_jax():
    x, _, _, g, _, _ = _bn_inputs("float32", seed=11)
    axes = (0, 1, 2)

    def jloss(a, ga, be):
        return jnp.sum(jconv.batch_norm_train(a, ga, be, axes, 1e-5)[0] * g)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(1.5, jnp.float32),
        jnp.asarray(0.2, jnp.float32))
    targs = [torch.tensor(a, dtype=torch.float32).requires_grad_()
             for a in (x, 1.5, 0.2)]
    (conv.batch_norm_train(*targs, axes, 1e-5)[0]
     * torch.as_tensor(g)).sum().backward()
    for t, want in zip(targs, jgrads):
        assert t.grad.shape == tuple(np.shape(want))
        _close(t.grad, want, 1e-5)


def test_batch_norm_inference_matches_jax():
    x, gamma, beta, _, wm, wv = _bn_inputs("float32", seed=12)
    var = np.abs(wv) + 0.1
    want = jconv.batch_norm_inference(*(jnp.asarray(a) for a in
                                        (x, gamma, beta, wm, var)), 1e-5)
    got = conv.batch_norm_inference(*(torch.as_tensor(a) for a in
                                      (x, gamma, beta, wm, var)), 1e-5)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("n", [4, 5])
def test_lrn_matches_jax(n):
    x = _rand((2, 4, 5, 7), 13)
    args = (2.0, n, 1e-2, 0.75)
    want = jconv.local_response_normalization(jnp.asarray(x), *args)
    got = conv.local_response_normalization(torch.as_tensor(x), *args)
    _close(got, want, 1e-10)
    g = _rand((2, 4, 5, 7), 14)
    jdx = jax.grad(lambda a: jnp.sum(
        jconv.local_response_normalization(a, *args) * g))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    (conv.local_response_normalization(tx, *args)
     * torch.as_tensor(g)).sum().backward()
    _close(tx.grad, jdx, 1e-10)


@pytest.mark.parametrize("shape", [(5, 7), (3, 3, 4, 8), (5, 5, 1, 20),
                                   (2, 3, 6, 7, 9)])
def test_fans_match_jax_for_dense_and_hwio(shape):
    assert weights._fans(shape) == jax_weights._fans(shape)
    if len(shape) == 4:
        kh, kw, cin, cout = shape
        assert weights._fans(shape) == (kh * kw * cin, kh * kw * cout)


def test_xavier_conv_kernel_scale_follows_hwio_fans():
    gen = torch.Generator().manual_seed(0)
    w = weights.init_weights(gen, (5, 5, 20, 50), "xavier")
    std = np.sqrt(2.0 / (25 * 20 + 25 * 50))
    assert abs(float(w.std()) / std - 1.0) < 0.02


def test_ieee_f32_conv_function_matches_f_conv2d():
    """The f32 conv the card runs with TF32 off computes, forward and
    backward, what ``F.conv2d`` and its autograd do (here on the CPU)."""
    import torch.nn.functional as F
    x = torch.tensor(_rand((2, 3, 9, 8), 15, np.float32), requires_grad=True)
    w = torch.tensor(_rand((4, 3, 3, 3), 16, np.float32), requires_grad=True)
    args = ((2, 1), (1, 0), (1, 2))
    out = conv._Conv2dF32.apply(x, w, *args)
    want = F.conv2d(x, w, None, *args)
    g = torch.as_tensor(_rand(tuple(out.shape), 17, np.float32))
    for a, b in zip(torch.autograd.grad(out, (x, w), g),
                    torch.autograd.grad(want, (x, w), g)):
        assert torch.equal(a, b)
    assert torch.equal(out, want)
