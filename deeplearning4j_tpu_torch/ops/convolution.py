"""Convolution, pooling and normalization primitives (port of
``deeplearning4j_tpu/ops/convolution.py``).

The JAX package lowers these through XLA (no Pallas kernel), so the port
uses PyTorch's own ops (cuDNN on the card) and keeps the JAX package's
semantics where PyTorch's differ:

- Layout: NHWC activations and HWIO kernels, as in the JAX package.  Each
  op permutes to NCHW/OIHW only around the ``F.conv2d``/pool call; an NHWC
  tensor permuted to NCHW has channels_last strides, so the permute is a
  view and cuDNN runs its NHWC kernels.
- SAME padding is XLA's: ``total = max((ceil(in/s) - 1) * s + eff_k - in,
  0)``, ``total // 2`` before and the rest after, padded explicitly
  (``F.conv2d(padding="same")`` rejects stride > 1, and torch's pool
  padding is symmetric).  Max pooling pads with -inf; average pooling under
  SAME divides by the count of real elements, under truncate by ``kh*kw``.
- pnorm pooling is ``(sum |x|^p)^(1/p)`` (``F.lp_pool2d`` has no ``|x|``).
- LRN sums ``x^2`` over a channel window padded ``(n//2, n-1-n//2)`` and
  scales by ``alpha`` itself (``F.local_response_norm`` divides alpha by n
  and pads even windows otherwise).
- Batch norm is E[x^2] - E[x]^2 clamped at 0, with f32 accumulation for
  bf16 inputs and the JAX package's fused backward
  (``BatchNormTrain``); ``F.batch_norm`` keeps another running variance.

On the CPU a bf16 conv runs in f32 and rounds once, as the JAX package's
CPU tier does; on the card cuDNN's bf16 convs accumulate in f32, and an
f32 conv runs in IEEE f32 forward and backward, not in cuDNN's default
TF32 (10-bit mantissa products), so an fp32 network on the card computes
what it does on the CPU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(x: Tensor, window: Tuple[int, int], stride: Tuple[int, int],
          padding: Tuple[int, int], mode: str) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) for NHWC ``x``."""
    if mode == "same":
        return (_same_pads(x.shape[1], window[0], stride[0])
                + _same_pads(x.shape[2], window[1], stride[1]))
    return (padding[0], padding[0], padding[1], padding[1])


def _pad_nhwc(x: Tensor, pads, value: float = 0.0) -> Tensor:
    t, b, l, r = pads
    if not any(pads):
        return x
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


def _ieee_f32():
    """cuDNN with TF32 off, its other flags as they are."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class _Conv2dF32(torch.autograd.Function):
    """``F.conv2d`` of f32 CUDA tensors with TF32 off in the forward and
    in both gradients (NCHW/OIHW, no bias)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation)
        with _ieee_f32():
            return F.conv2d(x, w, None, stride, padding, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation = ctx.conf
        with _ieee_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, dilation, False, (0, 0), 1,
                (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return dx, dw, None, None, None


def conv2d(x: Tensor, kernel: Tensor, stride: Tuple[int, int] = (1, 1),
           padding: Tuple[int, int] = (0, 0), mode: str = "truncate",
           dilation: Tuple[int, int] = (1, 1)) -> Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC.  ``mode`` "same" pads to
    ceil(in/stride) as XLA does; "truncate"/"strict" use ``padding`` on
    both sides."""
    stride, dilation = tuple(stride), tuple(dilation)
    eff = tuple(k + (k - 1) * (d - 1)
                for k, d in zip(kernel.shape[:2], dilation))
    t, b, l, r = _pads(x, eff, stride, tuple(padding), mode)
    if t == b and l == r:
        conv_pad = (t, l)
    else:
        x, conv_pad = _pad_nhwc(x, (t, b, l, r)), (0, 0)
    w = kernel.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        return _nhwc(_Conv2dF32.apply(_nchw(x), w, stride, conv_pad,
                                      dilation))
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        out = F.conv2d(_nchw(x).float(), w.float(), None, stride, conv_pad,
                       dilation)
        return _nhwc(out).to(x.dtype)
    return _nhwc(F.conv2d(_nchw(x), w, None, stride, conv_pad, dilation))


def conv_output_size(in_size: int, kernel: int, stride: int, padding: int,
                     mode: str, dilation: int = 1) -> int:
    """Spatial output size of a conv or pool along one dim."""
    eff_k = kernel + (kernel - 1) * (dilation - 1)
    if mode == "same":
        return -(-in_size // stride)  # ceil
    if mode == "strict":
        if (in_size + 2 * padding - eff_k) % stride != 0:
            raise ValueError(
                f"ConvolutionMode.Strict: size {in_size} with kernel "
                f"{kernel}, stride {stride}, padding {padding} does not "
                "divide exactly")
    return (in_size + 2 * padding - eff_k) // stride + 1


def _window_sum(x: Tensor, window, stride) -> Tensor:
    """Sum over each pooling window of padded NHWC ``x``."""
    return _nhwc(F.avg_pool2d(_nchw(x), window, stride, divisor_override=1))


def pool2d(x: Tensor, kind: str, window: Tuple[int, int],
           stride: Tuple[int, int], padding: Tuple[int, int] = (0, 0),
           mode: str = "truncate", pnorm: int = 2) -> Tensor:
    """2-D pooling over NHWC ``x``.  kinds: max | avg | sum | pnorm."""
    window, stride = tuple(window), tuple(stride)
    pads = _pads(x, window, stride, tuple(padding), mode)
    if kind == "max":
        xp = _pad_nhwc(x, pads, float("-inf"))
        return _nhwc(F.max_pool2d(_nchw(xp), window, stride))
    if kind in ("avg", "sum"):
        total = _window_sum(_pad_nhwc(x, pads), window, stride)
        if kind == "sum":
            return total
        if mode == "same":
            # average over the real (unpadded) elements of each window
            ones = torch.ones((1,) + tuple(x.shape[1:3]) + (1,),
                              dtype=x.dtype, device=x.device)
            return total / _window_sum(_pad_nhwc(ones, pads), window, stride)
        return total / (window[0] * window[1])
    if kind == "pnorm":
        powed = torch.pow(torch.abs(x), pnorm)
        total = _window_sum(_pad_nhwc(powed, pads), window, stride)
        return torch.pow(total, 1.0 / pnorm)
    raise ValueError(f"Unknown pooling kind '{kind}'")


# ---------------------------------------------------------------------------
# Batch normalization
# ---------------------------------------------------------------------------

def _bn_acc_dtype(x: Tensor) -> torch.dtype:
    """Statistics of bf16/f16 inputs accumulate in f32."""
    return (torch.float32 if x.dtype in (torch.bfloat16, torch.float16)
            else x.dtype)


def _bn_bshape(x: Tensor, axes: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(1 if i in axes else x.shape[i] for i in range(x.dim()))


def _bn_n(x: Tensor, axes: Tuple[int, ...]) -> int:
    n = 1
    for a in axes:
        n *= x.shape[a]
    return n


class BatchNormTrain(torch.autograd.Function):
    """Training-mode batch norm: ``(out, batch_mean, batch_var)``.

    Forward: one pass of sum(x) and sum(x^2) in the accumulation dtype,
    var = max(E[x^2] - E[x]^2, 0), the per-channel scale and shift folded
    in the accumulation dtype and applied as one multiply-add in x's
    dtype.  Backward: the JAX package's fused form, with f32-accumulated
    dgamma/dbeta, the exact terms of the returned mean and var, and the
    cotangent of a scalar gamma/beta (``lock_gamma_beta``) summed to a
    scalar."""

    @staticmethod
    def forward(ctx, x, gamma, beta, axes, eps):
        acc = _bn_acc_dtype(x)
        n = _bn_n(x, axes)
        s1 = torch.sum(x, dim=axes, dtype=acc)
        s2 = torch.sum(torch.square(x.to(acc)), dim=axes)
        mean = s1 / n
        var = torch.clamp_min(s2 / n - torch.square(mean), 0.0)
        inv = torch.rsqrt(var + eps)
        bshape = _bn_bshape(x, axes)
        g = gamma.to(acc)
        scale = (g * inv).reshape(bshape)
        shift = (beta.to(acc) - mean * g * inv).reshape(bshape)
        out = x * scale.to(x.dtype) + shift.to(x.dtype)
        ctx.save_for_backward(x, gamma, beta, mean, inv)
        ctx.axes = axes
        ctx.set_materialize_grads(False)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, dmean_ct, dvar_ct):
        x, gamma, beta, mean, inv = ctx.saved_tensors
        axes = ctx.axes
        acc = _bn_acc_dtype(x)
        n = _bn_n(x, axes)
        bshape = _bn_bshape(x, axes)
        if dy is None:
            dy = torch.zeros_like(x)
        xc = x - mean.reshape(bshape).to(x.dtype)
        x_hat = xc * inv.reshape(bshape).to(x.dtype)
        dbeta = torch.sum(dy, dim=axes, dtype=acc)
        dgamma = torch.sum(dy * x_hat, dim=axes, dtype=acc)
        scale = (gamma.to(acc) * inv).reshape(bshape)
        dx = (scale.to(x.dtype)
              * (dy - (dbeta / n).reshape(bshape).to(x.dtype)
                 - x_hat * (dgamma / n).reshape(bshape).to(x.dtype)))
        if dmean_ct is not None:
            dx = dx + (dmean_ct / n).reshape(bshape).to(x.dtype)
        if dvar_ct is not None:
            dx = dx + xc * (2.0 * dvar_ct / n).reshape(bshape).to(x.dtype)

        def reduce_to(d, primal):
            if d.shape != primal.shape:
                d = torch.sum(d).reshape(primal.shape)
            return d.to(primal.dtype)

        return (dx, reduce_to(dgamma, gamma), reduce_to(dbeta, beta),
                None, None)


def batch_norm_train(x: Tensor, gamma: Tensor, beta: Tensor,
                     axes: Sequence[int], eps: float
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Normalize over ``axes`` with batch statistics; returns (out,
    batch_mean, batch_var), the statistics in the accumulation dtype."""
    return BatchNormTrain.apply(x, gamma, beta, tuple(axes), float(eps))


def batch_norm_inference(x: Tensor, gamma: Tensor, beta: Tensor,
                         mean: Tensor, var: Tensor, eps: float) -> Tensor:
    """Normalize with running statistics; scale and shift are folded per
    channel in the accumulation dtype, then applied in x's dtype."""
    acc = _bn_acc_dtype(x)
    inv = torch.rsqrt(var.to(acc) + eps)
    scale = gamma.to(acc) * inv
    shift = beta.to(acc) - mean.to(acc) * scale
    return x * scale.to(x.dtype) + shift.to(x.dtype)


def local_response_normalization(x: Tensor, k: float, n: int, alpha: float,
                                 beta: float) -> Tensor:
    """Cross-channel LRN on NHWC: ``x / (k + alpha * sum_{window(n)}
    x_j^2)^beta``, the window over channels padded (n//2, n-1-n//2)."""
    half = n // 2
    sq = F.pad(torch.square(x), (half, n - 1 - half))
    summed = sq.unfold(-1, n, 1).sum(-1)
    return x / torch.pow(k + alpha * summed, beta)
