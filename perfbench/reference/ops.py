"""Plain PyTorch pieces the reference models share: SAME padding as XLA
pads it, convolution, batch norm, pooling, the softmax cross-entropy
score with its l2 term, the Nesterov momentum step in DL4J's order, and
the fp8 rounding that the control computes in.

Everything is float32 with TF32 off (``strict_fp32``), unless a
``quant`` format is named: then the layers' operands, results and
gradients are rounded to it (``q``), as a computation in that format
holds them, while statistics and the update stay in float32.  Tensors are NCHW
inside a model; weights are kept in the layouts the configurations
describe (convolution kernels HWIO, dense kernels (in, out)).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0     # largest finite float8_e4m3fn


def strict_fp32() -> None:
    """Float32 matrix products and convolutions in IEEE float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(t: torch.Tensor, fmt: str) -> torch.Tensor:
    """``t`` rounded to ``fmt`` and back: ``bf16``, or ``fp8``
    (float8_e4m3fn with one per-tensor scale, amax to 448)."""
    if fmt == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    amax = t.abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class _Rounded(torch.autograd.Function):
    """Rounds the value going forward and its gradient going back."""

    @staticmethod
    def forward(ctx, t, fmt):
        ctx.fmt = fmt
        return _round(t, fmt)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.fmt), None


def q(t: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """``t`` as a computation in ``quant`` (None: float32) holds it: each
    operand and result of a layer, and each gradient flowing back
    through it, rounded to that format."""
    return t if quant is None else _Rounded.apply(t, quant)


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int,
         quant: Optional[str] = None) -> torch.Tensor:
    """SAME convolution of NCHW ``x`` with an HWIO kernel."""
    kh, kw = w_hwio.shape[:2]
    t, b = same_pads(x.shape[2], kh, stride)
    l, r = same_pads(x.shape[3], kw, stride)
    w = q(w_hwio, quant).permute(3, 2, 0, 1)
    return q(F.conv2d(F.pad(q(x, quant), (l, r, t, b)), w, stride=stride),
             quant)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          quant: Optional[str] = None) -> torch.Tensor:
    y = q(x, quant) @ q(w, quant)
    return q(y if b is None else y + q(b, quant), quant)


def batch_norm(x: torch.Tensor, gamma, beta, mean, var, train: bool,
               eps: float, decay: float, quant: Optional[str] = None):
    """Batch norm over N, H, W.  Training normalises with the batch's
    mean and biased variance and returns the running statistics moved
    by ``decay``; inference uses the running statistics."""
    shape = (1, -1, 1, 1)
    if train:
        m = x.mean((0, 2, 3))
        v = (x - m.reshape(shape)).square().mean((0, 2, 3))
        new = (decay * mean + (1.0 - decay) * m.detach(),
               decay * var + (1.0 - decay) * v.detach())
    else:
        m, v, new = mean, var, (mean, var)
    y = (x - m.reshape(shape)) * torch.rsqrt(v.reshape(shape) + eps)
    return q(y * q(gamma, quant).reshape(shape)
             + q(beta, quant).reshape(shape), quant), new


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    t, b = same_pads(x.shape[2], k, s)
    l, r = same_pads(x.shape[3], k, s)
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), k, s)


def data_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the softmax cross-entropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(labels * logp).sum(-1).mean()


def l2_term(params: Dict, l2: Dict) -> torch.Tensor:
    """0.5 * l2 * ||w||^2 over the leaves that carry an l2 coefficient."""
    out = torch.zeros((), dtype=torch.float32,
                      device=next(iter(params.values())).device)
    for leaf, c in l2.items():
        if c:
            out = out + 0.5 * c * params[leaf].square().sum()
    return out


def nesterovs(params: Dict, velocity: Dict, grads: Dict, l2: Dict,
              lr: float, mu: float) -> None:
    """DL4J's Nesterov step in place: g += l2 * w; v' = mu v - lr g;
    w -= mu v - (1 + mu) v'."""
    with torch.no_grad():
        for leaf, g in grads.items():
            w, v = params[leaf], velocity[leaf]
            c = l2.get(leaf, 0.0)
            if c:
                g = g + c * w
            v_new = mu * v - lr * g
            w.sub_(mu * v - (1.0 + mu) * v_new)
            velocity[leaf] = v_new


def he_scale(shape) -> float:
    """sqrt(2 / fan_in) of a dense (in, out) or HWIO kernel."""
    fan_in = math.prod(shape[:-1])
    return math.sqrt(2.0 / fan_in)
