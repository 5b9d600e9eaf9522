"""Decoder layers of a hybrid language model (LFM2-MoE, Liquid AI's
``Lfm2MoeForCausalLM``): a token embedding over (batch, time) ids,
pre-norm residual blocks (gated short convolution, grouped-query
attention, a dense SwiGLU and a sparse mixture of SwiGLU experts), the
final RMSNorm and a softmax head trained on index labels.

Every block is one layer of a ``MultiLayerNetwork`` over (batch, time,
hidden) activations that applies its own pre-norm and residual:
``y = x + f(RMSNorm(x) * norm)``, with ``RMSNorm(x) = x * rsqrt(mean(x^2)
+ eps)`` whose statistics are taken in float32.  Kernels are ``(n_in,
n_out)``, used as ``x @ W``; expert kernels stack the experts first.

- :class:`ShortConvBlock` (``conv`` layers): ``[B, C, x~] =
  split3(x W_in)``, ``v`` the causal depthwise convolution of ``B * x~``
  over time (``conv`` holds the taps, (L, hidden): output t reads inputs
  t-L+1 .. t, tap L-1 on t), out ``(C * v) W_out``;
- :class:`GroupedQueryAttentionBlock` (``full_attention`` layers): q, k,
  v projections of ``n_heads``, ``n_kv_heads`` and ``n_kv_heads`` heads,
  each head RMS-normed (``q_norm``, ``k_norm``), RoPE in the rotate-half
  form over the whole head, causal softmax at 1/sqrt(head_dim) with each
  group of ``n_heads / n_kv_heads`` query heads on one KV head.  K and V
  are expanded to the query heads and go through ``ops.attention.
  flash_attention``: K1 (lse mode) and K2/K3 when training, K1
  (normalized) without a gradient; autograd folds dK and dV back onto
  the KV heads;
- :class:`SwiGLUBlock`: ``(silu(x W1) * x W3) W2``;
- :class:`MoEBlock`: ``ops.moe``'s sigmoid router with the
  non-trainable ``expert_bias`` (layer state, moving the choice only),
  top-k, weights normalized over the chosen, and the experts as grouped
  GEMMs, dropless.  The layer state also holds ``expert_tokens``, the
  int64 count of tokens routed to each expert by training steps, added
  to inside the step, so a captured step counts on every replay; the
  host reads it only when asked (``monitor/moe.py``).  The route, the
  experts and the combine run in ``moe/route``, ``moe/experts`` and
  ``moe/combine`` spans on eager steps (a replayed graph runs no Python).

Decoding through carried state (the convolution's last L-1 inputs beside
the KV ring) is not built: ``output()`` runs whole sequences.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ... import monitor as _monitor
from ...ops import moe as _moe
from ...ops.attention import flash_attention
from .. import lossfunctions as _losses
from ..conf import serde
from ..weights import init_weights
from .base import BaseLayerConfig, ParamTree, StateTree, Tensor
from .core import EmbeddingLayer


def rms_norm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, in float32,
    returned in ``x``'s dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rope(x: Tensor, theta: float) -> Tensor:
    """Rotary position embedding, rotate-half form, over the whole head
    of (batch, time, heads, d) ``x``, positions 0..T-1, in float32."""
    t, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] \
        * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)[None, :, None, :]
    xf = x.float()
    half = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    return (xf * torch.cos(ang) + half * torch.sin(ang)).to(x.dtype)


def causal_depthwise(u: Tensor, taps: Tensor) -> Tensor:
    """Per-channel causal convolution of (batch, time, channels) ``u``
    with (L, channels) ``taps``: out[t] = sum_j taps[j] u[t - L + 1 + j]
    (zeros before the start), accumulated in float32."""
    n, t = taps.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, n - 1, 0))
    acc = up[:, 0:t].float() * taps[0].float()
    for j in range(1, n):
        acc = acc + up[:, j:j + t].float() * taps[j].float()
    return acc.to(u.dtype)


def _ones(n: int, dtype, device) -> Tensor:
    return torch.ones((n,), dtype=dtype, device=device)


@serde.register("sequence_embedding")
@dataclasses.dataclass
class SequenceEmbedding(EmbeddingLayer):
    """Token ids (batch, time) -> rows of ``W`` (n_in = vocabulary,
    n_out), no bias.  Integer ids skip the network's compute-dtype cast,
    so no id is rounded."""

    def param_order(self) -> tuple:
        return ("W",)

    def init_params(self, gen, dtype, device) -> ParamTree:
        return {"W": init_weights(gen, (self.n_in, self.n_out),
                                  self.weight_init or "xavier", self.dist,
                                  dtype, device)}

    def forward(self, params, state, x, *, train, rng=None, mask=None):
        return params["W"][x.long()], state


@serde.register("rms_norm")
@dataclasses.dataclass
class RMSNormLayer(BaseLayerConfig):
    """RMSNorm over the last axis of width ``n_in``, weight ``w`` from
    ones."""

    n_in: int = 0
    eps: float = 1e-5

    INPUT_KIND = "any"

    def output_type(self, input_type):
        return input_type

    def param_order(self) -> tuple:
        return ("w",)

    def init_params(self, gen, dtype, device) -> ParamTree:
        return {"w": _ones(self.n_in, dtype, device)}

    def forward(self, params, state, x, *, train, rng=None, mask=None):
        return rms_norm(x, params["w"], self.eps), state


@dataclasses.dataclass
class _PreNormResidual(BaseLayerConfig):
    """``y = x + mix(RMSNorm(x) * norm)`` over (batch, time, n_in);
    subclasses give ``mix`` and their kernels (``_kernels``: name ->
    shape)."""

    n_in: int = 0
    eps: float = 1e-5

    INPUT_KIND = "any"

    def output_type(self, input_type):
        return input_type

    def _kernels(self) -> dict:
        raise NotImplementedError

    def _vectors(self) -> dict:
        """Leaves that start at ones (norm weights), name -> width."""
        return {"norm": self.n_in}

    def param_order(self) -> tuple:
        return tuple(self._vectors()) + tuple(self._kernels())

    def init_params(self, gen, dtype, device) -> ParamTree:
        out = {k: _ones(n, dtype, device)
               for k, n in self._vectors().items()}
        wi = self.weight_init or "xavier"
        for k, shape in self._kernels().items():
            out[k] = init_weights(gen, shape, wi, self.dist, dtype, device)
        return out

    def mix(self, params: ParamTree, h: Tensor) -> Tensor:
        raise NotImplementedError

    def forward(self, params, state, x, *, train, rng=None, mask=None):
        return x + self.mix(params, rms_norm(x, params["norm"],
                                             self.eps)), state


@serde.register("short_conv_block")
@dataclasses.dataclass
class ShortConvBlock(_PreNormResidual):
    """LFM2's gated short convolution (``conv_L_cache`` = ``kernel``
    taps, no biases)."""

    kernel: int = 3

    def _kernels(self) -> dict:
        d = self.n_in
        return {"W_in": (d, 3 * d), "conv": (self.kernel, d),
                "W_out": (d, d)}

    def mix(self, params, h):
        b, c, x = (h @ params["W_in"]).chunk(3, dim=-1)
        v = causal_depthwise(b * x, params["conv"])
        return (c * v) @ params["W_out"]


@serde.register("gqa_attention_block")
@dataclasses.dataclass
class GroupedQueryAttentionBlock(_PreNormResidual):
    """Causal grouped-query attention with per-head QK RMSNorm and RoPE,
    no biases."""

    n_heads: int = 1
    n_kv_heads: int = 1
    head_dim: int = 0
    rope_theta: float = 10000.0

    def _check(self) -> None:
        if (self.head_dim <= 0 or self.n_kv_heads <= 0
                or self.n_heads % self.n_kv_heads):
            raise ValueError(f"n_kv_heads={self.n_kv_heads} must divide "
                             f"n_heads={self.n_heads}, head_dim > 0")

    def _vectors(self) -> dict:
        return {"norm": self.n_in, "q_norm": self.head_dim,
                "k_norm": self.head_dim}

    def _kernels(self) -> dict:
        self._check()
        d, q, kv = (self.n_in, self.n_heads * self.head_dim,
                    self.n_kv_heads * self.head_dim)
        return {"Wq": (d, q), "Wk": (d, kv), "Wv": (d, kv), "Wo": (q, d)}

    def mix(self, params, h):
        b, t = h.shape[0], h.shape[1]
        hd, rep = self.head_dim, self.n_heads // self.n_kv_heads
        q = (h @ params["Wq"]).reshape(b, t, self.n_heads, hd)
        k = (h @ params["Wk"]).reshape(b, t, self.n_kv_heads, hd)
        v = (h @ params["Wv"]).reshape(b, t, self.n_kv_heads, hd)
        q = rope(rms_norm(q, params["q_norm"], self.eps), self.rope_theta)
        k = rope(rms_norm(k, params["k_norm"], self.eps), self.rope_theta)
        ctx = flash_attention(q, k.repeat_interleave(rep, dim=2),
                              v.repeat_interleave(rep, dim=2), causal=True,
                              device=h.device)
        return ctx.reshape(b, t, self.n_heads * hd) @ params["Wo"]


@serde.register("swiglu_block")
@dataclasses.dataclass
class SwiGLUBlock(_PreNormResidual):
    """Dense SwiGLU feed-forward of width ``width``."""

    width: int = 0

    def _kernels(self) -> dict:
        return {"W1": (self.n_in, self.width), "W3": (self.n_in, self.width),
                "W2": (self.width, self.n_in)}

    def mix(self, params, h):
        return (F.silu(h @ params["W1"]) * (h @ params["W3"])) @ params["W2"]


@serde.register("moe_block")
@dataclasses.dataclass
class MoEBlock(_PreNormResidual):
    """Sparse mixture of ``n_experts`` SwiGLU experts of width ``width``,
    ``top_k`` a token, sigmoid router with ``expert_bias``, weights
    normalized over the chosen and scaled by ``routed_scaling_factor``."""

    width: int = 0
    n_experts: int = 1
    top_k: int = 1
    routed_scaling_factor: float = 1.0

    def _kernels(self) -> dict:
        d, f, e = self.n_in, self.width, self.n_experts
        return {"router": (d, e), "w1": (e, d, f), "w3": (e, d, f),
                "w2": (e, f, d)}

    def init_params(self, gen, dtype, device) -> ParamTree:
        # an expert's kernel has the fans of one expert's (d, f)
        out = {"norm": _ones(self.n_in, dtype, device)}
        wi = self.weight_init or "xavier"
        for k, shape in self._kernels().items():
            parts = [init_weights(gen, shape[1:], wi, self.dist, dtype,
                                  device) for _ in range(shape[0])] \
                if len(shape) == 3 else None
            out[k] = (torch.stack(parts) if parts else
                      init_weights(gen, shape, wi, self.dist, dtype, device))
        return out

    def init_state(self, dtype, device) -> StateTree:
        e = self.n_experts
        return {"expert_bias": torch.zeros((e,), dtype=torch.float32,
                                           device=device),
                "expert_tokens": torch.zeros((e,), dtype=torch.long,
                                             device=device)}

    def forward(self, params, state, x, *, train, rng=None, mask=None):
        b, t, d = x.shape
        h = rms_norm(x, params["norm"], self.eps).reshape(b * t, d)
        with _monitor.span("moe/route", tokens=b * t):
            weights, experts = _moe.route(
                h, params["router"], state["expert_bias"], self.top_k,
                self.routed_scaling_factor)
            order, counts, offs = _moe.permute(experts, self.n_experts)
        with _monitor.span("moe/experts", slots=b * t * self.top_k):
            # each token's row once per slot, then in expert order: the
            # backward sums a token's slots in a reduction, not by atomics
            slots = h.unsqueeze(1).expand(-1, self.top_k, -1).reshape(-1, d)
            ys = _moe.expert_products(slots.index_select(0, order),
                                      params["w1"], params["w3"],
                                      params["w2"], offs)
        with _monitor.span("moe/combine"):
            y = _moe.combine(ys, order, weights)
        if train:
            state = dict(state,
                         expert_tokens=state["expert_tokens"] + counts)
        return x + y.reshape(b, t, d), state


@serde.register("lm_head")
@dataclasses.dataclass
class LMHeadLayer(BaseLayerConfig):
    """Softmax head over the vocabulary, ``W`` (n_in, n_out), no bias,
    trained on integer labels (batch, time) with ``sparse_mcxent``; the
    score is the mean over the labelled tokens (present tokens under a
    mask).  The logits reach the loss in float32."""

    n_in: int = 0
    n_out: int = 0
    activation: str = "softmax"
    loss: str = "sparse_mcxent"

    INPUT_KIND = "any"

    def output_type(self, input_type):
        return input_type

    def param_order(self) -> tuple:
        return ("W",)

    def init_params(self, gen, dtype, device) -> ParamTree:
        return {"W": init_weights(gen, (self.n_in, self.n_out),
                                  self.weight_init or "xavier", self.dist,
                                  dtype, device)}

    def pre_output(self, params, x):
        return x @ params["W"]

    def forward(self, params, state, x, *, train, rng=None, mask=None):
        return self._activate(self.pre_output(params, x)), state

    def compute_score(self, labels, preout, mask: Optional[Tensor] = None,
                      average: bool = True) -> Tensor:
        total = self.compute_score_examples(labels, preout, mask).sum()
        if not average:
            return total
        if mask is None:
            return total / labels.numel()
        return total / torch.clamp_min(mask.to(total.dtype).sum(), 1.0)

    def compute_score_examples(self, labels, preout, mask=None) -> Tensor:
        return _losses.score_examples(self.loss, labels, preout,
                                      self.activation, mask)


__all__ = ["GroupedQueryAttentionBlock", "LMHeadLayer", "MoEBlock",
           "RMSNormLayer", "SequenceEmbedding", "ShortConvBlock",
           "SwiGLUBlock", "causal_depthwise", "rms_norm", "rope"]
