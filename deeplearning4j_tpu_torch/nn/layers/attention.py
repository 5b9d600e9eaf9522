"""Causal decoder self-attention with a KV-cache ring (port of
``deeplearning4j_tpu/nn/layers/attention.py``).

Two forward tiers, as in the JAX package:

- **training** (``train=True``): ``flash_attention(causal=True)``, the
  hand-written CUDA kernels K1 (forward, lse mode) and K2/K3 (backward) on
  the card, their plain versions on the CPU.  The ring never materializes.
- **inference** (``train=False`` / ``forward_seq``): the ring-dense path
  ``ops.attention.kv_ring_attention`` with exact cursor masking, from a
  zero ring, so a full-sequence ``output()`` rides the same math as
  decode.

Params: Wq/Wk/Wv (n_in, n_out), Wo (n_out, n_out), b (n_out,), used as
``x @ W``; the output projection applies the layer activation (default
identity).

The ring is the layer's carry under the ``BaseRecurrentLayer`` contract,
so ``MultiLayerNetwork.decode_step``, ``serving.SessionCache`` and the
``serving.InferenceEngine`` session route decode over it; ``grow_carry``
pads a ring up to the next bucket of the serving cache-len ladder.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ...ops.attention import (flash_attention, kv_ring_attention,
                              kv_ring_update)
from ..conf import serde
from ..weights import init_weights
from .base import ParamTree, Tensor
from .recurrent import BaseRecurrentLayer


@serde.register("causal_attention")
@dataclasses.dataclass
class CausalSelfAttention(BaseRecurrentLayer):
    """Multi-head causal self-attention over (batch, time, features).

    ``n_heads`` must divide ``n_out``; ``cache_len`` is the ring capacity
    of the inference state (training is not bounded by it).  Carry:
    ``(k_cache, v_cache, cursor)`` with K/V (batch, n_heads, cache_len,
    head_dim) and an integer cursor = tokens already written.  The cursor
    is a host ``int``: a device scalar would cost a sync on every token,
    and the session layer tracks the position on the host anyway."""

    HAS_KV_RING = True

    activation: str = "identity"
    n_heads: int = 1
    cache_len: int = 128

    def _head_dim(self) -> int:
        if self.n_out <= 0 or self.n_heads <= 0 \
                or self.n_out % self.n_heads:
            raise ValueError(
                f"n_heads={self.n_heads} must divide n_out={self.n_out}")
        return self.n_out // self.n_heads

    def param_order(self) -> tuple:
        return ("Wq", "Wk", "Wv", "Wo", "b")

    def init_params(self, gen, dtype, device) -> ParamTree:
        self._head_dim()
        wi = self.weight_init or "xavier"
        shapes = {"Wq": (self.n_in, self.n_out), "Wk": (self.n_in, self.n_out),
                  "Wv": (self.n_in, self.n_out),
                  "Wo": (self.n_out, self.n_out)}
        params = {name: init_weights(gen, shape, wi, self.dist, dtype, device)
                  for name, shape in shapes.items()}
        params["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0),
                                 dtype=dtype, device=device)
        return params

    # -------------------------------------------------------------- carry
    def init_carry(self, batch: int, dtype, device,
                   cache_len: Optional[int] = None):
        cap = int(cache_len if cache_len is not None else self.cache_len)
        if cap < 1:
            raise ValueError("cache_len must be >= 1")
        shape = (batch, self.n_heads, cap, self._head_dim())
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device), 0)

    def grow_carry(self, carry, cache_len: int):
        """Zero-pad the ring's cache axis up to ``cache_len``, cursor
        unchanged: the serving bucket hop.  Slots past the cursor are
        masked to exact zeros, so growth never changes a result."""
        k_cache, v_cache, cursor = carry
        cap = k_cache.shape[2]
        if cache_len < cap:
            raise ValueError(
                f"cannot shrink KV ring from {cap} to {cache_len}")
        if cache_len == cap:
            return carry
        pad = (0, 0, 0, cache_len - cap)
        return (F.pad(k_cache, pad), F.pad(v_cache, pad), cursor)

    # ------------------------------------------------------------ forward
    def _project(self, params: ParamTree, x: Tensor):
        b, t = x.shape[0], x.shape[1]
        h, dh = self.n_heads, self._head_dim()
        q = (x @ params["Wq"]).reshape(b, t, h, dh)
        k = (x @ params["Wk"]).reshape(b, t, h, dh)
        v = (x @ params["Wv"]).reshape(b, t, h, dh)
        return q, k, v

    def _finish(self, params: ParamTree, ctx: Tensor, x: Tensor,
                mask: Optional[Tensor]):
        b, t = x.shape[0], x.shape[1]
        out = self._activate(
            ctx.reshape(b, t, self.n_out) @ params["Wo"] + params["b"])
        if mask is not None:
            # trailing time pad: causal queries never see later keys, so
            # zeroing padded outputs is the whole masking story
            out = out * mask[..., None].to(out.dtype)
        return out

    def forward_seq(self, params: ParamTree, x: Tensor, carry, *,
                    train: bool, rng=None, mask: Optional[Tensor] = None):
        k_cache, v_cache, cursor = carry
        t, cap = x.shape[1], k_cache.shape[2]
        if t > cap:
            raise ValueError(
                f"chunk of {t} timesteps exceeds the KV ring capacity "
                f"{cap}; raise cache_len")
        x = self.apply_dropout(x, train, rng)
        q, k, v = self._project(params, x)
        k_cache, v_cache = kv_ring_update(
            k_cache, v_cache, cursor, k.transpose(1, 2), v.transpose(1, 2))
        ctx = kv_ring_attention(q, k_cache, v_cache, cursor)
        out = self._finish(params, ctx, x, mask)
        return out, (k_cache, v_cache, int(cursor) + t)

    def forward(self, params: ParamTree, state, x: Tensor, *,
                train: bool, rng=None, mask=None):
        if train:
            x = self.apply_dropout(x, train, rng)
            q, k, v = self._project(params, x)
            ctx = flash_attention(q, k, v, causal=True, device=x.device)
            return self._finish(params, ctx, x, mask), state
        carry = self.init_carry(x.shape[0], x.dtype, x.device,
                                max(self.cache_len, x.shape[1]))
        out, _ = self.forward_seq(params, x, carry, train=False, rng=rng,
                                  mask=mask)
        return out, state
