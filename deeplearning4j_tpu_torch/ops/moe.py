"""Mixture-of-experts routing and the grouped expert products.

A sparse MoE layer (LFM2-MoE's, ``nn/layers/decoder.py``
``MoEBlock``) sends each token to ``top_k`` of ``n_experts`` SwiGLU
experts and sums their outputs with the router's weights.  The layer is
dropless: every token reaches every expert it chose, so the rows each
expert takes vary from step to step while their total, ``tokens *
top_k``, does not.  Nothing here reads a device value on the host, so
a step that routes is captured as one CUDA graph (``nn/step_graph.py``)
and replayed with fresh routing each time:

- :func:`route`: ``s = sigmoid(x W_r)`` in float32, the choice
  ``topk(s + expert_bias)`` (the bias moves the choice only), the weights
  ``s`` at the chosen experts over their sum (+ 1e-6), times the scaling
  factor;
- :func:`permute`: the ``tokens * top_k`` slots sorted by expert
  (``argsort``, stable), each expert's row count (a ``scatter_add`` on the
  device, not ``bincount``, whose output size is a host read) and the
  groups' end offsets;
- :func:`expert_products`: ``(silu(x W1_e) * x W3_e) W2_e`` for every
  expert's rows at once, three grouped GEMMs (``torch.nn.functional.
  grouped_mm``: CUTLASS's grouped kernels on the card) with their own
  backward (:class:`_GroupedMM`);
- :func:`combine`: the slots back in token order, weighted and summed
  over each token's ``top_k`` in float32.

:func:`expert_products_plain` is the per-expert loop the grouped products
are held to in the tests (it reads the offsets on the host).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

#: added to the chosen weights' sum before the division (HF's
#: ``Lfm2MoeSparseMoeBlock``)
NORM_EPS = 1e-6


def route(x: Tensor, w_router: Tensor, expert_bias: Tensor, top_k: int,
          scale: float = 1.0, norm_topk: bool = True
          ) -> Tuple[Tensor, Tensor]:
    """``(weights, experts)`` of each row of ``x`` (tokens, hidden): the
    float32 weights (tokens, top_k) and the int64 expert indices (tokens,
    top_k), in ``topk``'s order."""
    s = torch.sigmoid(x.float() @ w_router.float())
    experts = torch.topk(s + expert_bias.float(), top_k, dim=-1).indices
    w = torch.gather(s, 1, experts)
    if norm_topk:
        w = w / (w.sum(dim=-1, keepdim=True) + NORM_EPS)
    return w * scale, experts


def permute(experts: Tensor, n_experts: int
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(order, counts, offs)`` of the (tokens, top_k) choice: ``order``
    the slots (``token * top_k + j``) sorted by expert, stable, so each
    expert's rows keep the tokens' order; ``counts`` (n_experts,) int64;
    ``offs`` the groups' int32 end offsets into the sorted slots."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.long,
                         device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    return order, counts, counts.cumsum(0).to(torch.int32)


class _GroupedMM(torch.autograd.Function):
    """``grouped_mm(a, b, offs)`` of jagged rows ``a`` (M, K) against
    per-group ``b`` (G, K, N), with the backward as two grouped products
    of their own: dA = dY b^T per group, dB = A^T dY per group (rows of an
    empty group give a zero gradient)."""

    @staticmethod
    def forward(ctx, a, b, offs):
        ctx.save_for_backward(a, b, offs)
        return F.grouped_mm(a, b, offs=offs)

    @staticmethod
    def backward(ctx, g):
        a, b, offs = ctx.saved_tensors
        g = g.contiguous()
        da = F.grouped_mm(g, b.transpose(-2, -1), offs=offs)
        db = F.grouped_mm(a.t(), g, offs=offs)
        return da, db, None


def grouped_mm(a: Tensor, b: Tensor, offs: Tensor) -> Tensor:
    return _GroupedMM.apply(a, b, offs)


def expert_products(xs: Tensor, w1: Tensor, w3: Tensor, w2: Tensor,
                    offs: Tensor) -> Tensor:
    """The SwiGLU experts over rows sorted by expert: ``xs`` (slots,
    hidden), ``w1``/``w3`` (experts, hidden, width), ``w2`` (experts,
    width, hidden), ``offs`` from :func:`permute`."""
    a = F.silu(grouped_mm(xs, w1, offs)) * grouped_mm(xs, w3, offs)
    return grouped_mm(a, w2, offs)


def expert_products_plain(xs: Tensor, w1: Tensor, w3: Tensor, w2: Tensor,
                          offs: Tensor) -> Tensor:
    """:func:`expert_products` as a loop over the experts."""
    out, start = [], 0
    for e, end in enumerate(offs.tolist()):
        x = xs[start:end]
        out.append((F.silu(x @ w1[e]) * (x @ w3[e])) @ w2[e])
        start = end
    return torch.cat(out)


def combine(ys: Tensor, order: Tensor, weights: Tensor) -> Tensor:
    """The (tokens, hidden) output: the sorted slots' rows ``ys`` back in
    slot order, times their weights, summed over each token's top_k in
    float32, in ``ys``' dtype."""
    tokens, k = weights.shape
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    y = ys.index_select(0, inv).reshape(tokens, k, -1).float()
    return (y * weights.unsqueeze(-1)).sum(dim=1).to(ys.dtype)
