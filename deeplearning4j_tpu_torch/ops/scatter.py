"""Scatter-row economics: unique-row aggregation and fused AdaGrad (port
of ``deeplearning4j_tpu/ops/scatter.py``).

Every embedding trainer ends each step in an additive scatter
(``table.index_add_(0, idx, payload)``) whose ``idx`` repeats rows:
GloVe triples repeat hot words, every Huffman path shares the root node,
negative draws repeat hot unigram rows.  The JAX package lowers these to
XLA scatters; the port uses torch ops (no hand kernel: the reference has
no Pallas kernel here either):

- :func:`aggregate_rows` sorts the index vector (``torch.sort(stable=
  True)``: ``jnp.argsort`` is stable, and an unstable sort would reorder
  the segment sums) and sums every payload per unique destination row
  (``cumsum`` segment ids, ``index_add_`` segment sums,
  ``scatter_reduce_("amin")`` as ``segment_min``).  Static shapes: B
  slots, the unused ones carry the int32-max sentinel and exactly zero
  payload.  No ``torch.unique`` or ``nonzero``: on the card both read a
  count back to the host and would stall every step.
- :func:`scatter_add_agg` is ``table.index_add_(0, idx, vals)``, either
  plain or through the aggregated rows, updating ``table`` in place.
- :func:`fused_adagrad_dual` is the dual-buffer AdaGrad: weights and
  accumulators in one packed table ``[:, :P] = weights, [:, P:] =
  accumulators``, both landing in one ``index_add_``, with the naive
  path's read-after-batch accumulator (every duplicate of a row sees
  ``h_old + sum(g^2)`` of the whole batch).

Torch has no scatter ``mode="drop"``: the sentinel slots are clamped onto
the table's last row and add their payload there, which is exactly zero
(no element lands in an unused segment), so the row keeps its value, as
the JAX gather's clip does for the reads in ``fused_adagrad_dual``.

Duplicate rows under ``index_add_``: on the CPU it adds in index order,
as XLA's CPU scatter does, so the CPU parity tests can be tight; on the
card it accumulates by atomics, so the sum is right but its order changes
from run to run (under ``torch.use_deterministic_algorithms(True)`` it is
bitwise repeatable).

Platform gate: :func:`aggregation_enabled` decides per table device.
The JAX package aggregates only on a TPU (a TPU cost law: scatter rows,
not FLOPs, are what it pays for); on the CPU the aggregation costs more
than it saves, so the port keeps it off there too, and the CPU parity
tests compare like with like.  On the card the default is
``CARD_AGGREGATES``, which ``chip_smoke.py`` phase 15 (a) measured: the
full-width SGNS step (vocab 10,000, dim 128, batch 8,192, K=5) took
0.2625 ms plain and 0.9016 ms aggregated (NVIDIA H100 80GB HBM3, 700.00
W): the card's atomic ``index_add_`` absorbs the duplicates, while the
aggregation adds a radix sort, a segment sum and 70 more device events a
step (89 against 19).  So the card scatters plain, and GloVe's default
route there is the naive one (11.3M against 4.5M triples/s in the same
run).  ``DL4J_TPU_SCATTER_AGG`` and ``aggregate=`` override the default
either way.  :func:`fused_adagrad_dual` always aggregates: its
read-after-batch accumulator needs unique rows.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

#: the unused slots' destination (``segment_min``'s identity in int32)
SENTINEL = 2 ** 31 - 1
#: whether an additive scatter on a CUDA table aggregates by default
#: (chip_smoke.py phase 15 (a); see the module docstring)
CARD_AGGREGATES = False


def aggregation_enabled(override: Optional[bool] = None,
                        device=None) -> bool:
    """Whether an additive scatter onto a table on ``device`` takes the
    aggregated path: explicit ``override`` > ``DL4J_TPU_SCATTER_AGG`` env
    > the device's default (the CPU off, the card ``CARD_AGGREGATES``).
    Read at each call."""
    if override is not None:
        return override
    env = os.environ.get("DL4J_TPU_SCATTER_AGG")
    if env is not None:
        return env not in ("0", "false", "off")
    dev = torch.device("cpu" if device is None else device)
    return dev.type == "cuda" and CARD_AGGREGATES


def aggregate_rows(idx: Tensor, *vals: Tensor) -> Tuple[Tensor, ...]:
    """Sort ``idx`` (B,) and segment-sum each payload per unique row.

    Returns ``(dest, *sums)`` with static shapes: ``dest`` (B,) int64
    holds each unique destination row once, ascending, followed by
    ``SENTINEL`` for the (B - n_unique) unused slots; ``sums[k]`` has
    ``vals[k]``'s shape with row j holding the sum of the payload rows
    destined to ``dest[j]`` (zero in the sentinel slots).
    """
    idx = idx.reshape(-1).to(torch.int64)
    B = idx.shape[0]
    s_idx, order = torch.sort(idx, stable=True)
    starts = torch.ones(B, dtype=torch.bool, device=idx.device)
    starts[1:] = s_idx[1:] != s_idx[:-1]
    seg = torch.cumsum(starts, 0) - 1                 # (B,) segment ids
    dest = torch.full((B,), SENTINEL, dtype=torch.int64,
                      device=idx.device).scatter_reduce_(
                          0, seg, s_idx, reduce="amin")
    sums = tuple(
        torch.zeros((B,) + v.shape[1:], dtype=v.dtype,
                    device=v.device).index_add_(0, seg, v[order])
        for v in vals)
    return (dest,) + sums


def _onto(dest: Tensor, rows: int) -> Tensor:
    """Sentinel slots clamped onto the last row: their payload is zero."""
    return dest.clamp_(max=rows - 1)


def scatter_add_agg(table: Tensor, idx: Tensor, vals: Tensor,
                    aggregate: Optional[bool] = None) -> Tensor:
    """``table.index_add_(0, idx, vals)`` in place, through one scatter of
    unique rows where :func:`aggregation_enabled` says so (same math
    either way).  ``idx`` may be any shape (e.g. the (B, L) Huffman-path
    grid); ``vals`` is ``idx.shape + table.shape[1:]``.  Inert elements
    must carry zero payload (mask before the scatter).  Returns
    ``table``."""
    flat_idx = idx.reshape(-1)
    flat_vals = vals.reshape((flat_idx.shape[0],) + table.shape[1:])
    if not aggregation_enabled(aggregate, table.device):
        return table.index_add_(0, flat_idx, flat_vals)
    dest, summed = aggregate_rows(flat_idx, flat_vals)
    return table.index_add_(0, _onto(dest, table.shape[0]), summed)


def fused_adagrad_dual(state: Tensor, idx: Tensor, grad: Tensor, lr: Tensor,
                       eps: float = 1e-8) -> Tensor:
    """Fused dual-buffer AdaGrad, in place: one ``index_add_`` updates
    the weights and accumulators of the packed table ``state`` (V, 2P) =
    ``[weights | accumulators]`` for gradient rows ``grad`` (B, P)
    destined to ``idx`` (B,).  Per unique row: ``h_new = h_old +
    sum(g^2)``, ``dw = -lr * sum(g) / sqrt(h_new + eps)``, which is what
    ``accum.index_add_(0, idx, g * g)`` followed by ``weight.index_add_(
    0, idx, -lr * g / sqrt(accum[idx] + eps))`` computes.  Masked
    elements must carry zero gradient.  Returns ``state``."""
    P = grad.shape[-1]
    dest, g_sum, sq_sum = aggregate_rows(idx, grad, grad * grad)
    dest = _onto(dest, state.shape[0])
    h_new = state[dest, P:] + sq_sum
    dw = -lr * g_sum / torch.sqrt(h_new + eps)
    return state.index_add_(0, dest, torch.cat([dw, sq_sum], dim=-1))


def pack_dual(weights: Tensor, accum: Tensor) -> Tensor:
    """Pack (weights, accumulators) into the (V, 2P) layout
    :func:`fused_adagrad_dual` updates; 1-D tables pack as P=1."""
    if weights.dim() == 1:
        weights, accum = weights[:, None], accum[:, None]
    return torch.cat([weights, accum], dim=-1)


def unpack_dual(state: Tensor, squeeze: bool = False
                ) -> Tuple[Tensor, Tensor]:
    """Inverse of :func:`pack_dual` (views of ``state``)."""
    P = state.shape[-1] // 2
    w, h = state[:, :P], state[:, P:]
    if squeeze:
        w, h = w[:, 0], h[:, 0]
    return w, h
