"""GloVe: co-occurrence-matrix embeddings (port of
``deeplearning4j_tpu/nlp/glove.py``; reference ``models/glove/Glove.java``
+ ``AbstractCoOccurrences.java``): a host-side weighted co-occurrence
scan (weight 1/distance within the window, an own numpy copy whose counts
are bitwise the JAX package's), then AdaGrad regression on
``f(X_ij) (w_i·w̃_j + b_i + b̃_j − log X_ij)²`` over the triples, which
stay resident on the model's device for the whole fit.  Each epoch ships
one shuffled permutation (the host ``RandomState`` stream, so the order
is the JAX package's) and runs as a Python loop over its chunks.

Two update routes, both in place: the naive eight-scatter
``_glove_update`` (the semantics contract) and ``_glove_update_fused``
over ``ops/scatter.py``'s ``fused_adagrad_dual`` (two scatters of unique
rows).  ``Glove.use_fused_scatter`` keeps its meaning: True/False picks
one, None follows ``aggregation_enabled`` for the model's device.

Init: ``W``/``Wc`` ~ (U(0, 1) - 0.5) / D, drawn at each fit from a CPU
``torch.Generator`` seeded by ``seed`` (so every fit starts alike, as
the JAX package's threefry draw from ``seed`` does) or from
``init_generator`` where the caller sets one; or the tables
``init_tables`` holds (``jax_tables.load_jax_glove_tables``), which the
next fit consumes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.scatter import aggregation_enabled, fused_adagrad_dual
from .lookup_table import InMemoryLookupTable
from .word2vec import SequenceVectors

Tensor = torch.Tensor


def _glove_update(W: Tensor, Wc: Tensor, b: Tensor, bc: Tensor, hW: Tensor,
                  hWc: Tensor, hb: Tensor, hbc: Tensor, rows: Tensor,
                  cols: Tensor, logx: Tensor, fx: Tensor, mask: Tensor,
                  lr: Tensor) -> Tensor:
    """One AdaGrad batch over co-occurrence triples, in place: the naive
    eight-scatter path (four accumulator bumps, then four weight deltas
    scaled by the accumulators after the whole batch).  Returns the
    batch's weighted-least-squares loss."""
    wi = W[rows]
    wj = Wc[cols]
    diff = torch.einsum("bd,bd->b", wi, wj) + b[rows] + bc[cols] - logx
    g = fx * diff * mask                               # (B,)
    loss = 0.5 * torch.sum(fx * diff * diff * mask)
    gw = g[:, None] * wj
    gwc = g[:, None] * wi
    gg = g * g
    hW.index_add_(0, rows, gw * gw)
    hWc.index_add_(0, cols, gwc * gwc)
    hb.index_add_(0, rows, gg)
    hbc.index_add_(0, cols, gg)
    W.index_add_(0, rows, -lr * gw / torch.sqrt(hW[rows] + 1e-8))
    Wc.index_add_(0, cols, -lr * gwc / torch.sqrt(hWc[cols] + 1e-8))
    b.index_add_(0, rows, -lr * g / torch.sqrt(hb[rows] + 1e-8))
    bc.index_add_(0, cols, -lr * g / torch.sqrt(hbc[cols] + 1e-8))
    return loss


def _glove_update_fused(Sr: Tensor, Sc: Tensor, rows: Tensor, cols: Tensor,
                        logx: Tensor, fx: Tensor, mask: Tensor,
                        lr: Tensor) -> Tensor:
    """The two-scatter AdaGrad batch, in place on the packed dual-buffer
    state ``Sr`` (V, 2D+2) = ``[W | b | hW | hb]`` and ``Sc`` likewise
    for the context side: each side's duplicate rows collapse (sort +
    segment sum) and its weight deltas and accumulator bumps land in ONE
    scatter of unique rows.  Same gradient math, read-after-batch
    accumulators and loss as :func:`_glove_update`."""
    D = Sr.shape[1] // 2 - 1
    ri, ci = Sr[rows], Sc[cols]                        # (B, 2D+2)
    wi, bi = ri[:, :D], ri[:, D]
    wj, bj = ci[:, :D], ci[:, D]
    diff = torch.einsum("bd,bd->b", wi, wj) + bi + bj - logx
    g = fx * diff * mask                               # (B,)
    loss = 0.5 * torch.sum(fx * diff * diff * mask)
    grad_r = torch.cat([g[:, None] * wj, g[:, None]], dim=1)
    grad_c = torch.cat([g[:, None] * wi, g[:, None]], dim=1)
    fused_adagrad_dual(Sr, rows, grad_r, lr)
    fused_adagrad_dual(Sc, cols, grad_c, lr)
    return loss


def _chunks(order: Tensor):
    """(mask, sel) of each (B,) row of a padded (n_chunks, B) order:
    -1 pads train nothing."""
    for idx in order:
        yield (idx >= 0).to(torch.float32), idx.clamp(min=0)


def _glove_epoch(W, Wc, b, bc, hW, hWc, hb, hbc, rows_all, cols_all,
                 logx_all, fx_all, order, lr) -> Tensor:
    """One epoch of naive AdaGrad batches over device-resident triples;
    ``order`` is the shuffled (n_chunks, B) permutation.  Returns the
    epoch's loss (a device scalar, summed chunk by chunk)."""
    loss_sum = torch.zeros((), dtype=torch.float32, device=W.device)
    for mask, sel in _chunks(order):
        loss_sum = loss_sum + _glove_update(
            W, Wc, b, bc, hW, hWc, hb, hbc, rows_all[sel], cols_all[sel],
            logx_all[sel], fx_all[sel], mask, lr)
    return loss_sum


def _glove_epoch_fused(Sr, Sc, rows_all, cols_all, logx_all, fx_all,
                       order, lr) -> Tensor:
    """The fused twin of :func:`_glove_epoch`."""
    loss_sum = torch.zeros((), dtype=torch.float32, device=Sr.device)
    for mask, sel in _chunks(order):
        loss_sum = loss_sum + _glove_update_fused(
            Sr, Sc, rows_all[sel], cols_all[sel], logx_all[sel],
            fx_all[sel], mask, lr)
    return loss_sum


class Glove(SequenceVectors):
    """GloVe trainer (reference ``Glove.java`` builder: xMax, alpha,
    learningRate, epochs, symmetric window)."""

    #: co-occurrence keys buffered between dedup flushes (bounds the
    #: counting pass's transient memory on huge corpora)
    COOC_CHUNK_KEYS = 4_000_000

    #: final-epoch weighted-least-squares loss of the last fit (None
    #: until a fit trains at least one epoch on a non-empty cooc set)
    last_epoch_loss: Optional[float] = None

    #: True: the two-scatter fused dual-buffer route; False: the naive
    #: eight-scatter route (same math); None: ``aggregation_enabled()``
    #: for the model's device (same gate, same env override)
    use_fused_scatter: Optional[bool] = None

    def __init__(self, x_max: float = 100.0, alpha: float = 0.75,
                 symmetric: bool = True, **kwargs):
        kwargs.setdefault("learning_rate", 0.05)
        kwargs.setdefault("use_hierarchic_softmax", True)  # unused; appease
        super().__init__(**kwargs)
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric
        self._context: Optional[Tensor] = None
        #: draws the init of W and Wc; None: one seeded by ``seed``
        self.init_generator: Optional[torch.Generator] = None
        #: tables the next fit starts from instead of drawing (consumed)
        self.init_tables: Optional[Dict[str, Tensor]] = None

    # ------------------------------------------------------- co-occurrences
    def _count_cooccurrences(self, seqs: List[List[str]]
                             ) -> Dict[Tuple[int, int], float]:
        """Windowed 1/distance co-occurrence counts (reference
        ``AbstractCoOccurrences``) as a dict keyed (i, j)."""
        V = max(self.vocab.num_words(), 1)
        uk, sums = self._cooc_arrays(seqs)
        return {(int(k // V), int(k % V)): float(s)
                for k, s in zip(uk, sums)}

    def _cooc_arrays(self, seqs: List[List[str]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, sums) arrays of the windowed co-occurrence counts, keys
        i*V + j: for each distance d, the (i, i-d) pairs of a sequence
        are two shifted slices, merge-summed with unique/bincount in
        bounded chunks."""
        V = max(self.vocab.num_words(), 1)
        deduped: List[Tuple[np.ndarray, np.ndarray]] = []
        keys_parts: List[np.ndarray] = []
        wt_parts: List[np.ndarray] = []
        pending = 0

        def flush() -> None:
            nonlocal pending
            if not keys_parts:
                return
            keys = np.concatenate(keys_parts)
            uk, inv = np.unique(keys, return_inverse=True)
            deduped.append(
                (uk, np.bincount(inv, weights=np.concatenate(wt_parts))))
            keys_parts.clear()
            wt_parts.clear()
            pending = 0

        for seq in seqs:
            idx = self._sequence_to_indices(seq).astype(np.int64)
            n = idx.size
            for d in range(1, min(self.window_size, n - 1) + 1):
                a, bwd = idx[d:], idx[:-d]
                keys_parts.append(a * V + bwd)
                wt_parts.append(np.full(a.size, 1.0 / d))
                pending += a.size
                if self.symmetric:
                    keys_parts.append(bwd * V + a)
                    wt_parts.append(np.full(a.size, 1.0 / d))
                    pending += a.size
            if pending >= self.COOC_CHUNK_KEYS:
                flush()
        flush()
        if not deduped:
            return (np.zeros(0, np.int64), np.zeros(0, np.float64))
        keys = np.concatenate([k for k, _ in deduped])
        uk, inv = np.unique(keys, return_inverse=True)
        sums = np.bincount(
            inv, weights=np.concatenate([s for _, s in deduped]))
        return uk, sums

    # ------------------------------------------------------------- training
    def _draw_init(self, V: int, D: int) -> Dict[str, Tensor]:
        dev = self.device
        gen = (self.init_generator if self.init_generator is not None
               else torch.Generator().manual_seed(self.seed))

        def uniform():
            u = torch.rand((V, D), generator=gen, dtype=torch.float32)
            return ((u - 0.5) / D).to(dev)

        W, Wc = uniform(), uniform()

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        return {"W": W, "Wc": Wc, "b": z(V), "bc": z(V), "hW": z(V, D),
                "hWc": z(V, D), "hb": z(V), "hbc": z(V)}

    def fit(self, sequences) -> "Glove":
        seq_list = [list(s) for s in sequences]
        if self.vocab is None:
            self.build_vocab(seq_list)
        V = max(self.vocab.num_words(), 1)
        keys, sums = self._cooc_arrays(seq_list)
        if keys.size == 0:
            return self
        pairs = np.stack([(keys // V).astype(np.int64),
                          (keys % V).astype(np.int64)], axis=1)
        xs = sums.astype(np.float32)
        logx = np.log(xs)
        fx = np.minimum(1.0, (xs / self.x_max) ** self.alpha).astype(
            np.float32)

        V, D = self.vocab.num_words(), self.layer_size
        t = (self.init_tables if self.init_tables is not None
             else self._draw_init(V, D))
        self.init_tables = None
        W, Wc, b, bc = t["W"], t["Wc"], t["b"], t["bc"]
        hW, hWc, hb, hbc = t["hW"], t["hWc"], t["hb"], t["hbc"]
        lr = torch.tensor(np.float32(self.learning_rate), device=self.device)

        B = self.batch_size
        n = pairs.shape[0]
        n_chunks = -(-n // B)
        del keys, sums
        # triples device-resident for the whole fit; each epoch ships one
        # shuffled permutation
        rows_d = self._upload(pairs[:, 0].copy())
        cols_d = self._upload(pairs[:, 1].copy())
        logx_d = self._upload(logx)
        fx_d = self._upload(fx)
        order = np.arange(n)
        fused = (self.use_fused_scatter if self.use_fused_scatter
                 is not None else aggregation_enabled(device=self.device))
        ep_loss = None
        if fused:
            # packed dual-buffer state: [W | b | hW | hb] per side, so
            # each side's AdaGrad batch is ONE scatter of unique rows
            Sr = torch.cat([W, b[:, None], hW, hb[:, None]], dim=1)
            Sc = torch.cat([Wc, bc[:, None], hWc, hbc[:, None]], dim=1)
            for _ in range(self.epochs):
                ep_loss = _glove_epoch_fused(
                    Sr, Sc, rows_d, cols_d, logx_d, fx_d,
                    self._epoch_order(order, n_chunks, B), lr)
            W, b = Sr[:, :D], Sr[:, D]
            Wc, bc = Sc[:, :D], Sc[:, D]
        else:
            for _ in range(self.epochs):
                ep_loss = _glove_epoch(
                    W, Wc, b, bc, hW, hWc, hb, hbc, rows_d, cols_d,
                    logx_d, fx_d, self._epoch_order(order, n_chunks, B), lr)
        # the final epoch's loss; reading it is the fit's one host read
        self.last_epoch_loss = (float(ep_loss) if ep_loss is not None
                                else None)

        # final embedding: W + Wc (standard GloVe practice; the reference
        # exposes syn0)
        self.lookup_table = InMemoryLookupTable(
            self.vocab, D, self.seed, use_hs=False, negative=1.0,
            device=self.device)
        self.lookup_table.syn0 = W + Wc
        self._context = Wc.clone()
        return self

    def _epoch_order(self, order: np.ndarray, n_chunks: int,
                     B: int) -> Tensor:
        """Shuffle ``order`` in place with the host stream and pad it into
        the (n_chunks, B) chunk grid (-1 pads) on the device."""
        self._rng.shuffle(order)
        padded = np.full(n_chunks * B, -1, np.int64)
        padded[:order.size] = order
        return self._upload(padded.reshape(n_chunks, B))
