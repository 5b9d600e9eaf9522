"""SequenceVectors / Word2Vec (port of
``deeplearning4j_tpu/nlp/word2vec.py``; reference
``models/sequencevectors/SequenceVectors.java:179``, ``models/word2vec/
Word2Vec.java`` and the learning algorithms ``SkipGram.java`` /
``CBOW.java``).

The hot loop batches thousands of (input, target) pairs into one update:
embedding gathers, a (B, L, D) block of dot products, and additive
scatters back into syn0/syn1/syn1neg (``ops/scatter.py``; duplicate rows
accumulate).  The update functions are plain torch on the tables and
update them in place (``index_add_``), where the JAX package donates the
buffers to a jitted step.  Host pair generation (window sampling,
frequent-word subsampling, negative draws from the unigram table) keeps
the JAX package's numpy ``RandomState`` stream, so the host path's pairs
and negatives are bitwise the JAX package's; each batch's arrays are
uploaded to the model's device.  Corpora above
``DEVICE_PIPELINE_MIN_WORDS`` (or ``pair_generation="device"``) train
through the device-resident pipeline of ``device_corpus.py``.

``device=None`` means the CUDA card (``device.resolve_device``); the CPU
must be asked for.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.scatter import scatter_add_agg
from .lookup_table import InMemoryLookupTable
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor, build_huffman_tree

Tensor = torch.Tensor


# --------------------------------------------------------------------------
# update math (in place on the tables)
# --------------------------------------------------------------------------


def _hs_update(syn0: Tensor, syn1: Tensor, inputs: Tensor, points: Tensor,
               codes: Tensor, code_mask: Tensor, pair_mask: Tensor,
               lr: Tensor):
    """Hierarchical-softmax batch update (shared by the host path and the
    PV-DBOW label pass).

    inputs (B,): syn0 rows (the context word in skip-gram).
    points/codes/code_mask (B, L): the target word's Huffman path.
    word2vec update: for each inner node, g = (1 - code - sigmoid(h.w)) *
    lr; syn1 += g h; h += sum g w.  Returns (syn0, syn1, loss)."""
    h = syn0[inputs]                                   # (B, D)
    w = syn1[points]                                   # (B, L, D)
    logits = torch.einsum("bd,bld->bl", h, w)
    mask = code_mask * pair_mask[:, None]
    g = (1.0 - codes - torch.sigmoid(logits)) * mask * lr
    dh = torch.einsum("bl,bld->bd", g, w)
    # g is already masked, so dead rows carry zero payload
    scatter_add_agg(syn1, points, g[:, :, None] * h[:, None, :])
    scatter_add_agg(syn0, inputs, dh)
    # monitored loss: BCE over the path, sign-folded logits
    loss = -torch.sum(F.logsigmoid((1.0 - 2.0 * codes) * logits) * mask)
    return syn0, syn1, loss


def _ns_update(syn0: Tensor, syn1neg: Tensor, inputs: Tensor,
               targets: Tensor, labels: Tensor, target_mask: Tensor,
               pair_mask: Tensor, lr: Tensor):
    """Negative-sampling batch update (the ``AggregateSkipGram`` role).

    targets (B, 1+K): positive word then K negatives; labels (1+K,) is
    [1, 0, ..., 0]; target_mask (B, 1+K) zeroes residual negative-sample
    collisions with the positive.  Returns (syn0, syn1neg, loss)."""
    h = syn0[inputs]                                   # (B, D)
    w = syn1neg[targets]                               # (B, 1+K, D)
    logits = torch.einsum("bd,bkd->bk", h, w)
    mask = target_mask * pair_mask[:, None]
    g = (labels[None, :] - torch.sigmoid(logits)) * mask * lr
    dh = torch.einsum("bk,bkd->bd", g, w)
    scatter_add_agg(syn1neg, targets, g[:, :, None] * h[:, None, :])
    scatter_add_agg(syn0, inputs, dh)
    loss = -torch.sum(F.logsigmoid(
        torch.where(labels[None, :] > 0, logits, -logits)) * mask)
    return syn0, syn1neg, loss


def _cbow_hidden(syn0: Tensor, contexts: Tensor, context_mask: Tensor):
    cvecs = syn0[contexts]                             # (B, C, D)
    counts = torch.clamp(torch.sum(context_mask, dim=1, keepdim=True),
                         min=1.0)
    return torch.einsum("bcd,bc->bd", cvecs, context_mask) / counts


def _fan_out(syn0: Tensor, contexts: Tensor, context_mask: Tensor,
             dh: Tensor) -> None:
    """The full example gradient to every live context word (word2vec.c /
    reference AggregateCBOW: only the forward hidden is averaged)."""
    vals = dh[:, None, :] * context_mask[:, :, None]
    syn0.index_add_(0, contexts.reshape(-1),
                    vals.reshape(-1, syn0.shape[1]))


def _cbow_hs_step(syn0: Tensor, syn1: Tensor, contexts: Tensor,
                  context_mask: Tensor, points: Tensor, codes: Tensor,
                  code_mask: Tensor, pair_mask: Tensor, lr: Tensor):
    """CBOW + HS: the input is the mean of the window's vectors."""
    h = _cbow_hidden(syn0, contexts, context_mask)
    w = syn1[points]
    logits = torch.einsum("bd,bld->bl", h, w)
    mask = code_mask * pair_mask[:, None]
    g = (1.0 - codes - torch.sigmoid(logits)) * mask * lr
    dh = torch.einsum("bl,bld->bd", g, w)              # (B, D)
    syn1.index_add_(0, points.reshape(-1),
                    (g[:, :, None] * h[:, None, :]).reshape(
                        -1, syn1.shape[1]))
    _fan_out(syn0, contexts, context_mask, dh)
    loss = -torch.sum(F.logsigmoid((1.0 - 2.0 * codes) * logits) * mask)
    return syn0, syn1, loss


def _cbow_ns_step(syn0: Tensor, syn1neg: Tensor, contexts: Tensor,
                  context_mask: Tensor, targets: Tensor, labels: Tensor,
                  target_mask: Tensor, pair_mask: Tensor, lr: Tensor):
    h = _cbow_hidden(syn0, contexts, context_mask)
    w = syn1neg[targets]
    logits = torch.einsum("bd,bkd->bk", h, w)
    mask = target_mask * pair_mask[:, None]
    g = (labels[None, :] - torch.sigmoid(logits)) * mask * lr
    dh = torch.einsum("bk,bkd->bd", g, w)
    syn1neg.index_add_(0, targets.reshape(-1),
                       (g[:, :, None] * h[:, None, :]).reshape(
                           -1, syn1neg.shape[1]))
    _fan_out(syn0, contexts, context_mask, dh)
    loss = -torch.sum(F.logsigmoid(
        torch.where(labels[None, :] > 0, logits, -logits)) * mask)
    return syn0, syn1neg, loss


# --------------------------------------------------------------------------
# SequenceVectors
# --------------------------------------------------------------------------


class SequenceVectors:
    """Generic embedding trainer over sequences of tokens (reference
    ``SequenceVectors.java``; Word2Vec/ParagraphVectors build on it).

    Builder-style kwargs mirror the reference ``SequenceVectors.Builder``
    / ``Word2Vec.Builder``: ``layer_size``, ``window_size``,
    ``min_word_frequency``, ``iterations``, ``epochs``, ``learning_rate``
    (0.025), ``min_learning_rate`` (1e-4), ``negative`` (negative
    samples; 0 = off), ``use_hierarchic_softmax``, ``sampling``
    (frequent-word subsampling threshold; 0 = off), ``batch_size`` (pairs
    per update), ``elements_learning_algorithm`` ("skipgram" | "cbow"),
    ``seed``, and ``device`` (None = the card).

    ``draw_source``: None, or a callable ``(pipe, pass_count, n) ->
    device_corpus.PassDraws`` that supplies the random draws of each
    device-pipeline dispatch instead of the pipeline's generator (the
    parity tests inject the JAX package's threefry draws through it).
    """

    def __init__(self, layer_size: int = 100, window_size: int = 5,
                 min_word_frequency: int = 1, iterations: int = 1,
                 epochs: int = 1, learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, negative: float = 0.0,
                 use_hierarchic_softmax: bool = True, sampling: float = 0.0,
                 batch_size: int = 2048, seed: int = 42,
                 elements_learning_algorithm: str = "skipgram",
                 max_code_length: int = 40,
                 pair_generation: str = "auto", device=None):
        self.device = resolve_device(device)
        self.layer_size = layer_size
        self.window_size = window_size
        self.min_word_frequency = min_word_frequency
        self.iterations = iterations
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        self.sampling = sampling
        self.batch_size = batch_size
        self.seed = seed
        self.algorithm = elements_learning_algorithm.lower()
        self.max_code_length = max_code_length
        if pair_generation not in ("auto", "host", "device"):
            raise ValueError(
                f"unknown pair_generation {pair_generation!r}; expected "
                "'auto', 'host', or 'device'")
        self.pair_generation = pair_generation
        if not self.use_hs and self.negative <= 0:
            raise ValueError(
                "Enable hierarchical softmax and/or negative sampling")
        self.draw_source = None

        self.vocab: Optional[VocabCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None
        self._rng = np.random.RandomState(seed)
        self._code_arrays = None
        self._reset_queues()  # cross-sequence pair accumulators

    def _upload(self, arr: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ----------------------------------------------------------- vocab prep
    def build_vocab(self, sequences: Iterable[Sequence[str]]) -> None:
        constructor = VocabConstructor(
            min_word_frequency=self.min_word_frequency)
        self.vocab = constructor.build_vocab(sequences)
        if self.use_hs:
            build_huffman_tree(self.vocab,
                               max_code_length=self.max_code_length)
        self._new_lookup_table()

    def _new_lookup_table(self) -> None:
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.layer_size, self.seed, self.use_hs,
            self.negative, device=self.device)
        self.lookup_table.reset_weights()
        self._prepare_code_arrays()

    def _prepare_code_arrays(self) -> None:
        """Pack per-word Huffman codes/points into dense (V, L) tensors on
        the model's device."""
        if not self.use_hs:
            self._code_arrays = None
            return
        words = self.vocab.vocab_words()
        L = max((len(w.codes) for w in words), default=1)
        L = max(L, 1)
        V = len(words)
        points = np.zeros((V, L), np.int64)
        codes = np.zeros((V, L), np.float32)
        mask = np.zeros((V, L), np.float32)
        for w in words:
            n = len(w.codes)
            points[w.index, :n] = w.points
            codes[w.index, :n] = w.codes
            mask[w.index, :n] = 1.0
        self._code_arrays = (self._upload(points), self._upload(codes),
                             self._upload(mask))

    # ------------------------------------------------------- pair generation
    def _subsample_keep(self, indices: np.ndarray) -> np.ndarray:
        """Frequent-word subsampling filter (word2vec: keep prob
        (sqrt(f/(sample*total)) + 1) * sample*total/f)."""
        if self.sampling <= 0:
            return indices
        words = self.vocab.vocab_words()
        freqs = np.array([words[i].element_frequency for i in indices])
        total = self.vocab.total_word_count
        ratio = self.sampling * total / np.maximum(freqs, 1.0)
        keep_prob = np.minimum(1.0, np.sqrt(ratio) + ratio)
        return indices[self._rng.rand(indices.size) < keep_prob]

    def _sequence_to_indices(self, seq: Sequence[str]) -> np.ndarray:
        idx = [self.vocab.index_of(t) for t in seq]
        return np.array([i for i in idx if i >= 0], np.int64)

    def _generate_pairs(self, indices: np.ndarray):
        """(input_word, target_word) skip-gram pairs with per-center
        dynamic window shrink b ~ U[0, window) (word2vec semantics: input =
        context word, target = center word whose codes are trained)."""
        n = indices.size
        if n < 2:
            return np.empty((0, 2), np.int64)
        bs = self._rng.randint(0, self.window_size, n)
        pairs = []
        for pos in range(n):
            center = indices[pos]
            start = max(0, pos - self.window_size + bs[pos])
            end = min(n, pos + self.window_size - bs[pos] + 1)
            for j in range(start, end):
                if j != pos:
                    pairs.append((indices[j], center))
        return np.array(pairs, np.int64)

    def _generate_cbow(self, indices: np.ndarray):
        """(context window, center) examples for CBOW."""
        n = indices.size
        C = 2 * self.window_size
        if n < 2:
            return (np.empty((0, C), np.int64), np.empty((0, C), np.float32),
                    np.empty((0,), np.int64))
        bs = self._rng.randint(0, self.window_size, n)
        ctx = np.zeros((n, C), np.int64)
        cmask = np.zeros((n, C), np.float32)
        keep = []
        for pos in range(n):
            start = max(0, pos - self.window_size + bs[pos])
            end = min(n, pos + self.window_size - bs[pos] + 1)
            k = 0
            for j in range(start, end):
                if j != pos:
                    ctx[pos, k] = indices[j]
                    cmask[pos, k] = 1.0
                    k += 1
            if k:
                keep.append(pos)
        keep = np.array(keep, np.int64)
        return ctx[keep], cmask[keep], indices[keep]

    # ------------------------------------------------------------- training
    #: "auto" routes to the device pipeline above this many corpus words
    #: (tiny corpora keep the host path's sequential-update fidelity)
    DEVICE_PIPELINE_MIN_WORDS = 100_000

    def _device_eligible(self, seq_list) -> bool:
        if self.algorithm not in ("skipgram", "cbow"):
            return False
        if self.pair_generation == "host":
            return False
        # Subclasses that customize ANY hook of the feeding loop keep
        # their loop: the device pipeline would bypass the overrides.
        for hook in ("_train_sequence", "_generate_pairs",
                     "_subsample_keep", "_sequence_to_indices",
                     "_draw_negatives", "_skipgram_batch",
                     "_generate_cbow", "_cbow_batch"):
            if getattr(type(self), hook) is not getattr(SequenceVectors,
                                                        hook):
                return False
        if self.pair_generation == "device":
            return True
        n = sum(len(s) for s in seq_list)
        return n >= self.DEVICE_PIPELINE_MIN_WORDS

    def _device_conf_key(self):
        """Everything the device pipeline bakes in at construction plus
        the routing knobs: a change to any of these invalidates the
        pipeline cache (learning_rate/epochs/iterations are re-read per
        pass and may change freely)."""
        return (self.window_size, self.negative, self.use_hs,
                self.sampling, self.batch_size, self.seed,
                self.pair_generation, self.algorithm)

    def _run_device_passes(self, pipe) -> Dict:
        """Run epochs x iterations passes on a device pipeline and return
        THIS fit's stats (deltas: the counters span the pipeline's cached
        lifetime)."""
        passes = self.epochs * self.iterations
        total_words = pipe.n_words * passes
        prev_pairs, prev_loss = pipe.pairs_trained, pipe.loss_sum
        for p in range(passes):
            pipe.run_pass(p, total_words)
        pipe.finish()
        return {"pairs_trained": pipe.pairs_trained - prev_pairs,
                "loss_sum": pipe.loss_sum - prev_loss, "passes": passes}

    def _device_word_pipe(self, seq_list, source=None, seqs_idx=None):
        """The (possibly cached) word-side device pipeline, without
        running passes.  Cached on the caller's ``sequences`` object
        identity + vocab + baked config (data is immutable while training
        on it)."""
        from .device_corpus import DeviceSkipGram
        conf_key = self._device_conf_key()
        cached = getattr(self, "_device_fit_cache", None)
        if (cached is not None and source is not None
                and cached[0] is source and cached[1] is self.vocab
                and cached[2] == conf_key):
            return cached[3]
        seqs = (seqs_idx if seqs_idx is not None else
                [self._sequence_to_indices(s) for s in seq_list])
        seqs = [s for s in seqs if s.size >= 2]
        if not seqs:
            return None
        pipe = DeviceSkipGram(self, seqs)
        if source is not None:
            self._device_fit_cache = (source, self.vocab, conf_key, pipe)
        return pipe

    def _fit_device(self, seq_list, source=None,
                    seqs_idx=None) -> "SequenceVectors":
        """The device corpus pipeline (``device_corpus.py``); the built
        pipeline caches across fit() calls, so re-fitting the same corpus
        skips the host re-indexing and the corpus upload."""
        pipe = self._device_word_pipe(seq_list, source, seqs_idx)
        if pipe is None:
            return self
        stats = self._run_device_passes(pipe)
        stats.update(span=pipe.span, n_spans=pipe.n_spans)
        self._device_pipeline_stats = stats
        return self

    def fit(self, sequences) -> "SequenceVectors":
        """The reference fit pipeline (``SequenceVectors.java:179``):
        build vocab -> Huffman -> train ``epochs`` passes, through the
        device pipeline (``pair_generation="auto"|"device"``) or the host
        loop (small corpora, subclassed feeding loops)."""
        cached = getattr(self, "_device_fit_cache", None)
        if (cached is not None and cached[0] is sequences
                and cached[1] is self.vocab
                and cached[2] == self._device_conf_key()):
            return self._fit_device(None, source=sequences)
        seq_list = [list(s) for s in sequences]
        if self.vocab is None:
            self.build_vocab(seq_list)
        self._reset_queues()  # drop stale pairs from an aborted prior fit
        if self._device_eligible(seq_list):
            return self._fit_device(seq_list, source=sequences)
        total_words = sum(len(s) for s in seq_list) * self.epochs \
            * self.iterations
        words_seen = 0
        for _ in range(self.epochs):
            for seq in seq_list:
                for _ in range(self.iterations):
                    words_seen += len(seq)
                    alpha = max(
                        self.min_learning_rate,
                        self.learning_rate
                        * (1.0 - words_seen / max(total_words + 1, 1)))
                    self._train_sequence(seq, alpha)
        self._flush_queues()
        return self

    def _train_sequence(self, seq: Sequence[str], alpha: float) -> None:
        indices = self._sequence_to_indices(seq)
        indices = self._subsample_keep(indices)
        if indices.size < 2:
            return
        if self.algorithm == "cbow":
            ctx, cmask, centers = self._generate_cbow(indices)
            if centers.size:
                self._queue_cbow(ctx, cmask, centers, alpha)
            return
        pairs = self._generate_pairs(indices)
        if pairs.size:
            self._queue_skipgram(pairs[:, 0], pairs[:, 1], alpha)

    # -------------------------------------------- cross-sequence batching
    # Pairs accumulate across sequences and dispatch in full batch-size
    # chunks (the per-update lr is the mean alpha of the chunk's pairs);
    # the leftover partial chunk flushes at the end of fit().

    def _queue_skipgram(self, inputs: np.ndarray, targets: np.ndarray,
                        alpha: float) -> None:
        self._sg_queue.append((inputs.astype(np.int64),
                               targets.astype(np.int64),
                               np.full(inputs.size, alpha, np.float64)))
        self._sg_count += inputs.size
        if self._sg_count >= self.batch_size:
            self._drain_skipgram(force=False)

    def _queue_cbow(self, ctx: np.ndarray, cmask: np.ndarray,
                    centers: np.ndarray, alpha: float) -> None:
        self._cb_queue.append((ctx.astype(np.int64),
                               cmask.astype(np.float32),
                               centers.astype(np.int64),
                               np.full(centers.size, alpha, np.float64)))
        self._cb_count += centers.size
        if self._cb_count >= self.batch_size:
            self._drain_cbow(force=False)

    def _effective_batch(self) -> int:
        """Pairs per update, clamped so duplicate-row scatter-adds stay
        bounded: word2vec.c applies updates sequentially, while one
        batched scatter-add applies k gradients of a word hit k times at
        the same stale point (an effective k x lr that diverges once
        batch >> vocabulary).  Clamping the chunk to ~2x vocab keeps
        expected duplicates per row at ~2 while leaving realistic
        vocabularies (vocab >= batch/2) at the full batch size."""
        v = self.vocab.num_words() if hasattr(self, "vocab") and \
            self.vocab is not None else 0
        if v <= 0:
            return self.batch_size
        return int(min(self.batch_size, max(64, 2 * v)))

    def _drain_skipgram(self, force: bool) -> None:
        if not self._sg_count:
            return
        ins = np.concatenate([q[0] for q in self._sg_queue])
        tgts = np.concatenate([q[1] for q in self._sg_queue])
        alphas = np.concatenate([q[2] for q in self._sg_queue])
        B = self._effective_batch()
        s = 0
        while ins.size - s >= B or (force and s < ins.size):
            sl = slice(s, s + B)
            self._skipgram_batch(ins[sl], tgts[sl],
                                 float(alphas[sl].mean()))
            s += B
        self._sg_queue = ([] if s >= ins.size
                          else [(ins[s:], tgts[s:], alphas[s:])])
        self._sg_count = max(0, ins.size - s)

    def _drain_cbow(self, force: bool) -> None:
        if not self._cb_count:
            return
        width = max(q[0].shape[1] for q in self._cb_queue)

        def _w(a, fill):
            pad = width - a.shape[1]
            if not pad:
                return a
            return np.concatenate(
                [a, np.full((a.shape[0], pad), fill, a.dtype)], axis=1)

        ctx = np.concatenate([_w(q[0], 0) for q in self._cb_queue])
        cmask = np.concatenate([_w(q[1], 0.0) for q in self._cb_queue])
        ctrs = np.concatenate([q[2] for q in self._cb_queue])
        alphas = np.concatenate([q[3] for q in self._cb_queue])
        B = self._effective_batch()
        s = 0
        while ctrs.size - s >= B or (force and s < ctrs.size):
            sl = slice(s, s + B)
            self._cbow_batch(ctx[sl], cmask[sl], ctrs[sl],
                             float(alphas[sl].mean()))
            s += B
        self._cb_queue = ([] if s >= ctrs.size
                          else [(ctx[s:], cmask[s:], ctrs[s:], alphas[s:])])
        self._cb_count = max(0, ctrs.size - s)

    def _flush_queues(self) -> None:
        self._drain_skipgram(force=True)
        self._drain_cbow(force=True)

    def _reset_queues(self) -> None:
        self._sg_queue = []
        self._sg_count = 0
        self._cb_queue = []
        self._cb_count = 0

    def _pad(self, arr: np.ndarray, size: int):
        """Pad the leading axis to ``size`` and return (padded,
        pair_mask)."""
        n = arr.shape[0]
        mask = np.zeros(size, np.float32)
        mask[:n] = 1.0
        if n == size:
            return arr, mask
        pad = np.zeros((size - n,) + arr.shape[1:], arr.dtype)
        return np.concatenate([arr, pad]), mask

    def _draw_negatives(self, positives: np.ndarray, B: int):
        """Draw K negatives per row from the unigram table; collisions
        with the positive are resampled once, residual collisions are
        masked out (word2vec skips target==positive draws).  Returns
        (targets, labels, target_mask) on the model's device."""
        table = self.lookup_table.negative_table()
        K = int(self.negative)
        negs = table[self._rng.randint(0, table.size, (B, K))]
        collide = negs == positives[:, None]
        if collide.any():
            negs[collide] = table[self._rng.randint(
                0, table.size, int(collide.sum()))]
        tgt = np.concatenate([positives[:, None], negs], axis=1)
        tmask = np.ones((B, 1 + K), np.float32)
        tmask[:, 1:] = (negs != positives[:, None]).astype(np.float32)
        labels = np.concatenate([[1.0], np.zeros(K)]).astype(np.float32)
        return (self._upload(tgt.astype(np.int64)), self._upload(labels),
                self._upload(tmask))

    def _lr(self, alpha: float) -> Tensor:
        """The update's lr: the host float64 rounded to float32."""
        return torch.tensor(np.float32(alpha), device=self.device)

    def _skipgram_batch(self, inputs: np.ndarray, targets: np.ndarray,
                        alpha: float) -> None:
        lt = self.lookup_table
        B = self._effective_batch()
        inputs_p, pair_mask = self._pad(inputs.astype(np.int64), B)
        targets_p, _ = self._pad(targets.astype(np.int64), B)
        lr = self._lr(alpha)
        inputs_t, pmask_t = self._upload(inputs_p), self._upload(pair_mask)
        if self.use_hs:
            points, codes, cmask = self._code_arrays
            tp = self._upload(targets_p)
            _hs_update(lt.syn0, lt.syn1, inputs_t, points[tp], codes[tp],
                       cmask[tp], pmask_t, lr)
        if self.negative > 0:
            tgt, labels, tmask = self._draw_negatives(targets_p, B)
            _ns_update(lt.syn0, lt.syn1neg, inputs_t, tgt, labels, tmask,
                       pmask_t, lr)

    def _cbow_batch(self, ctx: np.ndarray, cmask: np.ndarray,
                    centers: np.ndarray, alpha: float) -> None:
        lt = self.lookup_table
        B = self._effective_batch()
        ctx_p, pair_mask = self._pad(ctx.astype(np.int64), B)
        cmask_p, _ = self._pad(cmask, B)
        centers_p, _ = self._pad(centers.astype(np.int64), B)
        lr = self._lr(alpha)
        ctx_t, cmask_t = self._upload(ctx_p), self._upload(cmask_p)
        pmask_t = self._upload(pair_mask)
        if self.use_hs:
            points, codes, hmask = self._code_arrays
            cp = self._upload(centers_p)
            _cbow_hs_step(lt.syn0, lt.syn1, ctx_t, cmask_t, points[cp],
                          codes[cp], hmask[cp], pmask_t, lr)
        if self.negative > 0:
            tgt, labels, tmask = self._draw_negatives(centers_p, B)
            _cbow_ns_step(lt.syn0, lt.syn1neg, ctx_t, cmask_t, tgt, labels,
                          tmask, pmask_t, lr)

    # --------------------------------------------------- WordVectors API
    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    def word_vector(self, word: str) -> Optional[np.ndarray]:
        return (self.lookup_table.vector(word)
                if self.lookup_table else None)

    getWordVectorMatrix = word_vector  # reference-name alias

    def similarity(self, w1: str, w2: str) -> float:
        """Cosine similarity (reference ``similarity``); NaN if missing."""
        a, b = self.word_vector(w1), self.word_vector(w2)
        if a is None or b is None:
            return float("nan")
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0 or nb == 0:
            return 0.0
        return float(np.dot(a, b) / (na * nb))

    def words_nearest(self, word_or_vec, negative=None,
                      top_n: int = 10) -> List[str]:
        """Nearest neighbors by cosine (reference ``wordsNearest``), on a
        host copy of syn0.

        Also accepts the analogy form (reference ``wordsNearest(positive,
        negative, top)`` / ``wordsNearestSum``): a list of positive words
        plus an optional list of negatives, e.g. ``words_nearest(["king",
        "woman"], ["man"])``, queried as sum(positive) - sum(negative),
        with the query words excluded from the result."""
        if isinstance(negative, int):       # words_nearest(word, 5) form
            top_n, negative = negative, None
        if isinstance(negative, str):       # single negative word
            negative = [negative]
        if negative:
            if isinstance(word_or_vec, str):
                word_or_vec = [word_or_vec]
            elif not isinstance(word_or_vec, (list, tuple)):
                raise ValueError(
                    "negative words require word-name positives, not a "
                    "raw vector")
        if isinstance(word_or_vec, str):
            vec = self.word_vector(word_or_vec)
            exclude = {word_or_vec}
            if vec is None:
                return []
        elif isinstance(word_or_vec, (list, tuple)) \
                and word_or_vec and isinstance(word_or_vec[0], str):
            pos = [self.word_vector(w) for w in word_or_vec]
            neg = [self.word_vector(w) for w in (negative or [])]
            if any(v is None for v in pos + neg):
                return []
            vec = np.sum(pos, axis=0)
            if neg:
                vec = vec - np.sum(neg, axis=0)
            exclude = set(word_or_vec) | set(negative or [])
        else:
            vec = np.asarray(word_or_vec)
            exclude = set()
        m = self.lookup_table.weights()
        norms = np.linalg.norm(m, axis=1) * max(np.linalg.norm(vec), 1e-12)
        sims = m @ vec / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = []
        for idx in order:
            w = self.vocab.word_at_index(int(idx))
            if w not in exclude:
                out.append(w)
            if len(out) >= top_n:
                break
        return out

    # reference wordsNearestSum: same additive-combination query
    words_nearest_sum = words_nearest

    def similar_words_in_vocab_to(self, word: str,
                                  accuracy: float) -> List[str]:
        """Vocab words whose string similarity to ``word`` is >=
        ``accuracy`` (reference ``similarWordsInVocabTo``)."""
        import difflib
        if self.vocab is None:
            return []
        sm = difflib.SequenceMatcher(None)
        sm.set_seq2(word)
        out = []
        for w in self.vocab.words():
            sm.set_seq1(w)
            if sm.real_quick_ratio() >= accuracy \
                    and sm.quick_ratio() >= accuracy \
                    and sm.ratio() >= accuracy:
                out.append(w)
        return out

    def word_vectors(self, words) -> np.ndarray:
        """(n, layer_size) matrix of the vectors for the given words,
        skipping out-of-vocab entries (reference ``getWordVectors``)."""
        vecs = [self.word_vector(w) for w in words]
        vecs = [v for v in vecs if v is not None]
        if not vecs:
            return np.zeros((0, self.layer_size), np.float32)
        return np.stack(vecs)

    def word_vectors_mean(self, words) -> np.ndarray:
        """Mean vector over in-vocab words (reference
        ``getWordVectorsMean``)."""
        m = self.word_vectors(words)
        if m.shape[0] == 0:
            return np.zeros((self.layer_size,), np.float32)
        return m.mean(axis=0)


class Word2Vec(SequenceVectors):
    """Word2Vec over text corpora (reference ``models/word2vec/
    Word2Vec.java``): a SequenceVectors whose sequences come from a
    sentence iterator + tokenizer factory."""

    def __init__(self, iterate=None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 stop_words: Sequence[str] = (), **kwargs):
        kwargs.setdefault("min_word_frequency", 5)
        super().__init__(**kwargs)
        self.sentence_iterator = iterate
        self.tokenizer_factory = tokenizer_factory \
            or DefaultTokenizerFactory()
        self.stop_words = set(stop_words)

    # Builder parity (reference Word2Vec.Builder().iterate(...).build());
    # any other setter, ``device(...)`` included, becomes a kwarg
    class Builder:
        def __init__(self):
            self._kw: Dict = {}
            self._iterate = None
            self._tokenizer = None

        def __getattr__(self, name):
            def setter(value):
                self._kw[name] = value
                return self
            return setter

        def iterate(self, it):
            self._iterate = it
            return self

        def tokenizer_factory(self, tf):
            self._tokenizer = tf
            return self

        def build(self) -> "Word2Vec":
            return Word2Vec(iterate=self._iterate,
                            tokenizer_factory=self._tokenizer, **self._kw)

    def _sentences_to_sequences(self, sentences: Iterable[str]):
        for sentence in sentences:
            tokens = self.tokenizer_factory.create(sentence).get_tokens()
            if self.stop_words:
                tokens = [t for t in tokens if t not in self.stop_words]
            if tokens:
                yield tokens

    def fit(self, sentences=None) -> "Word2Vec":
        source = sentences if sentences is not None \
            else self.sentence_iterator
        if source is None:
            raise ValueError("No sentence source; pass `iterate` or call "
                             "fit(sentences)")
        if isinstance(source, (list, tuple)) and source \
                and not isinstance(source[0], str):
            sequences = source  # pre-tokenized
        else:
            sequences = list(self._sentences_to_sequences(source))
        return super().fit(sequences)
