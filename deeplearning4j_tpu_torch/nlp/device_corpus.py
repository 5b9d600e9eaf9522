"""Device-resident skip-gram/CBOW corpus pipeline (port of
``deeplearning4j_tpu/nlp/device_corpus.py``): the reference's feeding
loop around ``SkipGram.java:258`` moved onto the card.

- The tokenized corpus uploads once as a flat index tensor plus a
  sentence-id tensor (windows never cross sentence boundaries); the
  sampling tables (keep probabilities, the blocked negative table, the
  Huffman paths) live beside it on the model's device.
- A pass is a Python loop over spans of center positions with no host
  read inside it, where the JAX package runs one ``lax.scan`` dispatch:
  per span, the (span, 2W) pair grid from shifted slices of the padded
  corpus, the LCG negative draws, and ONE center-aggregated update (a
  center's 2W cells train the same target rows, so their syn1-side
  contributions sum over the cell axis before the scatter).
- A pass's random draws are formed up front as tensors
  (:class:`PassDraws`: the subsample uniforms, the per-span window
  shrinks, the per-span LCG seeds) and then consumed.  They come from a
  ``torch.Generator`` on the model's device, where the JAX package draws
  threefry; ``SequenceVectors.draw_source`` replaces them (the parity
  tests feed the JAX package's exact draws through it, so one whole pass
  matches the JAX pass).
- The learning rates of a dispatch are host float64 numpy cast to
  float32, as in the JAX package; the pair and loss counters stay on the
  device and are read only in ``finish()``.

The LCG sampler is the JAX package's uint32 arithmetic in int64, masked
to 32 bits after each multiply and add (every product fits in 63 bits),
so the draws are bitwise the JAX package's for the same seed.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.scatter import scatter_add_agg
from .word2vec import _hs_update, _ns_update

Tensor = torch.Tensor

_U32 = 0xFFFFFFFF


class PassDraws(NamedTuple):
    """The random draws of one dispatch (a pass, or one segment of it).

    ``keep``: the subsample uniforms in [0, 1), (npad,) for a
    :class:`DeviceSkipGram` and (n, chunk) for :class:`DeviceDbowLabels`,
    or None when subsampling is off; ``shrink``: (n, span) window shrinks
    in [0, W) (None for the label pairs); ``seeds``: (n,) LCG seeds, uint32
    values in int64, or None without negative sampling."""
    keep: Optional[Tensor]
    shrink: Optional[Tensor]
    seeds: Optional[Tensor]


def build_corpus_arrays(seqs: List[np.ndarray],
                        chunk: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Flatten per-sequence index arrays into (corpus, sent_id) padded to
    a multiple of ``chunk``.  Padding positions get sent_id -1 so the
    same-sentence mask kills any pair touching them."""
    n = sum(s.size for s in seqs)
    npad = max(chunk, ((n + chunk - 1) // chunk) * chunk)
    corpus = np.zeros(npad, np.int32)
    sent = np.full(npad, -1, np.int32)
    pos = 0
    for i, s in enumerate(seqs):
        corpus[pos:pos + s.size] = s
        sent[pos:pos + s.size] = i
        pos += s.size
    return corpus, sent, n


def keep_probabilities(vocab, sampling: float) -> Optional[np.ndarray]:
    """Per-word subsampling keep probability (word2vec: keep prob
    min(1, sqrt(t/f') + t/f') with f' = freq/(sample*total)); None when
    subsampling is off."""
    if sampling <= 0:
        return None
    words = vocab.vocab_words()
    keep = np.ones(len(words), np.float32)
    total = vocab.total_word_count
    for w in words:
        ratio = sampling * total / max(w.element_frequency, 1.0)
        keep[w.index] = min(1.0, np.sqrt(ratio) + ratio)
    return keep


def window_offsets(window: int) -> np.ndarray:
    """The +-window offset row of the pair grid (0 excluded)."""
    return np.concatenate(
        [np.arange(-window, 0), np.arange(1, window + 1)]).astype(np.int32)


def abs_offsets(window: int, device=None) -> Tensor:
    """|offset| of each grid column, as a tensor on ``device``."""
    return torch.from_numpy(np.abs(window_offsets(window))
                            .astype(np.int64)).to(device)


def pair_grid_shaped(corpus_pad: Tensor, sent_pad: Tensor, start: int,
                     shrink: Tensor, window: int, span: int,
                     offsets: Optional[Tensor] = None):
    """The pair grid over W-padded tensors (sentinel sent_id -1 at both
    ends), in (span, 2W) grid shape: one slice pulls the span's
    (span + 2W) region and ``unfold`` views each center's 2W+1 window of
    it (no gather).  Center position p of the span maps to padded index
    start + W + p; ``start`` is clamped as ``lax.dynamic_slice`` clamps
    it.  A cell is live iff the center's sentence id is >= 0, the
    neighbor's matches it, and the offset is within the shrunk window.
    ``offsets``: :func:`abs_offsets` on the corpus' device (a caller
    looping over spans passes it once).  Returns (words (span, 2W),
    centers (span,), pmask (span, 2W) f32)."""
    width = span + 2 * window
    start = max(0, min(int(start), corpus_pad.shape[0] - width))
    region_c = corpus_pad[start:start + width]
    region_s = sent_pad[start:start + width]
    centers = region_c[window:window + span]
    csent = region_s[window:window + span]
    wc = region_c.unfold(0, 2 * window + 1, 1)       # (span, 2W+1) view
    ws = region_s.unfold(0, 2 * window + 1, 1)
    words = torch.cat([wc[:, :window], wc[:, window + 1:]], dim=1)
    wsent = torch.cat([ws[:, :window], ws[:, window + 1:]], dim=1)
    if offsets is None:
        offsets = abs_offsets(window, corpus_pad.device)
    win = window - shrink
    pmask = ((csent >= 0)[:, None] & (wsent == csent[:, None])
             & (offsets[None, :] <= win[:, None]))
    return words, centers, pmask.to(torch.float32)


def pad_with_sentinels(corpus: Tensor, sent: Tensor, window: int):
    """W sentinel entries (word 0, sent_id -1) on each side."""
    zc = corpus.new_zeros((window,))
    zs = sent.new_full((window,), -1)
    return torch.cat([zc, corpus, zc]), torch.cat([zs, sent, zs])


def compact_dest(keep: Tensor, npad: int) -> Tensor:
    """Destinations for stable keep-compaction: kept position i goes to
    cumsum(keep)[i]-1, dropped positions to slot ``npad``, one past the
    end.  The ONE source of truth for the compaction: corpus, sentence
    ids and any aligned side array (PV-DM's per-position labels) must all
    compact with the SAME dest or positions and labels drift apart."""
    tgt = torch.cumsum(keep, 0) - 1
    return torch.where(keep, tgt, torch.full_like(tgt, npad))


def compact_with(arr: Tensor, dest: Tensor, fill) -> Tensor:
    """Apply :func:`compact_dest` destinations to one aligned tensor.
    Torch has no scatter ``mode="drop"``: the buffer is one slot longer,
    every dropped position lands in that slot, and the slot is sliced
    off."""
    out = arr.new_full((arr.shape[0] + 1,), fill)
    out[dest] = arr
    return out[:-1]


def subsample_compact(corpus: Tensor, sent: Tensor, keep: Tensor):
    """Compact (corpus, sent) down to the kept positions (windows close
    up over removed words, word2vec.c subsampling); the dropped tail gets
    sentinel sent_id -1.  Returns (corpus, sent, n_valid) with n_valid a
    0-dim device tensor."""
    dest = compact_dest(keep, corpus.shape[0])
    return (compact_with(corpus, dest, 0), compact_with(sent, dest, -1),
            torch.sum(keep))


def block_negative_table(table: np.ndarray, k: int,
                         seed: int) -> np.ndarray:
    """Shuffle the word2vec unigram table ONCE on host and fold it into
    (table_size // k, k) blocks: every block is k draws without
    replacement from the unigram^0.75 multiset.  Bitwise the JAX
    package's."""
    table = np.random.RandomState(seed).permutation(table)
    n = (table.size // k) * k
    return table[:n].reshape(-1, k).astype(np.int32)


def lcg_state(seed, rows: int, device=None) -> Tensor:
    """The (rows,) LCG states of one draw: ``(seed + r * 2654435761) *
    1664525 + 1013904223`` in uint32 arithmetic (Knuth hash spread,
    Numerical-Recipes step), computed in int64 and masked to 32 bits
    after each multiply and add."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    r = torch.arange(rows, dtype=torch.int64, device=seed.device)
    state = (seed + ((r * 2654435761) & _U32)) & _U32
    return (state * 1664525 + 1013904223) & _U32


def lcg_negatives(seed, rows: int, k: int, table_2d: Tensor) -> Tensor:
    """(rows, k) negative draws: one 32-bit LCG draw per row selecting one
    ROW of the pre-shuffled block table (:func:`block_negative_table`).
    ``seed`` is a uint32 value (a 0-dim int64 tensor or an int).  Residual
    collisions with the positive are masked by the caller."""
    state = lcg_state(seed, rows, table_2d.device)
    base = (state >> 4) % table_2d.shape[0]
    return table_2d[base]


def _trainer_tables(sv):
    """Device-resident sampling/Huffman tables shared by every corpus
    trainer: subsample keep-probs (None when off), the block negative
    table (None without negative sampling), the HS path tensors (None
    without hierarchical softmax)."""
    dev = sv.device
    keep = keep_probabilities(sv.vocab, sv.sampling)
    keep_prob = torch.from_numpy(keep).to(dev) if keep is not None else None
    neg_table = None
    if sv.negative > 0:
        neg_table = torch.from_numpy(block_negative_table(
            sv.lookup_table.negative_table(), int(sv.negative),
            sv.seed).astype(np.int64)).to(dev)
    hs = sv._code_arrays if sv.use_hs else (None, None, None)
    return (keep_prob, neg_table) + tuple(hs)


def _on(t, device) -> Optional[Tensor]:
    """An injected draw on ``device``; unsigned numpy (the JAX package's
    uint32 seeds) widens to int64."""
    if t is None:
        return None
    if not isinstance(t, torch.Tensor):
        a = np.array(t)                          # a writable copy
        t = torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "u"
                             else a)
    return t.to(device)


def _minus(loss: Optional[Tensor], term: Tensor) -> Tensor:
    """``loss - term``, the first term negated (the JAX loss starts at
    0.0; 0 - x is -x)."""
    return -term if loss is None else loss - term


class _TrainerCounters:
    """Lazy pass counters and the draw stream shared by the device
    trainers.  The generator lives on the model's device and runs on
    across passes and fits, so a cached pipeline's re-fit never replays
    the first fit's draws; ``_passes_run`` counts dispatches over the
    pipeline's lifetime (the key count a ``draw_source`` receives).
    Counters are read (the device barrier) only in ``finish()``."""

    def __init__(self, model, key_seed: int):
        self.pairs_trained = 0.0
        self.loss_sum = 0.0
        self._pending: List = []
        self._passes_run = 0
        self.model = model
        self.device = model.device
        #: the seed the JAX package folds the pass count into
        self.key_seed = key_seed
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(key_seed)

    def _draws(self, n: int) -> PassDraws:
        count = self._passes_run
        self._passes_run += 1
        source = getattr(self.model, "draw_source", None)
        if source is None:
            return self._own_draws(n)
        return PassDraws(*(_on(t, self.device)
                           for t in source(self, count, n)))

    def _seeds(self, n: int, gen, device) -> Optional[Tensor]:
        if self.model.negative <= 0:
            return None
        return torch.randint(0, 2 ** 32, (n,), generator=gen,
                             dtype=torch.int64, device=device)

    def _alphas(self, pass_idx: int, total_words: int, lo: int, n: int,
                unit: int) -> Tensor:
        """The dispatch's per-unit learning rates: host float64 cast to
        float32, as the JAX package feeds its scan."""
        m = self.model
        starts = pass_idx * self.n_words + (lo + np.arange(n)) * unit
        alphas = np.maximum(
            m.min_learning_rate,
            m.learning_rate * (1.0 - starts / max(total_words + 1, 1)))
        return torch.from_numpy(alphas.astype(np.float32)).to(self.device)

    def finish(self) -> Tuple[float, float]:
        for pairs, loss in self._pending:
            self.pairs_trained += float(pairs)
            self.loss_sum += float(loss)
        self._pending = []
        return self.pairs_trained, self.loss_sum

    def _tables(self):
        lt = self.model.lookup_table
        return lt.syn0, lt.syn1, lt.syn1neg


def host_draws(seed: int):
    """A ``draw_source`` whose draws come from a CPU generator seeded by
    ``seed`` and the dispatch count: a model on the card and one on the
    CPU then train on the same draws (card-against-CPU checks)."""
    def source(pipe, count: int, n: int) -> PassDraws:
        gen = torch.Generator().manual_seed(seed * 1_000_003 + count)
        return pipe._own_draws(n, gen, "cpu")
    return source


def build_interleaved_label_arrays(seqs: List[np.ndarray],
                                   label_rows: List[int], chunk: int):
    """(corpus, pos_label, n) for the label-pair trainer, with document
    positions INTERLEAVED round-robin (doc0[0], doc1[0], ..., doc0[1],
    ...), which bounds label-row duplicates per chunk at ~ceil(chunk /
    n_docs)."""
    lengths = np.array([s.size for s in seqs], np.int64)
    n = int(lengths.sum())
    if n == 0:
        corpus = np.zeros(chunk, np.int32)
        return corpus, np.full(chunk, -1, np.int32), 0
    # stable sort by depth-in-document == round-robin over documents
    depth = np.concatenate([np.arange(sz) for sz in lengths])
    order = np.argsort(depth, kind="stable")
    flat_w = np.concatenate(seqs)[order]
    flat_l = np.repeat(np.asarray(label_rows, np.int64), lengths)[order]
    npad = max(chunk, ((n + chunk - 1) // chunk) * chunk)
    corpus = np.zeros(npad, np.int32)
    pos_label = np.full(npad, -1, np.int32)
    corpus[:n] = flat_w
    pos_label[:n] = flat_l
    return corpus, pos_label, n


class DeviceSkipGram(_TrainerCounters):
    """Device-resident corpus pipeline bound to a ``SequenceVectors``
    (skip-gram and CBOW; with ``label_rows`` the CBOW branch becomes
    PV-DM: each document's label row joins every window as an extra
    always-live column)."""

    def __init__(self, sv, seqs: List[np.ndarray],
                 label_rows: Optional[List[int]] = None,
                 algorithm: Optional[str] = None):
        _TrainerCounters.__init__(self, sv, sv.seed)
        self.sv = sv
        self.algorithm = algorithm or sv.algorithm
        if label_rows is not None and self.algorithm != "cbow":
            raise ValueError("label_rows requires the cbow branch")
        W = sv.window_size
        # Span sized so the expected live examples per update track the
        # host path's divergence clamp (``_effective_batch``): skip-gram
        # leaves ~(W+1)/2W of the grid live, CBOW trains one example per
        # center.
        eff = max(64, sv._effective_batch())
        if self.algorithm == "cbow":
            self.span = max(16, eff)
        else:
            live_frac = (W + 1) / (2 * W)
            self.span = max(16, int(eff / (live_frac * 2 * W)))
        corpus, sent, n = build_corpus_arrays(seqs, self.span)
        self.n_words = n
        self.npad = corpus.shape[0]
        self.n_spans = self.npad // self.span
        dev = self.device
        self.corpus = torch.from_numpy(corpus.astype(np.int64)).to(dev)
        self.sent = torch.from_numpy(sent.astype(np.int64)).to(dev)
        self.pos_label = None
        if label_rows is not None:
            # per-position label row, aligned with build_corpus_arrays'
            # contiguous layout (padding stays -1 via the sent ids)
            pos_label = np.where(
                sent >= 0,
                np.asarray(label_rows + [0], np.int64)[np.maximum(sent, 0)],
                np.int64(-1))
            self.pos_label = torch.from_numpy(pos_label).to(dev)
        (self.keep_prob, self.neg_table, self.hs_points, self.hs_codes,
         self.hs_cmask) = _trainer_tables(sv)
        self._live = torch.arange(self.npad, device=dev) < n
        K = int(sv.negative)
        self._lbl = torch.cat([torch.ones(1), torch.zeros(K)]).to(dev)
        self._ones = torch.ones((self.span, 1), device=dev)
        self._offsets = abs_offsets(W, dev)

    def _own_draws(self, n: int, gen=None, device=None) -> PassDraws:
        g = self._gen if gen is None else gen
        dev = self.device if device is None else device
        keep = (torch.rand(self.npad, generator=g, device=dev)
                if self.keep_prob is not None else None)
        shrink = torch.randint(0, self.sv.window_size, (n, self.span),
                               generator=g, device=dev)
        return PassDraws(keep, shrink, self._seeds(n, g, dev))

    def run_pass(self, pass_idx: int, total_words: int,
                 n_segments: int = 1) -> None:
        """One full corpus pass (epoch x iteration), optionally split
        into ``n_segments`` dispatches so a caller can INTERLEAVE several
        pipelines within a pass (ParagraphVectors).  Schedule, masking
        and update math are identical at any segmentation."""
        for seg in range(n_segments):
            self.run_segment(pass_idx, total_words, seg, n_segments)

    def run_segment(self, pass_idx: int, total_words: int, seg: int,
                    n_segments: int) -> None:
        sv = self.sv
        seg_spans = -(-self.n_spans // n_segments)
        lo = seg * seg_spans
        if lo >= self.n_spans:
            return
        alphas = self._alphas(pass_idx, total_words, lo, seg_spans,
                              self.span)
        draws = self._draws(seg_spans)
        W = sv.window_size
        corpus, sent, pos_label = self.corpus, self.sent, self.pos_label
        if self.keep_prob is not None:
            keep = (draws.keep < self.keep_prob[corpus]) & self._live
            dest = compact_dest(keep, self.npad)
            corpus = compact_with(corpus, dest, 0)
            sent = compact_with(sent, dest, -1)
            if pos_label is not None:
                # labels compact with the SAME dest so each kept position
                # keeps its document's label row
                pos_label = compact_with(pos_label, dest, -1)
        corpus_pad, sent_pad = pad_with_sentinels(corpus, sent, W)
        pairs = torch.zeros((), dtype=torch.float32, device=self.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        # a ragged final segment's overrun spans are no-ops in the JAX
        # scan (their mask is zeroed): the loop stops at the last span
        for j in range(min(seg_spans, self.n_spans - lo)):
            trained, loss = self._span(
                lo + j, alphas[j], draws.shrink[j],
                None if draws.seeds is None else draws.seeds[j],
                corpus_pad, sent_pad, pos_label)
            pairs = pairs + trained
            loss_sum = loss_sum + loss
        self._pending.append((pairs, loss_sum))

    def _span(self, c: int, alpha: Tensor, shrink: Tensor, seed,
              corpus_pad: Tensor, sent_pad: Tensor, pos_label):
        """One span's update, in place on the tables; returns (examples
        trained, loss) as 0-dim device tensors."""
        sv, span = self.sv, self.span
        syn0, syn1, syn1neg = self._tables()
        words, centers, pmask = pair_grid_shaped(
            corpus_pad, sent_pad, c * span, shrink, sv.window_size, span,
            self._offsets)
        if pos_label is not None:
            # PV-DM: the document label joins every window as one extra
            # always-live column (reference DM.java); a center whose
            # window is otherwise empty trains from the label alone
            s0 = min(c * span, self.npad - span)
            labs = pos_label[s0:s0 + span]
            words = torch.cat([words, labs.clamp(min=0)[:, None]], dim=1)
            pmask = torch.cat(
                [pmask, (labs >= 0).to(torch.float32)[:, None]], dim=1)
        hc = syn0[words]                               # (b, 2W[+1], d)
        cbow = self.algorithm == "cbow"
        if cbow:
            # ONE example per center: h is the masked MEAN of the window;
            # dh goes to every context word un-divided
            counts = torch.sum(pmask, dim=1)
            exmask = (counts > 0).to(torch.float32)     # (b,)
            h = (torch.einsum("bcd,bc->bd", hc, pmask)
                 / torch.clamp(counts, min=1.0)[:, None])
        loss = None
        d_syn0 = None
        if sv.use_hs:
            pts = self.hs_points[centers]               # (b, L)
            cds = self.hs_codes[centers]
            cmk = self.hs_cmask[centers]
            w = syn1[pts]                               # (b, L, d)
            if cbow:
                logits = torch.einsum("bd,bld->bl", h, w)
                g = ((1.0 - cds - torch.sigmoid(logits))
                     * cmk * exmask[:, None] * alpha)
                scatter_add_agg(syn1, pts, g[:, :, None] * h[:, None, :])
                d_syn0 = torch.einsum("bl,bld->bd", g, w)
                loss = _minus(loss, torch.sum(
                    F.logsigmoid((1.0 - 2.0 * cds) * logits)
                    * cmk * exmask[:, None]))
            else:
                logits = torch.einsum("bcd,bld->bcl", hc, w)
                g = ((1.0 - cds[:, None, :] - torch.sigmoid(logits))
                     * cmk[:, None, :] * pmask[:, :, None] * alpha)
                scatter_add_agg(syn1, pts,
                                torch.einsum("bcl,bcd->bld", g, hc))
                d_syn0 = torch.einsum("bcl,bld->bcd", g, w)
                loss = _minus(loss, torch.sum(
                    F.logsigmoid((1.0 - 2.0 * cds[:, None, :]) * logits)
                    * cmk[:, None, :] * pmask[:, :, None]))
        if sv.negative > 0:
            K = int(sv.negative)
            negs = lcg_negatives(seed, span, K, self.neg_table)
            tgt = torch.cat([centers[:, None], negs], dim=1)
            tmask = torch.cat(
                [self._ones, (negs != centers[:, None]).to(torch.float32)],
                dim=1)
            lbl = self._lbl
            w = syn1neg[tgt]                            # (b, 1+K, d)
            if cbow:
                logits = torch.einsum("bd,bkd->bk", h, w)
                g = ((lbl[None, :] - torch.sigmoid(logits))
                     * tmask * exmask[:, None] * alpha)
                scatter_add_agg(syn1neg, tgt, g[:, :, None] * h[:, None, :])
                dns = torch.einsum("bk,bkd->bd", g, w)
                loss = _minus(loss, torch.sum(F.logsigmoid(
                    torch.where(lbl[None, :] > 0, logits, -logits))
                    * tmask * exmask[:, None]))
            else:
                logits = torch.einsum("bcd,bkd->bck", hc, w)
                g = ((lbl[None, None, :] - torch.sigmoid(logits))
                     * tmask[:, None, :] * pmask[:, :, None] * alpha)
                scatter_add_agg(syn1neg, tgt,
                                torch.einsum("bck,bcd->bkd", g, hc))
                dns = torch.einsum("bck,bkd->bcd", g, w)
                loss = _minus(loss, torch.sum(F.logsigmoid(
                    torch.where(lbl[None, None, :] > 0, logits, -logits))
                    * tmask[:, None, :] * pmask[:, :, None]))
            d_syn0 = dns if d_syn0 is None else d_syn0 + dns
        if cbow:
            # the (b, d) example gradient fans out to every live context
            # cell (un-divided, word2vec.c neu1e semantics)
            scatter_add_agg(syn0, words,
                            d_syn0[:, None, :] * pmask[:, :, None])
            return torch.sum(exmask), loss
        scatter_add_agg(syn0, words, d_syn0)
        return torch.sum(pmask), loss


class DeviceDbowLabels(_TrainerCounters):
    """Device-resident PV-DBOW label-pair trainer bound to a
    ``ParagraphVectors``: corpus words + per-position label rows upload
    once (document positions interleaved, see
    :func:`build_interleaved_label_arrays`); each position contributes
    ONE (document label, word) pair (reference ``DBOW.java``).  Chunk
    size clamps to ~4x the document count so label-row duplicates per
    update stay ~4 (at least 8)."""

    def __init__(self, pv, seqs: List[np.ndarray],
                 label_rows: List[int]):
        _TrainerCounters.__init__(self, pv, pv.seed + 7919)
        self.pv = pv
        eff = max(64, pv._effective_batch())
        self.chunk = int(min(eff, max(8, 4 * len(seqs))))
        corpus, pos_label, n = build_interleaved_label_arrays(
            seqs, label_rows, self.chunk)
        self.n_words = n
        self.n_chunks = corpus.shape[0] // self.chunk
        dev = self.device
        self.corpus = torch.from_numpy(corpus.astype(np.int64)).to(dev)
        self.pos_label = torch.from_numpy(pos_label.astype(np.int64)).to(dev)
        (self.keep_prob, self.neg_table, self.hs_points, self.hs_codes,
         self.hs_cmask) = _trainer_tables(pv)
        K = int(pv.negative)
        self._lbl = torch.cat([torch.ones(1), torch.zeros(K)]).to(dev)
        self._ones = torch.ones((self.chunk, 1), device=dev)

    def _own_draws(self, n: int, gen=None, device=None) -> PassDraws:
        g = self._gen if gen is None else gen
        dev = self.device if device is None else device
        keep = (torch.rand((n, self.chunk), generator=g, device=dev)
                if self.keep_prob is not None else None)
        return PassDraws(keep, None, self._seeds(n, g, dev))

    def run_pass(self, pass_idx: int, total_words: int,
                 n_segments: int = 1) -> None:
        for seg in range(n_segments):
            self.run_segment(pass_idx, total_words, seg, n_segments)

    def run_segment(self, pass_idx: int, total_words: int, seg: int,
                    n_segments: int) -> None:
        pv = self.pv
        seg_chunks = -(-self.n_chunks // n_segments)
        lo = seg * seg_chunks
        if lo >= self.n_chunks:
            return
        alphas = self._alphas(pass_idx, total_words, lo, seg_chunks,
                              self.chunk)
        draws = self._draws(seg_chunks)
        syn0, syn1, syn1neg = self._tables()
        chunk = self.chunk
        pairs = torch.zeros((), dtype=torch.float32, device=self.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for j in range(min(seg_chunks, self.n_chunks - lo)):
            s0 = (lo + j) * chunk
            words = self.corpus[s0:s0 + chunk]
            labs = self.pos_label[s0:s0 + chunk]
            pm = (labs >= 0).to(torch.float32)         # -1 pads/OOV docs
            if self.keep_prob is not None:
                pm = pm * (draws.keep[j] < self.keep_prob[words]).to(
                    torch.float32)
            inputs = labs.clamp(min=0)
            loss = None                # the JAX loss: 0.0 + l_hs + l_ns
            if pv.use_hs:
                _, _, loss = _hs_update(
                    syn0, syn1, inputs, self.hs_points[words],
                    self.hs_codes[words], self.hs_cmask[words], pm,
                    alphas[j])
            if pv.negative > 0:
                negs = lcg_negatives(draws.seeds[j], chunk,
                                     int(pv.negative), self.neg_table)
                tgt = torch.cat([words[:, None], negs], dim=1)
                tmask = torch.cat(
                    [self._ones, (negs != words[:, None]).to(torch.float32)],
                    dim=1)
                _, _, l_ns = _ns_update(syn0, syn1neg, inputs, tgt,
                                        self._lbl, tmask, pm, alphas[j])
                loss = l_ns if loss is None else loss + l_ns
            pairs = pairs + torch.sum(pm)
            loss_sum = loss_sum + loss
        self._pending.append((pairs, loss_sum))
