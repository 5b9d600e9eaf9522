"""ParagraphVectors (doc2vec; port of
``deeplearning4j_tpu/nlp/paragraph_vectors.py``).

Equivalent of the reference's
``models/paragraphvectors/ParagraphVectors.java`` with the sequence learning
algorithms ``models/embeddings/learning/impl/sequence/DBOW.java`` and
``DM.java``.

Labels (document ids) are vocabulary elements with their own syn0 rows
(reference: label elements added to the vocab with ``isLabel`` markers):

- **DBOW** (distributed bag of words): the label vector is trained to
  predict each word of its document — skip-gram with input = label.
- **DM** (distributed memory): the label vector joins the context window
  average predicting the center word — CBOW with the label appended to
  every window.

Both reuse the Word2Vec update math unchanged: the host path through
the cross-sequence batching of ``word2vec.py``, the device path through
``device_corpus.py`` (DBOW's label-pair trainer, DM as
``DeviceSkipGram(label_rows=...)``), each pass split into
``INTERLEAVE_SEGMENTS`` alternating word-side and label-side dispatches.
``infer_vector`` is a host numpy loop over a host copy of the tables.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .sentence_iterator import (LabelAwareIterator, LabelsSource,
                                SimpleLabelAwareIterator)
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabWord, build_huffman_tree
from .word2vec import SequenceVectors


class ParagraphVectors(SequenceVectors):
    """doc2vec trainer (reference ``ParagraphVectors.java``)."""

    def __init__(self, sequence_learning_algorithm: str = "dbow",
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 train_word_vectors: bool = True, **kwargs):
        kwargs.setdefault("min_word_frequency", 1)
        super().__init__(**kwargs)
        self.sequence_algorithm = sequence_learning_algorithm.lower()
        if self.sequence_algorithm not in ("dbow", "dm"):
            raise ValueError("sequence_learning_algorithm must be dbow|dm")
        self.tokenizer_factory = tokenizer_factory \
            or DefaultTokenizerFactory()
        self.train_word_vectors = train_word_vectors
        self.labels_source = LabelsSource()
        self._docs: List[Tuple[List[str], str]] = []

    # ------------------------------------------------------------ ingestion
    def _resolve_documents(self, documents) -> List[Tuple[List[str], str]]:
        if isinstance(documents, LabelAwareIterator):
            docs = list(documents)
        else:
            docs = list(SimpleLabelAwareIterator(documents,
                                                 self.labels_source))
        out = []
        for d in docs:
            tokens = (self.tokenizer_factory.create(d.content).get_tokens()
                      if isinstance(d.content, str) else list(d.content))
            out.append((tokens, d.label))
        return out

    def build_vocab_from_documents(self, docs) -> None:
        from .vocab import VocabConstructor
        constructor = VocabConstructor(
            min_word_frequency=self.min_word_frequency)
        self.vocab = constructor.build_vocab([t for t, _ in docs])
        # Label elements join the vocab with frequency 1 and is_label=True
        # (excluded from subsampling and from being prediction targets).
        for _, label in docs:
            if not self.vocab.contains_word(label):
                w = VocabWord(label, 1.0)
                w.is_label = True
                self.vocab.add_token(w)
        self.vocab.finalize_vocab()
        if self.use_hs:
            build_huffman_tree(self.vocab,
                               max_code_length=self.max_code_length)
        self._new_lookup_table()

    # ------------------------------------------------------------- training
    def _device_eligible_pv(self, docs) -> bool:
        """Route PV onto the device pipelines: the word-vector side
        reuses the skip-gram/CBOW corpus scan; DBOW's label side runs
        the label-pair scan, DM's the CBOW grid with the label joined
        as an always-live context column.  Same gating posture as
        ``SequenceVectors._device_eligible``; subclasses overriding
        ``_train_document`` keep their loop."""
        if self.sequence_algorithm not in ("dbow", "dm"):
            return False
        # DM "auto" stays on the host loop: the device DM pass converges
        # slower on small corpora (its word/label segment alternation is
        # coarser than the host's per-document interleaving) — explicit
        # pair_generation="device" opts in.
        if (self.sequence_algorithm == "dm"
                and self.pair_generation != "device"):
            return False
        if type(self)._train_document is not ParagraphVectors._train_document:
            return False
        return self._device_eligible([t for t, _ in docs])

    #: interleave granularity: each pass of each pipeline splits into
    #: this many alternating scan dispatches (approximating the host
    #: loop's per-document alternation)
    INTERLEAVE_SEGMENTS = 16

    def _run_interleaved(self, word_pipe, label_pipe):
        """Alternate word-side and label-side SEGMENTS within each pass
        (the host loop interleaves per document): running all word
        passes first leaves the predictive tables already fit to the
        contexts, so the label gradients arrive saturated — measured on
        DM: labels stayed at noise (same-topic 0.10 vs host 0.68)
        under sequential ordering, and whole-pass alternation was still
        too coarse for the fast-converging NS tables; ~16-way segment
        alternation restores host-level label quality."""
        passes = self.epochs * self.iterations
        nseg = self.INTERLEAVE_SEGMENTS if word_pipe is not None else 1
        stats = {}
        prev = {}
        for name, pipe in (("word", word_pipe), ("label", label_pipe)):
            if pipe is not None:
                prev[name] = (pipe.pairs_trained, pipe.loss_sum)
        for p in range(passes):
            for seg in range(nseg):
                if word_pipe is not None:
                    word_pipe.run_segment(p, word_pipe.n_words * passes,
                                          seg, nseg)
                label_pipe.run_segment(p, label_pipe.n_words * passes,
                                       seg, nseg)
        for name, pipe in (("word", word_pipe), ("label", label_pipe)):
            if pipe is not None:
                pipe.finish()
                p0, l0 = prev[name]
                stats[name] = {"pairs_trained": pipe.pairs_trained - p0,
                               "loss_sum": pipe.loss_sum - l0,
                               "passes": passes}
        return stats

    def _fit_device_dbow(self, docs, source=None) -> "ParagraphVectors":
        """Both device pipelines (word side + label side), with the
        corpus indexed ONCE and both built pipelines cached across
        fit() calls keyed on the caller's ``documents`` object, the
        vocab, and the baked config (the SequenceVectors cache posture:
        re-fitting for more epochs skips re-indexing/re-upload and
        draws fresh RNG via the pipelines' lifetime pass counters)."""
        from .device_corpus import DeviceDbowLabels
        conf_key = self._device_conf_key() + (self.train_word_vectors,)
        cached = getattr(self, "_device_dbow_cache", None)
        if not (cached is not None and source is not None
                and cached[0] is source and cached[1] is self.vocab
                and cached[2] == conf_key):
            cached = None
        seqs = None
        if cached is None:
            seqs = [self._sequence_to_indices(t) for t, _ in docs]
        word_pipe = (self._device_word_pipe([t for t, _ in docs],
                                            source=source, seqs_idx=seqs)
                     if self.train_word_vectors else None)
        if cached is not None:
            label_pipe = cached[3]
        else:
            labels = [self.vocab.index_of(lab) for _, lab in docs]
            keep = [(s, l) for s, l in zip(seqs, labels)
                    if s.size >= 1 and l >= 0]
            if not keep:
                # no resolvable labels: the WORD side still trains
                # (baseline behavior); zeroed label stats so a prior
                # fit's numbers can't read as this fit's
                if word_pipe is not None:
                    self._device_pipeline_stats = \
                        self._run_device_passes(word_pipe)
                self._device_dbow_stats = {"pairs_trained": 0.0,
                                           "loss_sum": 0.0, "passes": 0}
                return self
            label_pipe = DeviceDbowLabels(self, [s for s, _ in keep],
                                          [l for _, l in keep])
            if source is not None:
                self._device_dbow_cache = (source, self.vocab, conf_key,
                                           label_pipe)
        stats = self._run_interleaved(word_pipe, label_pipe)
        if "word" in stats:
            self._device_pipeline_stats = stats["word"]
        self._device_dbow_stats = stats["label"]
        return self

    def _fit_device_dm(self, docs, source=None) -> "ParagraphVectors":
        """PV-DM on the device pipelines: optional word-vector training
        (the element algorithm's corpus scan), then the DM pass — the
        CBOW grid with each document's label appended as an always-live
        window column (reference ``DM.java`` semantics; a center with an
        otherwise-empty window trains from the label alone).  Long
        documents concentrate label-row scatter duplicates within a
        span exactly as the host path's batching does — shared, 
        documented exposure; quality-tested at moderate lengths."""
        from .device_corpus import DeviceSkipGram
        conf_key = self._device_conf_key() + ("dm",
                                              self.train_word_vectors)
        cached = getattr(self, "_device_dm_cache", None)
        if not (cached is not None and source is not None
                and cached[0] is source and cached[1] is self.vocab
                and cached[2] == conf_key):
            cached = None
        seqs = None
        if cached is None:
            seqs = [self._sequence_to_indices(t) for t, _ in docs]
        word_pipe = (self._device_word_pipe([t for t, _ in docs],
                                            source=source, seqs_idx=seqs)
                     if self.train_word_vectors else None)
        if cached is not None:
            dm_pipe = cached[3]
        else:
            labels = [self.vocab.index_of(lab) for _, lab in docs]
            keep = [(s, l) for s, l in zip(seqs, labels)
                    if s.size >= 1 and l >= 0]
            if not keep:
                if word_pipe is not None:
                    self._device_pipeline_stats = \
                        self._run_device_passes(word_pipe)
                self._device_dm_stats = {"pairs_trained": 0.0,
                                         "loss_sum": 0.0, "passes": 0}
                return self
            dm_pipe = DeviceSkipGram(self, [s for s, _ in keep],
                                     label_rows=[l for _, l in keep],
                                     algorithm="cbow")
            if source is not None:
                self._device_dm_cache = (source, self.vocab, conf_key,
                                         dm_pipe)
        stats = self._run_interleaved(word_pipe, dm_pipe)
        if "word" in stats:
            self._device_pipeline_stats = stats["word"]
        self._device_dm_stats = stats["label"]
        return self

    def fit(self, documents=None) -> "ParagraphVectors":
        docs = self._resolve_documents(documents)
        self._docs = docs
        if self.vocab is None:
            self.build_vocab_from_documents(docs)
        self._reset_queues()  # drop stale pairs from an aborted prior fit
        if self._device_eligible_pv(docs):
            if self.sequence_algorithm == "dm":
                return self._fit_device_dm(docs, source=documents)
            return self._fit_device_dbow(docs, source=documents)
        total = sum(len(t) for t, _ in docs) * self.epochs * self.iterations
        seen = 0
        for _ in range(self.epochs):
            for tokens, label in docs:
                for _ in range(self.iterations):
                    seen += len(tokens)
                    alpha = max(self.min_learning_rate,
                                self.learning_rate
                                * (1.0 - seen / max(total + 1, 1)))
                    self._train_document(tokens, label, alpha)
        self._flush_queues()
        return self

    def _train_document(self, tokens: Sequence[str], label: str,
                        alpha: float) -> None:
        """Queue one document's training pairs.  Pairs accumulate across
        documents into full ``batch_size`` updates (a short document
        no longer costs its own device round-trip — the host-dispatch-bound
        anti-pattern the word2vec kernel design note warns about)."""
        word_idx = self._subsample_keep(self._sequence_to_indices(tokens))
        label_idx = self.vocab.index_of(label)
        if word_idx.size == 0 or label_idx < 0:
            return
        if self.train_word_vectors:
            self._train_sequence(tokens, alpha)
        if self.sequence_algorithm == "dbow":
            # label -> each word (skip-gram, input = label row)
            inputs = np.full(word_idx.size, label_idx, np.int64)
            self._queue_skipgram(inputs, word_idx, alpha)
        else:
            # DM: CBOW windows with the label appended to every context
            ctx, cmask, centers = self._generate_cbow(word_idx)
            if centers.size == 0:
                # single-word docs: label alone predicts the word
                ctx = np.zeros((word_idx.size, 1), np.int64)
                cmask = np.zeros((word_idx.size, 1), np.float32)
                centers = word_idx
            label_col = np.full((ctx.shape[0], 1), label_idx, np.int64)
            ctx = np.concatenate([ctx, label_col], axis=1)
            cmask = np.concatenate(
                [cmask, np.ones((cmask.shape[0], 1), np.float32)], axis=1)
            self._queue_cbow(ctx, cmask, centers, alpha)

    # ------------------------------------------------------------ inference
    def infer_vector(self, text, steps: int = 20,
                     alpha: float = 0.025) -> np.ndarray:
        """Infer a vector for an unseen document (reference
        ``inferVector``): gradient steps on a fresh row with all other
        params frozen.  Host-side loop over a tiny problem — cheap."""
        tokens = (self.tokenizer_factory.create(text).get_tokens()
                  if isinstance(text, str) else list(text))
        word_idx = self._sequence_to_indices(tokens)
        rng = np.random.RandomState(abs(hash(tuple(tokens))) % (2 ** 31))
        vec = ((rng.rand(self.layer_size) - 0.5)
               / self.layer_size).astype(np.float32)
        if word_idx.size == 0:
            return vec
        if self.use_hs:
            points, codes, cmask = [a.cpu().numpy()
                                    for a in self._code_arrays]
            syn1 = self.lookup_table.syn1.cpu().numpy()
        for _ in range(steps):
            if self.use_hs:
                for w in word_idx:
                    p, c, m = points[w], codes[w], cmask[w]
                    w1 = syn1[p]
                    logits = w1 @ vec
                    g = (1.0 - c - 1.0 / (1.0 + np.exp(-logits))) * m
                    vec = vec + alpha * (g @ w1)
            else:
                table = self.lookup_table.negative_table()
                syn1neg = self.lookup_table.syn1neg.cpu().numpy()
                for w in word_idx:
                    negs = table[rng.randint(0, table.size,
                                             int(self.negative))]
                    tgt = np.concatenate([[w], negs])
                    lbl = np.concatenate([[1.0],
                                          np.zeros(int(self.negative))])
                    w1 = syn1neg[tgt]
                    logits = w1 @ vec
                    g = lbl - 1.0 / (1.0 + np.exp(-logits))
                    vec = vec + alpha * (g @ w1)
        return vec

    def predict(self, text) -> Optional[str]:
        """Nearest label for a document (reference ``predict``)."""
        vec = self.infer_vector(text)
        labels = [w for w in self.vocab.vocab_words() if w.is_label]
        if not labels:
            return None
        m = self.lookup_table.weights()
        best, best_sim = None, -np.inf
        for w in labels:
            lv = m[w.index]
            denom = max(np.linalg.norm(lv) * np.linalg.norm(vec), 1e-12)
            sim = float(lv @ vec / denom)
            if sim > best_sim:
                best, best_sim = w.word, sim
        return best

    def label_vector(self, label: str) -> Optional[np.ndarray]:
        return self.word_vector(label)
