"""Distributed NLP on the cluster tier (port of
``deeplearning4j_tpu/scaleout/nlp.py``; the reference's
``dl4j-spark-nlp`` module):

- :class:`TextPipeline` — the reference
  ``spark/text/functions/TextPipeline.java`` role: corpus partitions are
  tokenized in parallel, per-partition word counts merge like Spark
  accumulators, and the merged counts build the pruned
  :class:`~deeplearning4j_tpu_torch.nlp.vocab.VocabCache`.
- :class:`CountCumSum` — ``spark/text/functions/CountCumSum.java``:
  partition-wise cumulative sentence word-count offsets (per-partition
  cumsum + a broadcast fold of partition totals), giving every sentence
  its global word offset without a serial pass.
- :class:`ClusterWord2Vec` — ``spark/models/embeddings/word2vec/
  Word2Vec.java`` + ``Word2VecPerformer``/``FirstIterationFunction``:
  per-partition skip-gram/CBOW training on worker replicas of
  syn0/syn1, with the master folding the per-partition results back
  (the ``Word2VecChange`` merge), epoch by epoch.  Workers run the host
  path of :mod:`deeplearning4j_tpu_torch.nlp.word2vec` (numpy pairs and
  negatives, ``index_add_`` updates of the tables in place on the
  model's device) — the compute path is single-process training's; only
  the data partitioning and the merge live here.
- :class:`ClusterTfidfVectorizer` — the Spark TF-IDF pipeline: document
  frequencies counted per partition and merged, then the single-process
  :class:`~deeplearning4j_tpu_torch.nlp.vectorizer.TfidfVectorizer` transform
  applies.

Workers run on a thread pool in-process — the Spark ``local[N]`` test
pattern (reference ``BaseSparkTest.java:45``); on a real pod each host
runs its partition and the merge crosses hosts (see :mod:`.dcn`).

The tables live on the model's device (``device`` among the Word2Vec
kwargs; None: the card): each worker's replica is its own ``clone()`` of
the master's tables on that device (the updates write in place, so a
view would train the master from every thread), and the fold is a host
float64 average in worker order whose float32 result is written back to
the master table's device.
"""

from __future__ import annotations

from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..nlp.tokenization import DefaultTokenizerFactory, TokenizerFactory
from ..nlp.vocab import (VocabCache, VocabWord, build_huffman_tree)
from ..nlp.word2vec import Word2Vec
from .data import partition_evenly as _partition


class TextPipeline:
    """Distributed tokenize + count + vocab build (reference
    ``TextPipeline.java``: ``tokenizeRDD``, ``updateAndReturnAccumulatorVal``,
    ``filterMinWordAddVocab``)."""

    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1, num_workers: int = 4,
                 stop_words: Sequence[str] = ()):
        self.tokenizer_factory = tokenizer_factory \
            or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.num_workers = max(1, num_workers)
        self.stop_words = set(stop_words)
        self.word_freq: Counter = Counter()     # accumulator analogue

    def tokenize(self, corpus: Iterable[str]) -> List[List[str]]:
        """Tokenize partitions in parallel; drops stop words."""
        sentences = list(corpus)
        parts = _partition(sentences, self.num_workers)

        def tok_part(part: List[str]) -> List[List[str]]:
            out = []
            for text in part:
                toks = self.tokenizer_factory.create(text).get_tokens()
                out.append([t for t in toks if t not in self.stop_words])
            return out

        if len(parts) == 1:
            chunks = [tok_part(parts[0])]
        else:
            with ThreadPoolExecutor(max_workers=len(parts)) as pool:
                chunks = list(pool.map(tok_part, parts))
        return [seq for chunk in chunks for seq in chunk]

    def build_vocab_cache(self, corpus: Iterable[str]) -> VocabCache:
        """Tokenize + count (per-partition counters merged like Spark
        accumulators) -> min-frequency-pruned, index-assigned vocab."""
        sequences = self.tokenize(corpus)
        parts = _partition(sequences, self.num_workers)

        def count_part(part: List[List[str]]) -> Counter:
            c: Counter = Counter()
            for seq in part:
                c.update(seq)
            return c

        if len(parts) == 1:
            counters = [count_part(parts[0])] if parts else [Counter()]
        else:
            with ThreadPoolExecutor(max_workers=len(parts)) as pool:
                counters = list(pool.map(count_part, parts))
        self.word_freq = Counter()
        for c in counters:
            self.word_freq.update(c)

        cache = VocabCache()
        for word, count in self.word_freq.items():
            if count >= self.min_word_frequency:
                cache.add_token(VocabWord(word, float(count)))
        cache.finalize_vocab()
        cache.sequence_count = len(sequences)
        self.sequences = sequences
        return cache


class CountCumSum:
    """Global per-sentence word offsets from partitioned counts (reference
    ``CountCumSum.java``: ``cumSumWithinPartition`` then a broadcast map of
    partition totals)."""

    def __init__(self, sentence_counts: Sequence[int], num_partitions: int = 4):
        self.sentence_counts = list(sentence_counts)
        self.num_partitions = max(1, num_partitions)

    def cum_sum(self) -> np.ndarray:
        """Exclusive cumulative sum: element i = number of words before
        sentence i."""
        parts = _partition(self.sentence_counts, self.num_partitions)

        def part_cumsum(part: List[int]) -> np.ndarray:
            return np.cumsum([0] + part[:-1]) if part else np.empty(0, int)

        with ThreadPoolExecutor(max_workers=len(parts) or 1) as pool:
            local = list(pool.map(part_cumsum, parts))
        totals = [sum(p) for p in parts]
        offsets = np.cumsum([0] + totals[:-1])        # the broadcast fold
        return np.concatenate([lc + off for lc, off in zip(local, offsets)]) \
            if local else np.empty(0, int)


class ClusterWord2Vec:
    """Data-parallel Word2Vec (reference Spark ``Word2Vec.java``: the master
    builds the vocab via TextPipeline, executors each train their sentence
    partition against a replica of syn0/syn1, and the master merges the
    per-partition results each epoch).

    The merge is a words-processed-weighted average of the replicas'
    syn0/syn1/syn1neg — the param-averaging semantics of the rest of the
    scaleout tier (the reference accumulates per-index ``Word2VecChange``
    deltas; with dense batched kernels the weighted average is the
    equivalent fold).
    """

    def __init__(self, num_workers: int = 4,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 **w2v_kwargs):
        self.num_workers = max(1, num_workers)
        self.tokenizer_factory = tokenizer_factory \
            or DefaultTokenizerFactory()
        self.w2v_kwargs = dict(w2v_kwargs)
        self.epochs = int(self.w2v_kwargs.pop("epochs", 1))
        # the master model: holds vocab + the authoritative lookup table
        self.model = Word2Vec(tokenizer_factory=self.tokenizer_factory,
                              epochs=1, **self.w2v_kwargs)

    # -- replica plumbing --------------------------------------------------
    def _make_worker(self, seed: int) -> Word2Vec:
        w = Word2Vec(tokenizer_factory=self.tokenizer_factory, epochs=1,
                     seed=seed, **{k: v for k, v in self.w2v_kwargs.items()
                                   if k != "seed"})
        master = self.model
        w.vocab = master.vocab                      # shared, read-only
        w.lookup_table = type(master.lookup_table)(
            master.vocab, master.layer_size, seed, master.use_hs,
            master.negative, device=master.lookup_table.device)
        w._code_arrays = master._code_arrays        # shared, read-only
        return w

    def _push_master_weights(self, worker: Word2Vec) -> None:
        lt, mt = worker.lookup_table, self.model.lookup_table
        # Clone: the updates write the tables in place, so replicas must
        # not alias the master's (or each other's) tensors.
        for name in ("syn0", "syn1", "syn1neg"):
            t = getattr(mt, name)
            setattr(lt, name, None if t is None else t.clone())

    def fit(self, sentences: Iterable[str]) -> "ClusterWord2Vec":
        pipeline = TextPipeline(self.tokenizer_factory,
                                self.model.min_word_frequency,
                                self.num_workers,
                                stop_words=tuple(self.model.stop_words))
        vocab = pipeline.build_vocab_cache(sentences)
        sequences = pipeline.sequences
        master = self.model
        master.vocab = vocab
        if master.use_hs:
            build_huffman_tree(vocab,
                               max_code_length=master.max_code_length)
        from ..nlp.lookup_table import InMemoryLookupTable
        master.lookup_table = InMemoryLookupTable(
            vocab, master.layer_size, master.seed, master.use_hs,
            master.negative, device=master.device)
        master.lookup_table.reset_weights()
        master._prepare_code_arrays()

        workers = [self._make_worker(master.seed + 1 + i)
                   for i in range(self.num_workers)]

        for epoch in range(self.epochs):
            parts = _partition(sequences, self.num_workers)

            def train_part(worker: Word2Vec, part: List[List[str]]):
                self._push_master_weights(worker)
                worker._reset_queues()
                n_words = sum(len(s) for s in part) * worker.iterations
                seen, total = 0, max(n_words, 1)
                for seq in part:
                    # each sequence trains `iterations` times, like
                    # SequenceVectors.fit
                    for _ in range(worker.iterations):
                        seen += len(seq)
                        alpha = max(
                            worker.min_learning_rate,
                            worker.learning_rate
                            * (1.0 - seen / (total + 1)))
                        worker._train_sequence(seq, alpha)
                worker._flush_queues()
                return worker.lookup_table, n_words

            if len(parts) == 1:
                results = [train_part(workers[0], parts[0])]
            else:
                with ThreadPoolExecutor(max_workers=len(parts)) as pool:
                    results = list(pool.map(train_part, workers, parts))

            # -- the Word2VecChange fold ---------------------------------
            weights = np.array([max(n, 1) for _, n in results], np.float64)
            weights /= weights.sum()
            mt = master.lookup_table
            for name in ("syn0", "syn1", "syn1neg"):
                mats = [getattr(lt, name) for lt, _ in results]
                if mats[0] is None:
                    continue
                acc = np.zeros(tuple(mats[0].shape), np.float64)
                for m, w in zip(mats, weights):
                    acc += w * m.cpu().numpy().astype(np.float64)
                setattr(mt, name, torch.from_numpy(
                    acc.astype(np.float32)).to(mt.device))
        return self

    # -- WordVectors API (delegates) ---------------------------------------
    def word_vector(self, word: str):
        return self.model.word_vector(word)

    def similarity(self, w1: str, w2: str) -> float:
        return self.model.similarity(w1, w2)

    def words_nearest(self, word_or_vec, negative=None, top_n: int = 10):
        return self.model.words_nearest(word_or_vec, negative,
                                        top_n=top_n)

    def has_word(self, word: str) -> bool:
        return self.model.has_word(word)


class ClusterTfidfVectorizer:
    """Distributed TF-IDF fit (the Spark TF-IDF pipeline): per-partition
    document-frequency counters merge on the master, transform stays
    single-process (it is embarrassingly parallel per document)."""

    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1, num_workers: int = 4,
                 stop_words: Sequence[str] = ()):
        from ..nlp.vectorizer import TfidfVectorizer
        self.num_workers = max(1, num_workers)
        self._vec = TfidfVectorizer(
            tokenizer_factory=tokenizer_factory or DefaultTokenizerFactory(),
            min_word_frequency=min_word_frequency, stop_words=stop_words)

    def fit(self, texts: Iterable[str]) -> "ClusterTfidfVectorizer":
        texts = list(texts)
        pipeline = TextPipeline(self._vec.tokenizer_factory,
                                self._vec.min_word_frequency,
                                self.num_workers,
                                stop_words=tuple(self._vec.stop_words))
        seqs = pipeline.tokenize(texts)
        parts = _partition(seqs, self.num_workers)

        def df_part(part: List[List[str]]):
            df: Counter = Counter()
            tf: Counter = Counter()
            for seq in part:
                df.update(set(seq))
                tf.update(seq)
            return df, tf, len(part)

        with ThreadPoolExecutor(max_workers=len(parts) or 1) as pool:
            results = list(pool.map(df_part, parts))
        df_all: Counter = Counter()
        tf_all: Counter = Counter()
        n_docs = 0
        for df, tf, n in results:
            df_all.update(df)
            tf_all.update(tf)
            n_docs += n

        # install the merged statistics into the single-process vectorizer
        v = self._vec
        cache = VocabCache()
        for word, count in tf_all.items():
            if count >= v.min_word_frequency:
                cache.add_token(VocabWord(word, float(count)))
        cache.finalize_vocab()
        v.vocab = cache
        df = np.array([df_all[w] for w in cache.words()], np.float64)
        v._idf = np.log(max(n_docs, 1)
                        / np.maximum(df, 1.0)).astype(np.float32)
        return self

    def transform(self, text: str) -> np.ndarray:
        return self._vec.transform(text)

    @property
    def vocab(self) -> VocabCache:
        return self._vec.vocab
