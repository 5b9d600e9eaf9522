"""Bag-of-words / TF-IDF vectorizers (port of
``deeplearning4j_tpu/nlp/vectorizer.py``; host numpy onto the port's
``datasets.dataset.DataSet``).

Equivalent of the reference's ``bagofwords/vectorizer/``
(``BagOfWordsVectorizer.java``, ``TfidfVectorizer.java``): corpus scan ->
vocab, then text -> fixed-width count / tf-idf vectors, optionally paired
with labels as a classification :class:`DataSet`.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Optional, Sequence

import numpy as np

from ..datasets.dataset import DataSet
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor


class BagOfWordsVectorizer:
    """Count vectors over a fixed vocab (reference
    ``BagOfWordsVectorizer``)."""

    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1,
                 stop_words: Sequence[str] = ()):
        self.tokenizer_factory = tokenizer_factory \
            or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.stop_words = set(stop_words)
        self.vocab: Optional[VocabCache] = None

    def _tokenize(self, text: str) -> List[str]:
        tokens = self.tokenizer_factory.create(text).get_tokens()
        return [t for t in tokens if t not in self.stop_words]

    def fit(self, texts: Iterable[str]) -> "BagOfWordsVectorizer":
        seqs = [self._tokenize(t) for t in texts]
        self.vocab = VocabConstructor(
            min_word_frequency=self.min_word_frequency).build_vocab(seqs)
        self._post_fit(seqs)
        return self

    def _post_fit(self, seqs: List[List[str]]) -> None:
        pass

    def transform(self, text: str) -> np.ndarray:
        counts = Counter(self._tokenize(text))
        vec = np.zeros(self.vocab.num_words(), np.float32)
        for tok, c in counts.items():
            idx = self.vocab.index_of(tok)
            if idx >= 0:
                vec[idx] = self._weight(tok, c)
        return vec

    def _weight(self, token: str, count: int) -> float:
        return float(count)

    def fit_transform(self, texts: Sequence[str]) -> np.ndarray:
        self.fit(texts)
        return np.stack([self.transform(t) for t in texts])

    def vectorize(self, texts: Sequence[str],
                  labels: Sequence[int], n_classes: int) -> DataSet:
        """texts+labels -> classification DataSet (reference
        ``vectorize``)."""
        features = np.stack([self.transform(t) for t in texts])
        y = np.eye(n_classes, dtype=np.float32)[np.asarray(labels)]
        return DataSet(features, y)


class TfidfVectorizer(BagOfWordsVectorizer):
    """TF-IDF weighting (reference ``TfidfVectorizer.java``:
    idf = log(N / df), tf = raw count)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._idf: Optional[np.ndarray] = None

    def _post_fit(self, seqs: List[List[str]]) -> None:
        n_docs = max(len(seqs), 1)
        df = np.zeros(self.vocab.num_words(), np.float64)
        for seq in seqs:
            for tok in set(seq):
                idx = self.vocab.index_of(tok)
                if idx >= 0:
                    df[idx] += 1
        self._idf = np.log(n_docs / np.maximum(df, 1.0)).astype(np.float32)

    def _weight(self, token: str, count: int) -> float:
        return float(count) * float(self._idf[self.vocab.index_of(token)])
