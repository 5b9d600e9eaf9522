"""NN-bridge iterators: sentences -> DataSet tensors (port of
``deeplearning4j_tpu/nlp/iterators.py``; host numpy onto the port's
``datasets.dataset.DataSet``).

Equivalents of the reference's
``deeplearning4j-nlp/.../iterator/CnnSentenceDataSetIterator.java``
(sentences -> padded word-vector tensors + masks for CNN text
classification), ``LabeledSentenceProvider`` SPI, and
``models/word2vec/iterator/Word2VecDataSetIterator.java`` (per-timestep
word vectors for RNNs).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..datasets.dataset import DataSet
from .tokenization import DefaultTokenizerFactory, TokenizerFactory


class LabeledSentenceProvider:
    """Reference ``iterator/LabeledSentenceProvider.java``."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_sentence(self) -> Tuple[str, str]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def all_labels(self) -> List[str]:
        raise NotImplementedError


class CollectionLabeledSentenceProvider(LabeledSentenceProvider):
    """Reference ``CollectionLabeledSentenceProvider.java``."""

    def __init__(self, sentences: Sequence[str], labels: Sequence[str]):
        if len(sentences) != len(labels):
            raise ValueError("sentences and labels must align")
        self.sentences = list(sentences)
        self.labels = list(labels)
        self._order = sorted(set(labels))
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self.sentences)

    def next_sentence(self) -> Tuple[str, str]:
        pair = (self.sentences[self._pos], self.labels[self._pos])
        self._pos += 1
        return pair

    def reset(self) -> None:
        self._pos = 0

    def all_labels(self) -> List[str]:
        return list(self._order)


class CnnSentenceDataSetIterator:
    """Sentences -> (batch, maxLen, vecSize, 1) NHWC tensors + per-timestep
    masks (reference ``CnnSentenceDataSetIterator.java``; that emits NCHW
    (b, 1, maxLen, vec) — NHWC is the layout of this framework's conv
    stack).  ``format="rnn"`` emits (batch, time, vec) for
    recurrent heads (the ``Word2VecDataSetIterator`` role)."""

    def __init__(self, word_vectors, provider: LabeledSentenceProvider,
                 batch_size: int = 32, max_length: int = 64,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 format: str = "cnn"):
        self.word_vectors = word_vectors
        self.provider = provider
        self.batch_size = batch_size
        self.max_length = max_length
        self.tokenizer_factory = tokenizer_factory \
            or DefaultTokenizerFactory()
        if format not in ("cnn", "rnn"):
            raise ValueError("format must be cnn|rnn")
        self.format = format
        self.labels = provider.all_labels()
        self._label_idx = {l: i for i, l in enumerate(self.labels)}
        self.vec_size = self._infer_vec_size()

    def _infer_vec_size(self) -> int:
        table = getattr(self.word_vectors, "lookup_table", None)
        if table is not None:
            return table.vector_length
        return self.word_vectors.vector_length

    def _vector(self, token: str) -> Optional[np.ndarray]:
        return self.word_vectors.word_vector(token) \
            if hasattr(self.word_vectors, "word_vector") \
            else self.word_vectors.vector(token)

    def reset(self) -> None:
        self.provider.reset()

    def __iter__(self):
        self.reset()
        while self.provider.has_next():
            batch = []
            while self.provider.has_next() \
                    and len(batch) < self.batch_size:
                batch.append(self.provider.next_sentence())
            ds = self._to_dataset(batch)
            if ds is not None:
                yield ds

    def _to_dataset(self, batch) -> Optional[DataSet]:
        seqs: List[np.ndarray] = []
        labels: List[int] = []
        for sentence, label in batch:
            tokens = self.tokenizer_factory.create(sentence).get_tokens()
            vecs = [self._vector(t) for t in tokens]
            vecs = [v for v in vecs if v is not None][:self.max_length]
            if not vecs:
                continue
            seqs.append(np.stack(vecs))
            labels.append(self._label_idx[label])
        if not seqs:
            return None
        b = len(seqs)
        T = max(s.shape[0] for s in seqs)
        feats = np.zeros((b, T, self.vec_size), np.float32)
        mask = np.zeros((b, T), np.float32)
        for i, s in enumerate(seqs):
            feats[i, :s.shape[0]] = s
            mask[i, :s.shape[0]] = 1.0
        y = np.eye(len(self.labels), dtype=np.float32)[labels]
        if self.format == "cnn":
            return DataSet(feats[..., None], y, features_mask=None)
        return DataSet(feats, y, features_mask=mask)
