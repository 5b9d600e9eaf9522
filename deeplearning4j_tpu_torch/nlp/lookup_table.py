"""In-memory embedding lookup table (port of
``deeplearning4j_tpu/nlp/lookup_table.py``; reference
``models/embeddings/inmemory/InMemoryLookupTable.java``): the ``syn0``
(input embeddings), ``syn1`` (hierarchical-softmax inner nodes) and
``syn1neg`` (negative-sampling output embeddings) tables plus the
unigram negative-sampling table.

The tables are torch tensors on the model's device; the training steps
(``word2vec.py``, ``device_corpus.py``) update them in place with
``index_add_``.  ``reset_weights`` draws syn0 from a CPU
``torch.Generator`` seeded by ``seed`` and then moves it to the device,
so the card and the CPU start from the same values (which differ from
the JAX package's threefry draws: parity tests load one set of tables
into both, ``jax_tables.py``).  The negative table is host numpy, bitwise
the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .vocab import VocabCache


class InMemoryLookupTable:
    """syn0/syn1/syn1neg store + derived sampling tables."""

    def __init__(self, vocab: VocabCache, vector_length: int = 100,
                 seed: int = 42, use_hs: bool = True, negative: float = 0.0,
                 dtype=torch.float32, device: DeviceLike = None):
        self.vocab = vocab
        self.vector_length = vector_length
        self.seed = seed
        self.use_hs = use_hs
        self.negative = negative
        self.dtype = dtype
        # the card unless the caller asks for the CPU, as every entry
        # point of the port (raises when there is no card)
        self.device = resolve_device(device)
        self.syn0: Optional[torch.Tensor] = None
        self.syn1: Optional[torch.Tensor] = None
        self.syn1neg: Optional[torch.Tensor] = None
        self._neg_table: Optional[np.ndarray] = None

    def reset_weights(self) -> None:
        """word2vec init: syn0 ~ U(-0.5, 0.5)/dim; syn1* zero (reference
        ``InMemoryLookupTable.resetWeights``)."""
        v = max(self.vocab.num_words(), 1)
        d = self.vector_length
        gen = torch.Generator().manual_seed(self.seed)
        u = torch.rand((v, d), generator=gen, dtype=torch.float32)
        self.syn0 = ((u - 0.5) / d).to(self.dtype).to(self.device)
        if self.use_hs:
            self.syn1 = torch.zeros((max(v - 1, 1), d), dtype=self.dtype,
                                    device=self.device)
        if self.negative > 0:
            self.syn1neg = torch.zeros((v, d), dtype=self.dtype,
                                       device=self.device)

    # ---------------------------------------------------- negative sampling
    def negative_table(self, size: int = 1_000_000,
                       power: float = 0.75) -> np.ndarray:
        """Unigram^0.75 sampling table (reference ``makeTable``), host
        numpy."""
        if self._neg_table is None or self._neg_table.size != size:
            words = self.vocab.vocab_words()
            freqs = np.array([w.element_frequency for w in words],
                             np.float64)
            probs = freqs ** power
            probs /= probs.sum()
            counts = np.maximum(1, np.round(probs * size)).astype(np.int64)
            self._neg_table = np.repeat(np.arange(len(words)), counts)
        return self._neg_table

    # ------------------------------------------------------------- lookups
    def vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.vocab.index_of(word)
        if idx < 0 or self.syn0 is None:
            return None
        return self.syn0[idx].to("cpu", copy=True).numpy()

    def set_vector(self, word: str, vec) -> None:
        idx = self.vocab.index_of(word)
        if idx < 0:
            raise KeyError(word)
        self.syn0[idx] = torch.as_tensor(np.asarray(vec),
                                         dtype=self.syn0.dtype)

    def weights(self) -> np.ndarray:
        """A host copy of syn0 (never a view of the live table, which
        training updates in place)."""
        return self.syn0.to("cpu", copy=True).numpy()
