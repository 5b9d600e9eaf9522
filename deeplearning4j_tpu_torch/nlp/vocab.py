"""Vocabulary: VocabWord, VocabCache, VocabConstructor, Huffman coding
(the port's own copy of ``deeplearning4j_tpu/nlp/vocab.py``).

Equivalents of the reference's
``models/word2vec/wordstore/inmemory/AbstractCache.java`` (446 LoC),
``models/word2vec/wordstore/VocabConstructor.java`` (572 LoC — corpus scan,
min-word-frequency prune, special-token retention) and
``models/word2vec/Huffman.java`` (hierarchical-softmax tree: binary codes +
inner-node point paths per word).

Host-side data structures; the training steps consume the integer
codes/points arrays built here.  Codes and points are bitwise the JAX
package's for the same frequencies.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence


@dataclasses.dataclass
class VocabWord:
    """Reference ``models/word2vec/VocabWord.java``: frequency-weighted
    vocab element with Huffman code assignment."""

    word: str
    element_frequency: float = 1.0
    index: int = -1
    # Huffman assignment (reference VocabWord.codes / .points)
    codes: List[int] = dataclasses.field(default_factory=list)
    points: List[int] = dataclasses.field(default_factory=list)
    # ParagraphVectors: label elements are excluded from subsampling
    is_label: bool = False

    def increment(self, by: float = 1.0) -> None:
        self.element_frequency += by


class VocabCache:
    """Reference ``wordstore/inmemory/AbstractCache.java``: word <-> index
    <-> frequency store."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0.0

    # -- population --------------------------------------------------------
    def add_token(self, word: VocabWord) -> None:
        existing = self._words.get(word.word)
        if existing is not None:
            existing.increment(word.element_frequency)
        else:
            self._words[word.word] = word

    def update_words_occurrences(self) -> None:
        self.total_word_count = sum(w.element_frequency
                                    for w in self._words.values())

    def finalize_vocab(self) -> None:
        """Assign indices by descending frequency (ties: lexicographic),
        like the reference's sorted vocab."""
        self._by_index = sorted(self._words.values(),
                                key=lambda w: (-w.element_frequency, w.word))
        for i, w in enumerate(self._by_index):
            w.index = i
        self.update_words_occurrences()

    def remove(self, word: str) -> None:
        self._words.pop(word, None)

    # -- lookups (reference AbstractCache API) -----------------------------
    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def word_frequency(self, word: str) -> float:
        w = self._words.get(word)
        return w.element_frequency if w else 0.0

    def index_of(self, word: str) -> int:
        w = self._words.get(word)
        return w.index if w else -1

    def word_at_index(self, index: int) -> Optional[str]:
        if 0 <= index < len(self._by_index):
            return self._by_index[index].word
        return None

    def element_at_index(self, index: int) -> Optional[VocabWord]:
        if 0 <= index < len(self._by_index):
            return self._by_index[index]
        return None

    def num_words(self) -> int:
        return len(self._words)

    def words(self) -> List[str]:
        return [w.word for w in self._by_index] if self._by_index \
            else list(self._words)

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index) if self._by_index \
            else list(self._words.values())

    def __len__(self) -> int:
        return len(self._words)


class VocabConstructor:
    """Corpus scan -> pruned, index-assigned VocabCache (reference
    ``VocabConstructor.java``: ``buildJointVocabulary``, min-word-frequency
    prune at the end of the scan)."""

    def __init__(self, min_word_frequency: int = 1,
                 special_tokens: Sequence[str] = ()):
        self.min_word_frequency = min_word_frequency
        self.special_tokens = set(special_tokens)

    def build_vocab(self, sequences: Iterable[Sequence[str]],
                    cache: Optional[VocabCache] = None) -> VocabCache:
        cache = cache or VocabCache()
        counts: Counter = Counter()
        n_sequences = 0
        for seq in sequences:
            n_sequences += 1
            counts.update(seq)
        for word, count in counts.items():
            if count >= self.min_word_frequency or word in \
                    self.special_tokens:
                cache.add_token(VocabWord(word, float(count)))
        cache.finalize_vocab()
        cache.sequence_count = n_sequences
        return cache


def huffman_codes(frequencies: Sequence[int], max_code_length: int = 40):
    """Huffman codes + syn1 point paths for arbitrary frequencies
    (reference ``models/word2vec/Huffman.java``; also backs the graph
    tier's degree tree, ``deepwalk/GraphHuffman.java``).

    Standard word2vec construction: two frequency-sorted arrays merged
    bottom-up; each element's ``codes`` are its binary branch decisions
    from root to leaf, ``points`` the inner-node indices along that path
    (offsets into syn1: root = n-2, then top-down, leaf excluded).

    Input order is arbitrary — a stable descending-frequency permutation is
    applied internally and inverted on output.  Returns a list of
    ``(codes, points)`` pairs, one per input index.
    """
    freqs = [int(f) for f in frequencies]
    n = len(freqs)
    if n == 0:
        return []
    if n == 1:
        return [([], [])]
    # classic word2vec layout expects leaves sorted descending by freq
    perm = sorted(range(n), key=lambda i: -freqs[i])
    inv = [0] * n
    for sorted_pos, orig in enumerate(perm):
        inv[orig] = sorted_pos
    # count array: leaves then inner nodes
    count = [freqs[perm[i]] for i in range(n)] + [int(1e15)] * (n - 1)
    binary = [0] * (2 * n - 1)
    parent = [0] * (2 * n - 1)
    pos1, pos2 = n - 1, n
    for i in range(n - 1):
        # pick two smallest
        if pos1 >= 0 and count[pos1] < count[pos2]:
            min1, pos1 = pos1, pos1 - 1
        else:
            min1, pos2 = pos2, pos2 + 1
        if pos1 >= 0 and (pos2 >= 2 * n - 1 or count[pos1] < count[pos2]):
            min2, pos1 = pos1, pos1 - 1
        else:
            min2, pos2 = pos2, pos2 + 1
        count[n + i] = count[min1] + count[min2]
        parent[min1] = n + i
        parent[min2] = n + i
        binary[min2] = 1
    out = []
    for orig in range(n):
        codes: List[int] = []
        points: List[int] = []
        node = inv[orig]
        while node != 2 * n - 2:
            codes.append(binary[node])
            points.append(node)
            node = parent[node]
        codes.reverse()
        points.reverse()
        # After reversal ``points`` is [childOfRoot, ..., parentOfLeaf,
        # leaf].  The syn1 rows visited during training (word2vec layout,
        # reference Huffman.java) are the root (inner-node id n-2) followed
        # by the path inner nodes top-down, excluding the leaf; inner-node
        # ids shift down by n (the leaf count).
        codes = codes[:max_code_length]
        out.append((codes,
                    ([n - 2] + [p - n for p in points[:-1]])[:len(codes)]))
    return out


def build_huffman_tree(cache: VocabCache, max_code_length: int = 40) -> None:
    """Assign Huffman codes/points to every vocab word (reference
    ``models/word2vec/Huffman.java``) via :func:`huffman_codes`."""
    words = cache.vocab_words()
    if not words:
        return
    assigned = huffman_codes([int(w.element_frequency) for w in words],
                             max_code_length)
    for w, (codes, points) in zip(words, assigned):
        w.codes = codes
        w.points = points
    cache.huffman_built = True
