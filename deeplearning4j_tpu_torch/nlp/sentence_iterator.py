"""Sentence / document iterators (the port's own copy of
``deeplearning4j_tpu/nlp/sentence_iterator.py``).

Equivalents of the reference's
``text/sentenceiterator/`` (``SentenceIterator`` SPI, ``BasicLineIterator``,
``CollectionSentenceIterator``, ``FileSentenceIterator``,
``LineSentenceIterator``) and ``text/documentiterator/`` (LabelAware
variants, ``LabelsSource``).  Host-side IO only.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence


class SentencePreProcessor:
    def pre_process(self, sentence: str) -> str:
        raise NotImplementedError


class SentenceIterator:
    """Reference ``sentenceiterator/SentenceIterator.java``."""

    def __init__(self):
        self._preprocessor: Optional[SentencePreProcessor] = None

    def set_pre_processor(self, pre: SentencePreProcessor) -> None:
        self._preprocessor = pre

    def _apply(self, sentence: str) -> str:
        return (self._preprocessor.pre_process(sentence)
                if self._preprocessor else sentence)

    def next_sentence(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class CollectionSentenceIterator(SentenceIterator):
    """Reference ``CollectionSentenceIterator.java``."""

    def __init__(self, sentences: Sequence[str]):
        super().__init__()
        self._sentences = list(sentences)
        self._pos = 0

    def next_sentence(self) -> str:
        s = self._apply(self._sentences[self._pos])
        self._pos += 1
        return s

    def has_next(self) -> bool:
        return self._pos < len(self._sentences)

    def reset(self) -> None:
        self._pos = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference
    ``BasicLineIterator.java``)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._fh = None
        self._next_line: Optional[str] = None
        self.reset()

    def _advance(self) -> None:
        line = self._fh.readline()
        self._next_line = line.rstrip("\n") if line else None

    def next_sentence(self) -> str:
        s = self._apply(self._next_line)
        self._advance()
        return s

    def has_next(self) -> bool:
        return self._next_line is not None

    def reset(self) -> None:
        if self._fh is not None:
            self._fh.close()
        self._fh = open(self.path, "r", encoding="utf-8")
        self._advance()


class FileSentenceIterator(SentenceIterator):
    """All lines of every file under a directory (reference
    ``FileSentenceIterator.java``)."""

    def __init__(self, path: str):
        super().__init__()
        self.files = ([os.path.join(path, f) for f in sorted(os.listdir(path))]
                      if os.path.isdir(path) else [path])
        self.reset()

    def _load(self) -> None:
        self._lines: List[str] = []
        for f in self.files:
            with open(f, "r", encoding="utf-8") as fh:
                self._lines.extend(line.rstrip("\n") for line in fh)
        self._pos = 0

    def next_sentence(self) -> str:
        s = self._apply(self._lines[self._pos])
        self._pos += 1
        return s

    def has_next(self) -> bool:
        return self._pos < len(self._lines)

    def reset(self) -> None:
        self._load()


class LabelsSource:
    """Reference ``documentiterator/LabelsSource.java``: generates or stores
    document labels."""

    def __init__(self, template: str = "DOC_",
                 labels: Optional[Sequence[str]] = None):
        self.template = template
        self._labels = list(labels) if labels is not None else []
        self._counter = 0
        self._generated = labels is None

    def next_label(self) -> str:
        if self._generated:
            label = f"{self.template}{self._counter}"
            self._counter += 1
            self._labels.append(label)
            return label
        label = self._labels[self._counter]
        self._counter += 1
        return label

    def get_labels(self) -> List[str]:
        return list(self._labels)

    def reset(self) -> None:
        self._counter = 0


class LabelledDocument:
    """Reference ``documentiterator/LabelledDocument.java``."""

    def __init__(self, content: str, label: Optional[str] = None):
        self.content = content
        self.label = label


class LabelAwareIterator:
    """Reference ``documentiterator/LabelAwareIterator.java``."""

    def has_next_document(self) -> bool:
        raise NotImplementedError

    def next_document(self) -> LabelledDocument:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def get_labels_source(self) -> LabelsSource:
        raise NotImplementedError

    def __iter__(self) -> Iterator[LabelledDocument]:
        self.reset()
        while self.has_next_document():
            yield self.next_document()


class SimpleLabelAwareIterator(LabelAwareIterator):
    """Wraps (content, label) pairs or plain sentences with generated
    labels (reference ``BasicLabelAwareIterator``)."""

    def __init__(self, documents: Sequence, labels_source:
                 Optional[LabelsSource] = None):
        self._docs = list(documents)
        self._labels_source = labels_source or LabelsSource()
        self._pos = 0
        self._resolved: List[LabelledDocument] = []
        for doc in self._docs:
            if isinstance(doc, LabelledDocument):
                self._resolved.append(doc)
            elif isinstance(doc, tuple):
                self._resolved.append(LabelledDocument(doc[0], doc[1]))
            else:
                self._resolved.append(
                    LabelledDocument(doc, self._labels_source.next_label()))

    def has_next_document(self) -> bool:
        return self._pos < len(self._resolved)

    def next_document(self) -> LabelledDocument:
        d = self._resolved[self._pos]
        self._pos += 1
        return d

    def reset(self) -> None:
        self._pos = 0

    def get_labels_source(self) -> LabelsSource:
        return self._labels_source
