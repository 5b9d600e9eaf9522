"""Tokenizer SPI (the port's own copy of
``deeplearning4j_tpu/nlp/tokenization.py``).

Equivalent of the reference's
``deeplearning4j-nlp/.../text/tokenization/`` tier: ``Tokenizer`` /
``TokenizerFactory`` interfaces (``tokenizerfactory/DefaultTokenizerFactory
.java``, ``NGramTokenizerFactory.java``) and token preprocessors
(``tokenizer/preprocessor/CommonPreprocessor.java``,
``EndingPreProcessor.java``).

Pure host-side text processing — tokenization feeds the vocab build and the
device-side training; it never reaches the card.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence


class TokenPreProcess:
    """Reference ``tokenization/tokenizer/TokenPreProcess.java``."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (reference
    ``CommonPreprocessor.java``: removes ``[\\d.:,"'()\\[\\]|/?!;]``)."""

    _PATTERN = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PATTERN.sub("", token.lower())


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer (reference ``EndingPreProcessor.java``: strips s/ed/
    ing/ly endings)."""

    def pre_process(self, token: str) -> str:
        for ending in ("ing", "ed", "ly", "s"):
            if token.endswith(ending) and len(token) > len(ending) + 2:
                return token[: -len(ending)]
        return token


class StemmingPreprocessor(CommonPreprocessor):
    """Common cleanup + ending strip (reference chains porter stemming; the
    vendored snowball stemmer is out of scope)."""

    def pre_process(self, token: str) -> str:
        return EndingPreProcessor().pre_process(super().pre_process(token))


class Tokenizer:
    """Reference ``tokenization/tokenizer/Tokenizer.java`` — an iterator of
    tokens over one string."""

    def __init__(self, tokens: Sequence[str],
                 preprocessor: Optional[TokenPreProcess] = None):
        self._tokens = list(tokens)
        self._preprocessor = preprocessor
        self._pos = 0

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._preprocessor = pre

    def has_more_tokens(self) -> bool:
        return self._pos < len(self._tokens)

    def count_tokens(self) -> int:
        return len(self._tokens)

    def next_token(self) -> str:
        tok = self._tokens[self._pos]
        self._pos += 1
        return self._preprocessor.pre_process(tok) if self._preprocessor \
            else tok

    def get_tokens(self) -> List[str]:
        out = []
        while self.has_more_tokens():
            tok = self.next_token()
            if tok:
                out.append(tok)
        return out

    def __iter__(self):
        while self.has_more_tokens():
            tok = self.next_token()
            if tok:
                yield tok


class TokenizerFactory:
    """Reference ``tokenizerfactory/TokenizerFactory.java``."""

    def __init__(self):
        self._preprocessor: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._preprocessor = pre

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer (reference ``DefaultTokenizerFactory.java`` wraps
    Java's StringTokenizer on whitespace)."""

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text.split(), self._preprocessor)


class NGramTokenizerFactory(TokenizerFactory):
    """Reference ``NGramTokenizerFactory.java``: emits n-grams (joined by
    space? the reference joins with a space) from min_n to max_n over the
    base tokenizer's tokens."""

    def __init__(self, base: Optional[TokenizerFactory] = None,
                 min_n: int = 1, max_n: int = 2):
        super().__init__()
        self.base = base or DefaultTokenizerFactory()
        self.min_n = min_n
        self.max_n = max_n

    def create(self, text: str) -> Tokenizer:
        tokens = self.base.create(text).get_tokens()
        grams: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(tokens) - n + 1):
                grams.append(" ".join(tokens[i:i + n]))
        return Tokenizer(grams, self._preprocessor)


# Reference ``text/stopwords/StopWords.java`` ships a canned English list;
# this is the standard minimal set.
DEFAULT_STOP_WORDS = frozenset("""
a an and are as at be but by for if in into is it no not of on or such that
the their then there these they this to was will with
""".split())


def filter_stop_words(tokens: Iterable[str],
                      stop_words=DEFAULT_STOP_WORDS) -> List[str]:
    return [t for t in tokens if t not in stop_words]
