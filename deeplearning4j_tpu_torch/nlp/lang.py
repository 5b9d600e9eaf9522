"""Language packs: Japanese / Korean tokenizers + UIMA-style pipeline
(the port's own copy of ``deeplearning4j_tpu/nlp/lang.py``, pure Python
on the port's ``tokenization.py`` and ``sentence_iterator.py``).

Equivalents of the reference's NLP language modules:

- ``deeplearning4j-nlp-japanese`` vendors the Kuromoji morphological
  analyzer (55 files incl. its dictionary).  Shipping a vendored
  dictionary is out of scope here; :class:`JapaneseTokenizerFactory` is
  an honest rule-based segmenter: script-run segmentation (kanji /
  hiragana / katakana / latin / digit runs — the backbone of Japanese
  tokenization) refined by a longest-match split of common function
  words (particles, copulas) inside hiragana runs.  Same SPI, swap in a
  dictionary tokenizer for production morphology.
- ``deeplearning4j-nlp-korean`` wraps twitter-korean-text;
  :class:`KoreanTokenizerFactory` does whitespace segmentation with
  optional josa (particle-suffix) stripping — the normalization that
  wrapper is used for in embedding pipelines.
- ``deeplearning4j-nlp-uima`` drives UIMA ``AnalysisEngine``s
  (tokenizer + sentence segmenter annotators over a CAS).  The
  :class:`AnalysisEngine` here is the same shape: annotators mutate a
  :class:`CAS` (text + typed annotation spans) in pipeline order;
  :class:`UimaTokenizerFactory` and :class:`UimaSentenceIterator`
  expose the standard tokenizer/sentence SPIs on top.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from .sentence_iterator import SentenceIterator
from .tokenization import Tokenizer, TokenizerFactory


# --------------------------------------------------------------- japanese
_HIRAGANA = ("぀", "ゟ")
_KATAKANA = ("゠", "ヿ")
_CJK = ("一", "鿿")

# Common function words (particles, copulas, auxiliaries) for the
# longest-match split inside hiragana runs; ordered scan tries longer
# entries first.
_JA_FUNCTION_WORDS = sorted(
    ["から", "まで", "です", "ます", "でした", "ました", "だった",
     "では", "には", "とは", "は", "が", "を", "に", "で", "と",
     "の", "も", "へ", "や", "ね", "よ", "か", "だ", "な"],
    key=len, reverse=True)


def _script(ch: str) -> str:
    if _HIRAGANA[0] <= ch <= _HIRAGANA[1]:
        return "hiragana"
    if _KATAKANA[0] <= ch <= _KATAKANA[1]:
        return "katakana"
    if _CJK[0] <= ch <= _CJK[1]:
        return "kanji"
    if ch.isdigit():
        return "digit"
    if ch.isalpha():
        return "latin"
    if ch.isspace():
        return "space"
    return "punct"


def _split_hiragana_run(run: str) -> List[str]:
    """Longest-match function-word segmentation of a hiragana run: peel
    known particles off the front; unknown prefixes accumulate until a
    match starts."""
    out: List[str] = []
    buf = ""
    i = 0
    while i < len(run):
        for w in _JA_FUNCTION_WORDS:
            if run.startswith(w, i):
                if buf:
                    out.append(buf)
                    buf = ""
                out.append(w)
                i += len(w)
                break
        else:
            buf += run[i]
            i += 1
    if buf:
        out.append(buf)
    return out


def japanese_tokenize(text: str) -> List[str]:
    """Script-run segmentation + hiragana function-word splitting."""
    runs: List[Tuple[str, str]] = []
    for ch in text:
        s = _script(ch)
        if runs and runs[-1][0] == s:
            runs[-1] = (s, runs[-1][1] + ch)
        else:
            runs.append((s, ch))
    tokens: List[str] = []
    for s, run in runs:
        if s in ("space", "punct"):
            continue
        if s == "hiragana":
            tokens.extend(_split_hiragana_run(run))
        else:
            tokens.append(run)
    return tokens


class JapaneseTokenizerFactory(TokenizerFactory):
    """Reference ``JapaneseTokenizerFactory`` (Kuromoji role).

    ``mode="lattice"`` (default) runs the dictionary lattice + Viterbi
    tokenizer (``nlp/lattice.py`` — the actual Kuromoji algorithm over a
    bundled dictionary); ``mode="heuristic"`` keeps the script-run
    segmenter for dictionary-free use."""

    def __init__(self, mode: str = "lattice", dictionary=None):
        super().__init__()
        if mode not in ("lattice", "heuristic"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self._lattice = None
        if mode == "lattice":
            from .lattice import LatticeTokenizer
            self._lattice = LatticeTokenizer(entries=dictionary)

    def create(self, text: str) -> Tokenizer:
        tokens = (self._lattice.tokenize(text) if self._lattice is not None
                  else japanese_tokenize(text))
        return Tokenizer(tokens, self._preprocessor)


# ----------------------------------------------------------------- korean
_KO_JOSA = sorted(
    ["은", "는", "이", "가", "을", "를", "의", "에", "에서", "에게",
     "으로", "로", "와", "과", "도", "만", "부터", "까지", "처럼",
     "보다", "한테"],
    key=len, reverse=True)


def _strip_josa(token: str) -> str:
    """Strip one trailing particle if the stem stays non-empty Hangul."""
    for josa in _KO_JOSA:
        if token.endswith(josa) and len(token) > len(josa):
            return token[:-len(josa)]
    return token


def korean_tokenize(text: str, strip_josa: bool = True) -> List[str]:
    tokens = []
    for raw in re.findall(r"[가-힣]+|[A-Za-z0-9]+", text):
        tokens.append(_strip_josa(raw) if strip_josa
                      and "가" <= raw[0] <= "힣" else raw)
    return tokens


class KoreanTokenizerFactory(TokenizerFactory):
    """Reference ``KoreanTokenizerFactory`` (twitter-korean-text role):
    Hangul/alnum segmentation with josa stripping."""

    def __init__(self, strip_josa: bool = True):
        super().__init__()
        self.strip_josa = strip_josa

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(korean_tokenize(text, self.strip_josa),
                         self._preprocessor)


# ------------------------------------------------------------------- uima
class CAS:
    """Common Analysis Structure: document text + typed annotation spans
    (reference UIMA ``CAS``/``JCas`` role, minimally)."""

    def __init__(self, text: str):
        self.text = text
        self.annotations: Dict[str, List[Tuple[int, int]]] = {}

    def add(self, type_name: str, begin: int, end: int) -> None:
        self.annotations.setdefault(type_name, []).append((begin, end))

    def covered(self, type_name: str) -> List[str]:
        return [self.text[b:e]
                for b, e in self.annotations.get(type_name, [])]


class Annotator:
    """One analysis step (reference UIMA ``AnalysisComponent``)."""

    def process(self, cas: CAS) -> None:
        raise NotImplementedError


class SentenceAnnotator(Annotator):
    """Sentence spans by terminator punctuation (the SentenceDetector
    role)."""

    _BOUNDARY = re.compile(r"[.!?。！？]+\s*")

    def process(self, cas: CAS) -> None:
        start = 0
        for m in self._BOUNDARY.finditer(cas.text):
            if m.end() > start:
                span = cas.text[start:m.start()].strip()
                if span:
                    b = cas.text.index(span, start)
                    cas.add("sentence", b, b + len(span))
            start = m.end()
        tail = cas.text[start:].strip()
        if tail:
            b = cas.text.index(tail, start)
            cas.add("sentence", b, b + len(tail))


class TokenAnnotator(Annotator):
    """Token spans (the WhitespaceTokenizer annotator role)."""

    _TOKEN = re.compile(r"\S+")

    def process(self, cas: CAS) -> None:
        for m in self._TOKEN.finditer(cas.text):
            cas.add("token", m.start(), m.end())


class AnalysisEngine:
    """Annotator pipeline (reference UIMA ``AnalysisEngine`` /
    ``AggregateAnalysisEngine``)."""

    def __init__(self, annotators: Sequence[Annotator]):
        self.annotators = list(annotators)

    def process(self, text: str) -> CAS:
        cas = CAS(text)
        for a in self.annotators:
            a.process(cas)
        return cas


class UimaTokenizerFactory(TokenizerFactory):
    """Reference ``UimaTokenizerFactory``: tokens come from the engine's
    ``token`` annotations."""

    def __init__(self, engine: Optional[AnalysisEngine] = None):
        super().__init__()
        self.engine = engine or AnalysisEngine([TokenAnnotator()])

    def create(self, text: str) -> Tokenizer:
        cas = self.engine.process(text)
        return Tokenizer(cas.covered("token"), self._preprocessor)


class UimaSentenceIterator(SentenceIterator):
    """Reference ``UimaSentenceIterator``: documents -> sentence spans via
    the engine's ``sentence`` annotations."""

    def __init__(self, documents: Sequence[str],
                 engine: Optional[AnalysisEngine] = None):
        super().__init__()
        self.documents = list(documents)
        self.engine = engine or AnalysisEngine([SentenceAnnotator()])
        self._sentences: List[str] = []
        self._build()
        self._pos = 0

    def _build(self) -> None:
        self._sentences = []
        for doc in self.documents:
            self._sentences.extend(self.engine.process(doc)
                                   .covered("sentence"))

    def has_next(self) -> bool:
        return self._pos < len(self._sentences)

    def next_sentence(self) -> str:
        s = self._sentences[self._pos]
        self._pos += 1
        return self._apply(s)

    def reset(self) -> None:
        self._pos = 0
