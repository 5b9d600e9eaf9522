"""Dictionary-based lattice tokenizer for Japanese (the Kuromoji role;
the port's own copy of ``deeplearning4j_tpu/nlp/lattice.py``, pure
Python).

The reference vendors the full Kuromoji morphological analyzer
(``deeplearning4j-nlp-japanese``, 55 files: trie-backed dictionary,
lattice construction, Viterbi with word + connection costs, script-based
unknown-word handling).  This module implements the same algorithm at a
bundled-dictionary scale:

- :data:`DICTIONARY` — a few hundred high-frequency entries
  (surface, POS, cost); enough to prove the algorithm end to end.
  Production use loads a bigger dictionary through the same
  :class:`LatticeTokenizer` constructor.
- :class:`Trie` — common-prefix search over surfaces (Kuromoji's
  DoubleArrayTrie role).
- :class:`LatticeTokenizer` — per-position dictionary + unknown-word
  node generation, then Viterbi over (position, POS) states with word
  costs and a coarse POS-pair connection matrix.  Unknown words get
  script-dependent costs (katakana runs cheap as single tokens — they
  are usually loanword nouns; hiragana unknowns prefer short — real
  hiragana content words are in the dictionary; kanji runs moderate —
  compounds are fine as single tokens).

Segmentation quality goal (tested): all-hiragana sentences that the
script-run heuristic in ``lang.py`` cannot split
(すもももももももものうち, わたしはにほんごをべんきょうします, ...).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# (surface, pos, cost); lower cost = preferred.  POS classes: noun,
# pron, verb (conjugated surface forms included — this dictionary stores
# surfaces, not lemmas, like Kuromoji's conjugated entries), adj,
# particle, aux, adv, prefix, suffix, conj (conjunction), num.
_D: List[Tuple[str, str, int]] = [
    # --- particles (case/topic/binding; compounds as own entries) ---
    ("は", "particle", 1700), ("が", "particle", 1600),
    ("を", "particle", 1600), ("に", "particle", 1700),
    ("で", "particle", 1800), ("と", "particle", 1800),
    ("の", "particle", 1600), ("も", "particle", 1800),
    ("へ", "particle", 1800), ("や", "particle", 2000),
    ("か", "particle", 2100), ("ね", "particle", 2200),
    ("よ", "particle", 2200), ("な", "particle", 2300),
    ("から", "particle", 1900), ("まで", "particle", 1900),
    ("より", "particle", 2100), ("では", "particle", 2100),
    ("には", "particle", 2000), ("とは", "particle", 2100),
    ("への", "particle", 2100), ("でも", "particle", 2100),
    ("だけ", "particle", 2000), ("しか", "particle", 2100),
    ("ばかり", "particle", 2200), ("ながら", "particle", 2200),
    ("ので", "particle", 2000), ("のに", "particle", 2100),
    ("けど", "particle", 2100), ("けれど", "particle", 2200),
    # --- auxiliaries / polite endings / copulas ---
    ("です", "aux", 1800), ("でした", "aux", 1900),
    ("ます", "aux", 1700), ("ました", "aux", 1800),
    ("ません", "aux", 1900), ("ましょう", "aux", 2000),
    ("だ", "aux", 2000), ("だった", "aux", 2000),
    ("である", "aux", 2100), ("じゃない", "aux", 2100),
    ("ない", "aux", 1900), ("なかった", "aux", 2000),
    ("たい", "aux", 2000), ("たかった", "aux", 2100),
    ("られる", "aux", 2100), ("れる", "aux", 2200),
    ("させる", "aux", 2200), ("せる", "aux", 2300),
    ("ている", "aux", 1900), ("ています", "aux", 1900),
    ("ていた", "aux", 2000), ("てある", "aux", 2200),
    ("ておく", "aux", 2200), ("てしまう", "aux", 2200),
    ("ください", "aux", 1900),
    ("なさい", "aux", 2100), ("でしょう", "aux", 2000),
    ("だろう", "aux", 2100), ("かもしれない", "aux", 2200),
    ("はず", "aux", 2200), ("べき", "aux", 2300),
    # --- pronouns / demonstratives ---
    ("わたし", "pron", 2200), ("私", "pron", 2000),
    ("あなた", "pron", 2300), ("かれ", "pron", 2500),
    ("彼", "pron", 2100), ("彼女", "pron", 2100),
    ("これ", "pron", 2100), ("それ", "pron", 2100),
    ("あれ", "pron", 2200), ("どれ", "pron", 2300),
    ("ここ", "pron", 2100), ("そこ", "pron", 2200),
    ("あそこ", "pron", 2300), ("どこ", "pron", 2200),
    ("この", "adn", 2000), ("その", "adn", 2000),
    ("あの", "adn", 2100), ("どの", "adn", 2200),
    ("なに", "pron", 2200), ("何", "pron", 2100),
    ("だれ", "pron", 2300), ("誰", "pron", 2200),
    ("いつ", "pron", 2300), ("みんな", "pron", 2400),
    # --- common nouns (hiragana + kanji surfaces) ---
    ("うち", "noun", 2500), ("ひと", "noun", 2600), ("人", "noun", 2200),
    ("こと", "noun", 2300), ("もの", "noun", 2400), ("物", "noun", 2400),
    ("とき", "noun", 2400), ("時", "noun", 2300), ("ところ", "noun", 2500),
    ("所", "noun", 2500), ("日", "noun", 2300), ("年", "noun", 2300),
    ("月", "noun", 2400), ("今日", "noun", 2200), ("明日", "noun", 2300),
    ("昨日", "noun", 2300), ("今", "noun", 2300), ("いま", "noun", 2600),
    ("すもも", "noun", 2600), ("もも", "noun", 2600), ("桃", "noun", 2400),
    ("にほんご", "noun", 2400), ("日本語", "noun", 2100),
    ("にほん", "noun", 2500), ("日本", "noun", 2100),
    ("東京", "noun", 2200), ("大学", "noun", 2200),
    ("学生", "noun", 2200), ("がくせい", "noun", 2600),
    ("先生", "noun", 2200), ("せんせい", "noun", 2600),
    ("学校", "noun", 2200), ("がっこう", "noun", 2600),
    ("会社", "noun", 2200), ("かいしゃ", "noun", 2600),
    ("仕事", "noun", 2200), ("しごと", "noun", 2600),
    ("電車", "noun", 2300), ("でんしゃ", "noun", 2700),
    ("車", "noun", 2400), ("くるま", "noun", 2700),
    ("家", "noun", 2300), ("いえ", "noun", 2700),
    ("水", "noun", 2400), ("みず", "noun", 2700),
    ("お金", "noun", 2300), ("おかね", "noun", 2700),
    ("ご飯", "noun", 2300), ("ごはん", "noun", 2600),
    ("きもの", "noun", 2700), ("着物", "noun", 2300),
    ("はきもの", "noun", 2750), ("履物", "noun", 2400),
    ("ほん", "noun", 2700), ("本", "noun", 2300),
    ("映画", "noun", 2300), ("えいが", "noun", 2700),
    ("音楽", "noun", 2300), ("おんがく", "noun", 2700),
    ("友達", "noun", 2300), ("ともだち", "noun", 2600),
    ("家族", "noun", 2300), ("かぞく", "noun", 2700),
    ("天気", "noun", 2300), ("てんき", "noun", 2700),
    ("雨", "noun", 2400), ("あめ", "noun", 2700),
    ("朝", "noun", 2400), ("あさ", "noun", 2700),
    ("夜", "noun", 2400), ("よる", "noun", 2700),
    ("部屋", "noun", 2300), ("へや", "noun", 2700),
    ("写真", "noun", 2300), ("しゃしん", "noun", 2700),
    ("問題", "noun", 2300), ("もんだい", "noun", 2700),
    ("質問", "noun", 2300), ("しつもん", "noun", 2700),
    ("答え", "noun", 2400), ("こたえ", "noun", 2700),
    ("言葉", "noun", 2300), ("ことば", "noun", 2600),
    ("名前", "noun", 2300), ("なまえ", "noun", 2600),
    ("世界", "noun", 2300), ("せかい", "noun", 2700),
    ("国", "noun", 2400), ("くに", "noun", 2700),
    ("町", "noun", 2400), ("まち", "noun", 2700),
    ("駅", "noun", 2300), ("えき", "noun", 2700),
    ("店", "noun", 2400), ("みせ", "noun", 2700),
    ("道", "noun", 2400), ("みち", "noun", 2700),
    ("海", "noun", 2400), ("うみ", "noun", 2700),
    ("山", "noun", 2400), ("やま", "noun", 2700),
    ("空", "noun", 2400), ("そら", "noun", 2700),
    ("花", "noun", 2400), ("はな", "noun", 2700),
    ("犬", "noun", 2400), ("いぬ", "noun", 2700),
    ("猫", "noun", 2400), ("ねこ", "noun", 2700),
    ("魚", "noun", 2400), ("さかな", "noun", 2700),
    ("肉", "noun", 2400), ("にく", "noun", 2700),
    ("野菜", "noun", 2400), ("やさい", "noun", 2700),
    ("果物", "noun", 2400), ("くだもの", "noun", 2700),
    ("お茶", "noun", 2400), ("おちゃ", "noun", 2700),
    ("子供", "noun", 2300), ("こども", "noun", 2600),
    ("男", "noun", 2400), ("おとこ", "noun", 2700),
    ("女", "noun", 2400), ("おんな", "noun", 2700),
    ("目", "noun", 2500), ("手", "noun", 2500), ("足", "noun", 2500),
    ("頭", "noun", 2500), ("心", "noun", 2500), ("気", "noun", 2500),
    ("話", "noun", 2400), ("はなし", "noun", 2700),
    ("勉強", "noun", 2300), ("べんきょう", "noun", 2600),
    ("旅行", "noun", 2300), ("りょこう", "noun", 2700),
    ("料理", "noun", 2300), ("りょうり", "noun", 2700),
    ("買い物", "noun", 2300), ("かいもの", "noun", 2700),
    ("電話", "noun", 2300), ("でんわ", "noun", 2700),
    ("時間", "noun", 2300), ("じかん", "noun", 2700),
    ("時計", "noun", 2400), ("とけい", "noun", 2700),
    ("今年", "noun", 2400), ("ことし", "noun", 2700),
    ("去年", "noun", 2400), ("きょねん", "noun", 2700),
    ("来年", "noun", 2400), ("らいねん", "noun", 2700),
    # --- verbs (common surfaces incl. conjugations) ---
    ("する", "verb", 2000), ("し", "verb", 2400), ("します", "verb", 2100),
    ("して", "verb", 2200), ("した", "verb", 2200),
    ("いる", "verb", 2200), ("い", "verb", 2800), ("いた", "verb", 2500),
    ("ある", "verb", 2200), ("あった", "verb", 2400),
    ("あります", "verb", 2200), ("いく", "verb", 2400),
    ("行く", "verb", 2200), ("行った", "verb", 2300),
    ("行きます", "verb", 2300), ("いきます", "verb", 2500),
    ("くる", "verb", 2400), ("来る", "verb", 2300),
    ("きた", "verb", 2600), ("来た", "verb", 2400),
    ("きます", "verb", 2600), ("来ます", "verb", 2400),
    ("みる", "verb", 2400), ("見る", "verb", 2300),
    ("みた", "verb", 2600), ("見た", "verb", 2400),
    ("みます", "verb", 2600), ("見ます", "verb", 2400),
    ("きく", "verb", 2500), ("聞く", "verb", 2300),
    ("きいて", "verb", 2600), ("聞いて", "verb", 2400),
    ("いう", "verb", 2400), ("言う", "verb", 2300),
    ("いって", "verb", 2500), ("言って", "verb", 2400),
    ("おもう", "verb", 2500), ("思う", "verb", 2300),
    ("おもった", "verb", 2600), ("思った", "verb", 2400),
    ("たべる", "verb", 2400), ("食べる", "verb", 2300),
    ("たべた", "verb", 2500), ("食べた", "verb", 2400),
    ("たべます", "verb", 2500), ("食べます", "verb", 2400),
    ("のむ", "verb", 2500), ("飲む", "verb", 2300),
    ("のんで", "verb", 2600), ("飲んで", "verb", 2400),
    ("よむ", "verb", 2500), ("読む", "verb", 2300),
    ("よんで", "verb", 2600), ("読んで", "verb", 2400),
    ("かく", "verb", 2500), ("書く", "verb", 2300),
    ("かいて", "verb", 2600), ("書いて", "verb", 2400),
    ("はなす", "verb", 2500), ("話す", "verb", 2300),
    ("はなして", "verb", 2600), ("話して", "verb", 2400),
    ("わかる", "verb", 2400), ("分かる", "verb", 2300),
    ("わかった", "verb", 2500), ("分かった", "verb", 2400),
    ("しる", "verb", 2600), ("知る", "verb", 2300),
    ("しって", "verb", 2600), ("知って", "verb", 2400),
    ("かう", "verb", 2500), ("買う", "verb", 2300),
    ("かって", "verb", 2600), ("買って", "verb", 2400),
    ("つかう", "verb", 2500), ("使う", "verb", 2300),
    ("つかって", "verb", 2600), ("使って", "verb", 2400),
    ("つくる", "verb", 2500), ("作る", "verb", 2300),
    ("はたらく", "verb", 2500), ("働く", "verb", 2300),
    ("あるく", "verb", 2500), ("歩く", "verb", 2300),
    ("はしる", "verb", 2500), ("走る", "verb", 2300),
    ("およぐ", "verb", 2500), ("泳ぐ", "verb", 2300),
    ("ねる", "verb", 2500), ("寝る", "verb", 2300),
    ("おきる", "verb", 2500), ("起きる", "verb", 2300),
    ("すむ", "verb", 2500), ("住む", "verb", 2300),
    ("すんで", "verb", 2600), ("住んで", "verb", 2400),
    ("まつ", "verb", 2500), ("待つ", "verb", 2300),
    ("もつ", "verb", 2500), ("持つ", "verb", 2300),
    ("ぬぐ", "verb", 2600), ("脱ぐ", "verb", 2300),
    ("ぬいで", "verb", 2600), ("脱いで", "verb", 2400),
    ("わらう", "verb", 2500), ("笑う", "verb", 2300),
    ("なく", "verb", 2600), ("泣く", "verb", 2400),
    ("あそぶ", "verb", 2500), ("遊ぶ", "verb", 2300),
    ("おしえる", "verb", 2500), ("教える", "verb", 2300),
    ("ならう", "verb", 2500), ("習う", "verb", 2300),
    ("おぼえる", "verb", 2500), ("覚える", "verb", 2300),
    ("わすれる", "verb", 2500), ("忘れる", "verb", 2300),
    ("あう", "verb", 2500), ("会う", "verb", 2300),
    ("あって", "verb", 2700), ("会って", "verb", 2400),
    ("なる", "verb", 2300), ("なった", "verb", 2400),
    ("なります", "verb", 2400),
    # --- adjectives ---
    ("いい", "adj", 2200), ("よい", "adj", 2300), ("よかった", "adj", 2300),
    ("わるい", "adj", 2400), ("悪い", "adj", 2300),
    ("おおきい", "adj", 2400), ("大きい", "adj", 2300),
    ("ちいさい", "adj", 2400), ("小さい", "adj", 2300),
    ("あたらしい", "adj", 2400), ("新しい", "adj", 2300),
    ("ふるい", "adj", 2400), ("古い", "adj", 2300),
    ("たかい", "adj", 2400), ("高い", "adj", 2300),
    ("やすい", "adj", 2400), ("安い", "adj", 2300),
    ("ながい", "adj", 2400), ("長い", "adj", 2300),
    ("みじかい", "adj", 2400), ("短い", "adj", 2300),
    ("はやい", "adj", 2400), ("早い", "adj", 2300), ("速い", "adj", 2300),
    ("おそい", "adj", 2400), ("遅い", "adj", 2300),
    ("あつい", "adj", 2400), ("暑い", "adj", 2300), ("熱い", "adj", 2300),
    ("さむい", "adj", 2400), ("寒い", "adj", 2300),
    ("おいしい", "adj", 2300), ("まずい", "adj", 2500),
    ("たのしい", "adj", 2300), ("楽しい", "adj", 2300),
    ("うれしい", "adj", 2300), ("嬉しい", "adj", 2300),
    ("かなしい", "adj", 2400), ("悲しい", "adj", 2300),
    ("むずかしい", "adj", 2300), ("難しい", "adj", 2300),
    ("やさしい", "adj", 2300), ("易しい", "adj", 2400),
    ("すばらしい", "adj", 2300), ("素晴らしい", "adj", 2300),
    ("きれい", "adj", 2400), ("げんき", "adj", 2500),
    ("元気", "adj", 2300), ("しずか", "adj", 2500), ("静か", "adj", 2300),
    # --- adverbs / conjunctions ---
    ("とても", "adv", 2200), ("すこし", "adv", 2300),
    ("少し", "adv", 2300), ("ちょっと", "adv", 2300),
    ("たくさん", "adv", 2300), ("もう", "adv", 2300),
    ("まだ", "adv", 2300), ("また", "adv", 2300),
    ("いつも", "adv", 2300), ("ときどき", "adv", 2400),
    ("あまり", "adv", 2400), ("ぜんぜん", "adv", 2400),
    ("きっと", "adv", 2400), ("やっぱり", "adv", 2400),
    ("そして", "conj", 2200), ("しかし", "conj", 2300),
    ("でも", "conj", 2400), ("だから", "conj", 2300),
    ("それから", "conj", 2400), ("それで", "conj", 2400),
    # --- prefixes / suffixes / counters ---
    ("お", "prefix", 2900), ("ご", "prefix", 2900),
    ("さん", "suffix", 2200), ("ちゃん", "suffix", 2400),
    ("くん", "suffix", 2400), ("さま", "suffix", 2500),
    ("たち", "suffix", 2400), ("ら", "suffix", 2800),
    ("人", "suffix", 2600), ("円", "suffix", 2300),
    ("時", "suffix", 2600), ("分", "suffix", 2600),
]

DICTIONARY: List[Tuple[str, str, int]] = list(_D)


# Coarse POS-pair connection costs (Kuromoji's connection matrix role);
# absent pairs cost 0.  BOS/EOS are virtual.
CONNECTION_COSTS: Dict[Tuple[str, str], int] = {
    ("BOS", "particle"): 3000,   # sentences rarely open with a particle
    ("BOS", "aux"): 3000,
    ("BOS", "suffix"): 3500,
    ("particle", "particle"): 1200,  # compound particles are own entries
    ("particle", "aux"): 800,
    ("aux", "noun"): 600,
    ("noun", "noun"): 700,       # prefer one long noun over two short
    ("pron", "noun"): 900,
    ("noun", "verb"): 200,
    ("verb", "aux"): -400,       # verbs attract their auxiliaries
    ("adj", "noun"): 100,
    ("prefix", "noun"): -200,
    ("noun", "suffix"): -200,
    ("num", "suffix"): -400,
    ("unk", "unk"): 1500,        # discourage chains of unknown scraps
    ("particle", "EOS"): 900,
    ("prefix", "EOS"): 2500,
}


def load_dictionary(path: str) -> List[Tuple[str, str, int]]:
    """Load dictionary entries from a CSV/TSV file (the loadable
    counterpart of the reference's vendored Kuromoji dictionaries).

    Two line formats are accepted (auto-detected per line, ``#``
    comments and blank lines skipped; separator is TAB if present,
    else comma):

    - **simple**: ``surface,pos,cost`` — this module's native triple.
    - **MeCab-style** (``surface,left_id,right_id,word_cost,POS,...``,
      the format Kuromoji's dictionary compiler consumes): detected by
      numeric columns 2-4; the POS tag is taken from column 5 and
      mapped onto this module's coarse classes via
      :data:`MECAB_POS_MAP` (unknown tags pass through lowercased).
    """
    out: List[Tuple[str, str, int]] = []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            sep = "\t" if "\t" in line else ","
            cols = line.split(sep)
            if len(cols) >= 5 and cols[1].lstrip("-").isdigit() \
                    and cols[2].lstrip("-").isdigit() \
                    and cols[3].lstrip("-").isdigit():
                surface = cols[0]
                cost = int(cols[3])
                pos = MECAB_POS_MAP.get(cols[4], cols[4].lower())
            elif len(cols) == 3:
                surface, pos = cols[0], cols[1]
                try:
                    cost = int(cols[2])
                except ValueError:
                    raise ValueError(
                        f"{path}:{lineno}: cost column is not an int: "
                        f"{cols[2]!r}")
            else:
                raise ValueError(
                    f"{path}:{lineno}: expected 'surface,pos,cost' or "
                    f"MeCab-style 'surface,l,r,cost,POS,...'; got "
                    f"{len(cols)} columns")
            if not surface:
                raise ValueError(f"{path}:{lineno}: empty surface")
            out.append((surface, pos, cost))
    return out


#: MeCab/IPADIC top-level POS tags -> this module's coarse classes.
MECAB_POS_MAP: Dict[str, str] = {
    "名詞": "noun", "動詞": "verb", "形容詞": "adj", "副詞": "adv",
    "助詞": "particle", "助動詞": "aux", "連体詞": "adn",
    "接続詞": "conj", "感動詞": "interj", "接頭詞": "prefix",
    "接頭辞": "prefix", "接尾辞": "suffix", "代名詞": "pron",
    "記号": "punct",
}


def load_connection_matrix(path: str) -> Dict[Tuple[str, str], int]:
    """Load POS-pair connection costs (the role of Kuromoji's learned
    ``matrix.def``): one ``left_pos right_pos cost`` triple per line
    (whitespace- or comma-separated; ``#`` comments skipped).  The
    virtual classes ``BOS``/``EOS`` are valid on the left/right."""
    out: Dict[Tuple[str, str], int] = {}
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cols = line.replace(",", " ").split()
            if len(cols) != 3:
                raise ValueError(
                    f"{path}:{lineno}: expected 'left right cost', got "
                    f"{line!r}")
            out[(cols[0], cols[1])] = int(cols[2])
    return out


def save_dictionary(entries: Sequence[Tuple[str, str, int]],
                    path: str, sep: str = ",") -> None:
    """Write entries in the simple ``surface,pos,cost`` format
    :func:`load_dictionary` reads (round-trip tested)."""
    with open(path, "w", encoding="utf-8") as fh:
        for surface, pos, cost in entries:
            fh.write(f"{surface}{sep}{pos}{sep}{cost}\n")


class Trie:
    """Character trie with common-prefix search (DoubleArrayTrie role)."""

    __slots__ = ("_root",)

    def __init__(self, entries: Sequence[Tuple[str, str, int]]):
        self._root: dict = {}
        for surface, pos, cost in entries:
            node = self._root
            for ch in surface:
                node = node.setdefault(ch, {})
            node.setdefault(None, []).append((surface, pos, cost))

    def prefixes(self, text: str, start: int) -> List[Tuple[str, str, int]]:
        """All dictionary entries whose surface starts at ``start``."""
        out: List[Tuple[str, str, int]] = []
        node = self._root
        for i in range(start, len(text)):
            node = node.get(text[i])
            if node is None:
                break
            out.extend(node.get(None, ()))
        return out


def _script(ch: str) -> str:
    if "぀" <= ch <= "ゟ":
        return "hiragana"
    if "゠" <= ch <= "ヿ" or ch == "ー":
        return "katakana"
    if "一" <= ch <= "鿿" or "豈" <= ch <= "﫿":
        return "kanji"
    if ch.isdigit():
        return "digit"
    if ch.isalpha():
        return "latin"
    if ch.isspace():
        return "space"
    return "punct"


# script-dependent unknown-word costs: base + per-char (Kuromoji's
# unk.def char-class costs, coarsely)
_UNK_COSTS = {
    "katakana": (4500, 150),   # loanword nouns: whole run cheap
    "latin": (4000, 100),
    "digit": (3800, 80),
    "kanji": (5200, 700),
    "hiragana": (6000, 1700),  # real hiragana words live in the dict
}


class LatticeTokenizer:
    """Viterbi segmentation over a dictionary lattice (Kuromoji
    ``ViterbiBuilder``/``ViterbiSearcher`` role).

    >>> LatticeTokenizer().tokenize("すもももももももものうち")
    ['すもも', 'も', 'もも', 'も', 'もも', 'の', 'うち']
    """

    def __init__(self, entries: Optional[Sequence[Tuple[str, str, int]]]
                 = None,
                 connection_costs: Optional[Dict] = None):
        self.entries = list(entries) if entries is not None \
            else list(DICTIONARY)
        self.trie = Trie(self.entries)
        self.conn = dict(CONNECTION_COSTS if connection_costs is None
                         else connection_costs)

    @classmethod
    def from_files(cls, dictionary_path: str,
                   connection_path: Optional[str] = None,
                   include_bundled: bool = True) -> "LatticeTokenizer":
        """Build a tokenizer from on-disk dictionary assets — the
        loadable-dictionary tier (the reference vendors Kuromoji's
        compiled dictionaries + learned connection matrix,
        ``deeplearning4j-nlp-japanese``; here the assets are plain
        text, see :func:`load_dictionary` /
        :func:`load_connection_matrix` for the formats).

        ``include_bundled=True`` layers the file's entries OVER the
        bundled 440-entry dictionary (user-dictionary semantics —
        Kuromoji's ``UserDictionary`` augments the system dictionary);
        ``False`` uses the file alone."""
        entries = list(DICTIONARY) if include_bundled else []
        entries.extend(load_dictionary(dictionary_path))
        conn = dict(CONNECTION_COSTS) if include_bundled else {}
        if connection_path is not None:
            conn.update(load_connection_matrix(connection_path))
        return cls(entries, conn)

    # ---------------------------------------------------------------- core
    def _conn(self, left: str, right: str) -> int:
        return self.conn.get((left, right), 0)

    def _unknown_nodes(self, chunk: str, i: int
                       ) -> List[Tuple[str, str, int]]:
        s = _script(chunk[i])
        j = i
        while j < len(chunk) and _script(chunk[j]) == s and j - i < 24:
            j += 1
        run = j - i
        base, per = _UNK_COSTS.get(s, (6000, 1500))
        out = []
        # the full same-script run ...
        out.append((chunk[i:j], "unk", base + per * run))
        # ... and, for hiragana/kanji, short prefixes so the search can
        # re-synchronize with the dictionary mid-run
        if s in ("hiragana", "kanji"):
            for ln in range(1, min(run, 3)):
                out.append((chunk[i:i + ln], "unk", base + per * ln))
        return out

    def _segment_chunk(self, chunk: str) -> List[Tuple[str, str]]:
        """Viterbi over (position, POS) states; returns
        [(surface, pos), ...]."""
        n = len(chunk)
        # best[i][pos] = (cost, back) — back = (prev_i, prev_pos, surface)
        best: List[Dict[str, Tuple[int, Optional[tuple]]]] = \
            [dict() for _ in range(n + 1)]
        best[0]["BOS"] = (0, None)
        for i in range(n):
            if not best[i]:
                continue
            nodes = self.trie.prefixes(chunk, i)
            nodes += self._unknown_nodes(chunk, i)
            for surface, pos, wcost in nodes:
                j = i + len(surface)
                if j > n:
                    continue
                for left_pos, (lcost, _) in best[i].items():
                    c = lcost + wcost + self._conn(left_pos, pos)
                    cur = best[j].get(pos)
                    if cur is None or c < cur[0]:
                        best[j][pos] = (c, (i, left_pos, surface))
        # close with EOS connection
        end_pos, end_cost = None, None
        for pos, (c, _) in best[n].items():
            c2 = c + self._conn(pos, "EOS")
            if end_cost is None or c2 < end_cost:
                end_pos, end_cost = pos, c2
        if end_pos is None:
            return [(chunk, "unk")]
        # backtrack
        out: List[Tuple[str, str]] = []
        i, pos = n, end_pos
        while i > 0:
            _, back = best[i][pos]
            prev_i, prev_pos, surface = back
            out.append((surface, pos))
            i, pos = prev_i, prev_pos
        out.reverse()
        return out

    # ----------------------------------------------------------------- api
    def tokenize_with_pos(self, text: str) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        chunk = ""
        for ch in text:
            if _script(ch) in ("space", "punct"):
                if chunk:
                    out.extend(self._segment_chunk(chunk))
                    chunk = ""
            else:
                chunk += ch
        if chunk:
            out.extend(self._segment_chunk(chunk))
        return out

    def tokenize(self, text: str) -> List[str]:
        return [s for s, _ in self.tokenize_with_pos(text)]
