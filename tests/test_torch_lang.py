"""The port's language tools (``deeplearning4j_tpu_torch/nlp/lang.py`` and
``nlp/lattice.py``) against the JAX package's, on the CPU.

Every tokenizer (the Japanese lattice and heuristic modes, the Korean
one with and without josa stripping, the UIMA factory), the CAS pipeline
and the sentence iterator give the JAX package's tokens on the sentences
of ``tests/test_nlp_lang.py`` and ``tests/test_lattice_dict.py``; the
lattice's Viterbi gives its tokens and POS tags, with the bundled, a
custom and a generated dictionary and a loaded connection matrix; the
dictionary files each package writes are byte-identical, and each loads
the other's.  All exact: these modules are pure Python in both packages.
Then a port ``Word2Vec`` trains through the Japanese factory on the CPU.
"""

import itertools

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import lang as jlang
from deeplearning4j_tpu.nlp import lattice as jlat
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu_torch.nlp import lang as plang
from deeplearning4j_tpu_torch.nlp import lattice as plat
from deeplearning4j_tpu_torch.nlp import tokenization as ptok

JA = ["私は学校でコーヒーを飲みます", "東京タワーはTokyo Towerです。高さ333メートル",
      "犬と猫", "ABC犬", "すもももももももものうち",
      "わたしはにほんごをべんきょうします", "ここではきものをぬいでください",
      "東京大学で日本語を勉強しています", "コンピュータを使って仕事をします",
      "私は学生です", "今日は、いい天気です。", "深層学習を勉強します",
      "バガパはビグベです", "とびはしますから電山器をかきまわした",
      "ズヂヅヺとびはす", "ハイパリンク", ""]
KO = ["개가 고양이를 쫓는다", "서울에서 2024년", "서울에서", "은",
      "나는 학교에서 공부를 했다 ABC 123"]
EN = ["the quick fox", "Hello world. Bye now.",
      "First sentence. Second one! Third?", "これは文です。二つ目の文。",
      "  spaced   out\ttext\n", "no terminator here"]


def generated_dictionary():
    """``tests/test_lattice_dict.py::_generated_dictionary``: a few
    thousand entries none of which is bundled."""
    syl = ["バ", "ビ", "ブ", "ベ", "ボ", "ガ", "ギ", "グ", "ゲ", "ゴ",
           "パ", "ピ", "プ", "ペ", "ポ"]
    entries = [(a + b + c, "noun", 2800)
               for a, b, c in itertools.product(syl, syl, syl[:14])]
    stems = ["とびは", "かきまわ", "よみこ", "ひきだ", "おしすす",
             "まきもど", "ときあか", "ふりかえ", "うちけ", "もちあ"]
    endings = [("す", 2500), ("します", 2600), ("した", 2600),
               ("して", 2650), ("そう", 2800), ("せば", 2850)]
    entries += [(s + e, "verb", c) for s in stems for e, c in endings]
    kanji = ["電", "光", "石", "火", "風", "林", "山", "川", "空", "海"]
    entries += [(a + b + "器", "noun", 2900)
                for a, b in itertools.product(kanji, kanji)]
    return entries


# ------------------------------------------------------------ tokenizers
@pytest.mark.parametrize("mode", ["lattice", "heuristic"])
def test_japanese_factory_tokens_equal_jax(mode):
    fj = jlang.JapaneseTokenizerFactory(mode=mode)
    fp = plang.JapaneseTokenizerFactory(mode=mode)
    for text in JA:
        assert fp.create(text).get_tokens() == fj.create(text).get_tokens()
    fj.set_token_pre_processor(jtok.LowCasePreProcessor())
    fp.set_token_pre_processor(ptok.LowCasePreProcessor())
    for text in JA:
        assert fp.create(text).get_tokens() == fj.create(text).get_tokens()
    assert plang.JapaneseTokenizerFactory().create(
        "すもももももももものうち").get_tokens() == [
        "すもも", "も", "もも", "も", "もも", "の", "うち"]
    with pytest.raises(ValueError, match="unknown mode"):
        plang.JapaneseTokenizerFactory(mode="kuromoji")


def test_japanese_heuristic_function_equals_jax():
    for text in JA:
        assert plang.japanese_tokenize(text) == jlang.japanese_tokenize(text)


@pytest.mark.parametrize("strip", [True, False])
def test_korean_tokens_equal_jax(strip):
    for text in KO:
        assert plang.korean_tokenize(text, strip) == \
            jlang.korean_tokenize(text, strip)
        assert plang.KoreanTokenizerFactory(strip).create(
            text).get_tokens() == jlang.KoreanTokenizerFactory(
            strip).create(text).get_tokens()


def test_uima_pipeline_equals_jax():
    for text in EN + JA:
        assert plang.UimaTokenizerFactory().create(text).get_tokens() == \
            jlang.UimaTokenizerFactory().create(text).get_tokens()
        ej = jlang.AnalysisEngine([jlang.SentenceAnnotator(),
                                   jlang.TokenAnnotator()])
        ep = plang.AnalysisEngine([plang.SentenceAnnotator(),
                                   plang.TokenAnnotator()])
        cj, cp = ej.process(text), ep.process(text)
        assert cp.annotations == cj.annotations
        assert cp.covered("sentence") == cj.covered("sentence")
        assert cp.covered("token") == cj.covered("token")
    with pytest.raises(NotImplementedError):
        plang.Annotator().process(plang.CAS("x"))


def test_uima_sentence_iterator_equals_jax():
    ij, ip = jlang.UimaSentenceIterator(EN), plang.UimaSentenceIterator(EN)
    assert list(ip) == list(ij)
    ip.reset()
    assert ip.has_next() and ip.next_sentence() == "the quick fox"
    class Upper:
        def pre_process(self, sentence):
            return sentence.upper()

    sent = plang.UimaSentenceIterator(EN)
    sent.set_pre_processor(Upper())
    assert list(sent)[:2] == ["THE QUICK FOX", "HELLO WORLD"]


# --------------------------------------------------------------- lattice
def test_lattice_tokens_and_pos_equal_jax():
    tj, tp = jlat.LatticeTokenizer(), plat.LatticeTokenizer()
    for text in JA:
        assert tp.tokenize(text) == tj.tokenize(text)
        assert tp.tokenize_with_pos(text) == tj.tokenize_with_pos(text)
    assert tp.tokenize_with_pos("私は学生です") == [
        ("私", "pron"), ("は", "particle"), ("学生", "noun"), ("です", "aux")]
    extra = list(plat.DICTIONARY) + [("深層学習", "noun", 2000)]
    assert plat.LatticeTokenizer(entries=extra).tokenize(
        "深層学習を勉強します") == jlat.LatticeTokenizer(
        entries=extra).tokenize("深層学習を勉強します")


def test_trie_equals_jax():
    entries = list(plat.DICTIONARY) + generated_dictionary()
    tj, tp = jlat.Trie(entries), plat.Trie(entries)
    for text in JA:
        for start in range(len(text)):
            assert tp.prefixes(text, start) == tj.prefixes(text, start)


def test_dictionary_files_byte_identical_both_ways(tmp_path):
    assert plat.DICTIONARY == jlat.DICTIONARY
    entries = generated_dictionary()
    fj, fp = tmp_path / "jax.csv", tmp_path / "port.csv"
    jlat.save_dictionary(entries, str(fj))
    plat.save_dictionary(entries, str(fp))
    assert fj.read_bytes() == fp.read_bytes()
    assert plat.load_dictionary(str(fj)) == jlat.load_dictionary(str(fp)) \
        == entries
    mecab = tmp_path / "mecab.csv"
    mecab.write_text("ラピュタ,1285,1285,3000,名詞,固有名詞,*,*\n"
                     "飛ぶ,772,772,2800,動詞,自立,*,*\n"
                     "# comment\n\nトトロ\tnoun\t2400\n", encoding="utf-8")
    assert plat.load_dictionary(str(mecab)) == \
        jlat.load_dictionary(str(mecab))
    bad = tmp_path / "bad.csv"
    bad.write_text("ネコ,noun\n", encoding="utf-8")
    with pytest.raises(ValueError, match="bad.csv:1"):
        plat.load_dictionary(str(bad))


def test_generated_dictionary_and_connection_matrix_equal_jax(tmp_path):
    d = tmp_path / "big.csv"
    plat.save_dictionary(generated_dictionary(), str(d))
    m = tmp_path / "m.def"
    m.write_text("# learned\nnoun noun -100\nBOS,particle,3000\n",
                 encoding="utf-8")
    assert plat.load_connection_matrix(str(m)) == \
        jlat.load_connection_matrix(str(m))
    for kw in ({}, {"include_bundled": False}):
        tj = jlat.LatticeTokenizer.from_files(str(d), **kw)
        tp = plat.LatticeTokenizer.from_files(str(d), **kw)
        assert len(tp.entries) == len(tj.entries)
        for text in JA:
            assert tp.tokenize(text) == tj.tokenize(text)
    tj = jlat.LatticeTokenizer.from_files(str(d), str(m))
    tp = plat.LatticeTokenizer.from_files(str(d), str(m))
    for text in JA:
        assert tp.tokenize_with_pos(text) == tj.tokenize_with_pos(text)


# -------------------------------------------------------- into Word2Vec
def test_japanese_word2vec_pipeline_on_the_port():
    """``tests/test_nlp_lang.py::test_japanese_word2vec_pipeline`` with the
    port's Word2Vec on the CPU: the same vocabulary as the JAX model, and
    the animals closer to each other than to the foods."""
    from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JWord2Vec
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    rng = np.random.RandomState(0)
    animals, foods = ["犬", "猫", "馬"], ["寿司", "ラーメン", "パン"]
    sentences = []
    for _ in range(120):
        group = animals if rng.rand() < 0.5 else foods
        sentences.append("と".join(rng.choice(group, 4)) + "です")
    kw = dict(layer_size=12, window_size=3, min_word_frequency=1,
              negative=5.0, use_hierarchic_softmax=False, batch_size=128,
              seed=5, learning_rate=0.05)
    w2v = Word2Vec(tokenizer_factory=plang.JapaneseTokenizerFactory(),
                   device="cpu", **kw)
    w2v.fit(sentences)
    ref = JWord2Vec(tokenizer_factory=jlang.JapaneseTokenizerFactory(), **kw)
    ref.build_vocab([ref.tokenizer_factory.create(s).get_tokens()
                     for s in sentences])
    assert [w.word for w in w2v.vocab.vocab_words()] == \
        [w.word for w in ref.vocab.vocab_words()]
    assert w2v.similarity("犬", "猫") > w2v.similarity("犬", "寿司")
