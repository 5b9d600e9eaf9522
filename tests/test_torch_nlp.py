"""The port's host-side NLP modules against the JAX package's.

- tokenizers, preprocessors, sentence and label-aware iterators: the same
  tokens, sentences and labels;
- the vocab (indices, frequencies) and the Huffman codes and points,
  bitwise;
- the unigram negative table and ``block_negative_table``, bitwise;
- ``lcg_negatives``: the port's int64-and-mask arithmetic draws bitwise
  the JAX package's uint32 draws, for seeds near 0, in the middle and
  near 2^32;
- the serializer: Google text and binary files byte for byte, each read
  by the other package; full-model zips written by either package read
  in the other, with the same entry bytes;
- the bag-of-words and TF-IDF vectorizers and
  ``CnnSentenceDataSetIterator``: the same arrays.

The tables cross with ``load_jax_tables``; everything here is exact.
"""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.nlp import device_corpus as jdc
from deeplearning4j_tpu.nlp import iterators as jit_
from deeplearning4j_tpu.nlp import sentence_iterator as jsi
from deeplearning4j_tpu.nlp import serializer as jser
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.nlp import vectorizer as jvec
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JaxW2V
from deeplearning4j_tpu_torch.nlp import device_corpus as pdc
from deeplearning4j_tpu_torch.nlp import iterators as pit
from deeplearning4j_tpu_torch.nlp import sentence_iterator as psi
from deeplearning4j_tpu_torch.nlp import serializer as pser
from deeplearning4j_tpu_torch.nlp import tokenization as ptok
from deeplearning4j_tpu_torch.nlp import vectorizer as pvec
from deeplearning4j_tpu_torch.nlp import vocab as pvocab
from deeplearning4j_tpu_torch.nlp.jax_tables import load_jax_tables
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

TEXTS = ["The King rules; the kingdom (1066) is his!",
         "A queen walks: her dog runs quickly.",
         "Walking dogs, running kings and talking queens",
         "the king is a man and the queen is a woman"]


def _corpus(seed=0, n=60, vocab=40, length=(5, 25)):
    rng = np.random.RandomState(seed)
    zipf = np.minimum(rng.zipf(1.4, 4000) - 1, vocab - 1)
    out, pos = [], 0
    for _ in range(n):
        k = rng.randint(*length)
        out.append(["w%d" % w for w in zipf[pos:pos + k]])
        pos += k
    return out


# ------------------------------------------------------- text processing
@pytest.mark.parametrize("pre", ["CommonPreprocessor", "LowCasePreProcessor",
                                 "EndingPreProcessor", "StemmingPreprocessor",
                                 None])
def test_tokenizers_match_jax(pre):
    for mod_j, mod_p in [(jtok, ptok)]:
        for factory in ("DefaultTokenizerFactory", "NGramTokenizerFactory"):
            fj = getattr(mod_j, factory)()
            fp = getattr(mod_p, factory)()
            if pre is not None:
                fj.set_token_pre_processor(getattr(mod_j, pre)())
                fp.set_token_pre_processor(getattr(mod_p, pre)())
            for text in TEXTS:
                tj, tp = fj.create(text), fp.create(text)
                assert tp.count_tokens() == tj.count_tokens()
                assert list(tp) == list(tj)
                assert fp.create(text).get_tokens() == \
                    fj.create(text).get_tokens()
    assert ptok.filter_stop_words(TEXTS[3].split()) == \
        jtok.filter_stop_words(TEXTS[3].split())


def test_sentence_and_label_iterators_match_jax(tmp_path):
    class Upper(psi.SentencePreProcessor):
        def pre_process(self, s):
            return s.upper()

    class UpperJ(jsi.SentencePreProcessor):
        def pre_process(self, s):
            return s.upper()

    a = tmp_path / "a.txt"
    a.write_text("\n".join(TEXTS[:2]) + "\n")
    (tmp_path / "b.txt").write_text("\n".join(TEXTS[2:]) + "\n")
    for name, arg in [("CollectionSentenceIterator", TEXTS),
                      ("BasicLineIterator", str(a)),
                      ("FileSentenceIterator", str(tmp_path))]:
        ij, ip = getattr(jsi, name)(arg), getattr(psi, name)(arg)
        assert list(ip) == list(ij)
        ij.set_pre_processor(UpperJ())
        ip.set_pre_processor(Upper())
        assert list(ip) == list(ij)       # __iter__ resets
        assert list(ip) == list(ij)
    docs = [TEXTS[0], (TEXTS[1], "B"), TEXTS[2],
            psi.LabelledDocument(TEXTS[3], "D")]
    jdocs = docs[:3] + [jsi.LabelledDocument(TEXTS[3], "D")]
    lj = jsi.SimpleLabelAwareIterator(jdocs, jsi.LabelsSource("X_"))
    lp = psi.SimpleLabelAwareIterator(docs, psi.LabelsSource("X_"))
    assert [(d.content, d.label) for d in lp] == \
        [(d.content, d.label) for d in lj]
    assert lp.get_labels_source().get_labels() == \
        lj.get_labels_source().get_labels() == ["X_0", "X_1"]
    fixed_j = jsi.LabelsSource(labels=["p", "q"])
    fixed_p = psi.LabelsSource(labels=["p", "q"])
    assert [fixed_p.next_label(), fixed_p.next_label()] == \
        [fixed_j.next_label(), fixed_j.next_label()]


# ------------------------------------------------------- vocab, Huffman
def _vocab_rows(cache):
    return [(w.word, w.element_frequency, w.index, list(w.codes),
             list(w.points), w.is_label) for w in cache.vocab_words()]


@pytest.mark.parametrize("min_freq,max_code", [(1, 40), (2, 40), (1, 3)])
def test_vocab_and_huffman_codes_bitwise(min_freq, max_code):
    seqs = _corpus(1)
    vj = jvocab.VocabConstructor(min_freq, special_tokens=["w39"]) \
        .build_vocab(seqs)
    vp = pvocab.VocabConstructor(min_freq, special_tokens=["w39"]) \
        .build_vocab(seqs)
    jvocab.build_huffman_tree(vj, max_code)
    pvocab.build_huffman_tree(vp, max_code)
    assert _vocab_rows(vp) == _vocab_rows(vj)
    assert vp.total_word_count == vj.total_word_count
    assert vp.sequence_count == vj.sequence_count
    assert vp.words() == vj.words()
    freqs = np.random.RandomState(2).randint(1, 500, 33)
    assert pvocab.huffman_codes(freqs, max_code) == \
        jvocab.huffman_codes(freqs, max_code)


def test_negative_tables_bitwise():
    seqs = _corpus(2)
    j = JaxW2V(layer_size=8, negative=5, min_word_frequency=1, seed=3)
    p = Word2Vec(layer_size=8, negative=5, min_word_frequency=1, seed=3,
                 device="cpu")
    j.build_vocab(seqs)
    p.build_vocab(seqs)
    for size in (1000, 1_000_000):
        tj = j.lookup_table.negative_table(size)
        tp = p.lookup_table.negative_table(size)
        assert tp.dtype == tj.dtype
        np.testing.assert_array_equal(tp, tj)
    for k, seed in [(5, 3), (1, 0), (7, 12345)]:
        np.testing.assert_array_equal(
            pdc.block_negative_table(tp, k, seed),
            jdc.block_negative_table(tj, k, seed))
    keep_j = jdc.keep_probabilities(j.vocab, 1e-3)
    keep_p = pdc.keep_probabilities(p.vocab, 1e-3)
    np.testing.assert_array_equal(keep_p, keep_j)
    assert pdc.keep_probabilities(p.vocab, 0.0) is None


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1, 2 ** 31,
                                  2 ** 32 - 7, 2 ** 32 - 1])
def test_lcg_negatives_bitwise(seed):
    table = np.random.RandomState(0).randint(0, 50, (997, 5)) \
        .astype(np.int32)
    rows = 4099
    want = jdc.lcg_negatives(jnp.uint32(seed), rows, 5, jnp.asarray(table))
    got = pdc.lcg_negatives(torch.tensor(seed), rows, 5,
                            torch.from_numpy(table.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the state itself, before the block choice
    state = pdc.lcg_state(seed, rows)
    r = np.arange(rows, dtype=np.uint64)
    ref = ((np.uint64(seed) + r * np.uint64(2654435761)) % 2 ** 32
           * np.uint64(1664525) + np.uint64(1013904223)) % 2 ** 32
    np.testing.assert_array_equal(state.numpy(), ref.astype(np.int64))


# ------------------------------------------------------------- serializer
@pytest.fixture(scope="module")
def models():
    """A JAX Word2Vec fit for one epoch on the host path (HS and NS) and
    a port model with the same vocab and the JAX tables."""
    seqs = _corpus(3)
    kw = dict(layer_size=6, window_size=3, negative=3, min_word_frequency=1,
              seed=5, epochs=1, batch_size=64)
    j = JaxW2V(**kw)
    j.fit(seqs)
    p = Word2Vec(device="cpu", **kw)
    p.build_vocab(seqs)
    lt = j.lookup_table
    load_jax_tables(p, np.asarray(lt.syn0), np.asarray(lt.syn1),
                    np.asarray(lt.syn1neg))
    return j, p


def test_load_jax_tables_checks_shapes(models):
    _, p = models
    with pytest.raises(ValueError, match="syn0"):
        load_jax_tables(p, np.zeros((3, 6), np.float32))


@pytest.mark.parametrize("fmt", ["text", "binary"])
def test_google_formats_byte_for_byte_and_across(models, tmp_path, fmt):
    j, p = models
    write = {"text": "write_word_vectors",
             "binary": "write_binary_word_vectors"}[fmt]
    load = {"text": "load_txt_vectors",
            "binary": "load_binary_word_vectors"}[fmt]
    fj, fp = tmp_path / "j.vec", tmp_path / "p.vec"
    getattr(jser, write)(j, str(fj))
    getattr(pser, write)(p, str(fp))
    assert fp.read_bytes() == fj.read_bytes()
    vj, tj = getattr(jser, load)(str(fp))      # the port's file in JAX
    vp, tp = getattr(pser, load)(str(fj), device="cpu")
    assert vp.words() == vj.words()
    np.testing.assert_array_equal(tp.weights(), np.asarray(tj.syn0))
    assert tp.syn0.device.type == "cpu"


def _entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_full_model_zips_cross_both_ways(models, tmp_path):
    j, p = models
    zj, zp = tmp_path / "j.zip", tmp_path / "p.zip"
    jser.write_full_model(j, str(zj))
    pser.write_full_model(p, str(zp))
    ej, ep = _entries(zj), _entries(zp)
    assert sorted(ep) == sorted(ej) == sorted(
        ["config.json", "vocab.json", "syn0.npy", "syn1.npy", "syn1neg.npy"])
    for name in ej:
        assert ep[name] == ej[name], name
    back_p = pser.read_full_model(str(zj), device="cpu")   # JAX zip, port
    back_j = jser.read_full_model(str(zp))                # port zip, JAX
    assert _vocab_rows(back_p.vocab) == _vocab_rows(back_j.vocab)
    for name in ("syn0", "syn1", "syn1neg"):
        got = getattr(back_p.lookup_table, name)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(back_j.lookup_table, name)))
    for name in ("points", "codes"):
        i = ["points", "codes"].index(name)
        np.testing.assert_array_equal(back_p._code_arrays[i].numpy(),
                                      np.asarray(back_j._code_arrays[i]))
    assert json.loads(ep["config.json"])["negative"] == 3
    syn0 = np.load(io.BytesIO(ep["syn0.npy"]))
    np.testing.assert_array_equal(syn0, p.lookup_table.weights())


# ------------------------------------------------- vectorizers, iterators
@pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
def test_vectorizers_match_jax(cls):
    kw = dict(min_word_frequency=1, stop_words=["the", "a"])
    vj = getattr(jvec, cls)(**kw)
    vp = getattr(pvec, cls)(**kw)
    xj, xp = vj.fit_transform(TEXTS), vp.fit_transform(TEXTS)
    assert xp.dtype == xj.dtype == np.float32
    np.testing.assert_array_equal(xp, xj)
    np.testing.assert_array_equal(vp.transform("king queen dog dog"),
                                  vj.transform("king queen dog dog"))
    dj = vj.vectorize(TEXTS, [0, 1, 1, 0], 2)
    dp = vp.vectorize(TEXTS, [0, 1, 1, 0], 2)
    np.testing.assert_array_equal(dp.features, dj.features)
    np.testing.assert_array_equal(dp.labels, dj.labels)


@pytest.mark.parametrize("fmt", ["cnn", "rnn"])
def test_cnn_sentence_iterator_matches_jax(models, fmt):
    j, p = models
    words = j.vocab.words()
    rng = np.random.RandomState(7)
    sents = [" ".join(rng.choice(words + ["unk"], rng.randint(1, 9)))
             for _ in range(11)]
    labels = [("pos", "neg", "mid")[i % 3] for i in range(11)]
    ij = jit_.CnnSentenceDataSetIterator(
        j, jit_.CollectionLabeledSentenceProvider(sents, labels),
        batch_size=4, max_length=5, format=fmt)
    ip = pit.CnnSentenceDataSetIterator(
        p, pit.CollectionLabeledSentenceProvider(sents, labels),
        batch_size=4, max_length=5, format=fmt)
    bj, bp = list(ij), list(ip)
    assert len(bp) == len(bj) == 3
    for a, b in zip(bp, bj):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
        if b.features_mask is None:
            assert a.features_mask is None
        else:
            np.testing.assert_array_equal(a.features_mask, b.features_mask)


def test_c11_lookup_table_defaults_to_the_card():
    """C11: ``InMemoryLookupTable(vocab)`` took the CPU unless asked for
    the card.  Now ``device=None`` resolves as every entry point does: the
    card, or ``RuntimeError`` without one; ``device="cpu"`` builds the
    tables bitwise as before (syn0 ~ U(-0.5, 0.5) / dim from a CPU
    generator seeded by ``seed``, syn1 and syn1neg zero)."""
    from deeplearning4j_tpu_torch.nlp.lookup_table import \
        InMemoryLookupTable
    from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord
    vocab = VocabCache()
    for i, w in enumerate(("a", "b", "c", "d")):
        vocab.add_token(VocabWord(w, float(4 - i)))
    vocab.finalize_vocab()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            InMemoryLookupTable(vocab, 6)
    else:
        assert InMemoryLookupTable(vocab, 6).device.type == "cuda"
    table = InMemoryLookupTable(vocab, 6, seed=3, negative=1.0,
                                device="cpu")
    table.reset_weights()
    assert table.device.type == "cpu"
    u = torch.rand((vocab.num_words(), 6),
                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(table.syn0, (u - 0.5) / 6)
    assert torch.equal(table.syn1, torch.zeros(vocab.num_words() - 1, 6))
    assert torch.equal(table.syn1neg, torch.zeros(vocab.num_words(), 6))
