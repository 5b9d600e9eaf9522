"""The port's cluster NLP (``deeplearning4j_tpu_torch/scaleout/nlp.py``)
against the JAX package's: ``TextPipeline``, ``CountCumSum`` and
``ClusterTfidfVectorizer`` bitwise (tokens, counts, vocab order, offsets,
idf and transforms), and ``ClusterWord2Vec`` over 4 worker threads from
the same initial tables (the JAX init loaded into the port) at the
tolerance of ``tests/test_torch_word2vec.py``'s host path (rtol 1e-5,
atol 1e-6): the workers' numpy pair and negative streams are the JAX
package's, their updates are the host path's, and the fold is the same
float64 host average in worker order."""

from collections import Counter

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import lookup_table as jlt
from deeplearning4j_tpu.scaleout import nlp as jnlp
from deeplearning4j_tpu_torch.nlp import lookup_table as plt
from deeplearning4j_tpu_torch.scaleout import nlp as pnlp

RTOL, ATOL = 1e-5, 1e-6

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the dog barks at the quick fox",
    "a lazy dog sleeps all day",
    "the fox and the dog are not friends",
    "quick brown foxes leap over lazy dogs in summer",
    "day after day the dog sleeps",
] * 4


def _vocab(cache):
    return [(w.word, w.index, w.element_frequency)
            for w in cache.vocab_words()]


@pytest.mark.parametrize("workers", [1, 3, 4])
@pytest.mark.parametrize("min_freq,stop", [(1, ()), (8, ()),
                                           (1, ("the", "a"))])
def test_text_pipeline_matches_jax(workers, min_freq, stop):
    j = jnlp.TextPipeline(min_word_frequency=min_freq, num_workers=workers,
                          stop_words=stop)
    p = pnlp.TextPipeline(min_word_frequency=min_freq, num_workers=workers,
                          stop_words=stop)
    jc, pc = j.build_vocab_cache(CORPUS), p.build_vocab_cache(CORPUS)
    assert p.sequences == j.sequences
    assert p.word_freq == j.word_freq
    assert _vocab(pc) == _vocab(jc)
    assert pc.sequence_count == jc.sequence_count == len(CORPUS)
    serial = Counter(t for s in CORPUS for t in s.split() if t not in stop)
    assert p.word_freq == serial


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 7])
def test_count_cum_sum_matches_jax(parts):
    counts = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    got = pnlp.CountCumSum(counts, num_partitions=parts).cum_sum()
    np.testing.assert_array_equal(
        got, jnlp.CountCumSum(counts, num_partitions=parts).cum_sum())
    np.testing.assert_array_equal(got, np.cumsum([0] + counts[:-1]))
    assert pnlp.CountCumSum([], num_partitions=parts).cum_sum().size == 0


@pytest.mark.parametrize("workers", [1, 4])
def test_cluster_tfidf_matches_jax(workers):
    j = jnlp.ClusterTfidfVectorizer(min_word_frequency=2,
                                    num_workers=workers,
                                    stop_words=("a",)).fit(CORPUS)
    p = pnlp.ClusterTfidfVectorizer(min_word_frequency=2,
                                    num_workers=workers,
                                    stop_words=("a",)).fit(CORPUS)
    assert _vocab(p.vocab) == _vocab(j.vocab)
    np.testing.assert_array_equal(p._vec._idf, j._vec._idf)
    for text in CORPUS[:6] + ["an unseen dog"]:
        np.testing.assert_array_equal(np.asarray(p.transform(text)),
                                      np.asarray(j.transform(text)))


def _topic_corpus(n=200, seed=0):
    rng = np.random.RandomState(seed)
    animals = ["cat", "dog", "horse", "cow", "goat"]
    tools = ["hammer", "wrench", "drill", "saw", "file"]
    out = []
    for _ in range(n):
        group = animals if rng.rand() < 0.5 else tools
        out.append(" ".join(rng.choice(group, 6)))
    return out


W2V_CASES = {
    "ns": dict(negative=5.0, use_hierarchic_softmax=False),
    "hs": dict(use_hierarchic_softmax=True),
    "hs_ns_cbow": dict(negative=3.0, use_hierarchic_softmax=True,
                       elements_learning_algorithm="cbow"),
}


@pytest.mark.parametrize("case", sorted(W2V_CASES))
def test_cluster_word2vec_matches_jax(monkeypatch, case):
    """4 workers, 2 epochs, from the JAX master's initial tables: the
    master's folded syn0/syn1/syn1neg within the host path's tolerance;
    the vocab bitwise."""
    kw = dict(num_workers=4, layer_size=12, window_size=3,
              min_word_frequency=2, batch_size=128, epochs=2, seed=7,
              learning_rate=0.05, **W2V_CASES[case])
    init = {}
    real = jlt.InMemoryLookupTable.reset_weights

    def record(self):
        real(self)
        init.update({n: np.asarray(getattr(self, n)) for n in
                     ("syn0", "syn1", "syn1neg")
                     if getattr(self, n) is not None})

    def load(self):
        for name, arr in init.items():
            setattr(self, name, torch.from_numpy(arr.copy()).to(
                self.device))

    monkeypatch.setattr(jlt.InMemoryLookupTable, "reset_weights", record)
    monkeypatch.setattr(plt.InMemoryLookupTable, "reset_weights", load)
    corpus = _topic_corpus()
    j = jnlp.ClusterWord2Vec(**kw).fit(corpus)
    p = pnlp.ClusterWord2Vec(device="cpu", **kw).fit(corpus)
    assert _vocab(p.model.vocab) == _vocab(j.model.vocab)
    names = [n for n in ("syn0", "syn1", "syn1neg")
             if getattr(j.model.lookup_table, n) is not None]
    assert names and sorted(init) == names
    for name in names:
        got = getattr(p.model.lookup_table, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        want = np.asarray(getattr(j.model.lookup_table, name))
        assert not np.array_equal(want, init[name])       # it trained
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert p.similarity("cat", "dog") == pytest.approx(
        j.similarity("cat", "dog"), rel=1e-4, abs=1e-5)


def test_replicas_never_alias_the_master():
    """Each worker's tables are its own clones on the master's device:
    training a replica leaves the master's tables as they were."""
    w2v = pnlp.ClusterWord2Vec(num_workers=2, layer_size=8, window_size=2,
                               min_word_frequency=1, negative=2.0,
                               batch_size=64, device="cpu").fit(CORPUS)
    master = w2v.model.lookup_table
    worker = w2v._make_worker(123)
    assert worker.lookup_table.device == master.device
    w2v._push_master_weights(worker)
    before = {n: getattr(master, n).clone() for n in ("syn0", "syn1",
                                                     "syn1neg")}
    for name in before:
        mine = getattr(worker.lookup_table, name)
        assert mine.data_ptr() != getattr(master, name).data_ptr()
        assert torch.equal(mine, before[name])
    worker._reset_queues()
    for seq in (s.split() for s in CORPUS):
        worker._train_sequence(seq, 0.05)
    worker._flush_queues()
    assert not torch.equal(worker.lookup_table.syn0, before["syn0"])
    for name, t in before.items():
        assert torch.equal(getattr(master, name), t)


def test_cluster_word2vec_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pnlp.ClusterWord2Vec(num_workers=2)
    w2v = pnlp.ClusterWord2Vec(num_workers=2, layer_size=4,
                               min_word_frequency=1, device="cpu")
    w2v.fit(CORPUS[:6])
    assert w2v.model.lookup_table.syn0.device.type == "cpu"
    assert w2v.has_word("dog") and w2v.word_vector("dog").shape == (4,)
    assert w2v.words_nearest("dog", top_n=3)
