"""The port's Word2Vec (``nlp/word2vec.py``, ``nlp/device_corpus.py``)
against the JAX package's, with the tables carried across by
``load_jax_tables``.

- the four update functions (skip-gram HS/NS, CBOW HS/NS) on the same
  inputs, with duplicate rows and masked pairs;
- the host-path ``fit`` (skip-gram and CBOW, HS, NS and both) after 2
  epochs from the same init: every batch's pairs, negatives and lr are
  bitwise the JAX package's (the numpy ``RandomState`` stream), and the
  tables agree;
- ``pair_grid_shaped`` and ``subsample_compact``;
- one whole device-pipeline pass (``pair_generation="device"``, with
  subsampling) fed the JAX package's exact threefry draws through
  ``SequenceVectors.draw_source`` (:func:`jax_draws` recomputes them key
  by key as ``_epoch_fn`` splits them), for skip-gram NS, skip-gram HS
  and CBOW HS+NS: the same pair count and tables;
- ``words_nearest`` (plain and analogy) and ``similarity`` on the same
  tables.

Tolerance fp32, rtol 1e-5, atol 1e-6 element by element, for the
single updates and the whole fits alike: the einsums sum in another order
than XLA's dot and the sigmoid differs in the last bit, and over a few
hundred sequential updates (each feeding the next one's logits) the
largest gap seen on these corpora is 1.2e-6 absolute on entries of ~0.7.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nlp import device_corpus as jdc
from deeplearning4j_tpu.nlp import word2vec as jw2v
from deeplearning4j_tpu_torch.nlp import device_corpus as pdc
from deeplearning4j_tpu_torch.nlp import word2vec as pw2v
from deeplearning4j_tpu_torch.nlp.jax_tables import load_jax_tables

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def corpus(seed=0, n_sent=120, vocab=48, length=(6, 40)):
    """Zipf-distributed sentences over ``vocab`` words (a few thousand
    words in all)."""
    rng = np.random.RandomState(seed)
    zipf = np.minimum(rng.zipf(1.3, 20000) - 1, vocab - 1)
    out, pos = [], 0
    for _ in range(n_sent):
        k = rng.randint(*length)
        out.append(["w%d" % w for w in zipf[pos:pos + k]])
        pos += k
    return out


def jax_draws(pipe, count, n):
    """The JAX package's draws for a port pipeline's ``count``-th
    dispatch of ``n`` spans (chunks): ``_TrainerCounters._next_key`` then
    the splits of ``_epoch_fn`` / ``_labelpair_epoch_fn``."""
    key = jax.random.fold_in(jax.random.PRNGKey(pipe.key_seed), count)
    keep = shrink = seeds = None
    if isinstance(pipe, pdc.DeviceSkipGram):
        if pipe.keep_prob is not None:
            key, sub = jax.random.split(key)
            keep = jax.random.uniform(sub, (pipe.npad,))
        kbn = jax.vmap(jax.random.split)(jax.random.split(key, n))
        W, span = pipe.sv.window_size, pipe.span
        shrink = jax.vmap(lambda k: jax.random.randint(
            k, (span,), 0, W))(kbn[:, 0])
        kn = kbn[:, 1]
    else:
        span_keys = jax.random.split(key, n)
        if pipe.keep_prob is not None:
            kbn = jax.vmap(jax.random.split)(span_keys)
            keep = jax.vmap(lambda k: jax.random.uniform(
                k, (pipe.chunk,)))(kbn[:, 0])
            kn = kbn[:, 1]
        else:
            kn = span_keys
    if pipe.model.negative > 0:
        seeds = jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(kn)
    return tuple(None if a is None else np.asarray(a)
                 for a in (keep, shrink, seeds))


def _tables(model):
    lt = model.lookup_table
    return {n: np.asarray(getattr(lt, n)) if not isinstance(
        getattr(lt, n), torch.Tensor) else getattr(lt, n).numpy()
        for n in ("syn0", "syn1", "syn1neg") if getattr(lt, n) is not None}


def pair_models(seqs, **kw):
    """A JAX and a port model with the same vocab and the JAX init
    tables loaded into the port."""
    j = jw2v.SequenceVectors(**kw)
    p = pw2v.SequenceVectors(device="cpu", **kw)
    j.build_vocab(seqs)
    p.build_vocab(seqs)
    load_jax_tables(p, **_tables(j))
    return j, p


# ------------------------------------------------------------ update math
def _update_inputs(seed, V=20, D=8, B=32, L=5, K=4, C=6):
    rng = np.random.RandomState(seed)
    f = np.float32
    d = dict(
        syn0=(rng.randn(V, D) * 0.3).astype(f),
        syn1=(rng.randn(V - 1, D) * 0.3).astype(f),
        syn1neg=(rng.randn(V, D) * 0.3).astype(f),
        inputs=rng.randint(0, V, B), points=rng.randint(0, V - 1, (B, L)),
        codes=rng.randint(0, 2, (B, L)).astype(f),
        code_mask=(rng.rand(B, L) < 0.8).astype(f),
        pair_mask=(rng.rand(B) < 0.9).astype(f),
        targets=rng.randint(0, V, (B, 1 + K)),
        labels=np.concatenate([[1.0], np.zeros(K)]).astype(f),
        target_mask=(rng.rand(B, 1 + K) < 0.9).astype(f),
        contexts=rng.randint(0, V, (B, C)),
        context_mask=(rng.rand(B, C) < 0.7).astype(f),
        lr=np.float32(0.05))
    return d


_UPDATES = {
    "hs": ("_hs_update", "syn1", ["inputs", "points", "codes", "code_mask",
                                  "pair_mask", "lr"]),
    "ns": ("_ns_update", "syn1neg", ["inputs", "targets", "labels",
                                     "target_mask", "pair_mask", "lr"]),
    "cbow_hs": ("_cbow_hs_step", "syn1", ["contexts", "context_mask",
                                          "points", "codes", "code_mask",
                                          "pair_mask", "lr"]),
    "cbow_ns": ("_cbow_ns_step", "syn1neg", ["contexts", "context_mask",
                                             "targets", "labels",
                                             "target_mask", "pair_mask",
                                             "lr"]),
}


@pytest.mark.parametrize("aggregate", ["0", "1"])
@pytest.mark.parametrize("which", sorted(_UPDATES))
@pytest.mark.parametrize("seed", [0, 1])
def test_update_functions_match_jax(seed, which, aggregate, monkeypatch):
    """Both scatter routes (``DL4J_TPU_SCATTER_AGG``), in both
    packages."""
    monkeypatch.setenv("DL4J_TPU_SCATTER_AGG", aggregate)
    name, out_table, args = _UPDATES[which]
    d = _update_inputs(seed)
    j0, j1, jl = getattr(jw2v, name)(
        jnp.asarray(d["syn0"]), jnp.asarray(d[out_table]),
        *[jnp.asarray(d[a]) for a in args])
    p0 = torch.from_numpy(d["syn0"].copy())
    p1 = torch.from_numpy(d[out_table].copy())
    r0, r1, pl = getattr(pw2v, name)(
        p0, p1, *[torch.as_tensor(d[a]) for a in args])
    assert r0 is p0 and r1 is p1          # in place
    _close(p0, j0)
    _close(p1, j1)
    _close(pl, jl)


# ----------------------------------------------------------- host path
FIT_CASES = {
    "skipgram_hs": dict(use_hierarchic_softmax=True, negative=0),
    "skipgram_ns": dict(use_hierarchic_softmax=False, negative=4),
    "skipgram_hs_ns_sampled": dict(use_hierarchic_softmax=True, negative=3,
                                   sampling=1e-2),
    "cbow_hs": dict(use_hierarchic_softmax=True, negative=0,
                    elements_learning_algorithm="cbow"),
    "cbow_ns": dict(use_hierarchic_softmax=False, negative=4,
                    elements_learning_algorithm="cbow"),
}


def _record(model, name, log):
    fn = getattr(model, name)

    def wrapped(*a):
        out = fn(*a)
        log.append(tuple(np.asarray(x).copy() if not isinstance(
            x, torch.Tensor) else x.numpy().copy() for x in a + (
                out if isinstance(out, tuple) else ())))
        return out
    setattr(model, name, wrapped)


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_host_fit_matches_jax(case):
    seqs = corpus(1, n_sent=60)
    kw = dict(layer_size=12, window_size=3, epochs=2, batch_size=128,
              seed=7, pair_generation="host", **FIT_CASES[case])
    j, p = pair_models(seqs, **kw)
    logs = {}
    for tag, m in (("j", j), ("p", p)):
        for name in ("_skipgram_batch", "_cbow_batch", "_draw_negatives"):
            logs[tag, name] = []
            _record(m, name, logs[tag, name])
    j.fit(seqs)
    p.fit(seqs)
    batches = 0
    for name in ("_skipgram_batch", "_cbow_batch", "_draw_negatives"):
        lj, lp = logs["j", name], logs["p", name]
        assert len(lp) == len(lj)
        batches += len(lp)
        for a, b in zip(lp, lj):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert batches >= 20
    tj, tp = _tables(j), _tables(p)
    assert sorted(tp) == sorted(tj)
    for name in tj:
        _close(tp[name], tj[name])


# ------------------------------------------------------ device pipeline
def test_pair_grid_and_subsample_compact_match_jax():
    rng = np.random.RandomState(3)
    W, span = 3, 16
    seqs = [rng.randint(1, 30, n).astype(np.int64) for n in (7, 19, 2, 30)]
    corpus_np, sent_np, n = jdc.build_corpus_arrays(seqs, span)
    pc, ps = pdc.build_corpus_arrays(seqs, span)[:2]
    np.testing.assert_array_equal(pc, corpus_np)
    keep = (rng.rand(corpus_np.size) < 0.6) & (np.arange(corpus_np.size) < n)
    jc, js, jn = jdc.subsample_compact(jnp.asarray(corpus_np),
                                       jnp.asarray(sent_np),
                                       jnp.asarray(keep))
    tc, ts, tn = pdc.subsample_compact(torch.from_numpy(pc.astype(np.int64)),
                                       torch.from_numpy(ps.astype(np.int64)),
                                       torch.from_numpy(keep))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tn) == int(jn)
    jpad = jdc.pad_with_sentinels(jc, js, W)
    ppad = pdc.pad_with_sentinels(tc, ts, W)
    for a, b in zip(ppad, jpad):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n_spans = corpus_np.size // span
    for c in range(n_spans + 1):          # the last one past the end
        shrink = rng.randint(0, W, span)
        want = jdc.pair_grid_shaped(*jpad, c * span, jnp.asarray(shrink),
                                    W, span)
        got = pdc.pair_grid_shaped(*ppad, c * span,
                                   torch.from_numpy(shrink), W, span)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


DEVICE_CASES = {
    "skipgram_ns": dict(use_hierarchic_softmax=False, negative=4),
    "skipgram_hs": dict(use_hierarchic_softmax=True, negative=0),
    "cbow_hs_ns": dict(use_hierarchic_softmax=True, negative=3,
                       elements_learning_algorithm="cbow"),
}


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_device_pass_with_the_jax_draws_matches_jax(case):
    """One pass of the device pipeline, subsampled, the port fed the JAX
    package's threefry draws: the same examples trained, loss and
    tables."""
    seqs = corpus(2)
    kw = dict(layer_size=12, window_size=3, epochs=1, batch_size=256,
              seed=11, sampling=2e-2, pair_generation="device",
              **DEVICE_CASES[case])
    j, p = pair_models(seqs, **kw)
    p.draw_source = jax_draws
    j.fit(seqs)
    p.fit(seqs)
    sj, sp = j._device_pipeline_stats, p._device_pipeline_stats
    assert sp["n_spans"] == sj["n_spans"] >= 20
    assert sp["pairs_trained"] == sj["pairs_trained"] > 0
    np.testing.assert_allclose(sp["loss_sum"], sj["loss_sum"], rtol=RTOL)
    tj, tp = _tables(j), _tables(p)
    for name in tj:
        _close(tp[name], tj[name])


def test_device_pass_draws_its_own_stream_without_a_source():
    """Without a draw source the pipeline draws from its generator: a
    refit of the cached pipeline takes fresh draws, and two fresh models
    with one seed train bitwise alike."""
    seqs = corpus(4, n_sent=40)
    kw = dict(layer_size=8, window_size=3, epochs=1, batch_size=128,
              negative=3, use_hierarchic_softmax=False,
              pair_generation="device", device="cpu", seed=2)
    a, b = pw2v.SequenceVectors(**kw), pw2v.SequenceVectors(**kw)
    a.fit(seqs)
    b.fit(seqs)
    np.testing.assert_array_equal(a.lookup_table.weights(),
                                  b.lookup_table.weights())
    pipe = a._device_fit_cache[3]
    first = pipe._gen.get_state().clone()
    a.fit(seqs)                           # the cached pipe, fresh draws
    assert a._device_fit_cache[3] is pipe
    assert not torch.equal(pipe._gen.get_state(), first)
    assert pipe._passes_run == 2


# ------------------------------------------------------ WordVectors API
def test_words_nearest_and_similarity_match_jax():
    seqs = corpus(5, n_sent=50)
    j, p = pair_models(seqs, layer_size=10, window_size=3, negative=3,
                       epochs=1, batch_size=128, pair_generation="host")
    j.fit(seqs)
    load_jax_tables(p, **_tables(j))
    words = j.vocab.words()
    for w in words[:6] + ["nope"]:
        assert p.words_nearest(w, top_n=5) == j.words_nearest(w, top_n=5)
        assert p.similarity(w, words[1]) == j.similarity(w, words[1]) or \
            np.isnan(j.similarity(w, words[1]))
    assert p.words_nearest([words[0], words[2]], [words[3]], top_n=4) == \
        j.words_nearest([words[0], words[2]], [words[3]], top_n=4)
    vec = j.word_vector(words[4])
    assert p.words_nearest(vec, top_n=3) == j.words_nearest(vec, top_n=3)
    np.testing.assert_array_equal(p.word_vectors_mean(words[:5]),
                                  j.word_vectors_mean(words[:5]))
    assert p.similar_words_in_vocab_to("w1", 0.6) == \
        j.similar_words_in_vocab_to("w1", 0.6)
