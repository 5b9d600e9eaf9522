"""The port's GloVe (``nlp/glove.py``) and ParagraphVectors
(``nlp/paragraph_vectors.py``) against the JAX package's.

- GloVe's co-occurrence keys and counts, bitwise (symmetric and not);
- both AdaGrad routes (the naive eight scatters and the fused
  dual-buffer pair) on the same duplicate-heavy batch, each against its
  JAX twin and against each other;
- a 2-epoch ``Glove.fit`` per route from the JAX package's own init
  (``jax.random.uniform`` at ``fit``, recomputed here and carried in by
  ``load_jax_glove_tables``): the same final vectors, context table and
  last-epoch loss (the shuffle is the shared numpy stream);
- PV-DBOW and PV-DM on 8 documents from the same tables, on the host
  route (the numpy stream) and on the device route (the port fed the JAX
  package's threefry draws, ``test_torch_word2vec.jax_draws``, for the
  word-side and the label-side pipelines of every interleaved segment);
- ``infer_vector`` (HS and NS; its numpy stream is seeded by the
  document's tokens, the same in both packages in one process),
  ``predict`` and ``label_vector``.

Tolerance fp32, rtol 1e-5, atol 1e-6 element by element (the einsums
and the sigmoid round in another order than XLA's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp.paragraph_vectors import ParagraphVectors as JPV
from deeplearning4j_tpu_torch.nlp import glove as pglove
from deeplearning4j_tpu_torch.nlp.jax_tables import (load_jax_glove_tables,
                                                     load_jax_tables)
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import \
    ParagraphVectors as PPV
from test_torch_word2vec import _tables, corpus, jax_draws

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ GloVe
@pytest.mark.parametrize("symmetric", [True, False])
def test_glove_cooccurrence_counts_bitwise(symmetric):
    seqs = corpus(6, n_sent=80)
    j = jglove.Glove(window_size=4, symmetric=symmetric, layer_size=4)
    p = pglove.Glove(window_size=4, symmetric=symmetric, layer_size=4,
                     device="cpu")
    j.build_vocab(seqs)
    p.build_vocab(seqs)
    p.COOC_CHUNK_KEYS = j.COOC_CHUNK_KEYS = 500     # several flushes
    kj, sj = j._cooc_arrays(seqs)
    kp, sp = p._cooc_arrays(seqs)
    np.testing.assert_array_equal(kp, kj)
    np.testing.assert_array_equal(sp, sj)
    assert p._count_cooccurrences(seqs) == j._count_cooccurrences(seqs)


def _glove_batch(seed, V=16, D=6, B=64):
    rng = np.random.RandomState(seed)
    f = np.float32
    rows = np.minimum(rng.zipf(1.5, B) - 1, V - 1)
    cols = np.minimum(rng.zipf(1.5, B) - 1, V - 1)
    xs = rng.rand(B).astype(f) * 20 + 1
    tables = dict(W=((rng.rand(V, D) - .5) / D).astype(f),
                  Wc=((rng.rand(V, D) - .5) / D).astype(f),
                  b=(rng.randn(V) * .1).astype(f),
                  bc=(rng.randn(V) * .1).astype(f),
                  hW=rng.rand(V, D).astype(f), hWc=rng.rand(V, D).astype(f),
                  hb=rng.rand(V).astype(f), hbc=rng.rand(V).astype(f))
    batch = dict(rows=rows, cols=cols, logx=np.log(xs),
                 fx=np.minimum(1.0, (xs / 10.0) ** 0.75).astype(f),
                 mask=(rng.rand(B) < 0.9).astype(f), lr=np.float32(0.05))
    return tables, batch


NAMES = ("W", "Wc", "b", "bc", "hW", "hWc", "hb", "hbc")
BATCH = ("rows", "cols", "logx", "fx", "mask", "lr")


@pytest.mark.parametrize("seed", [0, 1])
def test_glove_updates_match_jax(seed):
    tables, batch = _glove_batch(seed)
    want = jglove._glove_update(*[jnp.asarray(tables[n]) for n in NAMES],
                                *[jnp.asarray(batch[n]) for n in BATCH])
    naive = {n: torch.from_numpy(tables[n].copy()) for n in NAMES}
    args = [torch.as_tensor(batch[n]) for n in BATCH]
    loss = pglove._glove_update(*[naive[n] for n in NAMES], *args)
    for i, n in enumerate(NAMES):
        _close(naive[n], want[i])
    _close(loss, want[8])

    def packed(pack, side):
        w, bias, h, hb = [tables[n] for n in side]
        return pack(w, bias[:, None], h, hb[:, None])

    sides = (("W", "b", "hW", "hb"), ("Wc", "bc", "hWc", "hbc"))
    jS = [packed(lambda *a: jnp.concatenate(a, axis=1), s) for s in sides]
    jr, jc, jl = jglove._glove_update_fused(
        *jS, *[jnp.asarray(batch[n]) for n in BATCH])
    pS = [torch.from_numpy(packed(lambda *a: np.concatenate(a, axis=1), s))
          for s in sides]
    pl = pglove._glove_update_fused(*pS, *args)
    _close(pS[0], jr)
    _close(pS[1], jc)
    _close(pl, jl)
    # the fused route is the naive one, per row
    D = tables["W"].shape[1]
    _close(pS[0][:, :D], naive["W"])
    _close(pS[0][:, D], naive["b"])
    _close(pS[1][:, D + 1:2 * D + 1], naive["hWc"])


def _jax_glove_init(seed, V, D):
    """``Glove.fit``'s init in the JAX package."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    W = (jax.random.uniform(k1, (V, D), jnp.float32) - 0.5) / D
    Wc = (jax.random.uniform(k2, (V, D), jnp.float32) - 0.5) / D
    return np.asarray(W, np.float32), np.asarray(Wc, np.float32)


@pytest.mark.parametrize("fused", [False, True])
def test_glove_fit_from_the_jax_init_matches_jax(fused):
    seqs = corpus(7, n_sent=60, vocab=40)
    kw = dict(layer_size=8, window_size=3, epochs=2, batch_size=64, seed=4)
    j = jglove.Glove(**kw)
    p = pglove.Glove(device="cpu", **kw)
    j.use_fused_scatter = p.use_fused_scatter = fused
    j.build_vocab(seqs)
    p.build_vocab(seqs)
    load_jax_glove_tables(p, *_jax_glove_init(4, j.vocab.num_words(), 8))
    j.fit(seqs)
    p.fit(seqs)
    assert p.init_tables is None                    # consumed
    _close(p.lookup_table.syn0, j.lookup_table.syn0)
    _close(p._context, j._context)
    np.testing.assert_allclose(p.last_epoch_loss, j.last_epoch_loss,
                               rtol=RTOL)
    # without carried tables the port draws its own init from ``seed`` at
    # each fit (two fresh models train alike), unless the caller hands
    # over a generator
    fits = []
    for gen in (None, None, torch.Generator().manual_seed(99)):
        p2 = pglove.Glove(device="cpu", **kw)
        p2.init_generator = gen
        p2.fit(seqs)
        assert np.isfinite(p2.last_epoch_loss)
        fits.append(p2.lookup_table.weights())
    np.testing.assert_array_equal(fits[0], fits[1])
    assert not np.array_equal(fits[0], fits[2])


# ------------------------------------------------------- ParagraphVectors
def _docs(seed=8, n=8):
    seqs = corpus(seed, n_sent=n, vocab=30, length=(20, 60))
    return [(" ".join(s), "DOC_%d" % i) for i, s in enumerate(seqs)]


def _pv_pair(mode, gen, **kw):
    docs = _docs()
    kw = dict(sequence_learning_algorithm=mode, layer_size=10,
              window_size=3, epochs=2, batch_size=128, seed=9,
              pair_generation=gen, **kw)
    j, p = JPV(**kw), PPV(device="cpu", **kw)
    j.build_vocab_from_documents(j._resolve_documents(docs))
    p.build_vocab_from_documents(p._resolve_documents(docs))
    assert p.vocab.words() == j.vocab.words()
    load_jax_tables(p, **_tables(j))
    return j, p, docs


PV_CASES = {"ns": dict(negative=3, use_hierarchic_softmax=False),
            "hs": dict(negative=0, use_hierarchic_softmax=True)}


@pytest.mark.parametrize("gen", ["host", "device"])
@pytest.mark.parametrize("mode", ["dbow", "dm"])
@pytest.mark.parametrize("case", sorted(PV_CASES))
def test_paragraph_vectors_match_jax(case, mode, gen):
    j, p, docs = _pv_pair(mode, gen, sampling=1e-2 if gen == "device"
                          else 0.0, **PV_CASES[case])
    p.draw_source = jax_draws
    j.fit(docs)
    p.fit(docs)
    if gen == "device":
        stats = "_device_%s_stats" % mode
        assert getattr(p, stats)["pairs_trained"] == \
            getattr(j, stats)["pairs_trained"] > 0
        assert p._device_pipeline_stats["pairs_trained"] == \
            j._device_pipeline_stats["pairs_trained"]
    tj, tp = _tables(j), _tables(p)
    for name in tj:
        _close(tp[name], tj[name])
    for label in ("DOC_0", "DOC_5"):
        _close(p.label_vector(label), j.label_vector(label))
    text = docs[3][0].split()[:12]
    _close(p.infer_vector(text, steps=5), j.infer_vector(text, steps=5))
    assert p.predict(docs[2][0]) == j.predict(docs[2][0])
