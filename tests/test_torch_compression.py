"""The port's delta codecs (``deeplearning4j_tpu_torch/scaleout/
compression.py``) against the JAX package's: every encoded chunk, record
buffer and decode bitwise on seeded vectors, the error-feedback residuals
over several pushes bitwise, and negotiation over every capability pair.
Both are host numpy, so every comparison here is exact."""

import itertools

import numpy as np
import pytest

from deeplearning4j_tpu.scaleout import compression as jc
from deeplearning4j_tpu_torch.scaleout import compression as pc

CODECS = [pc.CODEC_F32, pc.CODEC_INT8, pc.CODEC_TOPK8]


def _vec(seed, n, kind):
    rng = np.random.RandomState(seed)
    if kind == "normal":
        return rng.randn(n)
    if kind == "heavy":
        return rng.standard_cauchy(n) * 1e-3
    if kind == "constant":
        return np.full(n, 0.25)
    return rng.randn(n).astype(np.float32)          # float32 input


def test_constants_and_tables_are_the_jax_ones():
    for name in ("CODEC_RAW_F64", "CODEC_F32", "CODEC_INT8", "CODEC_TOPK8",
                 "CAP_F32", "CAP_INT8", "CAP_TOPK8", "CAP_ALL",
                 "CODEC_NAMES"):
        assert getattr(pc, name) == getattr(jc, name)
    for name in (None, "", "f64", "raw", "f32", "int8", "topk8", "auto"):
        assert pc.capability_mask(name) == jc.capability_mask(name)
    with pytest.raises(ValueError, match="unknown codec"):
        pc.capability_mask("zstd")


def test_negotiation_over_every_capability_pair():
    for server, client in itertools.product(range(8), range(8)):
        assert pc.negotiate(server, client) == jc.negotiate(server, client)
    for codec in CODECS:
        assert pc.dense_codec(codec) == jc.dense_codec(codec)


@pytest.mark.parametrize("dim,chunk", [(0, 4), (1, 4), (8, 4), (130, 64),
                                       (65536 * 2 + 3, 65536)])
def test_chunk_bounds_match(dim, chunk):
    assert pc.chunk_bounds(dim, chunk) == jc.chunk_bounds(dim, chunk)


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: pc.CODEC_NAMES[c])
@pytest.mark.parametrize("kind", ["normal", "heavy", "constant", "float32"])
@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_chunk_bytes_and_decode_match_jax(codec, kind, n):
    """Encoded bytes bitwise, decode bitwise, both directions."""
    x = _vec(n * 7 + len(kind), n, kind)
    for frac in (0.1, 0.37):
        enc = pc.encode_chunk(codec, x, frac)
        assert enc == jc.encode_chunk(codec, x, frac)
        got = pc.decode_chunk(codec, enc, n)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, jc.decode_chunk(codec, enc, n))


def test_codecs_reject_what_jax_rejects():
    for mod in (pc, jc):
        with pytest.raises(ValueError, match="non-finite"):
            mod.encode_chunk(mod.CODEC_INT8, np.array([1.0, np.inf]))
        with pytest.raises(ValueError, match="unknown codec"):
            mod.encode_chunk(9, np.ones(3))
        with pytest.raises(ValueError, match="carries"):
            mod.decode_chunk(mod.CODEC_F32, b"\0" * 8, 3)
        enc = mod.encode_chunk(mod.CODEC_TOPK8, np.arange(10.0), 0.2)
        with pytest.raises(ValueError, match="out of"):
            mod.decode_chunk(mod.CODEC_TOPK8, enc, 5)
        with pytest.raises(ValueError, match="truncated"):
            mod.unpack_records(mod.pack_records([(0, b"abcd")])[:-1])


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: pc.CODEC_NAMES[c])
def test_records_and_decode_dense_match_jax(codec):
    x = _vec(3, 300, "normal")
    bounds = pc.chunk_bounds(x.size, 64)
    dense = pc.dense_codec(codec)
    records = [(i, pc.encode_chunk(dense, x[s:e]))
               for i, (s, e) in enumerate(bounds)]
    payload = pc.pack_records(records)
    assert payload == jc.pack_records(records)
    assert pc.unpack_records(payload) == jc.unpack_records(payload)
    got = pc.decode_dense(dense, payload, bounds)
    np.testing.assert_array_equal(got, jc.decode_dense(dense, payload,
                                                       bounds))
    if dense == pc.CODEC_F32:
        np.testing.assert_array_equal(pc.decode_dense(dense, payload), got)
    with pytest.raises(ValueError, match="out of order"):
        pc.decode_dense(dense, pc.pack_records(records[1:]), bounds)


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: pc.CODEC_NAMES[c])
@pytest.mark.parametrize("frac", [0.05, 0.25])
def test_error_feedback_residuals_match_jax_over_pushes(codec, frac):
    """Six pushes through both packages' ``ErrorFeedback``: every push's
    records and the residual after it bitwise; the decoded sum tracks the
    raw sum to within the last residual."""
    dim, chunk = 200, 64
    pe = pc.ErrorFeedback(dim, codec, chunk, frac)
    je = jc.ErrorFeedback(dim, codec, chunk, frac)
    rng = np.random.RandomState(11)
    raw_sum = np.zeros(dim)
    dec_sum = np.zeros(dim)
    bounds = pc.chunk_bounds(dim, chunk)
    for _ in range(6):
        delta = rng.randn(dim) * 0.01
        raw_sum += delta
        got = pe.encode(delta)
        assert got == je.encode(delta)
        np.testing.assert_array_equal(pe.residual, je.residual)
        for i, enc in got:
            s, e = bounds[i]
            dec_sum[s:e] += pc.decode_chunk(codec, enc, e - s)
    np.testing.assert_allclose(dec_sum + pe.residual, raw_sum, atol=1e-12)
    with pytest.raises(ValueError, match="delta dim"):
        pe.encode(np.ones(dim + 1))
