"""Delta compression for the parameter-server wire (port of
``deeplearning4j_tpu/scaleout/compression.py``; host numpy, and the bytes
of every record are the JAX package's, so a port client and a JAX server,
or the other way round, speak one wire).

The MLPerf TPU-v3 pods paper (PAPERS.md) puts the scaling ceiling at the
gradient-bytes budget, and the TensorFlow system paper makes the async
parameter-server case exactly when network bytes and stragglers dominate
— so the scaleout wire (PAPER.md layer 6, the Aeron media-driver role)
gets a codec stack instead of raw f64:

- ``CODEC_F32``   chunked float32 — the dense baseline (2x vs legacy f64).
- ``CODEC_INT8``  per-chunk affine uint8 quantization.  The decode is the
  ingest wire's affine contract (``datasets.normalizers.WireFormat``,
  also the serving quantize path's):
  ``f32 = float32(u8) / denom * mult + add`` with ``denom=255``,
  ``mult=hi-lo``, ``add=lo`` per chunk — worst-case rounding error
  1/510 of the chunk's value range.
- ``CODEC_TOPK8`` top-k sparsification (largest-|v| fraction per chunk)
  with the kept values int8-quantized — the push codec; a dense pull
  falls back to :func:`dense_codec` (INT8).

Lossy codecs ship with **error feedback** (:class:`ErrorFeedback`): the
worker carries the residual ``(delta + residual) - decode(encode(...))``
locally and folds it into the next push, so the *sum* of decoded pushes
tracks the sum of raw deltas — the standard convergence fix for
sparsified/quantized SGD (1-bit SGD / deep gradient compression
lineage).

Codecs are negotiated per connection via a capability byte (``C`` frame,
``param_server.py``); clients that never negotiate keep the legacy raw
f64 ops, so old and new clients interoperate against one server.

Chunking: every codec operates on fixed-size chunks of the flat
parameter vector (:func:`chunk_bounds`).  Chunks are the concurrency and
framing unit — the server shards its lock per chunk and applies chunk
records as they stream off the socket.
"""

from __future__ import annotations

import math
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..datasets.normalizers import WireFormat

# -- codec ids (one byte on the wire) ------------------------------------

CODEC_RAW_F64 = 0   # legacy U/P ops; never negotiated
CODEC_F32 = 1
CODEC_INT8 = 2
CODEC_TOPK8 = 3

#: capability-byte bits (client->server ``C`` frame payload)
CAP_F32 = 1 << 0
CAP_INT8 = 1 << 1
CAP_TOPK8 = 1 << 2

CAP_ALL = CAP_F32 | CAP_INT8 | CAP_TOPK8

_CAP_OF = {CODEC_F32: CAP_F32, CODEC_INT8: CAP_INT8,
           CODEC_TOPK8: CAP_TOPK8}

#: negotiation preference, most compressed first
_PREFERENCE = (CODEC_TOPK8, CODEC_INT8, CODEC_F32)

CODEC_NAMES = {CODEC_RAW_F64: "f64", CODEC_F32: "f32",
               CODEC_INT8: "int8", CODEC_TOPK8: "topk8"}

_NAME_TO_CAP = {"f32": CAP_F32, "int8": CAP_INT8, "topk8": CAP_TOPK8,
                "auto": CAP_ALL}


def capability_mask(codec: Optional[str]) -> Optional[int]:
    """Capability byte for a client codec request (``"f32"``, ``"int8"``,
    ``"topk8"``, ``"auto"``); ``None``/``"f64"`` means legacy raw ops
    (no negotiation)."""
    if codec in (None, "", "f64", "raw"):
        return None
    try:
        return _NAME_TO_CAP[codec]
    except KeyError:
        raise ValueError(
            f"unknown codec {codec!r}: expected one of "
            f"{sorted(_NAME_TO_CAP)} or None/'f64'") from None


def negotiate(server_mask: int, client_mask: int) -> Optional[int]:
    """Most-compressed codec both sides support, or None."""
    common = server_mask & client_mask
    for codec in _PREFERENCE:
        if common & _CAP_OF[codec]:
            return codec
    return None


def dense_codec(codec: int) -> int:
    """The dense variant used for pulls: top-k makes no sense for a full
    parameter snapshot, so TOPK8 connections pull INT8."""
    return CODEC_INT8 if codec == CODEC_TOPK8 else codec


def chunk_bounds(dim: int, chunk_size: int) -> List[Tuple[int, int]]:
    """``[(start, end)]`` covering ``[0, dim)`` in ``chunk_size`` strides
    (the last chunk is short).  Shared by the server's lock shards, the
    worker's encoder, and the wire framing — all three MUST agree."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    return [(s, min(s + chunk_size, dim))
            for s in range(0, max(dim, 1), chunk_size)]


# -- per-chunk encode/decode ---------------------------------------------

_INT8_HEAD = struct.Struct(">ff")      # mult, add
_TOPK_HEAD = struct.Struct(">Iff")     # n_kept, mult, add


def _affine_u8(x: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """uint8 affine quantization of a 1-D vector; returns ``(q, mult,
    add)`` decoding via ``WireFormat(255, mult, add)`` (the serving
    ``quantize_leaf`` scheme applied to a chunk)."""
    lo = float(x.min()) if x.size else 0.0
    hi = float(x.max()) if x.size else 0.0
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError("cannot quantize non-finite values")
    if hi <= lo:
        # constant chunk: q*0 + lo decodes exactly
        return np.zeros(x.shape, np.uint8), 1.0, lo
    scale = (hi - lo) / 255.0
    q = np.clip(np.rint((x - lo) / scale), 0, 255).astype(np.uint8)
    return q, hi - lo, lo


def _decode_u8(q: np.ndarray, mult: float, add: float) -> np.ndarray:
    # the wire's exact decode expression (f32 rounding at each op), then
    # widened to the server's f64 accumulator dtype
    return WireFormat(255.0, mult, add).decode_host(q).astype(np.float64)


def encode_chunk(codec: int, values: np.ndarray,
                 topk_fraction: float = 0.1) -> bytes:
    """Encode one dense chunk (any float dtype) under ``codec``."""
    x = np.ascontiguousarray(values, np.float64)
    if codec == CODEC_F32:
        return x.astype(">f4").tobytes()
    if codec == CODEC_INT8:
        q, mult, add = _affine_u8(x)
        return _INT8_HEAD.pack(mult, add) + q.tobytes()
    if codec == CODEC_TOPK8:
        k = max(1, int(math.ceil(topk_fraction * x.size)))
        k = min(k, x.size)
        idx = np.argpartition(np.abs(x), x.size - k)[x.size - k:]
        idx = np.sort(idx).astype(">u4")
        kept = x[idx.astype(np.int64)]
        q, mult, add = _affine_u8(kept)
        return (_TOPK_HEAD.pack(k, mult, add) + idx.tobytes()
                + q.tobytes())
    raise ValueError(f"unknown codec id {codec}")


def decode_chunk(codec: int, data: bytes, n: int) -> np.ndarray:
    """Decode one chunk record back to a dense float64 vector of length
    ``n`` (zeros where a top-k codec dropped values)."""
    if codec == CODEC_F32:
        out = np.frombuffer(data, ">f4")
        if out.size != n:
            raise ValueError(f"f32 chunk carries {out.size} values, "
                             f"chunk holds {n}")
        return out.astype(np.float64)
    if codec == CODEC_INT8:
        mult, add = _INT8_HEAD.unpack_from(data)
        q = np.frombuffer(data, np.uint8, offset=_INT8_HEAD.size)
        if q.size != n:
            raise ValueError(f"int8 chunk carries {q.size} values, "
                             f"chunk holds {n}")
        return _decode_u8(q, mult, add)
    if codec == CODEC_TOPK8:
        k, mult, add = _TOPK_HEAD.unpack_from(data)
        idx = np.frombuffer(data, ">u4", count=k, offset=_TOPK_HEAD.size)
        q = np.frombuffer(data, np.uint8, count=k,
                          offset=_TOPK_HEAD.size + 4 * k)
        if k and int(idx.max()) >= n:
            raise ValueError(f"top-k index {int(idx.max())} out of "
                             f"range for chunk of {n}")
        out = np.zeros(n, np.float64)
        out[idx.astype(np.int64)] = _decode_u8(q, mult, add)
        return out
    raise ValueError(f"unknown codec id {codec}")


# -- chunk-record framing (the Z push payload / G pull body) -------------

_RECORD_HEAD = struct.Struct(">II")    # chunk_idx, enc_len


def pack_records(chunks: Sequence[Tuple[int, bytes]]) -> bytes:
    return b"".join(_RECORD_HEAD.pack(i, len(enc)) + enc
                    for i, enc in chunks)


def unpack_records(payload: bytes) -> List[Tuple[int, bytes]]:
    """Parse a full records buffer (client-side pull decode; the server
    streams records off the socket instead — ``param_server.py``)."""
    out: List[Tuple[int, bytes]] = []
    off = 0
    while off < len(payload):
        idx, n = _RECORD_HEAD.unpack_from(payload, off)
        off += _RECORD_HEAD.size
        if off + n > len(payload):
            raise ValueError("truncated chunk record")
        out.append((idx, payload[off:off + n]))
        off += n
    return out


def decode_dense(codec: int, payload: bytes,
                 bounds: Optional[List[Tuple[int, int]]] = None
                 ) -> np.ndarray:
    """Reassemble a full vector from a records buffer covering every
    chunk in order (the G pull body after its version prefix)."""
    records = unpack_records(payload)
    parts: List[np.ndarray] = []
    expect = 0
    for idx, enc in records:
        if idx != expect:
            raise ValueError(f"pull records out of order: got chunk "
                            f"{idx}, expected {expect}")
        if bounds is not None:
            n = bounds[idx][1] - bounds[idx][0]
        else:
            # infer from the encoding itself (f32 only)
            if codec != CODEC_F32:
                raise ValueError("bounds required for non-f32 decode")
            n = len(enc) // 4
        parts.append(decode_chunk(codec, enc, n))
        expect += 1
    return (np.concatenate(parts) if parts
            else np.zeros(0, np.float64))


class ErrorFeedback:
    """Worker-side lossy-push compensation.

    ``encode(delta)`` compresses ``delta + residual`` and keeps the new
    residual (what the server will NOT see) for the next call, so the
    running sum of server-decoded pushes tracks the running sum of raw
    deltas to within one residual.  The encoder is deterministic, and a
    retried push re-sends the same already-encoded bytes (idempotent on
    the server), so the residual stays consistent under at-least-once
    delivery.
    """

    def __init__(self, dim: int, codec: int, chunk_size: int,
                 topk_fraction: float = 0.1):
        self.codec = int(codec)
        self.topk_fraction = float(topk_fraction)
        self.bounds = chunk_bounds(int(dim), int(chunk_size))
        self.residual = np.zeros(int(dim), np.float64)

    def encode(self, delta: np.ndarray) -> List[Tuple[int, bytes]]:
        d = np.asarray(delta, np.float64)
        if d.shape != self.residual.shape:
            raise ValueError(
                f"delta dim {d.shape} != encoder dim "
                f"{self.residual.shape}")
        corrected = d + self.residual
        chunks: List[Tuple[int, bytes]] = []
        decoded = np.empty_like(corrected)
        for i, (s, e) in enumerate(self.bounds):
            enc = encode_chunk(self.codec, corrected[s:e],
                               self.topk_fraction)
            chunks.append((i, enc))
            decoded[s:e] = decode_chunk(self.codec, enc, e - s)
        self.residual = corrected - decoded
        return chunks
