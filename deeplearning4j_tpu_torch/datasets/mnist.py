"""MNIST dataset iterator (port of ``deeplearning4j_tpu/datasets/mnist.py``).

Equivalent of the reference's ``MnistDataSetIterator`` +
``MnistDataFetcher`` (IDX readers in ``MnistManager``).  Two sources:

1. LeCun IDX files under ``MNIST_DIR`` (default
   ``~/.deeplearning4j_tpu/mnist/``), parsed with numpy (big-endian magic
   2051 images / 2049 labels, raw or gzipped);
2. otherwise the JAX package's deterministic procedural MNIST-alike: a
   glyph per class with per-example shift, scale, shear, noise and blur,
   plus three hardness sources that set a designed error floor
   (confusable morphs across class pairs, stroke dropout, occlusion).
   The generator draws from one ``RandomState`` in the JAX package's call
   order, so a seed gives the same bytes in both packages.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from .dataset import DataSet, attach_wire
from .iterators import ListDataSetIterator
from .normalizers import U8_PIXEL, WireFormat

_GLYPHS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


#: visually confusable partner per class — the pairs real MNIST models
#: actually confuse (3<->8 closed loops, 4<->9 open top, 1<->7 stroke,
#: 5<->6 lower loop, 0<->8 double loop, 2<->3 top curve)
_CONFUSABLE = {0: 8, 1: 7, 2: 3, 3: 8, 4: 9, 5: 6, 6: 5, 7: 1, 8: 3, 9: 4}

#: hardness knobs (calibrated so a sound LeNet lands ~97-99% held-out:
#: the morph share with mix>0.5 is the designed Bayes floor)
_P_CONFUSE = 0.05      # examples rendered as a cross-class morph
_MIX_LO, _MIX_HI = 0.3, 0.7   # morph coefficient range (crosses 0.5)
_P_OCCLUDE = 0.25      # examples with a blank occlusion patch
_MAX_DROPOUT = 0.15    # per-example stroke-pixel dropout rate cap


def _glyph_array(digit: int) -> np.ndarray:
    return np.array([[float(c) for c in row] for row in _GLYPHS[digit]],
                    np.float32)  # (7, 5)


def _render_digit(digit: int, rng: np.random.RandomState) -> np.ndarray:
    """Render one 28x28 grayscale digit with random geometric jitter,
    plus the hardness sources documented in the module docstring
    (confusable morphs, stroke dropout, occlusion)."""
    glyph = _glyph_array(digit)
    if rng.rand() < _P_CONFUSE:
        # cross-class morph: mix can exceed 0.5, at which point the
        # image resembles the PARTNER class more than its own label —
        # these are the irreducibly ambiguous examples
        mix = rng.uniform(_MIX_LO, _MIX_HI)
        glyph = (1.0 - mix) * glyph + mix * _glyph_array(
            _CONFUSABLE[digit])
    # Random target size (thickness/scale jitter) then nearest upsample
    h = rng.randint(16, 22)
    w = rng.randint(10, 16)
    ys = (np.arange(h) * (glyph.shape[0] / h)).astype(int)
    xs = (np.arange(w) * (glyph.shape[1] / w)).astype(int)
    img_small = glyph[np.ix_(ys, xs)].copy()
    # stroke dropout: broken/faint pen lines
    drop = rng.uniform(0.0, _MAX_DROPOUT)
    img_small *= (rng.rand(h, w) >= drop).astype(np.float32)
    img = np.zeros((28, 28), np.float32)
    # Centered with +/-3px jitter, like real MNIST's centered digits
    cy, cx = (28 - h) // 2, (28 - w) // 2
    dy = np.clip(cy + rng.randint(-3, 4), 0, 28 - h)
    dx = np.clip(cx + rng.randint(-3, 4), 0, 28 - w)
    img[dy:dy + h, dx:dx + w] = img_small
    # shear: shift each row by a per-example slant
    slant = rng.uniform(-0.15, 0.15)
    out = np.zeros_like(img)
    for r in range(28):
        shift = int(round(slant * (r - 14)))
        out[r] = np.roll(img[r], shift)
    if rng.rand() < _P_OCCLUDE:
        # blank patch over part of the canvas (pre-blur so edges soften)
        oh, ow = rng.randint(4, 9), rng.randint(4, 9)
        oy = rng.randint(0, 28 - oh + 1)
        ox = rng.randint(0, 28 - ow + 1)
        out[oy:oy + oh, ox:ox + ow] = 0.0
    # box blur for soft pen strokes
    padded = np.pad(out, 1)
    blurred = (padded[:-2, :-2] + padded[:-2, 1:-1] + padded[:-2, 2:] +
               padded[1:-1, :-2] + padded[1:-1, 1:-1] + padded[1:-1, 2:] +
               padded[2:, :-2] + padded[2:, 1:-1] + padded[2:, 2:]) / 9.0
    blurred = np.clip(blurred * 1.8, 0.0, 1.0)
    noise = rng.uniform(0.0, 0.08, blurred.shape).astype(np.float32)
    return np.clip(blurred + noise, 0.0, 1.0)


def _generate_synthetic(num: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8 images, one-hot labels).  Pixels are quantized to uint8 at
    generation, as real MNIST is 8-bit."""
    rng = np.random.RandomState(seed)
    images = np.empty((num, 784), np.uint8)
    labels = np.zeros((num, 10), np.float32)
    digits = rng.randint(0, 10, num)
    for i, d in enumerate(digits):
        images[i] = np.round(
            _render_digit(int(d), rng).ravel() * 255.0).astype(np.uint8)
        labels[i, d] = 1.0
    return images, labels


def _read_idx(path: str) -> np.ndarray:
    """Parse an IDX file (reference ``MnistDbFile``/``MnistImageFile``
    layout: big-endian magic, dims, raw bytes)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">i", f.read(4))
        if magic == 2051:
            n, rows, cols = struct.unpack(">iii", f.read(12))
            data = np.frombuffer(f.read(n * rows * cols), np.uint8)
            return data.reshape(n, rows * cols)
        if magic == 2049:
            n, = struct.unpack(">i", f.read(4))
            return np.frombuffer(f.read(n), np.uint8)
        raise ValueError(f"Bad IDX magic {magic} in {path}")


def _load_real(data_dir: str, train: bool,
               num: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    stem = "train" if train else "t10k"
    for img_name, lbl_name in (
            (f"{stem}-images-idx3-ubyte", f"{stem}-labels-idx1-ubyte"),
            (f"{stem}-images-idx3-ubyte.gz", f"{stem}-labels-idx1-ubyte.gz")):
        img_path = os.path.join(data_dir, img_name)
        lbl_path = os.path.join(data_dir, lbl_name)
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            images = _read_idx(img_path)[:num]
            raw = _read_idx(lbl_path)[:num]
            labels = np.eye(10, dtype=np.float32)[raw]
            return images, labels
    return None


def mnist_arrays_u8(train: bool = True, num_examples: int = 60000,
                    seed: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8 images, one-hot labels): the IDX files if present, else the
    procedural set."""
    data_dir = os.environ.get(
        "MNIST_DIR", os.path.expanduser("~/.deeplearning4j_tpu/mnist"))
    real = _load_real(data_dir, train, num_examples)
    if real is not None:
        return real
    offset = 0 if train else 1_000_003
    return _generate_synthetic(num_examples, seed + offset)


def mnist_arrays(train: bool = True, num_examples: int = 60000,
                 seed: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """(float32 [0, 1] features, one-hot labels): the uint8 source scaled
    by ``/255``."""
    images, labels = mnist_arrays_u8(train, num_examples, seed)
    return images.astype(np.float32) / 255.0, labels


class MnistDataSetIterator(ListDataSetIterator):
    """Reference signature ``MnistDataSetIterator(batch, numExamples,
    binarize, train, shuffle, seed)``.  Features are flat 784-vectors in
    [0, 1]; pair them with ``InputType.convolutional_flat(28, 28, 1)`` for
    a CNN.  The dataset carries its uint8 twin (``dataset.attach_wire``),
    so the ingest paths upload 1 byte a pixel and decode on the device."""

    def __init__(self, batch: int, num_examples: int = 60000,
                 binarize: bool = False, train: bool = True,
                 shuffle: bool = True, seed: int = 6):
        u8, labels = mnist_arrays_u8(train, num_examples, seed)
        if binarize:
            # u8 / 255 > 0.3 is u8 >= 77; the {0, 1} result is itself
            # uint8, so its wire decodes with the identity format
            u8 = (u8 >= 77).astype(np.uint8)
            images = u8.astype(np.float32)
            fmt = WireFormat()
        else:
            images = u8.astype(np.float32) / 255.0
            fmt = U8_PIXEL
        super().__init__(attach_wire(DataSet(images, labels), u8, fmt),
                         batch, shuffle, seed)
