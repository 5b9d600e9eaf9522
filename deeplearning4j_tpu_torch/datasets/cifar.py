"""CIFAR-10 dataset iterator (port of ``deeplearning4j_tpu/datasets/
cifar.py``).

Equivalent of the reference's
``datasets/iterator/impl/CifarDataSetIterator.java`` +
``datasets/fetchers/CifarDataFetcher.java`` (binary-batch reader over the
canonical CIFAR-10 layout: each record is 1 label byte + 3072 pixel bytes,
R then G then B plane, 32x32 row-major).

Zero-egress environment, so (like the MNIST fetcher) two modes:

1. Real ``data_batch_*.bin`` / ``test_batch.bin`` files under
   ``~/.deeplearning4j_tpu/cifar10`` (or ``CIFAR_DIR``) are parsed with the
   canonical binary layout.
2. Otherwise a deterministic procedural CIFAR-alike: each of the 10 classes
   renders a distinct color/texture program (oriented gradient + class hue
   + blob pattern) with per-example jitter.  Learnable by the same conv
   stacks that fit real CIFAR, keeping smoke-train tests meaningful.

Features come out NHWC float32 in [0,1] — channels-last is the
package's conv layout (``ops/convolution.py``), where the reference emits
NCHW.  The procedural set draws the JAX package's ``RandomState`` stream,
so a seed gives bitwise the same arrays in both packages.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .dataset import DataSet
from .iterators import ListDataSetIterator

NUM_CLASSES = 10
HEIGHT = WIDTH = 32
CHANNELS = 3

LABELS = ["airplane", "automobile", "bird", "cat", "deer",
          "dog", "frog", "horse", "ship", "truck"]


def _read_cifar_bin_u8(path: str, max_records: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one CIFAR-10 binary batch file into raw (NHWC uint8 images,
    int labels): records of ``[label u8][3072 x u8 pixels, planar RGB]``
    (the layout ``CifarDataFetcher`` reads).  Numpy only: the JAX
    package decodes natively (``native/dataloader.cc`` through
    ``datasets/native_io.py``) when its C++ tier is built, and that
    binding waits for ROADMAP A11 here.  This is the JAX package's own
    route when no native module is present, and the native decode gives
    the same bytes."""
    raw = np.fromfile(path, dtype=np.uint8)
    rec = 1 + CHANNELS * HEIGHT * WIDTH
    n = raw.size // rec
    if max_records is not None:
        n = min(n, max_records)
    raw = raw[:n * rec].reshape(n, rec)
    labels = raw[:, 0].astype(np.int64)
    # planar (C,H,W) -> NHWC
    imgs = np.ascontiguousarray(
        raw[:, 1:].reshape(n, CHANNELS, HEIGHT, WIDTH)
        .transpose(0, 2, 3, 1))
    return imgs, labels


def _read_cifar_bin(path: str, max_records: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(NHWC float32 [0,1] images, int labels) — the uint8 reader scaled
    by the canonical ``/255`` (``normalizers.U8_PIXEL``)."""
    imgs, labels = _read_cifar_bin_u8(path, max_records)
    return imgs.astype(np.float32) / 255.0, labels


def _load_real(data_dir: str, train: bool,
               num: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    paths = [os.path.join(data_dir, n) for n in names]
    paths = [p for p in paths if os.path.exists(p)]
    if not paths:
        return None
    imgs, labels = [], []
    remaining = num
    for p in paths:
        im, lb = _read_cifar_bin(p, remaining)
        imgs.append(im)
        labels.append(lb)
        remaining -= im.shape[0]
        if remaining <= 0:
            break
    x = np.concatenate(imgs)
    y = np.eye(NUM_CLASSES, dtype=np.float32)[np.concatenate(labels)]
    return x, y


# ---------------------------------------------------------------- synthetic

def _render_class(cls: int, rng: np.random.RandomState) -> np.ndarray:
    """One 32x32x3 image whose statistics depend on the class: class hue,
    gradient orientation, and blob count/size vary per class."""
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32) / 31.0
    angle = cls * (2 * np.pi / NUM_CLASSES) + rng.uniform(-0.25, 0.25)
    grad = np.cos(angle) * xx + np.sin(angle) * yy
    base_hue = np.array([
        0.5 + 0.45 * np.cos(cls * 0.9 + c * 2.1) for c in range(3)],
        np.float32)
    img = grad[..., None] * 0.5 + base_hue * 0.5
    # class-dependent blob pattern
    n_blobs = 2 + cls % 4
    size = 3 + (cls // 2) % 4
    for _ in range(n_blobs):
        cy = rng.randint(0, HEIGHT - size)
        cx = rng.randint(0, WIDTH - size)
        tint = base_hue[::-1] * rng.uniform(0.6, 1.0)
        img[cy:cy + size, cx:cx + size] = \
            0.3 * img[cy:cy + size, cx:cx + size] + 0.7 * tint
    img += rng.uniform(-0.06, 0.06, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def _generate_synthetic(num: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(NHWC uint8 images, one-hot labels).  Pixels quantize to uint8 at
    generation — real CIFAR is 8-bit, and the uint8 source is what the
    ingest wire ships at 1 byte/pixel (``nn/ingest.py``)."""
    rng = np.random.RandomState(seed)
    x = np.empty((num, HEIGHT, WIDTH, CHANNELS), np.uint8)
    y = np.zeros((num, NUM_CLASSES), np.float32)
    classes = rng.randint(0, NUM_CLASSES, num)
    for i, c in enumerate(classes):
        x[i] = np.round(_render_class(int(c), rng) * 255.0).astype(np.uint8)
        y[i, c] = 1.0
    return x, y


def cifar_arrays_u8(train: bool = True, num_examples: int = 50000,
                    seed: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    """(NHWC uint8 images, one-hot labels): real binary batches if
    present, else the deterministic procedural set."""
    data_dir = os.environ.get(
        "CIFAR_DIR", os.path.expanduser("~/.deeplearning4j_tpu/cifar10"))
    real = _load_real(data_dir, train, num_examples)
    if real is not None:
        return real
    offset = 0 if train else 7_000_019
    return _generate_synthetic(num_examples, seed + offset)


def cifar_arrays(train: bool = True, num_examples: int = 50000,
                 seed: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    """(NHWC float32 images in [0,1], one-hot labels) — the uint8 source
    scaled by the canonical ``/255`` (``normalizers.U8_PIXEL``)."""
    x, y = cifar_arrays_u8(train, num_examples, seed)
    return x.astype(np.float32) / 255.0, y


class CifarDataSetIterator(ListDataSetIterator):
    """Reference signature ``CifarDataSetIterator(batch, numExamples,
    train)`` (``CifarDataSetIterator.java``).  Emits NHWC [0,1] features;
    pair with ``InputType.convolutional(32, 32, 3)``.  Batches carry a
    uint8 wire twin (``dataset.attach_wire``) for the ingest paths."""

    def __init__(self, batch: int, num_examples: int = 50000,
                 train: bool = True, shuffle: bool = True, seed: int = 12):
        from .dataset import attach_wire
        from .normalizers import U8_PIXEL
        u8, y = cifar_arrays_u8(train, num_examples, seed)
        x = u8.astype(np.float32) / 255.0
        super().__init__(attach_wire(DataSet(x, y), u8, U8_PIXEL),
                         batch, shuffle, seed)
