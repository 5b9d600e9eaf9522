"""LFW (Labeled Faces in the Wild) dataset iterator (port of
``deeplearning4j_tpu/datasets/lfw.py``).

Equivalent of the reference's
``datasets/iterator/impl/LFWDataSetIterator.java`` +
``datasets/fetchers/LFWDataFetcher.java``: face images organized as one
directory per person, labels = person identity.

Zero-egress environment and no JPEG codec in the stdlib, so (like the
MNIST/CIFAR fetchers) two modes:

1. Real mode: a directory tree ``{root}/{person_name}/*.{pgm,ppm,npy}``
   (convert LFW's jpgs once with any external tool; PGM/PPM parse with
   stdlib, ``.npy`` loads directly).  The ``lfw_subset`` layout the
   reference tests use (one flat dir per person) is the same shape.
2. Procedural mode: a deterministic face-alike generator — each "person"
   is a parameter vector (face ellipse, eye spacing, brow slant, mouth
   curvature, skin tone) rendered with per-photo pose/lighting jitter.
   Identity classification is learnable by the same conv stacks that fit
   real LFW subsets.

Features are NHWC float32 in [0,1] (the package's channels-last layout).
The procedural faces draw the JAX package's ``RandomState`` streams, so a
seed gives bitwise the same arrays in both packages."""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .dataset import DataSet
from .iterators import ListDataSetIterator


# ------------------------------------------------------------- real loading
def _read_pnm(path: str) -> np.ndarray:
    """Parse binary PGM (P5) / PPM (P6) into (H, W, C) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    parts: List[bytes] = []
    pos = 0
    while len(parts) < 4 and pos < len(data):
        # skip whitespace/comments
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        parts.append(data[start:pos])
    magic, w, h, maxval = (parts[0], int(parts[1]), int(parts[2]),
                           int(parts[3]))
    pos += 1                                    # single whitespace after maxval
    if maxval > 255:
        raise ValueError(f"16-bit PNM unsupported: {path}")
    c = {b"P5": 1, b"P6": 3}.get(magic)
    if c is None:
        raise ValueError(f"Not a binary PGM/PPM: {path}")
    arr = np.frombuffer(data[pos:pos + h * w * c], np.uint8)
    return arr.reshape(h, w, c)


def _load_image(path: str) -> Optional[np.ndarray]:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm"):
        return _read_pnm(path)
    if ext == ".npy":
        arr = np.load(path)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr
    return None


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * (img.shape[0] / h)).astype(int)
    xs = (np.arange(w) * (img.shape[1] / w)).astype(int)
    return img[np.ix_(ys, xs)]


def _load_real(root: str, num: int, shape: Tuple[int, int, int],
               num_labels: Optional[int] = None
               ) -> Optional[Tuple[np.ndarray, np.ndarray, List[str]]]:
    if not os.path.isdir(root):
        return None
    people = sorted(d for d in os.listdir(root)
                    if os.path.isdir(os.path.join(root, d)))
    if not people:
        return None
    if num_labels is not None and len(people) > num_labels:
        # keep the one-hot width consistent with the requested label count
        # (the reference's numLabels subset behavior)
        people = people[:num_labels]
    h, w, c = shape
    feats, labels = [], []
    for pid, person in enumerate(people):
        pdir = os.path.join(root, person)
        for fname in sorted(os.listdir(pdir)):
            img = _load_image(os.path.join(pdir, fname))
            if img is None:
                continue
            img = _resize_nearest(img, h, w)
            if img.shape[2] != c:               # gray<->color adaption
                img = (np.repeat(img, c, axis=2) if img.shape[2] == 1
                       else img.mean(axis=2, keepdims=True))
            feats.append(img.astype(np.float32) / 255.0)
            labels.append(pid)
            if len(feats) >= num:
                break
        if len(feats) >= num:
            break
    if not feats:
        return None
    x = np.stack(feats)
    y = np.eye(len(people), dtype=np.float32)[np.asarray(labels)]
    return x, y, people


# ------------------------------------------------------- procedural faces
def _render_face(person_rng: np.random.RandomState,
                 photo_rng: np.random.RandomState,
                 h: int, w: int) -> np.ndarray:
    """One grayscale face: identity params from ``person_rng`` (stable per
    person), pose/lighting jitter from ``photo_rng``."""
    # identity parameters
    face_ry = person_rng.uniform(0.32, 0.42) * h
    face_rx = person_rng.uniform(0.25, 0.36) * w
    eye_dx = person_rng.uniform(0.13, 0.2) * w
    eye_y = person_rng.uniform(-0.12, -0.04) * h
    eye_r = person_rng.uniform(0.035, 0.06) * min(h, w)
    mouth_w = person_rng.uniform(0.12, 0.22) * w
    mouth_y = person_rng.uniform(0.16, 0.26) * h
    mouth_curve = person_rng.uniform(-0.6, 0.6)
    tone = person_rng.uniform(0.45, 0.8)
    brow = person_rng.uniform(-0.3, 0.3)
    # photo jitter
    cy = h / 2 + photo_rng.uniform(-0.05, 0.05) * h
    cx = w / 2 + photo_rng.uniform(-0.05, 0.05) * w
    light = photo_rng.uniform(0.85, 1.15)
    tilt = photo_rng.uniform(-0.12, 0.12)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    # rotate coordinates by tilt around center
    ry = (yy - cy) * np.cos(tilt) - (xx - cx) * np.sin(tilt)
    rx = (yy - cy) * np.sin(tilt) + (xx - cx) * np.cos(tilt)
    img = np.zeros((h, w))
    face = ((ry / face_ry) ** 2 + (rx / face_rx) ** 2) <= 1.0
    img[face] = tone
    for side in (-1, 1):
        eye = ((ry - eye_y) ** 2
               + (rx - side * eye_dx) ** 2) <= eye_r ** 2
        img[eye] = 0.1
        brow_band = (np.abs(ry - (eye_y - 2.2 * eye_r)
                            - brow * (rx - side * eye_dx)) < 1.0) \
            & (np.abs(rx - side * eye_dx) < 1.8 * eye_r)
        img[brow_band & face] = 0.25
    mouth = (np.abs(ry - mouth_y
                    - mouth_curve * ((rx / mouth_w) ** 2) * 4.0) < 1.2) \
        & (np.abs(rx) < mouth_w)
    img[mouth & face] = 0.15
    nose = (np.abs(rx) < 0.02 * w) & (ry > eye_y) & (ry < mouth_y - 0.05 * h)
    img[nose & face] = tone * 0.8
    img = np.clip(img * light
                  + photo_rng.uniform(0, 0.05, img.shape), 0, 1)
    return img.astype(np.float32)


def _generate_synthetic(num: int, num_people: int, seed: int,
                        shape: Tuple[int, int, int],
                        identity_seed: int
                        ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    h, w, c = shape
    rng = np.random.RandomState(seed % (2 ** 31))
    x = np.empty((num, h, w, c), np.float32)
    ids = rng.randint(0, num_people, num)
    for i, pid in enumerate(ids):
        # Identity derives from identity_seed alone so a train iterator
        # and its test split render the SAME people (different photos).
        person_rng = np.random.RandomState(
            (identity_seed * 7919 + int(pid)) % (2 ** 31))
        img = _render_face(person_rng, rng, h, w)
        x[i] = img[:, :, None] if c == 1 else np.repeat(
            img[:, :, None], c, axis=2)
    y = np.eye(num_people, dtype=np.float32)[ids]
    names = [f"person_{i:03d}" for i in range(num_people)]
    return x, y, names


def lfw_arrays(num_examples: int = 1000, num_labels: int = 10,
               image_shape: Tuple[int, int, int] = (40, 40, 1),
               seed: int = 12, identity_seed: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(features NHWC, one-hot labels, person names): real directory tree
    if present under ``LFW_DIR``/``~/.deeplearning4j_tpu/lfw``, else the
    procedural face-alike set.  ``identity_seed`` (default: ``seed``)
    controls WHO the people are; ``seed`` controls which photos are
    rendered — pass the same identity_seed with different seeds to get a
    train/test split over the same identities."""
    root = os.environ.get(
        "LFW_DIR", os.path.expanduser("~/.deeplearning4j_tpu/lfw"))
    real = _load_real(root, num_examples, image_shape, num_labels)
    if real is not None:
        return real
    return _generate_synthetic(
        num_examples, num_labels, seed, image_shape,
        seed if identity_seed is None else identity_seed)


class LFWDataSetIterator(ListDataSetIterator):
    """Reference signature (``LFWDataSetIterator(batchSize, numExamples,
    imgDim, numLabels, useSubset, train, ...)``), channels-last."""

    def __init__(self, batch: int, num_examples: int = 1000,
                 image_shape: Tuple[int, int, int] = (40, 40, 1),
                 num_labels: int = 10, train: bool = True,
                 shuffle: bool = True, seed: int = 12):
        x, y, self.people = lfw_arrays(
            num_examples, num_labels, image_shape,
            seed + (0 if train else 999_331), identity_seed=seed)
        super().__init__(DataSet(x, y), batch, shuffle, seed)

    def get_labels(self) -> List[str]:
        return self.people
