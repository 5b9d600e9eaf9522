"""Carry a JAX-package embedding model's tables into the port.

The two packages build the same vocabulary (the same indices, Huffman
codes and points) from the same corpus, so the tables cross as plain
numpy: the caller hands over the JAX tables as ``np.asarray`` arrays and
they are written onto the port model's device.  Initial values are never
compared between the packages (threefry and torch streams differ), so
parity tests load one set of tables into both.  The full-model zip
(``serializer.py``) is the other route.  This module imports no JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _table(arr, like: Optional[torch.Tensor], shape, device, name: str
           ) -> torch.Tensor:
    a = np.asarray(arr, dtype=np.float32)
    want = tuple(like.shape) if like is not None else tuple(shape)
    if a.shape != want:
        raise ValueError(f"{name}: JAX table of shape {a.shape}, the port "
                         f"model's is {want}")
    return torch.from_numpy(a.copy()).to(device)


def load_jax_tables(model, syn0, syn1=None, syn1neg=None) -> None:
    """Write the JAX model's syn0 (and syn1 / syn1neg where given) into
    ``model``'s lookup table on its device.  ``model`` must have built the
    same vocab (``build_vocab``, or a fit's first step); each table must
    have the port table's shape."""
    lt = model.lookup_table
    if lt is None:
        raise ValueError("build the port model's vocab first")
    lt.syn0 = _table(syn0, lt.syn0, None, model.device, "syn0")
    if syn1 is not None:
        lt.syn1 = _table(syn1, lt.syn1, None, model.device, "syn1")
    if syn1neg is not None:
        lt.syn1neg = _table(syn1neg, lt.syn1neg, None, model.device,
                            "syn1neg")


def load_jax_glove_tables(glove, W, Wc, b=None, bc=None, hW=None, hWc=None,
                          hb=None, hbc=None) -> None:
    """Set the tables a ``Glove``'s next ``fit`` starts from, in place of
    its own draws: the word and context embeddings ``W``/``Wc`` (V, D),
    the biases ``b``/``bc`` (V,) and the AdaGrad accumulators (zero where
    not given), e.g. the JAX package's init of ``Glove.fit``.  The vocab
    must be built (``build_vocab``) so V is known."""
    if glove.vocab is None:
        raise ValueError("build the port model's vocab first")
    V, D = glove.vocab.num_words(), glove.layer_size
    dev = glove.device

    def t(arr, shape, name):
        if arr is None:
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        return _table(arr, None, shape, dev, name)

    glove.init_tables = {
        "W": t(W, (V, D), "W"), "Wc": t(Wc, (V, D), "Wc"),
        "b": t(b, (V,), "b"), "bc": t(bc, (V,), "bc"),
        "hW": t(hW, (V, D), "hW"), "hWc": t(hWc, (V, D), "hWc"),
        "hb": t(hb, (V,), "hb"), "hbc": t(hbc, (V,), "hbc")}
