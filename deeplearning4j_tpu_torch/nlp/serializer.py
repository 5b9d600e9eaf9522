"""Word-vector serialization (port of
``deeplearning4j_tpu/nlp/serializer.py``).

Equivalent of the reference's
``models/embeddings/loader/WordVectorSerializer.java`` (2710 LoC): the
Google word2vec text and binary formats plus a DL4J-style zip container
(vocab json + vectors) that round-trips the full model (frequencies,
Huffman state, training config).

The full-model zip is also the cross-package format for the tables: a zip
written by either package reads in the other, and entry by entry
(``config.json``, ``vocab.json``, ``syn0.npy``, ``syn1.npy``,
``syn1neg.npy``) the bytes are the same (the zip's own timestamps may
differ: ``writestr`` stamps the clock).  The readers take ``device``
(None = the card) for the tables they build.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from ..device import resolve_device
from .lookup_table import InMemoryLookupTable
from .vocab import VocabCache, VocabWord


# ------------------------------------------------------- Google text format

def write_word_vectors(model, path: str) -> None:
    """Google word2vec *text* format: header "V D", then one line per word:
    ``word v1 v2 ... vD`` (reference ``writeWordVectors``)."""
    vocab, table = model.vocab, model.lookup_table
    m = table.weights()
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(f"{vocab.num_words()} {table.vector_length}\n")
        for w in vocab.vocab_words():
            vec = " ".join(f"{x:.6f}" for x in m[w.index])
            fh.write(f"{w.word} {vec}\n")


def _host(arr) -> np.ndarray:
    """A table as host numpy (a tensor is copied off its device)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def load_txt_vectors(path: str, device=None):
    """Load Google text vectors -> (VocabCache, InMemoryLookupTable)
    (reference ``loadTxtVectors``).  Handles both headered and headerless
    files."""
    device = resolve_device(device)
    with open(path, "r", encoding="utf-8") as fh:
        lines = [line.rstrip("\n") for line in fh if line.strip()]
    start = 0
    first = lines[0].split()
    if len(first) == 2 and all(tok.isdigit() for tok in first):
        start = 1
    vocab = VocabCache()
    vectors = []
    for line in lines[start:]:
        parts = line.split(" ")
        word = parts[0]
        vec = np.array([float(x) for x in parts[1:] if x], np.float32)
        vocab.add_token(VocabWord(word, 1.0))
        vectors.append((word, vec))
    vocab.finalize_vocab()
    dim = vectors[0][1].size if vectors else 0
    table = InMemoryLookupTable(vocab, dim, use_hs=False, negative=1.0,
                                device=device)
    table.reset_weights()
    m = np.zeros((vocab.num_words(), dim), np.float32)
    for word, vec in vectors:
        m[vocab.index_of(word)] = vec
    table.syn0 = torch.from_numpy(m).to(table.device)
    return vocab, table


# ----------------------------------------------------- Google binary format

def write_binary_word_vectors(model, path: str) -> None:
    """Google word2vec *binary* format: "V D\\n" header then per word:
    ``word`` + space + D little-endian float32s + newline (reference binary
    branch of ``writeWordVectors``/original word2vec layout)."""
    vocab, table = model.vocab, model.lookup_table
    m = table.weights().astype("<f4")
    with open(path, "wb") as fh:
        fh.write(f"{vocab.num_words()} {table.vector_length}\n"
                 .encode("utf-8"))
        for w in vocab.vocab_words():
            fh.write(w.word.encode("utf-8") + b" ")
            fh.write(m[w.index].tobytes())
            fh.write(b"\n")


def load_binary_word_vectors(path: str, device=None):
    """Reference ``loadGoogleModel(file, binary=true)``."""
    device = resolve_device(device)
    with open(path, "rb") as fh:
        header = fh.readline().decode("utf-8").split()
        v, d = int(header[0]), int(header[1])
        vocab = VocabCache()
        m = np.zeros((v, d), np.float32)
        entries = []
        for _ in range(v):
            word_bytes = bytearray()
            while True:
                ch = fh.read(1)
                if ch in (b" ", b""):
                    break
                if ch != b"\n":
                    word_bytes.extend(ch)
            word = word_bytes.decode("utf-8")
            vec = np.frombuffer(fh.read(4 * d), dtype="<f4").copy()
            entries.append((word, vec))
            nxt = fh.peek(1)[:1] if hasattr(fh, "peek") else b""
            if nxt == b"\n":
                fh.read(1)
    for word, _ in entries:
        vocab.add_token(VocabWord(word, 1.0))
    vocab.finalize_vocab()
    for word, vec in entries:
        m[vocab.index_of(word)] = vec
    table = InMemoryLookupTable(vocab, d, use_hs=False, negative=1.0,
                                device=device)
    table.syn0 = torch.from_numpy(m).to(table.device)
    return vocab, table


# ----------------------------------------------------------- DL4J zip format

def write_full_model(model, path: str) -> None:
    """Full-model zip (reference ``writeFullModel``/``writeWord2VecModel``):
    config.json + vocab.json (words, frequencies, Huffman codes) +
    syn0/syn1/syn1neg .npy entries."""
    vocab, table = model.vocab, model.lookup_table
    config = {
        "layer_size": model.layer_size,
        "window_size": model.window_size,
        "min_word_frequency": model.min_word_frequency,
        "learning_rate": model.learning_rate,
        "min_learning_rate": model.min_learning_rate,
        "negative": model.negative,
        "use_hierarchic_softmax": model.use_hs,
        "sampling": model.sampling,
        "seed": model.seed,
        "algorithm": model.algorithm,
    }
    vocab_entries = [{
        "word": w.word, "frequency": w.element_frequency, "index": w.index,
        "codes": w.codes, "points": w.points, "is_label": w.is_label,
    } for w in vocab.vocab_words()]

    def npy_bytes(arr) -> bytes:
        buf = io.BytesIO()
        np.save(buf, _host(arr))
        return buf.getvalue()

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("config.json", json.dumps(config))
        zf.writestr("vocab.json", json.dumps(vocab_entries))
        zf.writestr("syn0.npy", npy_bytes(table.syn0))
        if table.syn1 is not None:
            zf.writestr("syn1.npy", npy_bytes(table.syn1))
        if table.syn1neg is not None:
            zf.writestr("syn1neg.npy", npy_bytes(table.syn1neg))


def read_full_model(path: str, device=None):
    """Restore a :class:`~..word2vec.Word2Vec`-compatible model on
    ``device`` (reference ``readWord2VecModel``): training can resume,
    syn1/syn1neg and Huffman state round-trip."""
    from .word2vec import Word2Vec

    device = resolve_device(device)

    with zipfile.ZipFile(path, "r") as zf:
        config = json.loads(zf.read("config.json"))
        vocab_entries = json.loads(zf.read("vocab.json"))
        syn0 = np.load(io.BytesIO(zf.read("syn0.npy")))
        syn1 = (np.load(io.BytesIO(zf.read("syn1.npy")))
                if "syn1.npy" in zf.namelist() else None)
        syn1neg = (np.load(io.BytesIO(zf.read("syn1neg.npy")))
                   if "syn1neg.npy" in zf.namelist() else None)

    model = Word2Vec(
        layer_size=config["layer_size"], window_size=config["window_size"],
        min_word_frequency=config["min_word_frequency"],
        learning_rate=config["learning_rate"],
        min_learning_rate=config["min_learning_rate"],
        negative=config["negative"],
        use_hierarchic_softmax=config["use_hierarchic_softmax"],
        sampling=config["sampling"], seed=config["seed"],
        elements_learning_algorithm=config["algorithm"], device=device)
    vocab = VocabCache()
    for e in vocab_entries:
        w = VocabWord(e["word"], e["frequency"])
        w.codes = list(e["codes"])
        w.points = list(e["points"])
        w.is_label = e.get("is_label", False)
        vocab.add_token(w)
    vocab.finalize_vocab()
    # finalize re-assigns indices by frequency; trust the stored ones
    for e in vocab_entries:
        vocab.word_for(e["word"]).index = e["index"]
    vocab._by_index = sorted(vocab.vocab_words(), key=lambda w: w.index)
    model.vocab = vocab
    table = InMemoryLookupTable(vocab, config["layer_size"], config["seed"],
                                config["use_hierarchic_softmax"],
                                config["negative"], device=model.device)
    table.syn0 = torch.from_numpy(syn0).to(model.device)
    if syn1 is not None:
        table.syn1 = torch.from_numpy(syn1).to(model.device)
    if syn1neg is not None:
        table.syn1neg = torch.from_numpy(syn1neg).to(model.device)
    model.lookup_table = table
    model._prepare_code_arrays()
    return model
