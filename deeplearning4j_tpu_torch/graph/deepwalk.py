"""DeepWalk graph embeddings + GraphVectors API (port of
``deeplearning4j_tpu/graph/deepwalk.py``).

Reference: ``deeplearning4j-graph/.../models/deepwalk/DeepWalk.java:31``
(random-walk skip-gram over vertices, hierarchical softmax over a
degree-frequency Huffman tree), ``deepwalk/GraphHuffman.java`` (tree over
vertex degrees), ``models/embeddings/InMemoryGraphLookupTable.java``
(vertex vectors + inner-node weights, per-pair ``iterate``),
``models/embeddings/GraphVectorsImpl.java`` (similarity /
verticesNearest), ``models/loader/GraphVectorSerializer.java`` (text
save/load).

The reference trains one (vertex, vertex) pair per ``iterate`` call on
the host.  Here window pairs are extracted for a whole batch of walks at
once and trained in chunks of ``B`` pairs through the word2vec tier's
hierarchical-softmax update (``nlp.word2vec._hs_update``: gathers, two
einsums and ``index_add_`` scatters, in place on the tables).  The JAX
package runs an epoch's chunks as one ``lax.scan``; the port loops over
them on device-resident index tensors with no host read inside the
loop.  Two routes:

- **device walks** (``fit(graph)``, the default where
  :meth:`DeepWalk._device_walk_eligible` holds): a start permutation, the
  ``walk_length`` uniform steps over the CSR on the model's device
  (:func:`device_walks`), the pair grid (:func:`walk_pair_grid`) and the
  chunk loop; the walks never leave the device.  Each epoch draws its
  permutation and uniforms from a ``torch.Generator`` on the model's
  device seeded by ``(seed, pass)`` (:func:`pass_seed`), where the JAX
  package folds the pass into a threefry key; ``DeepWalk.draw_source``
  replaces the draws (the parity tests feed the JAX package's);
- **host walks** (``fit(iterator=...)``, non-uniform cases, or
  ``DL4J_TPU_DEVICE_WALKS=0``): numpy ``generate_walks`` (bitwise the
  JAX package's for a seed), ``_walk_pairs`` and the same chunk loop.

``device=None`` means the CUDA card (``device.resolve_device``); the CPU
must be asked for.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..nlp.vocab import huffman_codes
from ..nlp.word2vec import _hs_update
from .api import NoEdgeHandling
from .graph import Graph
from .iterators import RandomWalkIterator, generate_walks

Tensor = torch.Tensor

#: ``(n_vertices, walk_length, pass) -> (starts (n,), u (walk_length, n))``
DrawSource = Callable[[int, int, int], Tuple[object, object]]


def device_walks_enabled() -> bool:
    """On-device walk generation escape hatch (``DL4J_TPU_DEVICE_WALKS=0``
    forces the host ``generate_walks`` path)."""
    return os.environ.get("DL4J_TPU_DEVICE_WALKS", "1") != "0"


def pass_seed(base: int, walk_pass: int) -> int:
    """The generator seed of one device-walk epoch: ``base`` (the model's
    seed) and the lifetime pass count mixed by ``np.random.SeedSequence``,
    the role of ``fold_in(PRNGKey(seed), pass)`` in the JAX package."""
    state = np.random.SeedSequence(
        [int(base) % 2 ** 64, int(walk_pass)]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def own_walk_draws(n_vertices: int, walk_length: int, seed: int,
                   device) -> Tuple[Tensor, Tensor]:
    """A start permutation (int32) and the (walk_length, n) float32
    uniforms of one epoch from a generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    starts = torch.randperm(n_vertices, generator=gen, device=device)
    u = torch.rand((walk_length, n_vertices), generator=gen, device=device)
    return starts.to(torch.int32), u


def host_walk_draws(seed: int) -> DrawSource:
    """A ``draw_source`` whose draws come from a CPU generator seeded by
    ``seed`` and the pass: a model on the card and one on the CPU then
    walk the same walks (card-against-CPU checks)."""
    def source(n_vertices: int, walk_length: int, walk_pass: int):
        return own_walk_draws(n_vertices, walk_length,
                              seed * 1_000_003 + walk_pass, "cpu")
    return source


def device_walks(indptr: Tensor, indices: Tensor, starts: Tensor,
                 u: Tensor) -> Tensor:
    """Uniform walks over the CSR on its device, one per start: (n, L+1)
    int32 with L = ``u.shape[0]``.  The JAX package's step
    (``_walk_epoch_fn`` ``wstep``): ``deg = indptr[cur+1] - indptr[cur]``,
    ``k = min(int32(u * float32(deg)), max(deg - 1, 0))`` (the product in
    float32, then truncation), ``pos = min(indptr[cur] + k, n_edges -
    1)``, ``next = where(deg == 0, cur, indices[pos])``: stuck walkers
    stay in place (SELF_LOOP_ON_DISCONNECTED)."""
    last = indices.shape[0] - 1
    cur = starts
    steps = [starts]
    for s in range(u.shape[0]):
        lo = indptr[cur]
        deg = indptr[cur + 1] - lo
        k = torch.minimum((u[s] * deg.to(torch.float32)).to(torch.int32),
                          torch.clamp(deg - 1, min=0))
        pos = torch.clamp(lo + k, max=last)
        cur = torch.where(deg == 0, cur, indices[pos])
        steps.append(cur)
    return torch.stack(steps, dim=1)


def walk_window(walk_length: int, window: int) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """(mids, offsets) of the reference window rule over walks of
    ``walk_length + 1`` vertices: mid in ``[window, L - window)``, offset
    in ``±1..±window``."""
    L = walk_length + 1
    mids = np.arange(window, L - window)
    offs = np.concatenate([np.arange(-window, 0),
                           np.arange(1, window + 1)]).astype(np.int64)
    return mids, offs


def chunked(inputs: Tensor, targets: Tensor, n_pairs: int, B: int
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """Pad the flat pair arrays to ``n_chunks * B`` (zeros) and reshape to
    (n_chunks, B), with the float32 pair mask that zeroes the pad."""
    n_chunks = max(1, -(-n_pairs // B))
    pad = n_chunks * B - n_pairs
    dev = inputs.device
    pmask = (torch.arange(n_chunks * B, device=dev) < n_pairs).to(
        torch.float32)
    if pad:
        inputs = torch.nn.functional.pad(inputs, (0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
    return (inputs.reshape(n_chunks, B), targets.reshape(n_chunks, B),
            pmask.reshape(n_chunks, B))


def walk_pair_grid(walks: Tensor, window: int, B: int
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """(inputs, targets, pair mask), each (n_chunks, B), of a walk batch
    (n, L+1) on its device, in ``DeepWalk._walk_pairs``'s block order
    (for mid, for offset: one (n,) block) with static shapes
    (``_walk_epoch_fn``'s extraction)."""
    n, L1 = walks.shape
    mids, offs = walk_window(L1 - 1, window)
    M, W2 = mids.size, offs.size
    mid_idx = torch.from_numpy(mids).to(walks.device)
    tgt_idx = torch.from_numpy(mids[:, None] + offs[None, :]).to(
        walks.device)
    ins = walks[:, mid_idx].T[:, None, :].expand(M, W2, n).reshape(-1)
    tgts = walks[:, tgt_idx].permute(1, 2, 0).reshape(-1)
    return chunked(ins, tgts, n * M * W2, B)


def hs_chunks(syn0: Tensor, syn1: Tensor, inputs: Tensor, targets: Tensor,
              pmask: Tensor, points: Tensor, codes: Tensor, cmask: Tensor,
              lr: Tensor) -> Tensor:
    """The chunk loop of one epoch (``_deepwalk_epoch``'s scan body):
    ``_hs_update`` on each (B,) chunk with the target vertices' Huffman
    paths gathered on the device, in place on ``syn0``/``syn1``.  Returns
    the epoch's loss, summed in chunk order in float32 on the device."""
    loss = torch.zeros((), dtype=torch.float32, device=syn0.device)
    for c in range(inputs.shape[0]):
        bt = targets[c]
        _, _, chunk_loss = _hs_update(syn0, syn1, inputs[c], points[bt],
                                      codes[bt], cmask[bt], pmask[c], lr)
        loss = loss + chunk_loss
    return loss


class GraphHuffman:
    """Huffman tree over vertex degrees for hierarchical softmax
    (reference ``deepwalk/GraphHuffman.java`` — codes + path inner nodes
    per vertex).  Same bottom-up two-pointer construction as the word2vec
    tier (``nlp/vocab.py:huffman_codes``), generalised to raw
    frequencies."""

    def __init__(self, frequencies: Sequence[int],
                 max_code_length: int = 64):
        freqs = [max(int(f), 1) for f in frequencies]
        n = len(freqs)
        if n < 2:
            raise ValueError("need at least 2 vertices for a Huffman tree")
        assigned = huffman_codes(freqs, max_code_length)
        self._codes: List[List[int]] = [c for c, _ in assigned]
        self._points: List[List[int]] = [p for _, p in assigned]
        self.num_inner = n - 1

    def get_code(self, vertex: int) -> List[int]:
        return list(self._codes[vertex])

    def get_code_length(self, vertex: int) -> int:
        return len(self._codes[vertex])

    def get_path_inner_nodes(self, vertex: int) -> List[int]:
        return list(self._points[vertex])


class GraphVectors:
    """Learned vertex representations (reference
    ``models/GraphVectors.java`` / ``GraphVectorsImpl.java``)."""

    def __init__(self, graph: Optional[Graph], vectors: np.ndarray):
        self.graph = graph
        self._vectors = np.asarray(vectors, dtype=np.float32)

    def num_vertices(self) -> int:
        return self._vectors.shape[0]

    @property
    def vector_size(self) -> int:
        return self._vectors.shape[1]

    def get_vertex_vector(self, idx: int) -> np.ndarray:
        return self._vectors[idx].copy()

    def vertex_vectors(self) -> np.ndarray:
        return self._vectors

    def similarity(self, v1: int, v2: int) -> float:
        """Cosine similarity (reference ``GraphVectorsImpl.similarity``)."""
        vecs = self._vectors  # one host fetch (DeepWalk property copies)
        a, b = vecs[v1], vecs[v2]
        denom = float(np.linalg.norm(a) * np.linalg.norm(b))
        return float(np.dot(a, b) / denom) if denom > 0 else 0.0

    def vertices_nearest(self, vertex_idx: int, top: int) -> np.ndarray:
        """Top-N vertices by cosine similarity, excluding the query vertex
        (reference ``GraphVectorsImpl.verticesNearest`` — priority queue
        there; one vectorised matmul + argpartition here)."""
        vecs = self._vectors  # one host fetch (DeepWalk property copies)
        v = vecs[vertex_idx]
        norms = np.linalg.norm(vecs, axis=1) * np.linalg.norm(v)
        sims = (vecs @ v) / np.maximum(norms, 1e-12)
        sims[vertex_idx] = -np.inf
        top = min(top, sims.size - 1)
        idx = np.argpartition(-sims, top - 1)[:top]
        return idx[np.argsort(-sims[idx])]


class DeepWalk(GraphVectors):
    """DeepWalk (Perozzi et al. 2014) — skip-gram with hierarchical softmax
    over random vertex walks (reference ``deepwalk/DeepWalk.java``).

    Usage matches the reference: ``Builder`` → ``initialize(graph)`` (or a
    degree list) → ``fit(graph, walk_length)``.  ``syn0``/``syn1`` are
    float32 tensors on ``device`` (None = the card).

    ``draw_source``: None, or a :data:`DrawSource` that supplies each
    device-walk epoch's start permutation and uniforms instead of the
    model's generator (:func:`host_walk_draws`; the parity tests feed the
    JAX package's threefry draws through it).
    """

    def __init__(self, vector_size: int = 100, window_size: int = 2,
                 learning_rate: float = 0.01, seed: Optional[int] = 0,
                 batch_size: int = 2048, device=None):
        self.device = resolve_device(device)
        self.vector_size_cfg = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.seed = seed
        self.batch_size = batch_size
        self.draw_source: Optional[DrawSource] = None
        self._init_called = False
        self.huffman: Optional[GraphHuffman] = None
        self.syn0: Optional[Tensor] = None
        self.syn1: Optional[Tensor] = None
        self.graph = None
        self._cum_loss = 0.0
        # device-resident CSR for on-device walk generation (uploaded
        # once per graph) + lifetime pass counter for the walk RNG
        self._csr_graph = None
        self._indptr_dev = None
        self._indices_dev = None
        self._walk_passes = 0
        #: pairs, chunks and chunk size of the last epoch, and its route
        self._walk_stats: dict = {}

    def _upload(self, arr: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- lifecycle ---------------------------------------------------------

    def initialize(self, graph_or_degrees) -> None:
        """Build the degree-Huffman tree and init weights (reference
        ``DeepWalk.initialize`` — vectors ~ (U(0,1)-0.5)/vectorSize), from
        ``np.random.default_rng(seed)``: the JAX package's init, bitwise."""
        if isinstance(graph_or_degrees, Graph):
            self.graph = graph_or_degrees
            degrees = graph_or_degrees.degrees()
        else:
            degrees = np.asarray(graph_or_degrees, dtype=np.int64)
        n = int(degrees.size)
        self.huffman = GraphHuffman(degrees.tolist())
        rng = np.random.default_rng(self.seed)
        d = self.vector_size_cfg
        self.syn0 = self._upload(
            ((rng.random((n, d)) - 0.5) / d).astype(np.float32))
        self.syn1 = self._upload(
            ((rng.random((self.huffman.num_inner, d)) - 0.5) / d)
            .astype(np.float32))
        max_len = max(self.huffman.get_code_length(v) for v in range(n))
        self._points = np.zeros((n, max_len), dtype=np.int32)
        self._codes = np.zeros((n, max_len), dtype=np.float32)
        self._code_mask = np.zeros((n, max_len), dtype=np.float32)
        for v in range(n):
            pts = self.huffman.get_path_inner_nodes(v)
            cds = self.huffman.get_code(v)
            self._points[v, :len(pts)] = pts
            self._codes[v, :len(cds)] = cds
            self._code_mask[v, :len(cds)] = 1.0
        # device-resident Huffman tables for the chunk loop
        self._points_dev = self._upload(self._points)
        self._codes_dev = self._upload(self._codes)
        self._cmask_dev = self._upload(self._code_mask)
        self._init_called = True

    # -- training ----------------------------------------------------------

    def fit(self, graph: Optional[Graph] = None, walk_length: int = 40,
            iterator: Optional[RandomWalkIterator] = None,
            epochs: int = 1) -> "DeepWalk":
        """Fit from a graph (fresh uniform walks per epoch, reference
        ``DeepWalk.fit(IGraph,int)``) or from a supplied walk iterator
        (reference ``fit(GraphWalkIterator)``)."""
        if not self._init_called:
            if graph is None and iterator is not None:
                graph = iterator.graph
            if graph is None:
                raise RuntimeError("DeepWalk not initialized: call "
                                   "initialize(graph) or pass a graph")
            self.initialize(graph)
        if graph is not None:
            self.graph = graph
        if (iterator is None and device_walks_enabled()
                and self._device_walk_eligible(walk_length)):
            self._fit_device_walks(walk_length, epochs)
            return self
        rng = np.random.default_rng(self.seed)
        for _ in range(epochs):
            if iterator is not None:
                walks = iterator.walks_array()
                iterator.reset()
            else:
                starts = np.arange(self.graph.num_vertices())
                rng.shuffle(starts)
                walks = generate_walks(
                    self.graph, walk_length, rng, start_vertices=starts,
                    no_edge=NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED)
            self._train_walks(walks)
        return self

    def _device_walk_eligible(self, walk_length: int) -> bool:
        """The device path covers the default ``fit(graph)`` route:
        uniform walks, at least one edge (the empty-CSR gather has no
        rows to pull from), and a window that yields pairs at all."""
        if self.graph is None:
            return False
        indptr, indices, _ = self.graph.csr()
        if indices.size == 0:
            return False
        return (walk_length + 1) - 2 * self.window_size > 0

    def _ensure_csr_device(self) -> None:
        if self._csr_graph is self.graph and self._indptr_dev is not None:
            return
        indptr, indices, _ = self.graph.csr()
        self._indptr_dev = self._upload(indptr.astype(np.int32))
        self._indices_dev = self._upload(indices.astype(np.int32))
        self._csr_graph = self.graph

    def _chunk_size(self) -> int:
        """Pairs per update, clamped to ~2x the vertex count: a batched
        scatter applies every duplicate row's gradient at the same stale
        point (effective k x lr), which diverges once the batch dwarfs
        the vertex set (a 20-vertex graph at B=2048 blew up to 1e11
        within 8 epochs in the JAX package) — the word2vec tier's
        ``_effective_batch`` rule, applied to vertices."""
        return int(min(self.batch_size, max(64, 2 * self.syn0.shape[0])))

    def _lr(self) -> Tensor:
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=self.device)

    def _walk_draws(self, n: int, walk_length: int, walk_pass: int,
                    base: int) -> Tuple[Tensor, Tensor]:
        if self.draw_source is None:
            return own_walk_draws(n, walk_length,
                                  pass_seed(base, walk_pass), self.device)
        starts, u = (a if isinstance(a, Tensor) else torch.from_numpy(
            np.array(a)) for a in self.draw_source(n, walk_length, walk_pass))
        starts = starts.to(self.device, torch.int32)
        u = u.to(self.device, torch.float32)
        if tuple(starts.shape) != (n,) or tuple(u.shape) != (walk_length,
                                                               n):
            raise ValueError(
                f"draw_source gave starts {tuple(starts.shape)} and u "
                f"{tuple(u.shape)}; expected ({n},) and ({walk_length}, "
                f"{n})")
        return starts, u

    def _fit_device_walks(self, walk_length: int, epochs: int) -> None:
        """Epochs of device walks: draws, walks, the pair grid and the
        chunk loop all on the model's device; the one loss read after the
        epoch loop is the completion barrier.  Zero epochs leave the model
        as it was."""
        self._ensure_csr_device()
        if epochs < 1:
            return
        n = int(self.syn0.shape[0])
        B = self._chunk_size()
        base = (self.seed if self.seed is not None
                else int(np.random.randint(0, 2**31 - 1)))
        lr = self._lr()
        losses = []
        for _ in range(epochs):
            starts, u = self._walk_draws(n, int(walk_length),
                                         self._walk_passes, base)
            self._walk_passes += 1
            walks = device_walks(self._indptr_dev, self._indices_dev,
                                 starts, u)
            inputs, targets, pmask = walk_pair_grid(walks,
                                                    self.window_size, B)
            del walks, u
            losses.append(hs_chunks(
                self.syn0, self.syn1, inputs, targets, pmask,
                self._points_dev, self._codes_dev, self._cmask_dev, lr))
        mids, offs = walk_window(int(walk_length), self.window_size)
        self._walk_stats = {"route": "device", "batch": B,
                            "chunks": int(inputs.shape[0]),
                            "pairs": n * mids.size * offs.size}
        for loss in losses:
            self._cum_loss += float(loss.item())

    def _walk_pairs(self, walks: np.ndarray) -> Tuple[np.ndarray,
                                                      np.ndarray]:
        """(input, target) pairs under the reference window rule
        (``DeepWalk.skipGram`` — mid ranges over
        ``[windowSize, len-windowSize)``, pos over ±window, pos != mid) —
        extracted for the whole walk batch at once by shifted slicing."""
        w = self.window_size
        L = walks.shape[1]
        ins, tgts = [], []
        for mid in range(w, L - w):
            for off in range(-w, w + 1):
                if off == 0:
                    continue
                ins.append(walks[:, mid])
                tgts.append(walks[:, mid + off])
        if not ins:
            return (np.empty(0, np.int64),) * 2
        return np.concatenate(ins), np.concatenate(tgts)

    def _train_walks(self, walks: np.ndarray) -> None:
        """One epoch of host walks: the pairs uploaded once as int32
        index tensors, padded to whole chunks with a pair mask, then the
        chunk loop on the model's device and one read of the loss."""
        inputs, targets = self._walk_pairs(walks)
        if inputs.size == 0:
            return
        B = self._chunk_size()
        n = inputs.size
        inputs, targets, pmask = chunked(
            self._upload(inputs.astype(np.int32)),
            self._upload(targets.astype(np.int32)), n, B)
        loss = hs_chunks(self.syn0, self.syn1, inputs, targets, pmask,
                         self._points_dev, self._codes_dev,
                         self._cmask_dev, self._lr())
        self._walk_stats = {"route": "host", "batch": B,
                            "chunks": int(inputs.shape[0]), "pairs": n}
        self._cum_loss += float(loss.item())

    # -- GraphVectors surface ---------------------------------------------

    @property
    def _vectors(self) -> np.ndarray:
        if self.syn0 is None:
            raise RuntimeError("DeepWalk not initialized")
        return self.syn0.detach().cpu().numpy()

    @_vectors.setter
    def _vectors(self, value) -> None:  # GraphVectors.__init__ compat
        self.syn0 = self._upload(np.asarray(value, dtype=np.float32))

    def get_vector_size(self) -> int:
        return self.vector_size_cfg

    class Builder:
        """Reference ``DeepWalk.Builder`` surface, plus ``device``."""

        def __init__(self):
            self._vector_size = 100
            self._window_size = 2
            self._learning_rate = 0.01
            self._seed: Optional[int] = 0
            self._batch_size = 2048
            self._device = None

        def vector_size(self, v: int) -> "DeepWalk.Builder":
            self._vector_size = v
            return self

        def window_size(self, w: int) -> "DeepWalk.Builder":
            self._window_size = w
            return self

        def learning_rate(self, lr: float) -> "DeepWalk.Builder":
            self._learning_rate = lr
            return self

        def seed(self, s: int) -> "DeepWalk.Builder":
            self._seed = s
            return self

        def batch_size(self, b: int) -> "DeepWalk.Builder":
            self._batch_size = b
            return self

        def device(self, d) -> "DeepWalk.Builder":
            self._device = d
            return self

        def build(self) -> "DeepWalk":
            return DeepWalk(self._vector_size, self._window_size,
                            self._learning_rate, self._seed,
                            self._batch_size, self._device)


def write_graph_vectors(model: GraphVectors, path: str) -> None:
    """Text save: one line per vertex, ``id<TAB>v0<TAB>v1...`` (reference
    ``models/loader/GraphVectorSerializer.writeGraphVectors``); the JAX
    package's bytes for the same vectors."""
    vecs = model.vertex_vectors()
    with open(path, "w", encoding="utf-8") as f:
        for i in range(vecs.shape[0]):
            f.write("\t".join([str(i)] + [repr(float(x))
                                          for x in vecs[i]]) + "\n")


def load_txt_vectors(path: str) -> GraphVectors:
    """Load vectors written by :func:`write_graph_vectors` (reference
    ``GraphVectorSerializer.loadTxtVectors``) as host ``GraphVectors``."""
    rows = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            rows[int(parts[0])] = [float(x) for x in parts[1:]]
    if not rows:
        raise ValueError(f"no vectors found in {path!r}")
    n = max(rows) + 1
    dim = len(next(iter(rows.values())))
    vecs = np.zeros((n, dim), dtype=np.float32)
    for i, v in rows.items():
        vecs[i] = v
    return GraphVectors(None, vecs)
