"""Random-walk iterators + vectorised batch walk generation (the port's
own copy of ``deeplearning4j_tpu/graph/iterators.py``).

Reference: ``deeplearning4j-graph/.../iterator/RandomWalkIterator.java``
(uniform neighbour walks, one walk starting at every vertex in random
order), ``WeightedRandomWalkIterator.java`` (edge-weight-proportional
steps), ``iterator/parallel/RandomWalkGraphIteratorProvider.java``
(splitting start vertices across workers).

The reference advances one walk at a time with a ``Random``; here
``generate_walks`` advances *all* walks one step per numpy op (gather
into CSR ``indices``; Walker alias tables for the weighted case), because
downstream training consumes walks as big batched updates, not one pair
at a time.  The iterator classes keep the reference's streaming surface
on top of the same vectorised core.  The draws come from
``np.random.default_rng``, with the same float64 ``rng.random(n) *
safe_deg`` truncation and clip as the JAX package, so a seed gives
bitwise the same walks in both packages.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .api import NoEdgeHandling, NoEdgesException, VertexSequence
from .graph import Graph


def generate_walks(graph: Graph, walk_length: int,
                   rng: np.random.Generator,
                   start_vertices: Optional[np.ndarray] = None,
                   weighted: bool = False,
                   no_edge: NoEdgeHandling =
                   NoEdgeHandling.EXCEPTION_ON_DISCONNECTED) -> np.ndarray:
    """Generate random walks, one per start vertex, vectorised over walks.

    Returns int array (n_walks, walk_length + 1); a walk of length L visits
    L+1 vertices (reference ``RandomWalkIterator`` walkLength semantics).
    """
    indptr, indices, _ = graph.csr()
    degrees = np.diff(indptr)
    if start_vertices is None:
        start_vertices = np.arange(graph.num_vertices(), dtype=np.int64)
    starts = np.asarray(start_vertices, dtype=np.int64)
    n = starts.size
    walks = np.empty((n, walk_length + 1), dtype=np.int64)
    walks[:, 0] = starts
    if walk_length == 0:
        return walks

    disconnected = degrees[starts] == 0
    if disconnected.any():
        if no_edge is NoEdgeHandling.EXCEPTION_ON_DISCONNECTED:
            bad = int(starts[disconnected][0])
            raise NoEdgesException(
                f"vertex {bad} has no outgoing edges (use "
                f"SELF_LOOP_ON_DISCONNECTED to self-loop instead)")
        # SELF_LOOP_ON_DISCONNECTED: stuck walkers stay in place.

    if indices.size == 0:
        # edgeless graph in SELF_LOOP mode: every walk stays in place
        walks[:, 1:] = starts[:, None]
        return walks

    if weighted:
        prob, alias = graph.alias_tables()

    cur = starts.copy()
    for step in range(1, walk_length + 1):
        deg = degrees[cur]
        if (no_edge is NoEdgeHandling.EXCEPTION_ON_DISCONNECTED
                and (deg == 0).any()):
            bad = int(cur[deg == 0][0])
            raise NoEdgesException(
                f"walk reached vertex {bad} with no outgoing edges at "
                f"step {step}")
        safe_deg = np.maximum(deg, 1)
        k = (rng.random(n) * safe_deg).astype(np.int64)
        pos = indptr[cur] + np.minimum(k, safe_deg - 1)
        # disconnected vertices produce an off-the-end gather index; clip it
        # (the gathered value is replaced by the self-loop `where` below)
        pos = np.minimum(pos, max(indices.size - 1, 0))
        if weighted:
            take_alias = rng.random(n) >= prob[pos]
            pos = np.where(take_alias, alias[pos], pos)
        nxt = indices[pos]
        # disconnected → self loop (only reachable in SELF_LOOP mode)
        nxt = np.where(deg == 0, cur, nxt)
        walks[:, step] = nxt
        cur = nxt
    return walks


class RandomWalkIterator:
    """Uniform random walks starting at every vertex in ``[first_vertex,
    last_vertex)`` exactly once, start order randomised (reference
    ``RandomWalkIterator.java``)."""

    weighted = False

    def __init__(self, graph: Graph, walk_length: int,
                 rng_seed: Optional[int] = None,
                 mode: NoEdgeHandling =
                 NoEdgeHandling.EXCEPTION_ON_DISCONNECTED,
                 first_vertex: int = 0,
                 last_vertex: Optional[int] = None):
        self.graph = graph
        self._walk_length = int(walk_length)
        self.mode = mode
        self.first_vertex = first_vertex
        self.last_vertex = (graph.num_vertices() if last_vertex is None
                            else last_vertex)
        # reset() continues this stream (reference reset() reuses the same
        # java.util.Random), so successive passes see fresh walks
        self._rng = np.random.default_rng(rng_seed)
        self.reset()

    def walk_length(self) -> int:
        return self._walk_length

    def reset(self) -> None:
        self._order = np.arange(self.first_vertex, self.last_vertex,
                                dtype=np.int64)
        self._rng.shuffle(self._order)
        self._walks = generate_walks(
            self.graph, self._walk_length, self._rng,
            start_vertices=self._order, weighted=self.weighted,
            no_edge=self.mode)
        self._position = 0

    def has_next(self) -> bool:
        return self._position < self._order.size

    def next(self) -> VertexSequence:
        if not self.has_next():
            raise StopIteration
        seq = VertexSequence(self.graph,
                             self._walks[self._position].tolist())
        self._position += 1
        return seq

    def __iter__(self) -> Iterator[VertexSequence]:
        while self.has_next():
            yield self.next()

    def walks_array(self) -> np.ndarray:
        """All remaining walks as one (n, L+1) batch — the fast path the
        batched trainer uses instead of per-walk iteration."""
        out = self._walks[self._position:]
        self._position = self._order.size
        return out


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional random walks (reference
    ``WeightedRandomWalkIterator.java``); weights need not be normalised."""

    weighted = True


class RandomWalkGraphIteratorProvider:
    """Split walk starts into N disjoint vertex ranges, one iterator each
    (reference ``iterator/parallel/RandomWalkGraphIteratorProvider.java`` —
    used there to hand one iterator per thread; here the split feeds
    per-device batches)."""

    def __init__(self, graph: Graph, walk_length: int,
                 seed: Optional[int] = None,
                 mode: NoEdgeHandling =
                 NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
                 weighted: bool = False):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.mode = mode
        self.weighted = weighted

    def get_graph_walk_iterators(self, num: int):
        n = self.graph.num_vertices()
        num = max(1, min(num, n))
        bounds = np.linspace(0, n, num + 1, dtype=np.int64)
        cls = (WeightedRandomWalkIterator if self.weighted
               else RandomWalkIterator)
        iters = []
        for i in range(num):
            if bounds[i] == bounds[i + 1]:
                continue
            seed_i = None if self.seed is None else self.seed + i
            iters.append(cls(self.graph, self.walk_length, seed_i,
                             self.mode, int(bounds[i]),
                             int(bounds[i + 1])))
        return iters
