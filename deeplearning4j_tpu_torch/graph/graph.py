"""Graph container + edgelist loaders (the port's own copy of
``deeplearning4j_tpu/graph/graph.py``).

Reference: ``deeplearning4j-graph/.../graph/Graph.java`` (adjacency-list
graph), ``data/GraphLoader.java`` + ``data/impl/DelimitedEdgeLineProcessor``
/ ``WeightedEdgeLineProcessor`` / ``DelimitedVertexLoader`` (edgelist /
vertex file parsing).

Edges are finalised into CSR arrays (``indptr`` / ``indices`` /
``weights``) so random walks can be generated *vectorised over all
walkers at once* (one gather per step, alias tables for weighted
sampling) instead of the reference's per-edge object chasing.  Host
numpy, as in the JAX package: the stable argsort gives the same CSR
order, which the walks index, and the same Walker tables.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .api import Edge, NoEdgesException, Vertex


class Graph:
    """Adjacency graph over vertices ``0..n-1`` (reference
    ``graph/Graph.java``).

    Undirected edges are stored in both directions, as the reference does
    (``Graph.addEdge`` appends to both endpoint lists for undirected).
    """

    def __init__(self, num_vertices: int,
                 vertex_values: Optional[Sequence[Any]] = None):
        if num_vertices <= 0:
            raise ValueError("num_vertices must be positive")
        self._n = int(num_vertices)
        self._values: List[Any] = (list(vertex_values) if vertex_values
                                   else [None] * self._n)
        if len(self._values) != self._n:
            raise ValueError("vertex_values length mismatch")
        self._edges: List[Edge] = []
        # CSR cache, invalidated on add_edge
        self._csr: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._alias: Optional[Tuple[np.ndarray, np.ndarray]] = None

    # -- construction ------------------------------------------------------

    def add_edge(self, frm: int, to: int, value: Any = None,
                 directed: bool = False) -> None:
        if not (0 <= frm < self._n and 0 <= to < self._n):
            raise ValueError(f"edge ({frm},{to}) out of range [0,{self._n})")
        self._edges.append(Edge(frm, to, value, directed))
        self._csr = None
        self._alias = None

    # -- basic queries -----------------------------------------------------

    def num_vertices(self) -> int:
        return self._n

    def num_edges(self) -> int:
        return len(self._edges)

    def get_vertex(self, idx: int) -> Vertex:
        return Vertex(idx, self._values[idx])

    def get_edges(self) -> List[Edge]:
        return list(self._edges)

    def vertex_degree(self, idx: int) -> int:
        indptr, _, _ = self.csr()
        return int(indptr[idx + 1] - indptr[idx])

    def degrees(self) -> np.ndarray:
        indptr, _, _ = self.csr()
        return np.diff(indptr).astype(np.int64)

    def neighbors(self, idx: int) -> np.ndarray:
        indptr, indices, _ = self.csr()
        return indices[indptr[idx]:indptr[idx + 1]].copy()

    def get_connected_vertices(self, idx: int) -> List[Vertex]:
        return [self.get_vertex(int(i)) for i in self.neighbors(idx)]

    def get_random_connected_vertex(self, idx: int,
                                    rng: np.random.Generator) -> Vertex:
        nbrs = self.neighbors(idx)
        if nbrs.size == 0:
            raise NoEdgesException(f"vertex {idx} has no outgoing edges")
        return self.get_vertex(int(nbrs[rng.integers(0, nbrs.size)]))

    # -- CSR / alias finalisation -----------------------------------------

    def csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(indptr, indices, weights) in CSR layout.  Unweighted edges get
        weight 1.0; an undirected edge appears in both rows."""
        if self._csr is None:
            frm, to, w = [], [], []
            for e in self._edges:
                weight = float(e.value) if isinstance(e.value, (int, float)) \
                    else 1.0
                frm.append(e.frm)
                to.append(e.to)
                w.append(weight)
                if not e.directed:
                    frm.append(e.to)
                    to.append(e.frm)
                    w.append(weight)
            frm_a = np.asarray(frm, dtype=np.int64)
            to_a = np.asarray(to, dtype=np.int64)
            w_a = np.asarray(w, dtype=np.float64)
            order = np.argsort(frm_a, kind="stable")
            counts = np.bincount(frm_a, minlength=self._n)
            indptr = np.zeros(self._n + 1, dtype=np.int64)
            np.cumsum(counts, out=indptr[1:])
            self._csr = (indptr, to_a[order], w_a[order])
        return self._csr

    def alias_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-vertex Walker alias tables over edge weights, flat in CSR
        edge order: ``(prob, alias)`` such that a weighted neighbour draw is
        ``k = floor(u1*deg); pos = indptr[v]+k;
        next = indices[pos] if u2 < prob[pos] else indices[alias[pos]]``.
        O(1) per draw → walk generation stays vectorised for weighted
        graphs too (the reference's WeightedRandomWalkIterator does a
        linear scan per step)."""
        if self._alias is None:
            indptr, indices, weights = self.csr()
            prob = np.ones_like(weights)
            alias = np.arange(indices.size, dtype=np.int64)
            for v in range(self._n):
                lo, hi = indptr[v], indptr[v + 1]
                d = hi - lo
                if d == 0:
                    continue
                w = weights[lo:hi]
                total = w.sum()
                if total <= 0:
                    scaled = np.full(d, 1.0)
                else:
                    scaled = w * (d / total)
                small = [i for i in range(d) if scaled[i] < 1.0]
                large = [i for i in range(d) if scaled[i] >= 1.0]
                p = scaled.copy()
                a = np.arange(d, dtype=np.int64)
                while small and large:
                    s = small.pop()
                    g = large.pop()
                    a[s] = g
                    p[g] = p[g] - (1.0 - p[s])
                    (small if p[g] < 1.0 else large).append(g)
                prob[lo:hi] = np.clip(p, 0.0, 1.0)
                alias[lo:hi] = a + lo
            self._alias = (prob, alias)
        return self._alias


class GraphLoader:
    """Edgelist file loaders (reference ``data/GraphLoader.java``)."""

    @staticmethod
    def load_undirected_graph_edge_list(path: str, num_vertices: int,
                                        delimiter: str = ",") -> Graph:
        """Each line ``frm<delim>to`` (reference
        ``loadUndirectedGraphEdgeListFile`` + DelimitedEdgeLineProcessor)."""
        g = Graph(num_vertices)
        for frm, to, _ in _iter_edge_lines(path, delimiter, weighted=False):
            g.add_edge(frm, to, directed=False)
        return g

    @staticmethod
    def load_weighted_edge_list(path: str, num_vertices: int,
                                delimiter: str = ",",
                                directed: bool = False) -> Graph:
        """Each line ``frm<delim>to<delim>weight`` (reference
        ``WeightedEdgeLineProcessor``)."""
        g = Graph(num_vertices)
        for frm, to, w in _iter_edge_lines(path, delimiter, weighted=True):
            g.add_edge(frm, to, value=w, directed=directed)
        return g

    @staticmethod
    def load_graph(edge_path: str, vertex_path: str,
                   delimiter: str = ",") -> Graph:
        """Vertex file: one value per line, vertex id = line number
        (reference ``DelimitedVertexLoader``); plus an edgelist."""
        with open(vertex_path, "r", encoding="utf-8") as f:
            values = [ln.strip() for ln in f if ln.strip()]
        g = Graph(len(values), vertex_values=values)
        for frm, to, _ in _iter_edge_lines(edge_path, delimiter,
                                           weighted=False):
            g.add_edge(frm, to, directed=False)
        return g


def _iter_edge_lines(path: str, delimiter: str, weighted: bool):
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(delimiter)
            if len(parts) < (3 if weighted else 2):
                raise ValueError(f"{path}:{lineno + 1}: bad edge line "
                                 f"{line!r}")
            yield (int(parts[0]), int(parts[1]),
                   float(parts[2]) if weighted else 1.0)
