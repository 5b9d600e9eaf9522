"""Vantage-point tree for nearest-neighbour search (a copy of
``deeplearning4j_tpu/clustering/vptree.py``: host numpy, the vantage
picks from ``np.random.default_rng(seed)``, so both packages build the
same tree and answer bit for bit).

Reference: ``deeplearning4j-core/.../clustering/vptree/VpTreeNode.java`` /
``VPTree.java`` (metric-tree kNN used by WordVectors.wordsNearest and the
UI's nearest-neighbour endpoints).

Host-side structure (numpy): build partitions around a random vantage
point by median distance; search prunes subtrees by the triangle
inequality.  For large *batched* query sets the device brute-force matmul
(see ``GraphVectors.vertices_nearest``) is usually faster there — the
tree wins for repeated single queries on big corpora, which is its role
in the reference too.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np


class _Node:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional["_Node"] = None   # d <= threshold
        self.outside: Optional["_Node"] = None  # d > threshold


class VPTree:
    """kNN metric tree (reference ``VPTree.java``; euclidean or cosine
    distance, matching the reference's supported similarity functions)."""

    def __init__(self, items, distance: str = "euclidean", seed: int = 0):
        self.items = np.asarray(items, np.float32)
        if self.items.ndim != 2 or self.items.shape[0] == 0:
            raise ValueError("items must be a non-empty (n, d) matrix")
        self.distance = distance.lower()
        if self.distance not in ("euclidean", "cosine"):
            raise ValueError("distance must be euclidean or cosine")
        if self.distance == "cosine":
            norms = np.maximum(
                np.linalg.norm(self.items, axis=1, keepdims=True), 1e-12)
            self._normed = self.items / norms
        self._rng = np.random.default_rng(seed)
        self.root = self._build(list(range(self.items.shape[0])))

    # -- distances ---------------------------------------------------------

    def _dist_many(self, q: np.ndarray, idx: Sequence[int]) -> np.ndarray:
        if self.distance == "cosine":
            # chord distance between unit vectors: sqrt(2*(1-cos)) — a
            # true metric (1-cos itself violates the triangle inequality,
            # which would break the tau pruning bounds) with the same
            # neighbour ordering as cosine similarity
            qn = q / max(np.linalg.norm(q), 1e-12)
            return np.linalg.norm(self._normed[idx] - qn, axis=1)
        return np.linalg.norm(self.items[idx] - q, axis=1)

    # -- build -------------------------------------------------------------

    def _build(self, indices: List[int]) -> Optional[_Node]:
        """Iterative construction (explicit worklist): recursion depth
        would be O(n) on duplicate-heavy data — every tie falls inside a
        zero-median ball — and blow the interpreter stack."""
        if not indices:
            return None
        root = _Node(-1)
        work = [(root, "inside", indices)]
        while work:
            parent, side, idx = work.pop()
            vp_pos = int(self._rng.integers(0, len(idx)))
            vp = idx[vp_pos]
            rest = idx[:vp_pos] + idx[vp_pos + 1:]
            node = _Node(vp)
            setattr(parent, side, node)
            if not rest:
                continue
            d = self._dist_many(self.items[vp], rest)
            median = float(np.median(d))
            node.threshold = median
            # Points AT the median satisfy both subtree invariants
            # (inside: d <= t, outside: d >= t), so distribute them to
            # keep the tree balanced — duplicate-heavy data would
            # otherwise degenerate to a list.  The search bounds stay
            # valid because outside only ever holds d >= threshold.
            inside = [i for i, di in zip(rest, d) if di < median]
            outside = [i for i, di in zip(rest, d) if di > median]
            for i, di in zip(rest, d):
                if di == median:
                    (inside if len(inside) <= len(outside)
                     else outside).append(i)
            if inside:
                work.append((node, "inside", inside))
            if outside:
                work.append((node, "outside", outside))
        return root.inside

    # -- search ------------------------------------------------------------

    def knn(self, query, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest neighbours of one query point: (indices, distances),
        nearest first (reference ``VPTree.search``)."""
        q = np.asarray(query, np.float32)
        heap: List[Tuple[float, int]] = []  # max-heap via negated dist
        tau = [np.inf]

        def visit(node: Optional[_Node]) -> None:
            if node is None:
                return
            d = float(self._dist_many(q, [node.index])[0])
            if d < tau[0] or len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) > k:
                    heapq.heappop(heap)
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d <= node.threshold:
                visit(node.inside)
                if d + tau[0] > node.threshold:  # ball crosses boundary
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        pairs = sorted(((-nd, i) for nd, i in heap))
        idx = np.array([i for _, i in pairs], np.int64)
        dist = np.array([d for d, _ in pairs], np.float32)
        return idx, dist
