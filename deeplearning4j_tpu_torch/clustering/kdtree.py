"""k-d tree for axis-aligned nearest-neighbour and radius search (a copy
of ``deeplearning4j_tpu/clustering/kdtree.py``: host numpy, the same
answers bit for bit).

Reference: ``deeplearning4j-core/.../clustering/kdtree/KDTree.java``
(``insert:54``, ``delete:102``, radius search ``knn:135``, ``nn:169``,
``size:313``).  The reference cycles the split dimension with depth; the
delete strategy differs: instead of the reference's successor-promotion
(which breaks the strict insert invariant and forces both-subtree
searches), deletion tombstones the node and rebuilds the tree balanced
once tombstones outnumber live points — same contract, no recursion, and
queries stay single-path-directed.

All traversals use explicit stacks: a degenerate insert order (sorted
points) produces an n-deep spine, and recursive walks would overflow
Python's recursion limit (the sibling :class:`VPTree` uses the same
worklist pattern).

Host-side structure (numpy), like :class:`VPTree`: single-query spatial
lookups are a host-side job — batched similarity queries should use the
device brute-force matmul instead (see ``GraphVectors``), which is the
faster shape for an accelerator.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class KDNode:
    """Tree node (reference ``KDTree.KDNode``)."""

    __slots__ = ("point", "left", "right", "deleted")

    def __init__(self, point: np.ndarray):
        self.point = point
        self.left: Optional["KDNode"] = None
        self.right: Optional["KDNode"] = None
        self.deleted = False


class KDTree:
    """k-d tree over points of a fixed dimensionality.

    ``knn(point, distance)`` follows the reference's contract: all points
    within ``distance`` of ``point`` (a radius search), sorted by
    distance; ``nn`` returns the single nearest ``(distance, point)``.
    """

    def __init__(self, dims: int):
        if dims <= 0:
            raise ValueError("dims must be positive")
        self.dims = dims
        self._root: Optional[KDNode] = None
        self._size = 0
        self._tombstones = 0

    def _check(self, point) -> np.ndarray:
        p = np.asarray(point, np.float64).reshape(-1)
        if p.shape[0] != self.dims:
            raise ValueError(f"point has {p.shape[0]} dims, tree has "
                             f"{self.dims}")
        return p

    # ------------------------------------------------------------ mutation
    def insert(self, point) -> None:
        p = self._check(point)
        self._size += 1
        if self._root is None:
            self._root = KDNode(p)
            return
        node, depth = self._root, 0
        while True:
            axis = depth % self.dims
            if p[axis] < node.point[axis]:
                if node.left is None:
                    node.left = KDNode(p)
                    return
                node = node.left
            else:
                if node.right is None:
                    node.right = KDNode(p)
                    return
                node = node.right
            depth += 1

    def delete(self, point) -> bool:
        """Remove one live node holding ``point`` (exact match); True if
        one was removed (reference ``delete:102``).

        The strict insert invariant (equal axis values go right) is never
        violated by tombstoning, so the descent is single-path: left only
        on strictly-less, right otherwise.
        """
        p = self._check(point)
        node, depth = self._root, 0
        while node is not None:
            if not node.deleted and np.array_equal(node.point, p):
                node.deleted = True
                self._size -= 1
                self._tombstones += 1
                if self._tombstones > max(self._size, 8):
                    self._rebuild()
                return True
            axis = depth % self.dims
            node = node.left if p[axis] < node.point[axis] else node.right
            depth += 1
        return False

    def _rebuild(self) -> None:
        """Re-pack live points into a balanced tree (median split per
        cycled axis), dropping tombstones."""
        pts: List[np.ndarray] = []
        stack = [self._root] if self._root is not None else []
        while stack:
            n = stack.pop()
            if not n.deleted:
                pts.append(n.point)
            if n.left is not None:
                stack.append(n.left)
            if n.right is not None:
                stack.append(n.right)
        self._tombstones = 0
        self._root = None
        if not pts:
            return
        arr = np.stack(pts)
        # (lo, hi, depth, parent, side); build by median split
        jobs = [(0, len(arr), 0, None, "")]
        order = np.arange(len(arr))
        while jobs:
            lo, hi, depth, parent, side = jobs.pop()
            if lo >= hi:
                continue
            axis = depth % self.dims
            seg = order[lo:hi]
            seg = seg[np.argsort(arr[seg, axis], kind="stable")]
            order[lo:hi] = seg
            mid = (lo + hi) // 2
            node = KDNode(arr[order[mid]])
            if parent is None:
                self._root = node
            elif side == "l":
                parent.left = node
            else:
                parent.right = node
            jobs.append((lo, mid, depth + 1, node, "l"))
            jobs.append((mid + 1, hi, depth + 1, node, "r"))

    # ------------------------------------------------------------- queries
    def nn(self, point) -> Tuple[float, Optional[np.ndarray]]:
        """Nearest neighbour as ``(distance, point)`` (reference
        ``nn:169``)."""
        p = self._check(point)
        best_d, best_p = np.inf, None
        # entries carry the split gap that guards them; far branches are
        # re-checked against the CURRENT best when popped, so later best
        # improvements still prune already-pushed subtrees
        stack = [(self._root, 0, 0.0)] if self._root is not None else []
        while stack:
            node, depth, bound = stack.pop()
            if bound >= best_d:
                continue
            if not node.deleted:
                d = float(np.linalg.norm(node.point - p))
                if d < best_d:
                    best_d, best_p = d, node.point
            axis = depth % self.dims
            diff = p[axis] - node.point[axis]
            near, far = ((node.left, node.right) if diff < 0
                         else (node.right, node.left))
            # push far first so near is explored first
            if far is not None and abs(diff) < best_d:
                stack.append((far, depth + 1, abs(diff)))
            if near is not None:
                stack.append((near, depth + 1, 0.0))
        return best_d, best_p

    def knn(self, point, distance: float
            ) -> List[Tuple[float, np.ndarray]]:
        """All points within ``distance``, sorted ascending by distance
        (the reference's radius-search ``knn:135``)."""
        p = self._check(point)
        out: List[Tuple[float, np.ndarray]] = []
        stack = [(self._root, 0)] if self._root is not None else []
        while stack:
            node, depth = stack.pop()
            if not node.deleted:
                d = float(np.linalg.norm(node.point - p))
                if d <= distance:
                    out.append((d, node.point))
            axis = depth % self.dims
            diff = p[axis] - node.point[axis]
            if node.left is not None and diff < distance:
                stack.append((node.left, depth + 1))
            if node.right is not None and -diff <= distance:
                stack.append((node.right, depth + 1))
        out.sort(key=lambda t: t[0])
        return out

    def size(self) -> int:
        return self._size
