"""K-means clustering on the device (port of
``deeplearning4j_tpu/clustering/kmeans.py``).

Reference: ``deeplearning4j-core/.../clustering/kmeans/KMeansClustering.java``
(setup(k, maxIter, distanceFn) over the BaseClusteringAlgorithm loop:
initial centers, assign-to-nearest, recompute centers, stop on the
iteration budget or convergence) with the ``Cluster``/``ClusterSet``
surface of ``clustering/cluster/``.

The k-means++ seeding is the JAX package's host numpy code, so both
packages start from the same centers for a seed.  The Lloyd loop
(:func:`lloyd`) runs as torch ops on the device: the assignment is one
(N, D) x (D, K) distance matmul and an ``argmin`` (``argmax`` of the
normalised cosine), the center update a one-hot (K, N) x (N, D) matmul,
empty clusters keep their center.  The JAX package runs the loop as one
``lax.while_loop``; here the stopping test (the largest squared move
<= 1e-12) reads one scalar to the host an iteration, counted in
``host_reads``.

Distances are IEEE float32: the loop runs with the float32 matmul
precision at ``"highest"`` (no TF32), because a TF32 ``a @ c.T`` flips
assignments of points near a boundary.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class Cluster:
    """One cluster (reference ``clustering/cluster/Cluster.java``)."""
    cluster_id: int
    center: np.ndarray
    point_indices: np.ndarray

    def get_center(self) -> np.ndarray:
        return self.center

    def num_points(self) -> int:
        return int(self.point_indices.size)


class ClusterSet:
    """Result container (reference ``clustering/cluster/ClusterSet.java``)."""

    def __init__(self, centers: np.ndarray, assignments: np.ndarray,
                 distance_fn: str):
        self.centers = centers
        self.assignments = assignments
        self.distance_fn = distance_fn
        self.clusters: List[Cluster] = [
            Cluster(k, centers[k], np.where(assignments == k)[0])
            for k in range(centers.shape[0])]

    def get_clusters(self) -> List[Cluster]:
        return self.clusters

    def cluster_count(self) -> int:
        return len(self.clusters)

    def nearest_cluster(self, point) -> Cluster:
        d = _pairwise_sq_dist(np.asarray(point, np.float32)[None, :],
                              self.centers)[0]
        if self.distance_fn == "cosinesimilarity":
            d = -_cosine_sim(np.asarray(point, np.float32)[None, :],
                             self.centers)[0]
        return self.clusters[int(np.argmin(d))]


def _pairwise_sq_dist(a, b):
    """||a_i - b_j||^2 via the matmul expansion (host numpy)."""
    aa = (a * a).sum(-1)[:, None]
    bb = (b * b).sum(-1)[None, :]
    return aa + bb - 2.0 * a @ b.T


def _cosine_sim(a, b):
    an = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return an @ bn.T


@contextlib.contextmanager
def ieee_f32_matmul():
    """Run the body with float32 matmuls in IEEE float32 (no TF32), and
    restore the caller's setting after.  The setting is process-wide."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _assign(points: torch.Tensor, centers: torch.Tensor,
            cosine: bool) -> torch.Tensor:
    if cosine:
        pn = points / torch.clamp(
            torch.linalg.norm(points, dim=-1, keepdim=True), min=1e-12)
        cn = centers / torch.clamp(
            torch.linalg.norm(centers, dim=-1, keepdim=True), min=1e-12)
        return torch.argmax(pn @ cn.T, dim=1)
    aa = torch.sum(points * points, -1)[:, None]
    cc = torch.sum(centers * centers, -1)[None, :]
    return torch.argmin(aa + cc - 2.0 * points @ centers.T, dim=1)


def lloyd(points: torch.Tensor, init_centers: torch.Tensor, k: int,
          max_iter: int, cosine: bool):
    """The Lloyd loop on the points' device (JAX ``_lloyd``): returns
    ``(centers, assignments, iterations, host_reads)``.  It stops after
    ``max_iter`` iterations or when no center moved by more than 1e-12
    (squared); each iteration reads that move to the host once."""
    centers = init_centers
    it, reads = 0, 0
    with ieee_f32_matmul():
        while it < max_iter:
            a = _assign(points, centers, cosine)
            one_hot = torch.nn.functional.one_hot(a, k).to(points.dtype)
            counts = one_hot.sum(0)                              # (K,)
            sums = one_hot.T @ points                            # (K, D)
            new_centers = torch.where(
                counts[:, None] > 0,
                sums / torch.clamp(counts[:, None], min=1.0), centers)
            moved = torch.max(torch.sum((new_centers - centers) ** 2, -1))
            centers = new_centers
            it += 1
            reads += 1
            if not bool(moved > 1e-12):
                break
        assignments = _assign(points, centers, cosine).to(torch.int32)
    return centers, assignments, it, reads


class KMeansClustering:
    """Reference surface: ``KMeansClustering.setup(k, maxIter,
    distanceFunction)`` then ``applyTo(points)``.

    ``n_init`` > 1 runs that many independently seeded Lloyd restarts and
    keeps the lowest-inertia result.  Default 1 = the reference's
    single-run behaviour.  ``device`` (default the card) is where the
    Lloyd loop runs.  After :meth:`apply_to`, ``iterations`` lists each
    restart's Lloyd iterations and ``host_reads`` counts the device reads
    of all restarts (one an iteration, plus the centers and the
    assignments of each restart)."""

    def __init__(self, k: int, max_iterations: int = 100,
                 distance_function: str = "euclidean",
                 seed: Optional[int] = 0, n_init: int = 1,
                 device: DeviceLike = None):
        self.k = int(k)
        self.max_iterations = int(max_iterations)
        self.distance_function = distance_function.lower()
        if self.distance_function not in ("euclidean",
                                          "cosinesimilarity"):
            raise ValueError("distance_function must be euclidean or "
                             "cosinesimilarity")
        self.seed = seed
        self.n_init = max(1, int(n_init))
        self.device = resolve_device(device)
        self.iterations: List[int] = []
        self.host_reads = 0

    @classmethod
    def setup(cls, k: int, max_iterations: int = 100,
              distance_function: str = "euclidean",
              seed: Optional[int] = 0, n_init: int = 1,
              device: DeviceLike = None) -> "KMeansClustering":
        return cls(k, max_iterations, distance_function, seed, n_init,
                   device)

    def seed_centers(self, x: np.ndarray, seed) -> np.ndarray:
        """k-means++ seeding on the host (the JAX package's code): the
        same centers in both packages for a seed."""
        n = x.shape[0]
        rng = np.random.default_rng(seed)
        centers = [x[rng.integers(0, n)]]
        cosine = self.distance_function == "cosinesimilarity"
        for _ in range(1, self.k):
            # seed with the SAME metric that drives the Lloyd loop
            if cosine:
                d = np.min(1.0 - _cosine_sim(x, np.stack(centers)), axis=1)
            else:
                d = np.min(_pairwise_sq_dist(x, np.stack(centers)), axis=1)
            d = np.maximum(d, 0.0)  # matmul expansion can go -eps
            if d.sum() <= 0:        # all points identical: any choice
                centers.append(x[rng.integers(0, n)])
                continue
            centers.append(x[rng.choice(n, p=d / d.sum())])
        return np.stack(centers)

    def _run_once(self, x: np.ndarray, points: torch.Tensor, seed) -> tuple:
        cosine = self.distance_function == "cosinesimilarity"
        init = torch.as_tensor(self.seed_centers(x, seed), device=self.device)
        c, a, iters, reads = lloyd(points, init, self.k,
                                   self.max_iterations, cosine)
        c, a = c.cpu().numpy(), a.cpu().numpy()
        self.iterations.append(iters)
        self.host_reads += reads + 2
        assigned = c[a]                       # O(n*d), no (n,k) matrix
        if cosine:
            num = np.sum(x * assigned, axis=1)
            den = (np.linalg.norm(x, axis=1)
                   * np.linalg.norm(assigned, axis=1))
            inertia = float(np.sum(1.0 - num / np.maximum(den, 1e-12)))
        else:
            inertia = float(np.sum((x - assigned) ** 2))
        return inertia, c, a

    def apply_to(self, points) -> ClusterSet:
        x = np.asarray(points, np.float32)
        n = x.shape[0]
        if n < self.k:
            raise ValueError(f"need at least k={self.k} points, got {n}")
        # seed=None keeps its meaning: fresh OS entropy per restart
        seeds = ([None] * self.n_init if self.seed is None
                 else [int(self.seed) + r for r in range(self.n_init)])
        self.iterations, self.host_reads = [], 0
        dev = torch.as_tensor(x, device=self.device)
        best = None
        for s in seeds:
            run = self._run_once(x, dev, s)
            if best is None or run[0] < best[0]:
                best = run
        _, c, a = best
        return ClusterSet(c, a, self.distance_fn_name())

    def distance_fn_name(self) -> str:
        return self.distance_function
