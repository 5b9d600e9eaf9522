"""The port's clustering and t-SNE (``clustering/``, ``plot/``) against the
JAX package's, on the CPU.

- the port twins of every case of ``tests/test_clustering_tsne.py``;
- the KD and VP trees answer bit for bit as the JAX package's (both are
  the same host numpy code; the VP tree's vantage picks come from
  ``np.random.default_rng(seed)``);
- k-means from the same seed: the same k-means++ centers, then the same
  assignments and centers at rtol 1e-5 (float32 sums in another order)
  after the Lloyd loop, for both metrics and ``n_init`` > 1;
- t-SNE: the exact P at rtol 1e-4 in float32 and 1e-12 in float64, each
  with an absolute floor of the same fraction of the largest entry (the
  bisection's beta moves ~5e-6 relative in float32 when one of its 50
  comparisons rounds the other way, and exp(-d * beta) scales that by
  d * beta in the smallest entries), the blocked kNN's indices equal on
  tie-free data, the tiled path's sparse P the same way;
- 10 iterations of each path from the JAX ``y0``: at the JAX defaults
  (learning rate 200, exaggeration 12) in float64 at rtol 1e-9, and
  through ``Tsne.fit`` in float32 at rtol 1e-4 of the largest coordinate
  with learning rate 10.  At learning rate 200 the float32 rounding of
  the first step (~3e-6) grows to ~1e-3 in 10 steps in both directions
  (the gains' sign test is discontinuous), while float64 holds 1e-12: the
  dynamics amplify rounding, the two packages compute the same steps.
  The tiled path runs at small N through ``tile_threshold=64,
  block_size=32``.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.clustering import KDTree as JaxKDTree
from deeplearning4j_tpu.clustering import VPTree as JaxVPTree
from deeplearning4j_tpu.clustering import kmeans as jkmeans
from deeplearning4j_tpu.plot import tsne as jtsne
from deeplearning4j_tpu_torch.clustering import (KDTree, KMeansClustering,
                                                 VPTree)
from deeplearning4j_tpu_torch.clustering import kmeans as pkmeans
from deeplearning4j_tpu_torch.plot import Tsne
from deeplearning4j_tpu_torch.plot import tsne as ptsne

CPU = "cpu"


def _blobs(k=3, per=30, d=4, spread=0.3, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 5.0
    x = np.concatenate([centers[i] + spread * rng.randn(per, d)
                        for i in range(k)])
    labels = np.repeat(np.arange(k), per)
    return x.astype(np.float32), labels, centers


def _jax_draws(shape, seed):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))


# ------------------------------------------------ twins of the JAX tests

class TestKMeans:
    def test_recovers_blobs(self):
        x, labels, _ = _blobs()
        cs = KMeansClustering.setup(3, 100, "euclidean",
                                    device=CPU).apply_to(x)
        assert cs.cluster_count() == 3
        for t in range(3):
            assert len(set(cs.assignments[labels == t].tolist())) == 1
        assert len(set(cs.assignments.tolist())) == 3

    def test_centers_near_truth(self):
        x, labels, centers = _blobs(spread=0.1, seed=3)
        cs = KMeansClustering.setup(3, 100, device=CPU).apply_to(x)
        for t in range(3):
            assert np.linalg.norm(cs.centers - centers[t], axis=1).min() \
                < 0.5

    def test_nearest_cluster(self):
        x, labels, centers = _blobs(seed=5)
        cs = KMeansClustering.setup(3, 100, device=CPU).apply_to(x)
        cl = cs.nearest_cluster(centers[0])
        assert (labels[cl.point_indices] == 0).all()

    def test_cosine_distance(self):
        rng = np.random.RandomState(2)
        a = rng.rand(20, 1) * np.array([[1.0, 0.1, 0.0]])
        b = rng.rand(20, 1) * np.array([[0.0, 0.1, 1.0]])
        x = np.concatenate([a, b]).astype(np.float32)
        cs = KMeansClustering.setup(2, 50, "cosinesimilarity",
                                    device=CPU).apply_to(x)
        assert len(set(cs.assignments[:20].tolist())) == 1
        assert len(set(cs.assignments[20:].tolist())) == 1
        assert cs.assignments[0] != cs.assignments[20]

    def test_too_few_points_raises(self):
        with pytest.raises(ValueError):
            KMeansClustering.setup(5, device=CPU).apply_to(np.zeros((3, 2)))


class TestVPTree:
    def test_knn_matches_brute_force(self):
        rng = np.random.RandomState(1)
        pts = rng.randn(200, 6).astype(np.float32)
        tree = VPTree(pts)
        for qi in (0, 17, 99):
            q = pts[qi] + 0.01
            idx, dist = tree.knn(q, k=5)
            brute = np.argsort(np.linalg.norm(pts - q, axis=1))[:5]
            np.testing.assert_array_equal(np.sort(idx), np.sort(brute))
            assert (np.diff(dist) >= -1e-6).all()

    def test_cosine_knn(self):
        pts = np.array([[1, 0], [0.9, 0.1], [0, 1], [-1, 0]], np.float32)
        idx, _ = VPTree(pts, distance="cosine").knn(np.array([1.0, 0.05]),
                                                     k=2)
        assert set(idx.tolist()) == {0, 1}

    def test_single_point(self):
        idx, _ = VPTree(np.zeros((1, 3))).knn(np.ones(3), k=1)
        assert idx.tolist() == [0]

    def test_duplicate_heavy_data_builds_and_searches(self):
        pts = np.zeros((5000, 4), np.float32)
        pts[0] = [1, 1, 1, 1]
        idx, dist = VPTree(pts).knn(np.array([1, 1, 1, 1], np.float32), k=1)
        assert idx.tolist() == [0] and dist[0] == 0.0


class TestTsne:
    def test_embedding_separates_blobs(self):
        x, labels, _ = _blobs(k=3, per=25, d=8, spread=0.2, seed=7)
        t = Tsne(n_dims=2, perplexity=10.0, max_iter=300,
                 learning_rate=100.0, seed=1, device=CPU)
        y = t.fit_transform(x)
        assert y.shape == (75, 2)
        assert np.isfinite(y).all() and np.isfinite(t.kl_divergence)

    COHESION = dict(n_dims=2, perplexity=8.0, max_iter=300,
                    learning_rate=100.0, stop_lying_iteration=100,
                    switch_momentum_iteration=100, device=CPU)

    def test_blob_cohesion(self):
        """From the JAX test's initial points (its seed's JAX draws)."""
        x, labels, _ = _blobs(k=2, per=25, d=6, spread=0.2, seed=9)
        y0 = _jax_draws((50, 2), 2) * np.float32(1e-2)
        y = Tsne(seed=2, **self.COHESION).fit_transform(x, y0)
        assert _cohesion(y, labels) < 0.5

    def test_blob_cohesion_from_the_ports_own_draws(self):
        """The cohesion depends on the initial points: over seeds 0-5 it
        reads 0.19-0.43 in the JAX package and 0.24-0.51 from the port's
        own draws (seed 2: 0.508), so the port's draws are held by the
        median of six seeds."""
        x, labels, _ = _blobs(k=2, per=25, d=6, spread=0.2, seed=9)
        runs = [_cohesion(Tsne(seed=s, **self.COHESION).fit_transform(x),
                          labels) for s in range(6)]
        assert np.median(runs) < 0.5

    def test_builder_surface(self):
        t = (Tsne.Builder().set_max_iter(123).perplexity(5.0)
             .theta(0.5).use_pca(False).learning_rate(50.0)
             .device(CPU).build())
        assert t.max_iter == 123 and t.perplexity == 5.0
        assert t.device.type == "cpu"

    def test_perplexity_guard(self):
        with pytest.raises(ValueError):
            Tsne(perplexity=30.0, device=CPU).fit(np.random.randn(10, 3))

    def test_save_coordinates(self, tmp_path):
        x, labels, _ = _blobs(k=2, per=15, d=4)
        t = Tsne(perplexity=5.0, max_iter=50, seed=0, device=CPU)
        t.fit(x)
        p = tmp_path / "coords.csv"
        t.save_coordinates(str(p), labels=labels)
        lines = p.read_text().strip().split("\n")
        assert len(lines) == 30 and lines[0].count(",") == 2


def _cohesion(y, labels):
    """Mean within-label distance over mean cross-label distance."""
    d = np.linalg.norm(y[:, None] - y[None], axis=-1)
    same = labels[:, None] == labels[None]
    off = ~np.eye(len(y), dtype=bool)
    return d[same & off].mean() / d[~same].mean()


class TestKDTree:
    def test_basic_nn(self):
        tree = KDTree(2)
        for p in ([-1.0, -1.0], [1.0, 1.0], [0.5, 0.5]):
            tree.insert(p)
        d, p = tree.nn([0.4, 0.6])
        np.testing.assert_allclose(p, [0.5, 0.5])
        assert d == pytest.approx(np.hypot(0.1, 0.1))
        assert tree.size() == 3

    def test_nn_matches_brute_force(self):
        rng = np.random.RandomState(0)
        pts = rng.randn(200, 3)
        tree = KDTree(3)
        for p in pts:
            tree.insert(p)
        for q in rng.randn(25, 3):
            d, p = tree.nn(q)
            dists = np.linalg.norm(pts - q, axis=1)
            assert d == pytest.approx(dists.min())
            np.testing.assert_allclose(p, pts[dists.argmin()])

    def test_radius_knn_sorted_and_complete(self):
        rng = np.random.RandomState(1)
        pts = rng.rand(150, 2)
        tree = KDTree(2)
        for p in pts:
            tree.insert(p)
        q, r = np.array([0.5, 0.5]), 0.25
        got = tree.knn(q, r)
        dists = sorted(d for d in np.linalg.norm(pts - q, axis=1) if d <= r)
        assert [d for d, _ in got] == pytest.approx(dists)

    def test_delete(self):
        rng = np.random.RandomState(2)
        pts = rng.randn(60, 2)
        tree = KDTree(2)
        for p in pts:
            tree.insert(p)
        drop = rng.permutation(60)[:30]
        for i in drop:
            assert tree.delete(pts[i]) is True
        assert tree.size() == 30
        assert tree.delete([123.0, 456.0]) is False
        keep = np.delete(pts, drop, axis=0)
        for q in rng.randn(15, 2):
            assert tree.nn(q)[0] == pytest.approx(
                np.linalg.norm(keep - q, axis=1).min())

    def test_dim_validation(self):
        with pytest.raises(ValueError, match="dims"):
            KDTree(3).insert([1.0, 2.0])
        with pytest.raises(ValueError, match="positive"):
            KDTree(0)

    def test_degenerate_insert_order_no_recursion_error(self):
        tree = KDTree(2)
        for i in range(3000):
            tree.insert([float(i), 0.0])
        assert tree.nn([1500.2, 0.0])[0] == pytest.approx(0.2)
        assert len(tree.knn([10.0, 0.0], 2.5)) == 5
        assert tree.delete([2999.0, 0.0]) is True and tree.size() == 2999

    def test_heavy_delete_triggers_rebuild_and_stays_correct(self):
        rng = np.random.RandomState(5)
        pts = rng.randn(300, 3)
        tree = KDTree(3)
        for p in pts:
            tree.insert(p)
        drop = rng.permutation(300)[:260]
        for i in drop:
            assert tree.delete(pts[i])
        assert tree.size() == 40
        keep = np.delete(pts, drop, axis=0)
        for q in rng.randn(20, 3):
            assert tree.nn(q)[0] == pytest.approx(
                np.linalg.norm(keep - q, axis=1).min())
        assert tree.knn(pts[drop[0]], 1e-9) == []


class TestTsneTiled:
    def test_tiled_path_separates_blobs(self):
        x, labels, _ = _blobs(k=3, per=40, d=8, spread=0.2, seed=5)
        t = Tsne(n_dims=2, perplexity=10.0, max_iter=250,
                 learning_rate=100.0, seed=1, tile_threshold=32,
                 block_size=48, device=CPU)           # 120 points, pad 144
        y = t.fit_transform(x)
        assert y.shape == (120, 2) and np.isfinite(y).all()
        assert np.isfinite(t.kl_divergence)
        assert _cohesion(y, labels) < 0.5

    def test_large_n_completes_memory_bounded(self):
        n = 12000
        x = np.random.RandomState(0).randn(n, 16).astype(np.float32)
        t = Tsne(n_dims=2, perplexity=30.0, max_iter=3,
                 learning_rate=100.0, seed=0, block_size=256, device=CPU)
        y = t.fit_transform(x)
        assert y.shape == (n, 2) and np.isfinite(y).all()


def test_kmeans_n_init_restarts_escape_local_optima():
    rng = np.random.RandomState(0)
    centers = np.array([[0, 0], [5, 5], [0, 5]])
    x = np.concatenate([c + rng.randn(100, 2) * 0.5
                        for c in centers]).astype(np.float32)
    true = np.repeat([0, 1, 2], 100)
    for seed in range(4):
        a = KMeansClustering.setup(3, 50, "euclidean", seed=seed, n_init=4,
                                   device=CPU).apply_to(x).assignments
        for cl in range(3):
            members = true[a == cl]
            assert members.size > 0 and len(set(members)) == 1


# ------------------------------------------------------ paired with JAX

def _kd_pair(pts):
    trees = JaxKDTree(pts.shape[1]), KDTree(pts.shape[1])
    for p in pts:
        for t in trees:
            t.insert(p)
    return trees


def test_kdtree_answers_bitwise_jax():
    rng = np.random.RandomState(3)
    pts = rng.randn(300, 3)
    jt, pt = _kd_pair(pts)
    for i in rng.permutation(300)[:200]:        # past the rebuild point
        assert jt.delete(pts[i]) == pt.delete(pts[i])
    assert jt.size() == pt.size()
    for q in rng.randn(30, 3):
        (jd, jp), (pd, pp) = jt.nn(q), pt.nn(q)
        assert jd == pd and np.array_equal(jp, pp)
        jk, pk = jt.knn(q, 0.8), pt.knn(q, 0.8)
        assert [d for d, _ in jk] == [d for d, _ in pk]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(jk, pk))


def _vp_nodes(node):
    out, stack = [], [node]
    while stack:
        n = stack.pop()
        if n is None:
            continue
        out.append((n.index, n.threshold))
        stack += [n.inside, n.outside]
    return out


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_vptree_builds_and_answers_bitwise_jax(distance):
    rng = np.random.RandomState(4)
    pts = rng.randn(400, 8).astype(np.float32)
    jt, pt = (JaxVPTree(pts, distance, seed=11),
              VPTree(pts, distance, seed=11))
    assert _vp_nodes(jt.root) == _vp_nodes(pt.root)
    for q in rng.randn(20, 8).astype(np.float32):
        (ji, jd), (pi, pd) = jt.knn(q, k=7), pt.knn(q, k=7)
        assert np.array_equal(ji, pi) and np.array_equal(jd, pd)


@pytest.mark.parametrize("metric", ["euclidean", "cosinesimilarity"])
@pytest.mark.parametrize("n_init", [1, 3])
def test_kmeans_matches_jax(metric, n_init):
    x, _, _ = _blobs(k=4, per=40, d=6, spread=0.8, seed=2)
    jcs = jkmeans.KMeansClustering.setup(4, 100, metric, seed=5,
                                         n_init=n_init).apply_to(x)
    km = KMeansClustering.setup(4, 100, metric, seed=5, n_init=n_init,
                                device=CPU)
    np.testing.assert_array_equal(km.seed_centers(x, 5),
                                  _jax_seed_centers(x, 4, metric, 5))
    pcs = km.apply_to(x)
    np.testing.assert_array_equal(pcs.assignments, jcs.assignments)
    np.testing.assert_allclose(pcs.centers, jcs.centers, rtol=1e-5,
                               atol=1e-6)
    assert len(km.iterations) == n_init
    assert km.host_reads == sum(km.iterations) + 2 * n_init
    assert pcs.assignments.dtype == np.int32


def _jax_seed_centers(x, k, metric, seed):
    """The JAX package's k-means++ seeding, read off its Lloyd call."""
    seen = {}
    real = jkmeans._lloyd

    def spy(points, init, *args):
        seen["init"] = np.asarray(init)
        return real(points, init, *args)

    jkmeans._lloyd = spy
    try:
        jkmeans.KMeansClustering(k, 1, metric, seed)._run_once(x, seed)
    finally:
        jkmeans._lloyd = real
    return seen["init"]


def test_kmeans_stops_at_max_iter_and_keeps_empty_clusters():
    """An empty cluster keeps its center, as in the JAX loop, and the loop
    stops at ``max_iter``."""
    x = np.array([[0, 0], [0.1, 0], [5, 5], [5.1, 5]], np.float32)
    init = torch.tensor([[0.0, 0.0], [5.0, 5.0], [100.0, 100.0]])
    c, a, iters, reads = pkmeans.lloyd(torch.as_tensor(x), init, 3, 1,
                                       False)
    jc, ja, jiters = jkmeans._lloyd(jnp.asarray(x), jnp.asarray(init), 3, 1,
                                    False)
    assert iters == reads == int(jiters) == 1
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert c[2].tolist() == [100.0, 100.0]


def test_kmeans_restores_the_matmul_precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        x, _, _ = _blobs()
        KMeansClustering.setup(3, device=CPU).apply_to(x)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


def _jax_exact_p(x, perplexity):
    """The P of the JAX ``_tsne_run`` (its first six lines)."""
    n = x.shape[0]
    eye_mask = 1.0 - jnp.eye(n, dtype=x.dtype)
    d = jnp.where(eye_mask > 0, jtsne._sq_dists(x), jnp.inf)
    beta = jtsne._perplexity_search(d, jnp.log(perplexity))
    p = jnp.exp(-jnp.where(eye_mask > 0, d, 0.0) * beta[:, None]) * eye_mask
    p = p / jnp.maximum(p.sum(1, keepdims=True), 1e-12)
    return np.asarray(jnp.maximum((p + p.T) / (2.0 * n), 1e-12))


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-4),
                                        (np.float64, 1e-12)])
def test_tsne_exact_p_matches_jax(dtype, rtol):
    x, _, _ = _blobs(k=3, per=30, d=8, spread=0.5, seed=1)
    x = x.astype(dtype)
    want = _jax_exact_p(jnp.asarray(x), jnp.asarray(10.0, dtype))
    got = ptsne.exact_affinities(torch.as_tensor(x), 10.0).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * want.max())


def _tie_free(n=200, d=6, seed=0):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def test_tsne_knn_matches_jax():
    """``knn`` in (block, N) tiles: the JAX indices on tie-free data, with
    padding rows masked out of every neighbour list."""
    x = np.concatenate([_tie_free(), np.zeros((24, 6), np.float32)])
    mask = np.concatenate([np.ones(200), np.zeros(24)]).astype(np.float32)
    jd, ji = jtsne._knn(jnp.asarray(x), jnp.asarray(mask), 15, 32)
    pd, pi = ptsne.knn(torch.as_tensor(x), torch.as_tensor(mask), 15, 32)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    assert pi[:200].max() < 200


def test_tsne_tiled_sparse_p_matches_jax():
    x = _tie_free(160, 6, 2)
    mask = np.ones(160, np.float32)
    src, dst, pval = ptsne.tiled_affinities(
        torch.as_tensor(x), torch.as_tensor(mask), 160, 10.0, 30, 32)
    jd, ji = jtsne._knn(jnp.asarray(x), jnp.asarray(mask), 30, 32)
    beta = jtsne._perplexity_search(jd, jnp.log(jnp.float32(10.0)))
    p = jnp.exp(-jd * beta[:, None])
    p = p / jnp.maximum(p.sum(1, keepdims=True), 1e-12)
    np.testing.assert_array_equal(dst.numpy(), np.asarray(ji).reshape(-1))
    np.testing.assert_array_equal(src.numpy(), np.repeat(np.arange(160), 30))
    np.testing.assert_allclose(pval.numpy(),
                               np.asarray(p).reshape(-1) / (2.0 * 160),
                               rtol=1e-4, atol=0)


def _jax_f64_runs(x, y0, iters, tiled):
    key = jax.random.PRNGKey(0)
    hyper = (jnp.float64(10.0), iters, jnp.float64(200.0), jnp.int32(250),
             jnp.int32(250), jnp.float64(12.0))
    if tiled:
        n = x.shape[0]
        return jtsne._tsne_run_tiled(
            jnp.asarray(x), jnp.ones(n), key, 2, jnp.float64(n), *hyper,
            30, 32)
    return jtsne._tsne_run(jnp.asarray(x), key, 2, *hyper)


@pytest.mark.parametrize("tiled", [False, True], ids=["exact", "tiled"])
def test_tsne_ten_iterations_match_jax_in_float64(tiled):
    """The JAX defaults (learning rate 200, exaggeration 12) in float64:
    the same 10 steps from the JAX ``y0`` (the JAX program draws it from
    the same key)."""
    x = _blobs(k=4, per=40, d=8, spread=1.0, seed=0)[0].astype(np.float64)
    x = (x - x.mean(0)) / x.std(0)
    y0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (160, 2),
                                      jnp.float64)) * 1e-2
    jy, jkl = _jax_f64_runs(x, y0, 10, tiled)
    hyper = dict(perplexity=10.0, max_iter=10, learning_rate=200.0,
                 switch_momentum=250, stop_lying_iteration=250,
                 exaggeration=12.0)
    xt, y0t = torch.as_tensor(x), torch.as_tensor(y0)
    if tiled:
        py, pkl = ptsne.tsne_tiled(xt, torch.ones(160, dtype=torch.float64),
                                   160, y0t, k=30, block=32, **hyper)
    else:
        py, pkl = ptsne.tsne_exact(xt, y0t, **hyper)
    jy = np.asarray(jy)
    np.testing.assert_allclose(py.numpy(), jy, rtol=0,
                               atol=1e-9 * np.abs(jy).max())
    assert float(pkl) == pytest.approx(float(jkl), rel=1e-9)


@pytest.mark.parametrize("tiled", [False, True], ids=["exact", "tiled"])
def test_tsne_fit_ten_iterations_match_jax(tiled):
    """``Tsne.fit`` in float32 from the JAX draws (``y0``), 10
    iterations with the momentum switch and the end of the exaggeration
    inside them; the tiled run pads 150 points to 160."""
    x = _blobs(k=3, per=50, d=8, spread=1.0, seed=6)[0]
    kw = dict(perplexity=10.0, max_iter=10, learning_rate=10.0, seed=3,
              switch_momentum_iteration=4, stop_lying_iteration=6)
    if tiled:
        kw.update(tile_threshold=64, block_size=32)
    want = jtsne.Tsne(**kw).fit(x)
    rows = 160 if tiled else 150          # the JAX draw's rows (padded)
    t = Tsne(device=CPU, **kw)
    t.fit(x, y0=_jax_draws((rows, 2), 3)[:150] * np.float32(1e-2))
    scale = np.abs(want.coords).max()
    np.testing.assert_allclose(t.coords, want.coords, rtol=0,
                               atol=1e-4 * scale)
    assert t.kl_divergence == pytest.approx(want.kl_divergence, rel=1e-4)
    assert t.host_reads == 2 and set(t.phase_ms) == {"affinities",
                                                     "iterations"}


def test_tsne_initial_coordinates():
    """``y0`` stands in for the draws; the default draws come from a CPU
    generator seeded by ``seed``, the same for every run and device."""
    x = _blobs(k=2, per=20, d=4)[0]
    a = Tsne(perplexity=5.0, max_iter=5, seed=9, device=CPU).fit(x).coords
    b = Tsne(perplexity=5.0, max_iter=5, seed=9, device=CPU).fit(x).coords
    np.testing.assert_array_equal(a, b)
    y0 = ptsne.host_draws((40, 2), 9) * np.float32(1e-2)
    c = Tsne(perplexity=5.0, max_iter=5, seed=0, device=CPU).fit(
        x, y0=y0).coords
    np.testing.assert_array_equal(a, c)


def test_tsne_coordinates_reach_the_ui():
    """The port's coordinates published through ``UIServer.set_tsne_data``
    come back from ``GET /tsne/data``."""
    from deeplearning4j_tpu_torch.ui.server import UIServer
    x, labels, _ = _blobs(k=2, per=15, d=4)
    coords = Tsne(perplexity=5.0, max_iter=20, seed=0,
                  device=CPU).fit_transform(x)
    srv = UIServer(port=0).start()
    try:
        srv.set_tsne_data(coords, labels)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/tsne/data", timeout=5) as r:
            body = json.loads(r.read())
    finally:
        srv.stop()
    np.testing.assert_array_equal(np.asarray(body["coords"]),
                                  coords.astype(float))
    assert body["labels"] == [str(l) for l in labels]
