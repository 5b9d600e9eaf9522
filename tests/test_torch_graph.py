"""The port's graph tier (``deeplearning4j_tpu_torch/graph``) against the
JAX package's (``deeplearning4j_tpu/graph``), on the CPU.

- ``Graph.csr()`` and ``alias_tables()``, ``generate_walks`` and the walk
  iterators, in every ``NoEdgeHandling`` mode, uniform and weighted:
  bitwise (host numpy in both, the same ``default_rng`` stream);
- ``GraphHuffman`` codes and points, and ``DeepWalk.initialize``'s tables
  (``default_rng(seed)``): bitwise;
- the host-walk ``fit`` (``DL4J_TPU_DEVICE_WALKS=0``, and ``fit(iterator=
  ...)``): a few epochs from the same tables, syn0/syn1 at rtol 1e-5 and
  the summed loss at rtol 1e-5;
- one device-walk epoch fed the JAX package's threefry draws through
  ``DeepWalk.draw_source`` (:func:`jax_walk_draws` recomputes them from
  the keys of ``_fit_device_walks`` and ``_walk_epoch_fn``): the walks and
  the pair grid bitwise, the tables at rtol 1e-5;
- ``vertices_nearest`` and ``similarity`` on the same tables, and the text
  serializer's files byte-identical both ways.

Tolerance fp32, rtol 1e-5, atol 1e-6 element by element: the einsums sum
in another order than XLA's dot and the sigmoid differs in the last bit;
over the ~100 sequential chunk updates of these fits the largest gap seen
is 3.3e-7 absolute.  The loss is one float32 sum over the chunks in both
packages, in the same order, but of per-chunk losses that differ in the
last bits, so it is held at rtol 1e-5 too.

The device-walk epoch of the JAX package runs under
``jax.enable_x64(False)``, its configuration outside this test suite
(``tests/conftest.py`` turns x64 on, which would make its uniforms and
the walk step's product float64; the port's, like the JAX package's on
its accelerator, are float32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.graph import api as japi
from deeplearning4j_tpu.graph import deepwalk as jdw
from deeplearning4j_tpu.graph import graph as jg
from deeplearning4j_tpu.graph import iterators as jit_
from deeplearning4j_tpu_torch.graph import api as papi
from deeplearning4j_tpu_torch.graph import deepwalk as pdw
from deeplearning4j_tpu_torch.graph import graph as pg
from deeplearning4j_tpu_torch.graph import iterators as pit
from deeplearning4j_tpu_torch.nlp.jax_tables import load_jax_graph_tables

RTOL, ATOL = 1e-5, 1e-6
SIDES = {"jax": (japi, jg, jit_, jdw), "port": (papi, pg, pit, pdw)}


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def random_graph(g_mod, n=60, e=300, seed=0, weighted=False,
                 directed=False, isolated=0):
    """``bench_deepwalk``'s construction at a small size: ``e`` random
    endpoint pairs from ``RandomState(seed)``, self-pairs dropped; the
    last ``isolated`` vertices get no edge."""
    rng = np.random.RandomState(seed)
    g = g_mod.Graph(n)
    m = n - isolated
    a, b = rng.randint(0, m, e), rng.randint(0, m, e)
    w = rng.rand(e) * 3.0
    for i in range(e):
        if a[i] != b[i]:
            g.add_edge(int(a[i]), int(b[i]),
                       float(w[i]) if weighted else 1.0, directed)
    return g


def community_graph(g_mod, sizes=(10, 10)):
    """Dense cliques joined by one bridge edge
    (``tests/test_graph.py::_community_graph``)."""
    g = g_mod.Graph(sum(sizes))
    start, anchors = 0, []
    for sz in sizes:
        for i in range(start, start + sz):
            for j in range(i + 1, start + sz):
                g.add_edge(i, j)
        anchors.append(start)
        start += sz
    for a, b in zip(anchors[:-1], anchors[1:]):
        g.add_edge(a, b)
    return g


GRAPHS = {
    "undirected": dict(),
    "weighted directed": dict(weighted=True, directed=True),
    "weighted with isolated": dict(weighted=True, isolated=5),
}


def pair(**kw):
    return random_graph(jg, **kw), random_graph(pg, **kw)


# --------------------------------------------------------- CSR and walks
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_csr_and_alias_tables_equal_jax(case):
    gj, gp = pair(**GRAPHS[case])
    for a, b in zip(gj.csr(), gp.csr()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(gj.alias_tables(), gp.alias_tables()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(gj.degrees(), gp.degrees())
    assert np.array_equal(gj.neighbors(3), gp.neighbors(3))


MODES = ["SELF_LOOP_ON_DISCONNECTED", "EXCEPTION_ON_DISCONNECTED"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_generate_walks_bitwise(case, mode, weighted):
    gj, gp = pair(**GRAPHS[case])
    out = {}
    for side, g in (("jax", gj), ("port", gp)):
        api, _, it, _ = SIDES[side]
        rng = np.random.default_rng(11)
        starts = rng.permutation(g.num_vertices())
        try:
            out[side] = it.generate_walks(
                g, 12, rng, start_vertices=starts, weighted=weighted,
                no_edge=getattr(api.NoEdgeHandling, mode))
        except Exception as exc:                        # noqa: BLE001
            out[side] = (type(exc).__name__, str(exc))
    if isinstance(out["jax"], tuple):
        assert out["port"] == out["jax"]
        assert out["jax"][0] == "NoEdgesException"
    else:
        assert out["port"].dtype == out["jax"].dtype
        assert np.array_equal(out["port"], out["jax"])


def test_walks_on_an_edgeless_graph_stay_in_place():
    walks = [SIDES[s][2].generate_walks(
        SIDES[s][1].Graph(4), 5, np.random.default_rng(0),
        no_edge=SIDES[s][0].NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED)
        for s in ("jax", "port")]
    assert np.array_equal(walks[0], walks[1])
    assert (walks[1] == np.arange(4)[:, None]).all()


@pytest.mark.parametrize("cls", ["RandomWalkIterator",
                                 "WeightedRandomWalkIterator"])
def test_walk_iterators_bitwise(cls):
    gj, gp = pair(weighted=True)
    seqs = {}
    for side, g in (("jax", gj), ("port", gp)):
        api, _, it, _ = SIDES[side]
        walker = getattr(it, cls)(
            g, 7, rng_seed=4, mode=api.NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
            first_vertex=5, last_vertex=50)
        first = [list(s.indices) for s in walker]
        assert walker.walk_length() == 7 and not walker.has_next()
        walker.reset()
        head = walker.next()
        rest = walker.walks_array()
        walker.reset()
        seqs[side] = (first, list(head.indices),
                      [v.idx for v in head], rest, walker.walks_array())
    j, p = seqs["jax"], seqs["port"]
    assert p[0] == j[0] and p[1] == j[1] and p[2] == j[2]
    assert np.array_equal(p[3], j[3]) and np.array_equal(p[4], j[4])


@pytest.mark.parametrize("weighted", [False, True])
def test_iterator_provider_bitwise(weighted):
    gj, gp = pair(weighted=True, isolated=3)
    walks = {}
    for side, g in (("jax", gj), ("port", gp)):
        it = SIDES[side][2]
        prov = it.RandomWalkGraphIteratorProvider(g, 6, seed=9,
                                                  weighted=weighted)
        walks[side] = [w.walks_array() for w in
                       prov.get_graph_walk_iterators(4)]
    assert len(walks["port"]) == len(walks["jax"]) == 4
    for a, b in zip(walks["jax"], walks["port"]):
        assert np.array_equal(a, b)


def test_loaders_equal_jax(tmp_path):
    edges = tmp_path / "e.csv"
    edges.write_text("# comment\n0,1\n1,2\n\n2,3\n3,0\n")
    wedges = tmp_path / "w.tsv"
    wedges.write_text("0\t1\t0.5\n1\t2\t2.0\n2\t0\t1.5\n")
    verts = tmp_path / "v.txt"
    verts.write_text("a\nb\nc\nd\n")
    for load in (lambda G: G.load_undirected_graph_edge_list(str(edges), 4),
                 lambda G: G.load_weighted_edge_list(str(wedges), 3, "\t",
                                                     directed=True),
                 lambda G: G.load_graph(str(edges), str(verts))):
        a, b = load(jg.GraphLoader), load(pg.GraphLoader)
        assert [tuple(e.__dict__.values()) for e in a.get_edges()] == \
            [tuple(e.__dict__.values()) for e in b.get_edges()]
        for x, y in zip(a.csr(), b.csr()):
            assert np.array_equal(x, y)
        assert [v.value for v in (a.get_vertex(i) for i in range(3))] == \
            [v.value for v in (b.get_vertex(i) for i in range(3))]
    bad = tmp_path / "bad.csv"
    bad.write_text("0\n")
    with pytest.raises(ValueError, match="bad.csv:1"):
        pg.GraphLoader.load_undirected_graph_edge_list(str(bad), 2)


# ------------------------------------------------------- Huffman, tables
def test_graph_huffman_equals_jax():
    gj, gp = pair(n=200, e=900)
    hj = jdw.GraphHuffman(gj.degrees().tolist())
    hp = pdw.GraphHuffman(gp.degrees().tolist())
    assert hp.num_inner == hj.num_inner
    for v in range(200):
        assert hp.get_code(v) == hj.get_code(v)
        assert hp.get_path_inner_nodes(v) == hj.get_path_inner_nodes(v)
    with pytest.raises(ValueError):
        pdw.GraphHuffman([3])


def models(vector_size=16, window=2, lr=0.05, seed=3, batch=256, g_kw=None):
    gj, gp = pair(**(g_kw or {}))
    j = jdw.DeepWalk(vector_size, window, lr, seed, batch)
    p = pdw.DeepWalk(vector_size, window, lr, seed, batch, device="cpu")
    j.initialize(gj)
    p.initialize(gp)
    return gj, gp, j, p


def test_initialize_tables_bitwise():
    _, _, j, p = models()
    assert np.array_equal(p.syn0.numpy(), np.asarray(j.syn0))
    assert np.array_equal(p.syn1.numpy(), np.asarray(j.syn1))
    for name in ("_points", "_codes", "_code_mask"):
        a, b = getattr(j, name), getattr(p, name)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert p._points_dev.dtype == torch.int32
    _, _, j2, p2 = models()
    p2.initialize([3, 1, 4, 1, 5, 9, 2, 6])
    j2.initialize([3, 1, 4, 1, 5, 9, 2, 6])
    assert np.array_equal(p2.syn0.numpy(), np.asarray(j2.syn0))


def test_load_jax_graph_tables_checks_shapes():
    _, _, j, p = models()
    rng = np.random.RandomState(0)
    s0 = rng.randn(*np.asarray(j.syn0).shape).astype(np.float32)
    s1 = rng.randn(*np.asarray(j.syn1).shape).astype(np.float32)
    load_jax_graph_tables(p, s0, s1)
    assert np.array_equal(p.syn0.numpy(), s0)
    assert np.array_equal(p.syn1.numpy(), s1)
    with pytest.raises(ValueError, match="syn1"):
        load_jax_graph_tables(p, s0, s1[1:])
    with pytest.raises(ValueError, match="initialize"):
        load_jax_graph_tables(pdw.DeepWalk(device="cpu"), s0, s1)


# -------------------------------------------------------- host-walk fit
@pytest.mark.parametrize("window,batch", [(2, 256), (3, 2048)])
def test_host_walk_fit_matches_jax(monkeypatch, window, batch):
    monkeypatch.setenv("DL4J_TPU_DEVICE_WALKS", "0")
    gj, gp, j, p = models(window=window, batch=batch)
    j.fit(gj, walk_length=10, epochs=3)
    p.fit(gp, walk_length=10, epochs=3)
    _close(p.syn0, j.syn0)
    _close(p.syn1, j.syn1)
    np.testing.assert_allclose(p._cum_loss, j._cum_loss, rtol=RTOL)
    assert p._walk_stats["route"] == "host"
    # the 2x-vertices clamp: 60 vertices -> chunks of 120 pairs
    assert p._walk_stats["batch"] == min(batch, 120)


def test_walk_pairs_bitwise():
    _, _, j, p = models(window=3)
    walks = np.random.RandomState(2).randint(0, 60, (9, 11))
    for a, b in zip(j._walk_pairs(walks), p._walk_pairs(walks)):
        assert np.array_equal(a, b)
    assert p._walk_pairs(walks[:, :6])[0].size == 0


def test_fit_through_an_iterator_matches_jax():
    gj, gp, j, p = models(g_kw=dict(weighted=True))
    itj = jit_.WeightedRandomWalkIterator(
        gj, 8, rng_seed=5, mode=japi.NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED)
    itp = pit.WeightedRandomWalkIterator(
        gp, 8, rng_seed=5, mode=papi.NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED)
    j.fit(iterator=itj, epochs=2)
    p.fit(iterator=itp, epochs=2)
    _close(p.syn0, j.syn0)
    _close(p.syn1, j.syn1)
    np.testing.assert_allclose(p._cum_loss, j._cum_loss, rtol=RTOL)


# ------------------------------------------------------ device-walk fit
def jax_walk_draws(seed):
    """The JAX package's draws of device-walk pass ``walk_pass``: the key
    ``fold_in(PRNGKey(seed), pass)`` of ``_fit_device_walks`` split as
    ``_walk_epoch_fn`` splits it (permutation key, then one key a step)."""
    def source(n, walk_length, walk_pass):
        with jax.enable_x64(False):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), walk_pass)
            kperm, kwalk = jax.random.split(key)
            starts = jax.random.permutation(kperm, n).astype(jnp.int32)
            u = jnp.stack([jax.random.uniform(k, (n,))
                           for k in jax.random.split(kwalk, walk_length)])
        return np.array(starts), np.array(u)
    return source


def jax_walks(g, starts, u):
    """The JAX package's walk step (``_walk_epoch_fn`` ``wstep``) over
    ``g``'s CSR, float32 as outside the test suite."""
    indptr, indices, _ = g.csr()
    indptr = jnp.asarray(indptr.astype(np.int32))
    indices = jnp.asarray(indices.astype(np.int32))
    n_edges = int(indices.shape[0])
    with jax.enable_x64(False):
        cur = jnp.asarray(starts)
        rows = [cur]
        for s in range(u.shape[0]):
            deg = indptr[cur + 1] - indptr[cur]
            k = jnp.minimum((jnp.asarray(u[s]) * deg.astype(jnp.float32))
                            .astype(jnp.int32), jnp.maximum(deg - 1, 0))
            pos = jnp.minimum(indptr[cur] + k, n_edges - 1)
            cur = jnp.where(deg == 0, cur, indices[pos])
            rows.append(cur)
        return np.asarray(jnp.stack(rows, axis=1))


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_device_walks_and_pair_grid_bitwise(case):
    gj, gp = pair(**GRAPHS[case])
    starts, u = jax_walk_draws(21)(gp.num_vertices(), 15, 3)
    indptr, indices, _ = gp.csr()
    walks = pdw.device_walks(torch.from_numpy(indptr.astype(np.int32)),
                             torch.from_numpy(indices.astype(np.int32)),
                             torch.from_numpy(starts), torch.from_numpy(u))
    assert walks.dtype == torch.int32
    assert np.array_equal(walks.numpy(), jax_walks(gj, starts, u))
    p = pdw.DeepWalk(window_size=3, device="cpu")
    ins, tgts = p._walk_pairs(walks.numpy().astype(np.int64))
    B = 128
    gi, gt, gm = pdw.walk_pair_grid(walks, 3, B)
    n = ins.size
    assert gi.shape == (-(-n // B), B) and gm.sum().item() == n
    assert np.array_equal(gi.reshape(-1)[:n].numpy(), ins)
    assert np.array_equal(gt.reshape(-1)[:n].numpy(), tgts)
    assert (gi.reshape(-1)[n:] == 0).all() and (gm.reshape(-1)[n:] == 0).all()


@pytest.mark.parametrize("window,epochs", [(2, 1), (3, 2)])
def test_device_walk_epochs_match_jax(window, epochs):
    gj, gp, j, p = models(window=window, g_kw=dict(isolated=4))
    p.draw_source = jax_walk_draws(3)
    with jax.enable_x64(False):
        j.fit(gj, walk_length=12, epochs=epochs)
    p.fit(gp, walk_length=12, epochs=epochs)
    assert p._walk_stats["route"] == "device"
    assert p._walk_passes == j._walk_passes == epochs
    _close(p.syn0, j.syn0)
    _close(p.syn1, j.syn1)
    np.testing.assert_allclose(p._cum_loss, j._cum_loss, rtol=RTOL)


def test_device_walks_follow_the_seed_and_the_pass():
    def fit(seed):
        g = random_graph(pg)
        p = pdw.DeepWalk(vector_size=8, seed=seed, device="cpu")
        p.fit(g, walk_length=6, epochs=2)
        return p.syn0.numpy()
    assert np.array_equal(fit(5), fit(5))
    assert not np.array_equal(fit(5), fit(6))
    assert pdw.pass_seed(5, 0) != pdw.pass_seed(5, 1)


def test_bad_draws_are_refused():
    g = random_graph(pg)
    p = pdw.DeepWalk(vector_size=8, device="cpu")
    p.draw_source = lambda n, L, k: (np.arange(n), np.zeros((L + 1, n)))
    with pytest.raises(ValueError, match="draw_source"):
        p.fit(g, walk_length=6)


def test_device_walks_need_edges_and_a_window():
    p = pdw.DeepWalk(window_size=3, device="cpu")
    p.initialize(random_graph(pg))
    assert p._device_walk_eligible(6)
    assert not p._device_walk_eligible(5)
    p.graph = pg.Graph(5)
    assert not p._device_walk_eligible(10)


# ------------------------------------------- similarity and serializer
def fitted_pair():
    gj, gp, j, p = models(g_kw=dict(n=40, e=200))
    j.fit(gj, walk_length=8, epochs=1)
    load_jax_graph_tables(p, np.asarray(j.syn0), np.asarray(j.syn1))
    return j, p


def test_nearest_and_similarity_equal_jax():
    j, p = fitted_pair()
    for v in (0, 7, 33):
        assert np.array_equal(p.vertices_nearest(v, 5),
                              j.vertices_nearest(v, 5))
        for w in (1, 20):
            assert p.similarity(v, w) == j.similarity(v, w)
    assert p.get_vertex_vector(3).tolist() == \
        j.get_vertex_vector(3).tolist()
    assert p.num_vertices() == 40 and p.vector_size == 16


def test_serializer_files_byte_identical_both_ways(tmp_path):
    j, p = fitted_pair()
    fj, fp = tmp_path / "jax.txt", tmp_path / "port.txt"
    jdw.write_graph_vectors(j, str(fj))
    pdw.write_graph_vectors(p, str(fp))
    assert fj.read_bytes() == fp.read_bytes()
    back_p = pdw.load_txt_vectors(str(fj))
    back_j = jdw.load_txt_vectors(str(fp))
    assert np.array_equal(back_p.vertex_vectors(), back_j.vertex_vectors())
    assert np.array_equal(back_p.vertex_vectors(), p.vertex_vectors())
    fj2, fp2 = tmp_path / "jax2.txt", tmp_path / "port2.txt"
    jdw.write_graph_vectors(back_j, str(fj2))
    pdw.write_graph_vectors(back_p, str(fp2))
    assert fj2.read_bytes() == fp2.read_bytes() == fj.read_bytes()
    (tmp_path / "empty.txt").write_text("\n")
    with pytest.raises(ValueError, match="no vectors"):
        pdw.load_txt_vectors(str(tmp_path / "empty.txt"))


# ------------------------------------------------- behaviour on the CPU
def test_fit_learns_communities_on_the_cpu():
    """``tests/test_graph.py::TestDeepWalk::test_fit_learns_communities``
    through the port's Builder and device-walk route."""
    g = community_graph(pg)
    dw = (pdw.DeepWalk.Builder().vector_size(16).window_size(2)
          .learning_rate(0.05).seed(12345).device("cpu").build())
    dw.initialize(g)
    dw.fit(g, walk_length=10, epochs=12)
    hits = 0
    for probe in (2, 3, 13, 14):
        community = set(range(10)) if probe < 10 else set(range(10, 20))
        hits += sum(1 for v in dw.vertices_nearest(probe, 5)
                    if int(v) in community)
    assert hits >= 14
    in_comm = np.mean([dw.similarity(2, v) for v in range(3, 10)])
    cross = np.mean([dw.similarity(2, v) for v in range(11, 20)])
    assert in_comm > cross


def test_tiny_graph_stays_stable_over_many_epochs():
    """``tests/test_graph.py::test_deepwalk_stable_on_tiny_graph_many_
    epochs`` on the port: the 2x-vertices chunk clamp keeps a 20-vertex
    graph at batch 2048 finite over 20 fits."""
    rng = np.random.RandomState(3)
    g = pg.Graph(20)
    for c in (0, 10):
        for i in range(10):
            for j in range(i + 1, 10):
                if rng.rand() < 0.7:
                    g.add_edge(c + i, c + j)
    g.add_edge(0, 10)
    dw = (pdw.DeepWalk.Builder().vector_size(16).window_size(3)
          .learning_rate(0.05).seed(1).device("cpu").build())
    dw.initialize(g)
    for _ in range(20):
        dw.fit(g, walk_length=30)
    s0 = dw.syn0.numpy()
    assert np.isfinite(s0).all() and np.abs(s0).max() < 50.0
    assert dw._walk_stats["batch"] == 64


def test_unfit_model_raises_and_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="not initialized"):
        pdw.DeepWalk(device="cpu").fit()
    with pytest.raises(RuntimeError, match="not initialized"):
        pdw.DeepWalk(device="cpu").vertex_vectors()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pdw.DeepWalk()
        with pytest.raises(RuntimeError, match="CUDA"):
            pdw.DeepWalk.Builder().build()


@pytest.mark.parametrize("route", ["device", "host"])
def test_zero_epochs_leave_the_model_as_jax_does(monkeypatch, route):
    """``fit(graph, epochs=0)`` trains nothing on either route, as in the
    JAX package: the tables, the pass count, the summed loss and the walk
    statistics stay as ``initialize`` left them."""
    monkeypatch.setenv("DL4J_TPU_DEVICE_WALKS",
                       "1" if route == "device" else "0")
    gj, gp, j, p = models()
    s0, s1 = p.syn0.clone(), p.syn1.clone()
    with jax.enable_x64(False):
        j.fit(gj, walk_length=10, epochs=0)
    p.fit(gp, walk_length=10, epochs=0)
    assert torch.equal(p.syn0, s0) and torch.equal(p.syn1, s1)
    assert np.array_equal(p.syn0.numpy(), np.asarray(j.syn0))
    assert np.array_equal(p.syn1.numpy(), np.asarray(j.syn1))
    assert p._walk_passes == j._walk_passes == 0
    assert p._cum_loss == j._cum_loss == 0.0
    assert p._walk_stats == {}
