"""The port's fused ingest (``nn/ingest.py``, the cache, window and
``fit_scan`` paths of ``multilayer._Network``) against the JAX package's.

- ``cacheable_source`` gives the JAX verdict on the same iterators;
- the uint8 wire: ``device_decode`` and ``MnistDataSetIterator``'s twin
  are bit-equal to the JAX package's in f32 and bf16, and the wire and
  float32 staging train bit-identically;
- with ``shuffle=False`` and the JAX weights loaded, the port's cache,
  window and ``fit_scan`` paths equal the JAX package's same paths after
  2 epochs with a tail batch, for sgd and adam, in both containers, at
  the JAX ingest test's tolerance (rtol 2e-5, atol 1e-7: f32 sums in
  another order);
- with ``shuffle=True`` the cache path equals the per-batch path replayed
  in ``ingest.epoch_permutation``'s order (the documented difference in
  the permutation stream), bitwise, and is deterministic per seed;
- consecutive epochs fuse into one dispatch without listeners, and the
  fused run equals per-epoch dispatches; listener replay gives the JAX
  package's per-iteration scores.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import attach_wire as jax_attach
from deeplearning4j_tpu.datasets.iterators import (
    AsyncDataSetIterator as JaxAsync, ExistingDataSetIterator as JaxExisting,
    ListDataSetIterator as JaxList)
from deeplearning4j_tpu.datasets.mnist import \
    MnistDataSetIterator as JaxMnist
from deeplearning4j_tpu.datasets.normalizers import (
    ImagePreProcessingScaler as JaxScaler, U8_PIXEL as JAX_U8_PIXEL)
from deeplearning4j_tpu.nn import ingest as jingest
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets import dataset as pdataset
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator, ExistingDataSetIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
from deeplearning4j_tpu_torch.datasets.normalizers import (
    U8_PIXEL, ImagePreProcessingScaler, WireFormat)
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.nn import ingest
from deeplearning4j_tpu_torch.nn import multilayer as pml
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

RTOL, ATOL = 2e-5, 1e-7


def _arrays(n=70, n_in=6, n_classes=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, n_in).astype(np.float32)
    y = np.eye(n_classes, dtype=np.float32)[rng.randint(0, n_classes, n)]
    return x, y


def _wired(pkg, n=70, n_in=8, n_classes=3, seed=0):
    """Integer pixels as the readers build them: the f32 features ARE the
    numpy decode of the u8 twin."""
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, (n, n_in), dtype=np.uint8)
    y = np.eye(n_classes, dtype=np.float32)[rng.randint(0, n_classes, n)]
    if pkg == "jax":
        return jax_attach(JaxDataSet(JAX_U8_PIXEL.decode_host(u8), y), u8,
                          JAX_U8_PIXEL)
    return pdataset.attach_wire(DataSet(U8_PIXEL.decode_host(u8), y), u8,
                                U8_PIXEL)


def _jconf(container, updater="adam", n_in=6, n_classes=3, seed=7,
           compute_dtype=None, dtype="float32"):
    b = (JaxConf.builder().seed(seed).dtype(dtype).updater(updater)
         .learning_rate(0.05).activation("tanh").weight_init("xavier"))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    if container == "graph":
        return (b.graph_builder().add_inputs("in")
                .add_layer("h", jcore.DenseLayer(n_in=n_in, n_out=10), "in")
                .add_layer("out", jcore.OutputLayer(n_in=10,
                                                    n_out=n_classes), "h")
                .set_outputs("out").build())
    return (b.list().layer(jcore.DenseLayer(n_out=10))
            .layer(jcore.OutputLayer(n_out=n_classes))
            .set_input_type(jin.feed_forward(n_in)).build())


def _pair(container="mln", **kw):
    """A JAX network and the port's with the JAX weights loaded."""
    jconf = _jconf(container, **kw)
    if container == "graph":
        jnet = JaxCG(jconf).init()
        pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
            jconf.to_json()), device="cpu").init()
    else:
        jnet = JaxNet(jconf).init()
        pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jconf.to_json()), device="cpu").init()
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _net(container="mln", **kw):
    return _pair(container, **kw)[1]


def _close(pnet, jnet):
    np.testing.assert_allclose(pnet.get_flat_params(),
                               np.asarray(jnet.get_flat_params()),
                               rtol=RTOL, atol=ATOL)


class _P:
    def preprocess(self, ds):
        pass


# ------------------------------------------------------------ eligibility
def _iterator_case(pkg, case):
    x, y = _arrays()
    DS = JaxDataSet if pkg == "jax" else DataSet
    L = JaxList if pkg == "jax" else ListDataSetIterator
    if case == "list":
        return L(DS(x, y), 16, shuffle=True, seed=3)
    if case == "async":
        return (JaxAsync if pkg == "jax" else AsyncDataSetIterator)(
            L(DS(x, y), 16, shuffle=True, seed=3))
    if case == "async_preprocessed":
        it = (JaxAsync if pkg == "jax" else AsyncDataSetIterator)(
            L(DS(x, y), 16))
        it.set_preprocessor(_P())
        return it
    if case == "masked":
        return L(DS(x, y, features_mask=np.ones((70, 1), np.float32)), 16)
    if case == "existing":
        return (JaxExisting if pkg == "jax" else ExistingDataSetIterator)(
            [DS(x, y)])
    if case == "preprocessor":
        it = L(DS(x, y), 16)
        it.set_preprocessor(_P())
        return it
    if case == "float64":
        return L(DS(x.astype(np.float64), y), 16)
    if case == "subclass":
        class Sub(L):
            def __next__(self):
                return super().__next__()
        return Sub(DS(x, y), 16)
    u8 = np.random.RandomState(1).randint(0, 256, (40, 8), dtype=np.uint8)
    lab = np.eye(2, dtype=np.float32)[np.arange(40) % 2]
    feats = u8 if case.startswith("scaler_u8") else u8.astype(np.float32)
    it = L(DS(feats, lab), 8)
    it.set_preprocessor((JaxScaler if pkg == "jax"
                         else ImagePreProcessingScaler)())
    return it


@pytest.mark.parametrize("case", [
    "list", "async", "async_preprocessed", "masked", "existing",
    "preprocessor", "float64", "subclass", "scaler_u8", "scaler_u8_nowire",
    "scaler_f32"])
def test_cacheable_source_gives_the_jax_verdict(case, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_WIRE_UINT8",
                       "0" if case.endswith("nowire") else "1")
    j = jingest.cacheable_source(_iterator_case("jax", case))
    p = ingest.cacheable_source(_iterator_case("port", case))
    assert (j is None) == (p is None)
    assert (p is None) == (case not in ("list", "async", "scaler_u8"))


def test_cacheable_source_respects_the_size_limit(monkeypatch):
    x, y = _arrays()
    monkeypatch.setattr(ingest, "DEVICE_CACHE_LIMIT_BYTES",
                        x.nbytes + y.nbytes - 1)
    monkeypatch.setattr(jingest, "DEVICE_CACHE_LIMIT_BYTES",
                        x.nbytes + y.nbytes - 1)
    assert ingest.cacheable_source(ListDataSetIterator(DataSet(x, y))) \
        is None
    assert jingest.cacheable_source(JaxList(JaxDataSet(x, y))) is None


def test_bf16_host_tensors_are_cacheable():
    x, y = _arrays()
    it = ListDataSetIterator(DataSet(torch.from_numpy(x).bfloat16(), y), 16)
    assert ingest.cacheable_source(it) is it
    assert next(iter(it)).features.dtype == torch.bfloat16


# ---------------------------------------------------------- the u8 wire
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", [(255.0, 1.0, 0.0), (255.0, 1.0, -0.5),
                                 (1.0, 1.0, 0.0)])
def test_device_decode_is_bit_equal_to_jax(dtype, fmt):
    import jax.numpy as jnp
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = ingest.device_decode(torch.from_numpy(u8), fmt)
    want = jingest.device_decode(jnp.asarray(u8), fmt)
    host = WireFormat(*fmt).decode_host(u8)
    if dtype == "bfloat16":
        got = got.to(torch.bfloat16).float()
        want = want.astype(jnp.bfloat16).astype(jnp.float32)
        host = torch.from_numpy(host).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), host)


@pytest.mark.parametrize("binarize", [False, True])
def test_mnist_wire_twin_is_the_jax_one(binarize, tmp_path, monkeypatch):
    monkeypatch.setenv("MNIST_DIR", str(tmp_path))   # both generate
    p = MnistDataSetIterator(16, 48, binarize=binarize, shuffle=False)
    j = JaxMnist(16, 48, binarize=binarize, shuffle=False)
    (pu8, pfmt), (ju8, jfmt) = pdataset.wire_of(p._ds), j._ds._wire
    np.testing.assert_array_equal(pu8, ju8)
    assert pfmt.as_tuple() == jfmt.as_tuple()
    np.testing.assert_array_equal(pfmt.decode_host(pu8), p._ds.features)
    np.testing.assert_array_equal(p._ds.features, j._ds.features)
    pb, jb = next(iter(p)), next(iter(j))
    np.testing.assert_array_equal(pdataset.wire_of(pb)[0], jb._wire[0])
    np.testing.assert_array_equal(pb.features, jb.features)


def test_a_preprocessor_drops_the_wire():
    it = ListDataSetIterator(_wired("port"), 16)
    assert pdataset.wire_of(next(iter(it))) is not None
    it.set_preprocessor(_P())
    assert pdataset.wire_of(next(iter(it))) is None


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_wire_and_float32_staging_train_alike_on_the_cache(monkeypatch,
                                                           compute_dtype):
    ds = _wired("port")

    def run(flag):
        monkeypatch.setenv("DL4J_TPU_WIRE_UINT8", flag)
        net = _net(n_in=8, compute_dtype=compute_dtype)
        net.fit(ListDataSetIterator(ds, 16, shuffle=True, seed=3),
                epochs=2, ingest="cache")
        return net.get_flat_params()

    np.testing.assert_array_equal(run("1"), run("0"))


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_wire_and_float32_staging_train_alike_on_the_window(monkeypatch,
                                                            container):
    ds = _wired("port", n=96)

    def run(flag):
        monkeypatch.setenv("DL4J_TPU_WIRE_UINT8", flag)
        net = _net(container, n_in=8)
        net.fit(ListDataSetIterator(ds, 16), epochs=2, ingest="window",
                window=2)
        return net.get_flat_params()

    np.testing.assert_array_equal(run("1"), run("0"))


@pytest.mark.parametrize("path", ["cache", "window"])
def test_the_staged_bytes_are_uint8(monkeypatch, path):
    monkeypatch.setenv("DL4J_TPU_WIRE_UINT8", "1")
    net = _net(n_in=8)
    net.fit(ListDataSetIterator(_wired("port", n=64), 16), ingest=path,
            window=4)
    assert monitor.gauge("ingest_staged_bytes").value(path=path) == \
        64 * (8 * 1 + 3 * 4)


def test_the_cache_stays_resident_across_fits():
    net = _net()
    x, y = _arrays(n=64)
    ds = DataSet(x, y)
    net.fit(ListDataSetIterator(ds, 16), ingest="cache")
    first = net._ingest_device_cache[3]
    net.fit(ListDataSetIterator(ds, 16), ingest="cache")
    assert net._ingest_device_cache[3] is first
    net.fit(ListDataSetIterator(DataSet(x.copy(), y), 16), ingest="cache")
    assert net._ingest_device_cache[3] is not first


def test_a_scaler_over_uint8_fuses_into_the_cache(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_WIRE_UINT8", "1")
    rng = np.random.RandomState(4)
    u8 = DataSet(rng.randint(0, 256, (70, 8), dtype=np.uint8),
                 np.eye(3, dtype=np.float32)[rng.randint(0, 3, 70)])

    def run(mode):
        it = ListDataSetIterator(u8, 16)
        it.set_preprocessor(ImagePreProcessingScaler(-0.5, 0.5))
        net = _net(n_in=8)
        net.fit(it, epochs=2, ingest=mode)
        return net.get_flat_params()

    np.testing.assert_array_equal(run("batch"), run("cache"))


def test_cast_for_transfer_is_the_forward_cast():
    x = torch.randn(4, 5)
    assert ingest.cast_for_transfer(x, torch.float32) is x
    np.testing.assert_array_equal(
        ingest.cast_for_transfer(x, torch.bfloat16).float().numpy(),
        x.to(torch.bfloat16).float().numpy())
    u8 = torch.zeros(3, dtype=torch.uint8)
    assert ingest.cast_for_transfer(u8, torch.bfloat16) is u8


# --------------------------------------------------- epochs and batches
def test_epoch_index_batches_boundaries():
    order = np.arange(70)
    idx = ingest.epoch_index_batches(order, 16)
    assert [a.shape for a in idx] == [(4, 16), (1, 6)]
    np.testing.assert_array_equal(np.concatenate(
        [a.ravel() for a in idx]), order)
    assert ingest.epoch_index_batches(np.arange(5), 16)[0].shape == (1, 5)
    for got, want in zip(idx, jingest.epoch_index_batches(order, 16)):
        np.testing.assert_array_equal(got, want)


def test_consume_epoch_marks_the_iterator_consumed():
    x, y = _arrays()
    it = ListDataSetIterator(DataSet(x, y), 16, shuffle=True, seed=3)
    ingest.consume_epoch(it)
    with pytest.raises(StopIteration):
        next(it)
    assert it._epoch == 3      # the two resets of a per-batch epoch


def test_epoch_permutation_is_seeded_by_network_and_epoch():
    a = ingest.epoch_permutation(7, 2, 50, True, "cpu")
    assert sorted(a.tolist()) == list(range(50))
    assert torch.equal(a, ingest.epoch_permutation(7, 2, 50, True, "cpu"))
    assert not torch.equal(a, ingest.epoch_permutation(7, 3, 50, True,
                                                       "cpu"))
    assert not torch.equal(a, ingest.epoch_permutation(8, 2, 50, True,
                                                       "cpu"))
    assert torch.equal(ingest.epoch_permutation(7, 2, 50, False, "cpu"),
                       torch.arange(50))


# ------------------------------------------------------- parity with JAX
@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("updater", ["sgd", "adam"])
@pytest.mark.parametrize("path", ["cache", "window"])
def test_the_fused_paths_match_jax(container, updater, path):
    """2 epochs over 70 examples in batches of 16 (a tail of 6)."""
    x, y = _arrays()
    jnet, pnet = _pair(container, updater=updater)
    if path == "cache":
        jnet.fit(JaxList(JaxDataSet(x, y), 16), epochs=2, ingest="cache")
        pnet.fit(ListDataSetIterator(DataSet(x, y), 16), epochs=2,
                 ingest="cache")
    else:
        jb = list(JaxList(JaxDataSet(x, y), 16))
        pb = list(ListDataSetIterator(DataSet(x, y), 16))
        jnet.fit(JaxExisting(jb), epochs=2, ingest="window", window=2)
        pnet.fit(ExistingDataSetIterator(pb), epochs=2, ingest="window",
                 window=2)
    assert pnet.iteration == jnet.iteration == 10
    _close(pnet, jnet)
    np.testing.assert_allclose(pnet.score(DataSet(x, y)),
                               float(jnet.score(JaxDataSet(x, y))),
                               rtol=1e-5)


@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_fit_scan_matches_jax(container, updater):
    x, y = _arrays(n=64)
    jnet, pnet = _pair(container, updater=updater)
    for _ in range(2):
        js = jnet.fit_scan([JaxDataSet(x[i:i + 16], y[i:i + 16])
                            for i in range(0, 64, 16)])
        ps = pnet.fit_scan([DataSet(x[i:i + 16], y[i:i + 16])
                            for i in range(0, 64, 16)])
        np.testing.assert_allclose(ps, np.asarray(js), rtol=1e-5)
    assert pnet.iteration == jnet.iteration == 8
    _close(pnet, jnet)


def test_fit_scan_refuses_mixed_masks_and_tbptt_rules():
    x, y = _arrays(n=32)
    net = _net()
    with pytest.raises(ValueError, match="Mixed mask presence"):
        net.fit_scan([DataSet(x[:16], y[:16],
                              features_mask=np.ones((16, 1), np.float32)),
                      DataSet(x[16:], y[16:])])
    net.conf.conf.num_iterations = 2
    with pytest.raises(ValueError, match="num_iterations"):
        net.fit_scan([DataSet(x, y)])


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_the_cache_path_equals_the_batch_path_without_shuffle(container):
    x, y = _arrays()
    a, b = _net(container), _net(container)
    a.fit(ListDataSetIterator(DataSet(x, y), 16), epochs=2, ingest="batch")
    b.fit(ListDataSetIterator(DataSet(x, y), 16), epochs=2, ingest="cache")
    np.testing.assert_array_equal(a.get_flat_params(), b.get_flat_params())
    np.testing.assert_array_equal(a.get_flat_updater_state(),
                                  b.get_flat_updater_state())


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_shuffled_cache_is_the_batch_path_in_the_device_order(container):
    """The cache path's order is ``epoch_permutation(seed, epoch)``; the
    per-batch path fed the same order trains bit-identically, tail batch
    included; the same seed repeats, the order differs from unshuffled."""
    x, y = _arrays()
    cached = _net(container)
    cached.fit(ListDataSetIterator(DataSet(x, y), 16, shuffle=True, seed=3),
               epochs=2, ingest="cache")
    replay = _net(container)
    for epoch in range(2):
        order = ingest.epoch_permutation(7, epoch, 70, True, "cpu").numpy()
        replay.fit(ExistingDataSetIterator(
            [DataSet(x[order[i:i + 16]], y[order[i:i + 16]])
             for i in range(0, 70, 16)]), ingest="batch")
    np.testing.assert_array_equal(cached.get_flat_params(),
                                  replay.get_flat_params())
    again = _net(container)
    again.fit(ListDataSetIterator(DataSet(x, y), 16, shuffle=True, seed=3),
              epochs=2, ingest="cache")
    np.testing.assert_array_equal(cached.get_flat_params(),
                                  again.get_flat_params())
    plain = _net(container)
    plain.fit(ListDataSetIterator(DataSet(x, y), 16), epochs=2,
              ingest="cache")
    assert not np.array_equal(cached.get_flat_params(),
                              plain.get_flat_params())


def _dispatches(monkeypatch):
    """The step count of each dispatch (its scores reach the replayer
    once per dispatch)."""
    calls = []
    real = ingest.ScoreReplayer.add

    def count(self, start_iteration, scores):
        calls.append(scores.shape[0])
        real(self, start_iteration, scores)
    monkeypatch.setattr(ingest.ScoreReplayer, "add", count)
    return calls


def test_listener_free_epochs_fuse_into_one_dispatch(monkeypatch):
    x, y = _arrays(n=64)          # 64 % 16 == 0: no tail
    calls = _dispatches(monkeypatch)
    fused = _net()
    fused.fit(ListDataSetIterator(DataSet(x, y), 16, shuffle=True, seed=3),
              epochs=3, ingest="cache")
    assert calls == [12]
    per_epoch = _net()
    for _ in range(3):
        per_epoch.fit(ListDataSetIterator(DataSet(x, y), 16, shuffle=True,
                                          seed=3), ingest="cache")
    np.testing.assert_array_equal(fused.get_flat_params(),
                                  per_epoch.get_flat_params())

    class L:
        def iteration_done(self, model, iteration):
            pass
    del calls[:]
    listened = _net()
    listened.set_listeners(L())
    listened.fit(ListDataSetIterator(DataSet(x, y), 16, shuffle=True,
                                     seed=3), epochs=3, ingest="cache")
    assert calls == [4, 4, 4]
    np.testing.assert_array_equal(fused.get_flat_params(),
                                  listened.get_flat_params())


def test_a_tail_batch_is_its_own_dispatch(monkeypatch):
    x, y = _arrays()
    calls = _dispatches(monkeypatch)
    _net().fit(ListDataSetIterator(DataSet(x, y), 16), epochs=2,
               ingest="cache")
    assert calls == [4, 1, 4, 1]


class _Collect:
    def __init__(self):
        self.scores, self.epoch_ends = [], 0

    def iteration_done(self, model, iteration):
        self.scores.append((iteration, float(model.score())))

    def on_epoch_end(self, model):
        self.epoch_ends += 1


@pytest.mark.parametrize("path", ["batch", "cache", "window"])
def test_listener_replay_gives_the_jax_scores(path):
    x, y = _arrays()
    jnet, pnet = _pair()
    got, want = _Collect(), _Collect()
    pnet.set_listeners(got)
    jnet.set_listeners(want)
    if path == "window":
        pnet.fit(ExistingDataSetIterator(list(ListDataSetIterator(
            DataSet(x, y), 16))), epochs=2, ingest=path, window=3)
        jnet.fit(JaxExisting(list(JaxList(JaxDataSet(x, y), 16))),
                 epochs=2, ingest=path, window=3)
    else:
        pnet.fit(ListDataSetIterator(DataSet(x, y), 16), epochs=2,
                 ingest=path)
        jnet.fit(JaxList(JaxDataSet(x, y), 16), epochs=2, ingest=path)
    assert [i for i, _ in got.scores] == [i for i, _ in want.scores] == \
        list(range(1, 11))
    assert got.epoch_ends == want.epoch_ends == 2
    np.testing.assert_allclose([s for _, s in got.scores],
                               [s for _, s in want.scores], rtol=RTOL)


def test_auto_picks_the_jax_path(monkeypatch):
    """``"auto"``: the cache for a cacheable iterator, the window for any
    other; solvers and tBPTT stay on the per-batch path."""
    x, y = _arrays(n=64)
    taken = []
    for name in ("_fit_device_cached", "_fit_windowed"):
        real = getattr(pml._Network, name)

        def spy(self, *a, _name=name, _real=real, **k):
            taken.append(_name)
            return _real(self, *a, **k)
        monkeypatch.setattr(pml._Network, name, spy)
    net = _net()
    net.fit(ListDataSetIterator(DataSet(x, y), 16))
    net.fit(ExistingDataSetIterator([DataSet(x, y)]))
    net.fit(DataSet(x, y))
    with pytest.raises(ValueError, match="not device-cacheable"):
        net.fit(ExistingDataSetIterator([DataSet(x, y)]), ingest="cache")
    assert taken == ["_fit_device_cached", "_fit_windowed"]


def test_windowed_masks_and_shape_changes_equal_the_batch_path():
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
    from deeplearning4j_tpu_torch.nn.layers.pooling import \
        GlobalPoolingLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTM
    rng = np.random.RandomState(0)

    def seq(n, t):
        f = rng.randn(n, t, 4).astype(np.float32)
        lab = np.eye(2, dtype=np.float32)[rng.randint(0, 2, n)]
        fm = (rng.rand(n, t) > 0.2).astype(np.float32)
        fm[:, 0] = 1.0
        return DataSet(f, lab, features_mask=fm)

    def net():
        conf = (NeuralNetConfiguration.builder().seed(11).updater("sgd")
                .learning_rate(0.1).weight_init("xavier").list()
                .layer(GravesLSTM(n_out=6, activation="tanh"))
                .layer(GlobalPoolingLayer(pooling_type="avg"))
                .layer(OutputLayer(n_out=2))
                .set_input_type(inputs.recurrent(4)).build())
        return MultiLayerNetwork(conf, device="cpu").init()

    batches = [seq(8, 5), seq(8, 5), seq(8, 7), seq(8, 7), seq(8, 7)]
    a, b = net(), net()
    a.fit(ExistingDataSetIterator(batches), ingest="batch")
    b.fit(ExistingDataSetIterator(batches), ingest="window", window=4)
    np.testing.assert_array_equal(a.get_flat_params(), b.get_flat_params())
