"""The data tier of the port (``datasets/``) against the JAX package's: the
procedural MNIST and the embedded iris give the same bytes, every iterator
gives the same batches in the same order for a seed, normalizers fit the
same statistics and read each other's files, and the async prefetch
drains its worker and raises its errors in the consumer.

Tolerances: bytes and batches exactly; normalizer statistics 1e-7
relative (both accumulate in float64 in the same order and round to
float32, so they agree to the last bit in practice); transforms exactly.
Every test that joins a worker thread runs under a time limit (``_within``).
"""

import threading

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets import iris as jiris
from deeplearning4j_tpu.datasets import iterators as jit
from deeplearning4j_tpu.datasets import mnist as jmnist
from deeplearning4j_tpu.datasets import normalizers as jnorm
from deeplearning4j_tpu_torch.datasets import dataset as pds
from deeplearning4j_tpu_torch.datasets import iris as piris
from deeplearning4j_tpu_torch.datasets import iterators as pit
from deeplearning4j_tpu_torch.datasets import mnist as pmnist
from deeplearning4j_tpu_torch.datasets import normalizers as pnorm

N_MNIST = 256
LIMIT_S = 60.0


def _within(fn, seconds=LIMIT_S):
    """Run ``fn`` on a thread; fail if it has not returned in ``seconds``,
    raise what it raised."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


@pytest.fixture(autouse=True)
def _no_idx_files(monkeypatch, tmp_path):
    """Both packages read the procedural MNIST (no IDX files here)."""
    monkeypatch.setenv("MNIST_DIR", str(tmp_path / "no_mnist"))


def _batches(it):
    return [tuple(None if a is None else np.asarray(a).copy()
                  for a in ds.as_tuple()) for ds in it]


def _same_batches(got, want):
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ bytes
@pytest.mark.parametrize("train", [True, False])
def test_mnist_bytes_equal(train):
    got = pmnist.mnist_arrays_u8(train, N_MNIST, seed=6)
    want = jmnist.mnist_arrays_u8(train, N_MNIST, seed=6)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    f, _ = pmnist.mnist_arrays(train, N_MNIST)
    np.testing.assert_array_equal(f, jmnist.mnist_arrays(train, N_MNIST)[0])


def test_mnist_idx_reader_matches_jax(tmp_path, monkeypatch):
    """Gzipped IDX files decode to the same arrays."""
    import gzip
    import struct
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (7, 28 * 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 7).astype(np.uint8)
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">iiii", 2051, 7, 28, 28) + images.tobytes())
    with gzip.open(tmp_path / "t10k-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">ii", 2049, 7) + labels.tobytes())
    monkeypatch.setenv("MNIST_DIR", str(tmp_path))
    got = pmnist.mnist_arrays_u8(False, 5)
    want = jmnist.mnist_arrays_u8(False, 5)
    np.testing.assert_array_equal(got[0], images[:5])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_iris_bytes_equal():
    got, want = piris.iris_dataset(), jiris.iris_dataset()
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.features.dtype == want.features.dtype == np.float32


# ------------------------------------------------------------- iterators
def _mnist(pkg, **kw):
    mod = pmnist if pkg == "port" else jmnist
    return mod.MnistDataSetIterator(32, N_MNIST, **kw)


def _list_ds(pkg, masks=False):
    rng = np.random.RandomState(4)
    x = rng.randn(50, 3, 4).astype(np.float32)
    y = rng.rand(50, 3, 2).astype(np.float32)
    m = (rng.rand(50, 3) > 0.3).astype(np.float32) if masks else None
    return (pds if pkg == "port" else jds).DataSet(x, y, m, m)


ITERATORS = {
    "mnist_shuffled": lambda pkg, mod: _mnist(pkg),
    "mnist_train_binarized": lambda pkg, mod: _mnist(pkg, binarize=True),
    "mnist_test_binarized": lambda pkg, mod: _mnist(pkg, binarize=True,
                                                    train=False,
                                                    shuffle=False),
    "iris_subset": lambda pkg, mod: (piris if pkg == "port" else jiris)
    .IrisDataSetIterator(16, 100, shuffle=True, seed=3),
    "list_masked": lambda pkg, mod: mod.ListDataSetIterator(
        _list_ds(pkg, True), 8, shuffle=True, seed=11),
    "list_in_order": lambda pkg, mod: mod.ListDataSetIterator(
        _list_ds(pkg), 16),
    "existing": lambda pkg, mod: mod.ExistingDataSetIterator(
        list(_list_ds(pkg).batch_by(20))),
    "multiple_epochs": lambda pkg, mod: mod.MultipleEpochsIterator(
        3, mod.ListDataSetIterator(_list_ds(pkg), 16, shuffle=True,
                                   seed=2)),
    "async": lambda pkg, mod: (
        mod.AsyncDataSetIterator(_mnist(pkg), use_native=False)
        if pkg == "jax" else mod.AsyncDataSetIterator(_mnist(pkg))),
}


@pytest.mark.parametrize("name", sorted(ITERATORS))
def test_iterators_give_the_same_batches(name):
    """Three epochs, each opened as ``fit`` opens one (``reset()`` then
    ``iter()``), so the shuffle seeds advance alike."""
    def epochs(pkg, mod):
        it = ITERATORS[name](pkg, mod)
        out = []
        for _ in range(3):
            it.reset()
            out.append(_batches(it))
        if hasattr(it, "close"):
            it.close()
        return out

    got = _within(lambda: epochs("port", pit))
    want = _within(lambda: epochs("jax", jit))
    for g, w in zip(got, want):
        _same_batches(g, w)


@pytest.mark.parametrize("binarize", [False, True])
def test_preprocessed_mnist_batches_match(binarize):
    p, j = _mnist("port", binarize=binarize), _mnist("jax",
                                                     binarize=binarize)
    p.set_preprocessor(pnorm.ImagePreProcessingScaler(-1, 1, 1))
    j.set_preprocessor(jnorm.ImagePreProcessingScaler(-1, 1, 1))
    _same_batches(_batches(p), _batches(j))


def test_dataset_helpers_match_jax():
    p, j = _list_ds("port", True), _list_ds("jax", True)
    for got, want in zip(p.shuffle(5).split_test_and_train(30),
                         j.shuffle(5).split_test_and_train(30)):
        _same_batches([tuple(got.as_tuple())], [tuple(want.as_tuple())])
    _same_batches(_batches(p.batch_by(12)), _batches(j.batch_by(12)))
    md = pds.MultiDataSet([np.zeros((4, 2))], [np.zeros((4, 1))])
    assert md.num_examples() == 4


# ------------------------------------------------------------ async
class _Boom(pit.DataSetIterator):
    def __init__(self, at):
        self.at, self.n = at, 0

    def reset(self):
        self.n = 0

    def __next__(self):
        self.n += 1
        if self.n > self.at:
            raise RuntimeError("reader failed")
        return pds.DataSet(np.zeros((1, 2)), np.zeros((1, 1)))


def test_async_raises_the_worker_error_in_the_consumer():
    it = pit.AsyncDataSetIterator(_Boom(3))

    def consume():
        got = []
        with pytest.raises(RuntimeError, match="reader failed"):
            for ds in it:
                got.append(ds)
        return len(got)

    assert _within(consume) == 3
    with pytest.raises(StopIteration):
        _within(lambda: next(it))
    _within(it.close)
    assert it._thread is None


def test_async_reset_and_close_drain_the_worker():
    """A reset mid-epoch and a close with batches still queued both join
    the worker (it would otherwise block on the full queue)."""
    it = pit.AsyncDataSetIterator(_mnist("port"), queue_size=1)

    def run():
        it.reset()
        next(it)
        first = it._thread
        it.reset()                       # mid-epoch
        assert not first.is_alive()
        n = len(_batches(it))
        next(iter(it))
        worker = it._thread
        it.close()
        assert not worker.is_alive() and it._thread is None
        return n

    assert _within(run) == N_MNIST // 32
    assert it.native is False


class _Counting(pit.DataSetIterator):
    """64 one-row batches; counts the rows read since the last reset."""

    def __init__(self):
        self.n = 0

    def reset(self):
        self.n = 0

    def __next__(self):
        if self.n >= 64:
            raise StopIteration
        self.n += 1
        return pds.DataSet(np.zeros((1, 2)), np.zeros((1, 1)))


def test_async_reset_stops_the_worker_early():
    """``fit`` resets and then iterates, so every epoch starts with two
    resets: the worker of the first must stop within a queue's worth of
    batches, not read the whole epoch before the second starts."""
    under = _Counting()
    it = pit.AsyncDataSetIterator(under, queue_size=2)
    read = []
    real_reset = under.reset

    def reset():
        read.append(under.n)
        real_reset()

    under.reset = reset

    def run():
        it.reset()
        n = len(_batches(it))
        it.close()
        return n

    assert _within(run) == 64
    # rows read by the first worker before the second reset: at most the
    # queue's capacity, one blocked put and one in hand
    assert read[1] <= 2 + 2, read


def test_async_refuses_the_native_ring():
    with pytest.raises(NotImplementedError, match="A11"):
        pit.AsyncDataSetIterator(_mnist("port"), use_native=True)


# ------------------------------------------------------------ normalizers
def _feature_sets():
    rng = np.random.RandomState(9)
    flat = pds.DataSet(rng.randn(40, 5).astype(np.float32) * 3 + 1,
                       rng.randn(40, 2).astype(np.float32))
    seq = pds.DataSet(rng.randn(6, 7, 3).astype(np.float32),
                      rng.randn(6, 7, 2).astype(np.float32),
                      (rng.rand(6, 7) > 0.25).astype(np.float32),
                      (rng.rand(6, 7) > 0.25).astype(np.float32))
    return {"flat": flat, "sequence_masked": seq}


NORMALIZERS = {
    "standardize": lambda mod: mod.NormalizerStandardize(fit_label=True),
    "minmax": lambda mod: mod.NormalizerMinMaxScaler(-1.0, 2.0,
                                                     fit_label=True),
    "image": lambda mod: mod.ImagePreProcessingScaler(0.5, 1.0),
}


def _stats(n):
    names = ("mean", "std", "label_mean", "label_std", "min", "max",
             "label_min", "label_max")
    return {k: getattr(n, k) for k in names
            if getattr(n, k, None) is not None}


@pytest.mark.parametrize("data", ["flat", "sequence_masked"])
@pytest.mark.parametrize("kind", sorted(NORMALIZERS))
def test_normalizers_fit_and_transform_like_jax(kind, data):
    ds = _feature_sets()[data]
    jds_ = jds.DataSet(*ds.as_tuple())
    # fitted over an iterator of 4-row batches: the streaming pass
    p = NORMALIZERS[kind](pnorm).fit(pit.ListDataSetIterator(ds, 4))
    j = NORMALIZERS[kind](jnorm).fit(jit.ListDataSetIterator(jds_, 4))
    ps, js = _stats(p), _stats(j)
    assert sorted(ps) == sorted(js)
    for k in ps:
        assert ps[k].dtype == js[k].dtype
        np.testing.assert_allclose(ps[k], js[k], rtol=1e-7, atol=0)
    pb, jb = pds.DataSet(*ds.as_tuple()), jds.DataSet(*ds.as_tuple())
    p.preprocess(pb)
    j.preprocess(jb)
    np.testing.assert_array_equal(pb.features, jb.features)
    np.testing.assert_array_equal(pb.labels, jb.labels)
    p.revert(pb)
    j.revert(jb)
    np.testing.assert_array_equal(pb.features, jb.features)


@pytest.mark.parametrize("kind", sorted(NORMALIZERS))
def test_normalizer_files_cross_both_ways(kind, tmp_path):
    ds = _feature_sets()["flat"]
    p = NORMALIZERS[kind](pnorm).fit(ds)
    j = NORMALIZERS[kind](jnorm).fit(jds.DataSet(*ds.as_tuple()))
    p.save(str(tmp_path / "port.npz"))
    j.save(str(tmp_path / "jax.npz"))
    into_jax = jnorm.load_normalizer(str(tmp_path / "port.npz"))
    into_port = pnorm.load_normalizer(str(tmp_path / "jax.npz"))
    assert type(into_port).__name__ == type(j).__name__
    x = np.asarray(ds.features)
    np.testing.assert_array_equal(into_jax.transform(x), j.transform(x))
    np.testing.assert_array_equal(into_port.transform(x), p.transform(x))


def test_unfitted_normalizer_raises():
    with pytest.raises(RuntimeError, match="not fitted"):
        pnorm.NormalizerStandardize().preprocess(_feature_sets()["flat"])
