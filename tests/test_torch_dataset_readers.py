"""The port's readers (``deeplearning4j_tpu_torch/datasets/records.py``,
``cifar.py``, ``lfw.py``, ``curves.py``) against the JAX package's, on the
CPU.  Everything is host numpy in both packages, so everything is
bitwise:

- every record reader's batches (features, labels, masks) through
  ``RecordReaderDataSetIterator`` (classification, multi-column
  regression, no labels, ``max_num_batches``, a preprocessor),
  ``SequenceRecordReaderDataSetIterator`` in every ``AlignmentMode`` with
  two readers and with one, and ``RecordReaderMultiDataSetIterator``
  (column subsets, one-hot columns, record and sequence readers, every
  alignment), with the JAX package's errors for bad input;
- the procedural CIFAR-10, LFW and curves arrays and their iterators'
  batches (``CIFAR_DIR``/``LFW_DIR`` pointed at empty directories, so both
  packages generate), the CIFAR u8 wire twin;
- ``_read_cifar_bin`` and ``_read_pnm`` on files the test writes, and the
  real-directory modes over them.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import cifar as jcifar
from deeplearning4j_tpu.datasets import curves as jcurves
from deeplearning4j_tpu.datasets import lfw as jlfw
from deeplearning4j_tpu.datasets import normalizers as jnorm
from deeplearning4j_tpu.datasets import records as jrec
from deeplearning4j_tpu_torch.datasets import cifar as pcifar
from deeplearning4j_tpu_torch.datasets import curves as pcurves
from deeplearning4j_tpu_torch.datasets import lfw as plfw
from deeplearning4j_tpu_torch.datasets import normalizers as pnorm
from deeplearning4j_tpu_torch.datasets import records as prec
from deeplearning4j_tpu_torch.datasets.dataset import wire_of

SIDES = {"jax": jrec, "port": prec}


def same(a, b):
    """Bitwise equal arrays (or both None)."""
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def same_batches(jit, pit):
    """Drain both iterators and hold every DataSet/MultiDataSet field."""
    jb, pb = list(jit), list(pit)
    assert len(jb) == len(pb) > 0
    for a, b in zip(jb, pb):
        if hasattr(a, "features_mask"):
            for x, y in zip(a.as_tuple(), b.as_tuple()):
                same(x, y)
        else:
            for name in ("features", "labels", "features_masks",
                         "labels_masks"):
                xs, ys = getattr(a, name), getattr(b, name)
                if xs is None or ys is None:
                    assert xs is None and ys is None
                    continue
                assert len(xs) == len(ys)
                for x, y in zip(xs, ys):
                    same(x, y)
    return pb


def rows(n=23, seed=0):
    """[f0, f1, f2, class, r0, r1] records."""
    rng = np.random.RandomState(seed)
    return [[float(a), float(b), float(c), int(k), float(r0), float(r1)]
            for a, b, c, k, r0, r1 in zip(
                rng.randn(n), rng.rand(n), rng.randn(n) * 5,
                rng.randint(0, 4, n), rng.randn(n), rng.randn(n))]


def sequences(n=9, seed=1, equal=False, cols=3):
    rng = np.random.RandomState(seed)
    lens = [5] * n if equal else rng.randint(1, 8, n)
    return [[list(map(float, rng.randn(cols))) for _ in range(T)]
            for T in lens]


def label_sequences(feats, seed=2, classes=3, same_len=True):
    rng = np.random.RandomState(seed)
    out = []
    for s in feats:
        T = len(s) if same_len else max(1, len(s) - rng.randint(0, 3))
        out.append([[int(rng.randint(0, classes))] for _ in range(T)])
    return out


# ------------------------------------------------------------ readers
RECORD_CASES = {
    "classification": dict(batch_size=5, label_index=3,
                           num_possible_labels=4),
    "regression columns": dict(batch_size=4, label_index=4,
                               regression=True, label_index_to=5),
    "no labels": dict(batch_size=6),
    "max batches": dict(batch_size=3, label_index=3, num_possible_labels=4,
                        max_num_batches=2),
}


@pytest.mark.parametrize("reader", ["collection", "csv"])
@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_record_reader_iterator_equals_jax(tmp_path, reader, case):
    data = rows()
    path = tmp_path / "r.csv"
    path.write_text("a,b,c,k,r0,r1\n" + "".join(
        ",".join(repr(v) for v in r) + "\n" for r in data) + "\n")
    its = {}
    for side, mod in SIDES.items():
        rr = (mod.CollectionRecordReader(data) if reader == "collection"
              else mod.CSVRecordReader(skip_num_lines=1).initialize(
                  str(path)))
        its[side] = mod.RecordReaderDataSetIterator(rr, **RECORD_CASES[case])
    got = same_batches(its["jax"], its["port"])
    assert got[0].features.dtype == np.float32
    assert its["port"].batch() == RECORD_CASES[case]["batch_size"]
    # a second pass after reset gives the same batches again
    same_batches(its["port"], its["jax"])


def test_record_reader_preprocessor_and_errors():
    data = rows()
    its = {side: mod.RecordReaderDataSetIterator(
        mod.CollectionRecordReader(data), 8, 3, 4)
        for side, mod in SIDES.items()}
    jn, pn = jnorm.NormalizerStandardize(), pnorm.NormalizerStandardize()
    jn.fit(its["jax"])
    pn.fit(its["port"])
    its["jax"].set_preprocessor(jn)
    its["port"].set_preprocessor(pn)
    same_batches(its["jax"], its["port"])
    with pytest.raises(ValueError, match="num_possible_labels"):
        prec.RecordReaderDataSetIterator(prec.CollectionRecordReader(data),
                                         4, label_index=3)
    bad = prec.RecordReaderDataSetIterator(
        prec.CollectionRecordReader([[1.0, 7]]), 4, 1, 3)
    with pytest.raises(ValueError, match="out of range"):
        next(iter(bad))
    with pytest.raises(NotImplementedError):
        prec.RecordReader().has_next()


MODES = ["equal_length", "align_start", "align_end"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("readers", ["two readers", "label column"])
def test_sequence_iterator_equals_jax(mode, readers):
    equal = mode == "equal_length"
    feats = sequences(equal=equal)
    labels = label_sequences(feats, same_len=True)
    its = {}
    for side, mod in SIDES.items():
        if readers == "two readers":
            it = mod.SequenceRecordReaderDataSetIterator(
                mod.CollectionSequenceRecordReader(feats),
                mod.CollectionSequenceRecordReader(labels), 4, 3,
                alignment_mode=getattr(mod.AlignmentMode, mode.upper()))
        else:
            merged = [[r + l for r, l in zip(fs, ls)]
                      for fs, ls in zip(feats, labels)]
            it = mod.SequenceRecordReaderDataSetIterator(
                mod.CollectionSequenceRecordReader(merged), None, 4, 3,
                alignment_mode=getattr(mod.AlignmentMode, mode.upper()),
                label_index=3)
        its[side] = it
    got = same_batches(its["jax"], its["port"])
    assert (got[0].features_mask is None) == equal


@pytest.mark.parametrize("mode", ["align_start", "align_end"])
def test_sequence_regression_with_shorter_labels_equals_jax(mode):
    feats = sequences(seed=4)
    labels = [s[:max(1, len(s) - 2)] for s in sequences(seed=5, cols=2)]
    labels = [lab[:len(f)] for lab, f in zip(labels, feats)]
    its = {side: mod.SequenceRecordReaderDataSetIterator(
        mod.CollectionSequenceRecordReader(feats),
        mod.CollectionSequenceRecordReader(labels), 5, regression=True,
        alignment_mode=getattr(mod.AlignmentMode, mode.upper()))
        for side, mod in SIDES.items()}
    same_batches(its["jax"], its["port"])


def test_sequence_errors_equal_jax():
    feats = sequences()
    labels = label_sequences(feats)
    errors = []
    for mod in (jrec, prec):
        it = mod.SequenceRecordReaderDataSetIterator(
            mod.CollectionSequenceRecordReader(feats),
            mod.CollectionSequenceRecordReader(labels), 4, 3)
        with pytest.raises(ValueError) as exc:
            next(iter(it))
        errors.append(str(exc.value))
        with pytest.raises(ValueError, match="labels reader"):
            mod.SequenceRecordReaderDataSetIterator(
                mod.CollectionSequenceRecordReader(feats))
    assert errors[0] == errors[1]
    two_col = [[[0.0, 1.0]] * len(s) for s in feats]
    it = prec.SequenceRecordReaderDataSetIterator(
        prec.CollectionSequenceRecordReader(feats),
        prec.CollectionSequenceRecordReader(two_col), 4, 3,
        alignment_mode=prec.AlignmentMode.ALIGN_START)
    with pytest.raises(ValueError, match="one column"):
        next(iter(it))


def test_csv_sequence_reader_equals_jax(tmp_path):
    feats = sequences(n=5, cols=2)
    for i, s in enumerate(feats):
        (tmp_path / f"seq_{i}.csv").write_text(
            "x,y\n" + "".join(f"{a!r},{b!r}\n" for a, b in s))
    (tmp_path / ".hidden").write_text("ignored\n")
    readers = {side: mod.CSVSequenceRecordReader(1).initialize(
        str(tmp_path)) for side, mod in SIDES.items()}
    assert readers["port"]._seqs == readers["jax"]._seqs
    paths = sorted(str(p) for p in tmp_path.glob("seq_*.csv"))[:3]
    for mod in SIDES.values():
        readers[mod] = mod.CSVSequenceRecordReader(1).initialize(paths)
    assert readers[prec]._seqs == readers[jrec]._seqs
    its = {side: mod.SequenceRecordReaderDataSetIterator(
        mod.CSVSequenceRecordReader(1).initialize(str(tmp_path)), None, 2,
        regression=True, alignment_mode=mod.AlignmentMode.ALIGN_END,
        label_index=1) for side, mod in SIDES.items()}
    same_batches(its["jax"], its["port"])


def multi_iterator(mod, mode, batch=4):
    data = rows(n=10)
    feats = sequences(n=12, seed=6, equal=mode == "equal_length")
    labels = label_sequences(feats, seed=7)
    b = (mod.RecordReaderMultiDataSetIterator.Builder(batch)
         .add_reader("rec", mod.CollectionRecordReader(data))
         .add_sequence_reader("seq", mod.CollectionSequenceRecordReader(
             feats))
         .add_sequence_reader("lab", mod.CollectionSequenceRecordReader(
             labels))
         .sequence_alignment_mode(getattr(mod.AlignmentMode, mode.upper()))
         .add_input("rec", 0, 2).add_input("rec", 5)
         .add_input_one_hot("rec", 3, 4).add_input("seq")
         .add_output("seq", 1, 2).add_output_one_hot("lab", 0, 3)
         .add_output("rec", 4, 5))
    return b.build()


@pytest.mark.parametrize("mode", MODES)
def test_multi_iterator_equals_jax(mode):
    got = same_batches(multi_iterator(jrec, mode), multi_iterator(prec, mode))
    assert len(got) == 3                    # 10 records bound the pass
    assert (got[0].features_masks is None) == (mode == "equal_length")


def test_multi_iterator_preprocessor_and_builder_errors():
    class Double:
        def preprocess(self, mds):
            mds.features = [f * 2 for f in mds.features]

    its = {m: multi_iterator(m, "align_start") for m in (jrec, prec)}
    for it in its.values():
        it.set_preprocessor(Double())
    same_batches(its[jrec], its[prec])
    errors = {}
    for mod in (jrec, prec):
        B = mod.RecordReaderMultiDataSetIterator.Builder
        cases = [
            lambda: B(0),
            lambda: B(2).build(),
            lambda: B(2).add_reader("r", mod.CollectionRecordReader([]))
            .build(),
            lambda: B(2).add_reader("r", mod.CollectionRecordReader([]))
            .add_input("x").build(),
            lambda: B(2).sequence_alignment_mode("sideways"),
            lambda: B(2).add_input("r", -1, 3),
            lambda: B(2).add_input("r", 3, 1),
            lambda: B(2).add_reader("r", mod.CollectionRecordReader([]))
            .add_sequence_reader("r", mod.CollectionSequenceRecordReader(
                [])).add_input("r").build(),
        ]
        errors[mod] = []
        for case in cases:
            with pytest.raises(ValueError) as exc:
                case()
            errors[mod].append(str(exc.value))
    assert errors[prec] == errors[jrec]


# ----------------------------------------------------------- images
@pytest.fixture
def empty_dirs(tmp_path, monkeypatch):
    (tmp_path / "cifar").mkdir()
    (tmp_path / "lfw").mkdir()
    monkeypatch.setenv("CIFAR_DIR", str(tmp_path / "cifar"))
    monkeypatch.setenv("LFW_DIR", str(tmp_path / "lfw"))
    return tmp_path


@pytest.mark.parametrize("train", [True, False])
def test_procedural_cifar_bitwise(empty_dirs, train):
    for a, b in zip(jcifar.cifar_arrays_u8(train, 40, seed=3),
                    pcifar.cifar_arrays_u8(train, 40, seed=3)):
        same(a, b)
    for a, b in zip(jcifar.cifar_arrays(train, 12, seed=5),
                    pcifar.cifar_arrays(train, 12, seed=5)):
        same(a, b)
    jit = jcifar.CifarDataSetIterator(16, 40, train=train, seed=3)
    pit = pcifar.CifarDataSetIterator(16, 40, train=train, seed=3)
    for a, b in zip(list(jit) + list(jit), list(pit) + list(pit)):
        same(a.features, b.features)
        same(a.labels, b.labels)
        (ju8, jfmt), (pu8, pfmt) = a._wire, wire_of(b)
        same(ju8, pu8)
        assert pfmt is pnorm.U8_PIXEL and pfmt.denom == jfmt.denom == 255.0
        same(pfmt.decode_host(pu8), b.features)


def cifar_file(path, n, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    planes = rng.randint(0, 256, (n, 3, 32, 32)).astype(np.uint8)
    np.concatenate([labels[:, None], planes.reshape(n, -1)],
                   axis=1).tofile(path)
    return labels, planes


def test_cifar_binary_files_equal_jax(empty_dirs):
    d = empty_dirs / "cifar"
    labels, planes = cifar_file(d / "data_batch_1.bin", 5, 0)
    cifar_file(d / "data_batch_2.bin", 4, 1)
    cifar_file(d / "test_batch.bin", 3, 2)
    for a, b in zip(jcifar._read_cifar_bin(str(d / "data_batch_1.bin")),
                    pcifar._read_cifar_bin(str(d / "data_batch_1.bin"))):
        same(a, b)
    imgs, lbls = pcifar._read_cifar_bin_u8(str(d / "data_batch_1.bin"), 3)
    assert imgs.shape == (3, 32, 32, 3) and imgs.dtype == np.uint8
    assert np.array_equal(lbls, labels[:3])
    assert imgs[1, 5, 7, 2] == planes[1, 2, 5, 7]
    for train, num in ((True, 7), (True, 50), (False, 10)):
        for a, b in zip(jcifar.cifar_arrays(train, num),
                        pcifar.cifar_arrays(train, num)):
            same(a, b)


def test_procedural_lfw_bitwise(empty_dirs):
    for kw in (dict(num_examples=30, num_labels=5, image_shape=(20, 16, 1),
                    seed=4),
               dict(num_examples=12, num_labels=3, image_shape=(12, 12, 3),
                    seed=7, identity_seed=2)):
        a, b = jlfw.lfw_arrays(**kw), plfw.lfw_arrays(**kw)
        same(a[0], b[0])
        same(a[1], b[1])
        assert a[2] == b[2]
    for train in (True, False):
        jit = jlfw.LFWDataSetIterator(8, 20, (16, 16, 1), 4, train=train)
        pit = plfw.LFWDataSetIterator(8, 20, (16, 16, 1), 4, train=train)
        assert pit.get_labels() == jit.get_labels()
        same_batches(jit, pit)


def test_lfw_directory_tree_and_pnm_equal_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    for pid, person in enumerate(["alice", "bob", "carol"]):
        d = tmp_path / person
        d.mkdir()
        for k in range(3):
            gray = rng.randint(0, 256, (10, 8)).astype(np.uint8)
            (d / f"img{k}.pgm").write_bytes(
                b"P5\n# comment\n8 10\n255\n" + gray.tobytes())
        rgb = rng.randint(0, 256, (6, 5, 3)).astype(np.uint8)
        (d / "color.ppm").write_bytes(b"P6\n5 6\n255\n" + rgb.tobytes())
        np.save(d / "arr.npy", rng.randint(0, 256, (7, 7)).astype(np.uint8))
        (d / "notes.txt").write_text("skipped")
    monkeypatch.setenv("LFW_DIR", str(tmp_path))
    for kw in (dict(num_examples=20, image_shape=(10, 8, 1)),
               dict(num_examples=7, num_labels=2, image_shape=(6, 6, 3))):
        a, b = jlfw.lfw_arrays(**kw), plfw.lfw_arrays(**kw)
        same(a[0], b[0])
        same(a[1], b[1])
        assert a[2] == b[2]
    for name in ("alice/img0.pgm", "bob/color.ppm"):
        same(jlfw._read_pnm(str(tmp_path / name)),
             plfw._read_pnm(str(tmp_path / name)))
    (tmp_path / "bad.pgm").write_bytes(b"P2\n2 2\n255\n0 0 0 0")
    with pytest.raises(ValueError, match="Not a binary"):
        plfw._read_pnm(str(tmp_path / "bad.pgm"))
    (tmp_path / "deep.pgm").write_bytes(b"P5\n2 2\n65535\n" + bytes(8))
    with pytest.raises(ValueError, match="16-bit"):
        plfw._read_pnm(str(tmp_path / "deep.pgm"))


def test_curves_bitwise():
    for a, b in zip(jcurves.curves_arrays(15, seed=2),
                    pcurves.curves_arrays(15, seed=2)):
        same(a, b)
    for shuffle in (False, True):
        same_batches(jcurves.CurvesDataSetIterator(4, 10, shuffle=shuffle),
                     pcurves.CurvesDataSetIterator(4, 10, shuffle=shuffle))
