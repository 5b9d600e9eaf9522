"""Evaluation in the port (``eval/`` and ``MultiLayerNetwork.do_evaluation``)
against the JAX package: every metric and ``stats()`` of Evaluation, ROC,
ROCMultiClass and RegressionEvaluation on the same arrays; a small LeNet
trained on the procedural MNIST gives the same confusion matrix on the same
weights (ROADMAP A4's acceptance); a masked GravesLSTM time-series
evaluation agrees; the top-1 route moves int32 indices only.

Tolerances: metrics of the same arrays exactly (the same numpy code on
the same inputs).  Network evaluations: counts and confusion matrices
exactly; ROC and regression statistics, which read float32 probabilities
of the two packages, 1e-5 relative (f32 sums in another order), and the
correlation (in [-1, 1], a difference of sums that cancel) 1e-5 absolute.
"""

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JaxList
from deeplearning4j_tpu.datasets.mnist import \
    MnistDataSetIterator as JaxMnist
from deeplearning4j_tpu.eval import evaluation as jev
from deeplearning4j_tpu.eval import regression as jreg
from deeplearning4j_tpu.eval import roc as jroc
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import convolution as jconvl
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch import monitor as pmonitor
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
from deeplearning4j_tpu_torch.eval import evaluation as pev
from deeplearning4j_tpu_torch.eval import regression as preg
from deeplearning4j_tpu_torch.eval import roc as proc
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_idx_files(monkeypatch, tmp_path):
    monkeypatch.setenv("MNIST_DIR", str(tmp_path / "no_mnist"))


def _pair(conf):
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _probs(rng, n, c):
    z = rng.randn(n, c)
    return (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)


def _onehot(rng, n, c):
    return np.eye(c, dtype=np.float32)[rng.randint(0, c, n)]


# ------------------------------------------------------- metrics on arrays
def _evaluation_metrics(ev):
    c = ev.num_classes
    out = {"accuracy": ev.accuracy(), "precision": ev.precision(),
           "recall": ev.recall(), "f1": ev.f1(),
           "fpr": ev.false_positive_rate(), "fnr": ev.false_negative_rate(),
           "false_alarm": ev.false_alarm_rate(),
           "top_n": ev.top_n_accuracy(), "stats": ev.stats(),
           "matrix": ev.confusion.matrix.tolist()}
    for k in range(c):
        out[f"class{k}"] = (ev.precision(k), ev.recall(k), ev.f1(k),
                            ev.false_positive_rate(k),
                            ev.false_negative_rate(k))
    return out


def _fill_evaluation(mod, top_n, names):
    rng = np.random.RandomState(1)
    ev = mod.Evaluation(label_names=names, top_n=top_n)
    for _ in range(3):
        ev.eval(_onehot(rng, 20, 4), _probs(rng, 20, 4))
    seq = _onehot(rng, 18, 4).reshape(3, 6, 4)
    mask = (rng.rand(3, 6) > 0.3).astype(np.float32)
    ev.eval_time_series(seq, _probs(rng, 18, 4).reshape(3, 6, 4), mask)
    other = mod.Evaluation(top_n=top_n)
    other.eval(_onehot(rng, 9, 4), _probs(rng, 9, 4))
    ev.merge(other)
    if top_n == 1:
        ev.eval_class_indices(rng.randint(0, 4, 7), rng.randint(0, 4, 7), 4)
    else:
        with pytest.raises(ValueError, match="top-N"):
            ev.eval_class_indices([0], [1], 4)
    meta = mod.Evaluation(top_n=top_n)
    meta.eval(_onehot(rng, 5, 4), _probs(rng, 5, 4),
              record_meta_data=[f"row{i}" for i in range(5)])
    errors = [(p.actual, p.predicted, p.record_meta_data)
              for p in meta.get_prediction_errors()]
    return ev, errors


@pytest.mark.parametrize("top_n,names", [(1, None),
                                         (2, ["a", "b", "c", "d"])])
def test_evaluation_metrics_and_stats_match(top_n, names):
    (p, perr), (j, jerr) = (_fill_evaluation(pev, top_n, names),
                            _fill_evaluation(jev, top_n, names))
    assert _evaluation_metrics(p) == _evaluation_metrics(j)
    assert perr == jerr


def _fill_roc(mod, kind):
    rng = np.random.RandomState(2)
    if kind == "binary":
        roc = mod.ROC(20)
        for _ in range(2):
            labels = _onehot(rng, 30, 2)
            roc.eval(labels, np.clip(labels * 0.4 + _probs(rng, 30, 2) * 0.6,
                                     0, 1))
        roc.eval(rng.randint(0, 2, (10, 1)).astype(np.float32),
                 rng.rand(10, 1).astype(np.float32))
        seq = _onehot(rng, 12, 2).reshape(2, 6, 2)
        roc.eval_time_series(seq, _probs(rng, 12, 2).reshape(2, 6, 2),
                             (rng.rand(2, 6) > 0.4).astype(np.float32))
        return {"auc": roc.calculate_auc(), "curve": roc.get_roc_curve(),
                "pr": roc.get_precision_recall_curve()}
    roc = mod.ROCMultiClass(15)
    for _ in range(2):
        roc.eval(_onehot(rng, 25, 3), _probs(rng, 25, 3))
    other = mod.ROCMultiClass(15)
    other.eval(_onehot(rng, 5, 3), _probs(rng, 5, 3))
    roc.merge(other)
    return {"avg": roc.calculate_average_auc(),
            "per_class": [(roc.calculate_auc(k), roc.get_roc_curve(k))
                          for k in range(3)]}


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_roc_metrics_match(kind):
    assert _fill_roc(proc, kind) == _fill_roc(jroc, kind)


def _fill_regression(mod):
    rng = np.random.RandomState(3)
    ev = mod.RegressionEvaluation(["x", "y", "z"])
    for _ in range(2):
        labels = rng.randn(16, 3).astype(np.float32)
        ev.eval(labels, labels + 0.3 * rng.randn(16, 3).astype(np.float32))
    ev.eval_time_series(rng.randn(2, 5, 3).astype(np.float32),
                        rng.randn(2, 5, 3).astype(np.float32),
                        (rng.rand(2, 5) > 0.5).astype(np.float32))
    other = mod.RegressionEvaluation()
    other.eval(rng.randn(4, 3), rng.randn(4, 3))
    ev.merge(other)
    cols = [(ev.mean_squared_error(k), ev.mean_absolute_error(k),
             ev.root_mean_squared_error(k), ev.correlation_r2(k),
             ev.r_squared(k), ev.relative_squared_error(k))
            for k in range(ev.num_columns())]
    return cols, ev.stats()


def test_regression_metrics_and_stats_match():
    assert _fill_regression(preg) == _fill_regression(jreg)


# ------------------------------------------------------ network evaluation
def _small_lenet():
    """LeNet's layers at narrow widths (4 and 8 filters, dense 32) on the
    28 x 28 MNIST input, adam 1e-3 as in models/lenet.py."""
    return (JaxConf.builder().seed(123).updater("adam").learning_rate(1e-3)
            .weight_init("xavier").activation("identity").list()
            .layer(jconvl.ConvolutionLayer(n_out=4, kernel_size=(5, 5)))
            .layer(jconvl.SubsamplingLayer(pooling_type="max"))
            .layer(jconvl.ConvolutionLayer(n_out=8, kernel_size=(5, 5)))
            .layer(jconvl.SubsamplingLayer(pooling_type="max"))
            .layer(jcore.DenseLayer(n_out=32, activation="relu"))
            .layer(jcore.OutputLayer(n_out=10, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(jin.convolutional_flat(28, 28, 1)).build())


def test_small_lenet_gives_the_same_confusion_matrix():
    """One epoch on 256 procedural MNIST examples in both packages (the
    same batches), then ``evaluate`` on 256 test examples: the same
    confusion matrix and ``stats()``; 1,024 bytes of int32 indices moved."""
    jnet, pnet = _pair(_small_lenet())
    jnet.fit(JaxMnist(32, 256), ingest="batch")
    pnet.fit(MnistDataSetIterator(32, 256), ingest="batch")
    ev = pnet.evaluate(MnistDataSetIterator(64, 256, train=False))
    jev_ = jnet.evaluate(JaxMnist(64, 256, train=False))
    np.testing.assert_array_equal(ev.confusion.matrix, jev_.confusion.matrix)
    assert ev.stats() == jev_.stats()
    assert ev.confusion.matrix.sum() == 256
    gauge = pmonitor.registry().get("eval_bytes_transferred")
    assert gauge.value(path="indices") == 256 * 4 == \
        jmonitor.registry().get("eval_bytes_transferred").value(
            path="indices")
    assert pnet.f1_score(MnistDataSetIterator(64, 256, train=False)) == \
        jnet.f1_score(JaxMnist(64, 256, train=False))


def _masked_lstm():
    return (JaxConf.builder().seed(7).activation("tanh").list()
            .layer(jrec.GravesLSTM(n_out=6))
            .layer(jrec.RnnOutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(jin.recurrent(4)).build())


def _sequences(seed=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(10, 7, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (10, 7))]
    m = np.ones((10, 7), np.float32)
    for i, n in enumerate(rng.randint(2, 8, 10)):
        m[i, n:] = 0
    return x, y, m


@pytest.mark.parametrize("evaluator", ["evaluate", "evaluate_regression",
                                       "evaluate_roc_multi_class"])
def test_masked_lstm_time_series_evaluation_matches(evaluator):
    """Per-timestep outputs with a features mask: the top-1 route filters
    the masked steps on the host, the others go through
    ``eval_time_series``."""
    jnet, pnet = _pair(_masked_lstm())
    x, y, m = _sequences()
    got = getattr(pnet, evaluator)(
        ListDataSetIterator(DataSet(x, y, m), 4))
    want = getattr(jnet, evaluator)(JaxList(JaxDataSet(x, y, m), 4))
    if evaluator == "evaluate":
        np.testing.assert_array_equal(got.confusion.matrix,
                                      want.confusion.matrix)
        assert got.confusion.matrix.sum() == m.sum()
    elif evaluator == "evaluate_regression":
        for k in range(3):
            np.testing.assert_allclose(got.mean_squared_error(k),
                                       want.mean_squared_error(k), rtol=RTOL)
            np.testing.assert_allclose(got.correlation_r2(k),
                                       want.correlation_r2(k), rtol=0,
                                       atol=RTOL)
    else:
        np.testing.assert_allclose(
            [got.calculate_auc(k) for k in range(3)],
            [want.calculate_auc(k) for k in range(3)], rtol=RTOL)


def _iris_like():
    rng = np.random.RandomState(4)
    x = rng.randn(40, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 0] + 0.3 * x[:, 1] > 0) * 1]
    conf = (JaxConf.builder().seed(3).activation("tanh").list()
            .layer(jcore.DenseLayer(n_out=5))
            .layer(jcore.OutputLayer(n_out=2, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(jin.feed_forward(4)).build())
    return conf, x, y


def test_roc_and_several_evaluators_in_one_pass_match():
    """``evaluate_roc``, and ``do_evaluation`` with a top-3 Evaluation
    beside a plain one: the logits route (probabilities to the host), its
    bytes counted."""
    conf, x, y = _iris_like()
    jnet, pnet = _pair(conf)
    got = pnet.evaluate_roc(ListDataSetIterator(DataSet(x, y), 16))
    want = jnet.evaluate_roc(JaxList(JaxDataSet(x, y), 16))
    np.testing.assert_allclose(got.calculate_auc(), want.calculate_auc(),
                               rtol=RTOL)
    pe = pnet.do_evaluation(DataSet(x, y), pev.Evaluation(),
                            pev.Evaluation(top_n=2))
    je = jnet.do_evaluation(JaxDataSet(x, y), jev.Evaluation(),
                            jev.Evaluation(top_n=2))
    for a, b in zip(pe, je):
        np.testing.assert_array_equal(a.confusion.matrix,
                                      b.confusion.matrix)
        assert a.top_n_accuracy() == b.top_n_accuracy()
    gauge = pmonitor.registry().get("eval_bytes_transferred")
    assert gauge.value(path="logits") == 40 * 2 * 4
