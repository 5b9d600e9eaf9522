"""The port's streaming pipeline, converters and sources
(``deeplearning4j_tpu_torch/streaming/``) on the CPU: the port twins of
every case of ``tests/test_streaming.py``, and the pipeline against the
JAX pipeline on the same weights (``set_flat_params`` of the JAX
network's vector): the same micro-batches give the same predictions,
padded rows included, and the same parameters after ``fit`` at rtol 2e-5
(atol 1e-7; float32 sums in another order).

Every wait is bounded: ``_wait`` gives up after a few seconds, every
``poll`` takes a timeout and every child process a deadline.
"""

import json
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.streaming import (
    CsvRecordConverter as JaxCsv, DictRecordConverter as JaxDict,
    InMemoryRecordSource as JaxMemory, StreamingPipeline as JaxPipeline)
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.streaming import (CsvRecordConverter,
                                                DictRecordConverter,
                                                FileTailRecordSource,
                                                InMemoryRecordSource,
                                                SocketRecordSource,
                                                StreamingPipeline)

RTOL, ATOL = 2e-5, 1e-7
CPU = "cpu"


def _jconf(n_in=4, n_classes=3, seed=7):
    return (JaxConf.builder().seed(seed).updater("sgd").learning_rate(0.2)
            .activation("tanh").weight_init("xavier").list()
            .layer(jcore.DenseLayer(n_out=8))
            .layer(jcore.OutputLayer(n_out=n_classes))
            .set_input_type(jin.feed_forward(n_in)).build())


def _pair(n_in=4, n_classes=3):
    """A JAX network and the port's on the JAX weights."""
    conf = _jconf(n_in, n_classes)
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device=CPU).init()
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _net(n_in=4, n_classes=3):
    return _pair(n_in, n_classes)[1]


def _pipe(net, src, conv, **kw):
    return StreamingPipeline(net, src, conv, device=CPU, **kw)


def _wait(predicate, timeout=8.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


# ------------------------------------------------------------- converters

def test_csv_converter_labeled_and_unlabeled():
    c = CsvRecordConverter(label_index=-1, num_classes=3)
    f, l = c.convert("0.5, 1.0, -2.0, 2")
    np.testing.assert_allclose(f, [0.5, 1.0, -2.0])
    np.testing.assert_array_equal(l, [0, 0, 1])
    f, l = CsvRecordConverter(label_index=None).convert("1,2,3")
    assert l is None and f.shape == (3,)


def test_csv_converter_requires_num_classes():
    with pytest.raises(ValueError):
        CsvRecordConverter(label_index=0)


def test_dict_converter_json_strings():
    c = DictRecordConverter(num_classes=2)
    f, l = c.convert(json.dumps({"features": [1, 2], "label": 1}))
    np.testing.assert_array_equal(l, [0, 1])
    assert c.convert({"features": [3, 4]})[1] is None


def test_csv_converter_rejects_out_of_range_label_index():
    with pytest.raises(ValueError, match="out of range"):
        CsvRecordConverter(label_index=5, num_classes=2).convert("1,2,3,0")
    with pytest.raises(ValueError):
        CsvRecordConverter(label_index=-1, num_classes=2).convert("1,2,-1")


@pytest.mark.parametrize("record", [
    "0.5, 1.0, -2.0, 2", "3,1,4,1", "1e-3,-7.25,0,0"])
def test_converters_give_the_jax_rows(record):
    for label_index in (-1, 0, None):
        kw = {} if label_index is None else {"num_classes": 5}
        want = JaxCsv(label_index=label_index, **kw).convert(record)
        got = CsvRecordConverter(label_index=label_index,
                                 **kw).convert(record)
        for w, g in zip(want, got):
            assert (w is None and g is None) or (
                w.dtype == g.dtype and np.array_equal(w, g))
    rec = {"features": [float(v) for v in record.split(",")], "label": 1}
    for w, g in zip(JaxDict(num_classes=3).convert(json.dumps(rec)),
                    DictRecordConverter(num_classes=3).convert(
                        json.dumps(rec))):
        assert w.dtype == g.dtype and np.array_equal(w, g)


# ---------------------------------------------------------------- sources

def test_file_tail_source_follows_appends(tmp_path):
    path = str(tmp_path / "stream.csv")
    open(path, "w").write("1,2\n")
    src = FileTailRecordSource(path)
    assert src.poll(timeout=1.0) == "1,2"
    assert src.poll(timeout=0.1) is None
    with open(path, "a") as f:
        f.write("3,4\n")
    assert src.poll(timeout=1.0) == "3,4"
    src.close()


def test_file_tail_multibyte_partial_line(tmp_path):
    path = str(tmp_path / "s.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("café,1")
    src = FileTailRecordSource(path)
    assert src.poll(timeout=0.1) is None
    with open(path, "a", encoding="utf-8") as f:
        f.write("\ncafé,2\n")
    assert src.poll(timeout=1.0) == "café,1"
    assert src.poll(timeout=1.0) == "café,2"
    src.close()


def test_socket_source_receives_lines():
    src = SocketRecordSource(port=0)
    try:
        SocketRecordSource.send(src.host, src.port, ["a,b", "c,d"])
        assert src.poll(timeout=2.0) == "a,b"
        assert src.poll(timeout=2.0) == "c,d"
    finally:
        src.close()
    assert not src._thread.is_alive()


# --------------------------------------------------------------- pipeline

def _rows(n, n_in=4, seed=0, labels=None):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        row = ",".join(f"{v:.4f}" for v in rng.randn(n_in))
        out.append(row if labels is None else f"{row},{i % labels}")
    return out


def test_pipeline_online_predictions():
    net = _net()
    src = InMemoryRecordSource()
    preds = []
    pipe = _pipe(net, src, CsvRecordConverter(label_index=None),
                 mode="predict", batch_size=4, flush_interval=0.1,
                 on_prediction=lambda x, out: preds.append((x, out)))
    with pipe:
        src.offer_all(_rows(10))
        assert _wait(lambda: pipe.records_processed >= 10)
        assert _wait(lambda: sum(len(p[1]) for p in preds) >= 10)
    assert sum(len(p[1]) for p in preds) == 10   # no padded row leaks
    for x, out in preds:
        assert isinstance(out, np.ndarray) and out.shape[1] == 3
        np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-4)
    assert not pipe.errors


def test_pipeline_online_fit_learns():
    net = _net(n_in=2, n_classes=2)
    src = InMemoryRecordSource()
    pipe = _pipe(net, src, CsvRecordConverter(label_index=-1, num_classes=2),
                 mode="fit", batch_size=16, flush_interval=0.1)
    rng = np.random.RandomState(3)
    X = rng.randn(400, 2)
    y = (X[:, 0] > 0).astype(int)
    probe = DataSet(X[:100].astype(np.float32),
                    np.eye(2, dtype=np.float32)[y[:100]])
    before = float(net.score(probe))
    with pipe:
        src.offer_all([f"{a:.4f},{b:.4f},{int(c)}"
                       for (a, b), c in zip(X, y)])
        assert _wait(lambda: pipe.records_processed >= 400)
        assert _wait(lambda: pipe.batches_processed >= 20)
    assert float(net.score(probe)) < before * 0.8
    assert not pipe.errors


def test_pipeline_socket_end_to_end():
    net = _net(n_in=2, n_classes=2)
    src = SocketRecordSource(port=0)
    outs = []
    pipe = _pipe(net, src, DictRecordConverter(num_classes=2),
                 mode="predict", batch_size=2, flush_interval=0.1,
                 on_prediction=lambda x, o: outs.append(o))
    with pipe:
        SocketRecordSource.send(src.host, src.port, [
            json.dumps({"features": [0.1 * i, 0.2 * i]}) for i in range(3)])
        assert _wait(lambda: sum(map(len, outs)) >= 3)
    src.close()
    assert not pipe.errors


def test_pipeline_poison_records_counted_not_fatal():
    monitor.reset()
    net = _net()
    src = InMemoryRecordSource()
    pipe = _pipe(net, src, CsvRecordConverter(label_index=None),
                 mode="predict", batch_size=2, flush_interval=0.05)
    with pipe:
        src.offer("not,a,number,row,xyz")
        src.offer("0.1,0.2,0.3,0.4")
        src.offer("0.5,0.6,0.7,0.8")
        assert _wait(lambda: pipe.records_processed >= 2)
    assert len(pipe.errors) == 1 and pipe.records_processed == 2
    assert monitor.counter("streaming_errors_total").value(
        reason="convert") == 1
    assert monitor.counter("streaming_records_total").value() == 2


def test_pipeline_callback_error_does_not_cancel_fit():
    net = _net(n_in=2, n_classes=2)
    src = InMemoryRecordSource()

    def bad_callback(x, out):
        raise RuntimeError("callback boom")

    pipe = _pipe(net, src, CsvRecordConverter(label_index=-1, num_classes=2),
                 mode="both", batch_size=4, flush_interval=0.05,
                 on_prediction=bad_callback)
    with pipe:
        src.offer_all([f"{i*0.1:.2f},{i*0.2:.2f},{i%2}" for i in range(8)])
        assert _wait(lambda: pipe.batches_processed >= 2)
    assert len(pipe.errors) >= 2 and pipe.batches_processed >= 2


def test_pipeline_rejects_bad_mode():
    with pytest.raises(ValueError):
        _pipe(_net(), InMemoryRecordSource(),
              CsvRecordConverter(label_index=None), mode="stream")


def test_pipeline_refuses_a_network_on_another_device():
    class OnTheCard:
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="lives on"):
        StreamingPipeline(OnTheCard(), InMemoryRecordSource(),
                          CsvRecordConverter(label_index=None),
                          device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        StreamingPipeline(_net(), InMemoryRecordSource(),
                          CsvRecordConverter(label_index=None),
                          device="mps")


def test_pipeline_fit_from_child_process_socket():
    net = _net(n_in=2, n_classes=2)
    src = SocketRecordSource(port=0)
    pipe = _pipe(net, src, CsvRecordConverter(label_index=-1, num_classes=2),
                 mode="fit", batch_size=16, flush_interval=0.1)
    rng = np.random.RandomState(5)
    X = rng.randn(100, 2)
    y = (X[:, 0] > 0).astype(int)
    probe = DataSet(X.astype(np.float32), np.eye(2, dtype=np.float32)[y])
    before = float(net.score(probe))
    feeder = textwrap.dedent("""
        import socket, sys
        import numpy as np
        host, port = sys.argv[1], int(sys.argv[2])
        rng = np.random.RandomState(6)
        X = rng.randn(400, 2)
        y = (X[:, 0] > 0).astype(int)
        with socket.create_connection((host, port), timeout=10) as s:
            for (a, b), c in zip(X, y):
                s.sendall(f"{a:.4f},{b:.4f},{int(c)}\\n".encode())
        print("fed")
    """)
    with pipe:
        proc = subprocess.Popen(
            [sys.executable, "-c", feeder, src.host, str(src.port)],
            stdout=subprocess.PIPE, text=True)
        out, _ = proc.communicate(timeout=60)
        assert "fed" in out
        assert _wait(lambda: pipe.records_processed >= 400, timeout=60)
    src.close()
    assert float(net.score(probe)) < before * 0.8
    assert not pipe.errors


def test_pipeline_predict_from_child_process_file_tail(tmp_path):
    path = str(tmp_path / "stream.csv")
    open(path, "w").close()
    net = _net(n_in=2, n_classes=2)
    src = FileTailRecordSource(path)
    outs = []
    pipe = _pipe(net, src, CsvRecordConverter(label_index=None),
                 mode="predict", batch_size=4, flush_interval=0.1,
                 on_prediction=lambda x, o: outs.append(o))
    writer = textwrap.dedent("""
        import sys, time
        import numpy as np
        rng = np.random.RandomState(7)
        with open(sys.argv[1], "a") as f:
            for i in range(20):
                a, b = rng.randn(2)
                f.write(f"{a:.4f},{b:.4f}\\n")
                f.flush()
                if i % 5 == 4:
                    time.sleep(0.05)
        print("wrote")
    """)
    with pipe:
        proc = subprocess.Popen([sys.executable, "-c", writer, path],
                                stdout=subprocess.PIPE, text=True)
        out, _ = proc.communicate(timeout=60)
        assert "wrote" in out
        assert _wait(lambda: sum(map(len, outs)) >= 20, timeout=60)
    src.close()
    assert sum(map(len, outs)) == 20 and not pipe.errors


# ----------------------------------------------------- against the JAX one

def _run(make, net, src, rows, n_batches, **kw):
    """Offer every row before the pipeline starts and let only full
    micro-batches close while it runs (a flush interval far longer than
    the run; a slow batch would otherwise let a stale partial one close
    after it), then stop it, which processes the tail: each micro-batch
    holds the same rows in both packages."""
    outs = []
    src.offer_all(rows)
    pipe = make(net, src, on_prediction=lambda x, o: outs.append(
        (np.array(x), np.array(o))), flush_interval=300.0, **kw)
    with pipe:
        assert _wait(lambda: pipe.records_processed == len(rows)
                     and pipe.batches_processed == n_batches - 1)
    assert not pipe.errors and pipe.batches_processed == n_batches
    return outs


@pytest.mark.parametrize("mode", ["predict", "fit", "both"])
def test_pipeline_matches_the_jax_pipeline(mode):
    """20 labelled records at batch 8: two full micro-batches and a tail
    of 4 (padded with its last row to predict, cycled to 8 to fit).  The
    predictions of each micro-batch and the parameters after the fits
    equal the JAX pipeline's."""
    jnet, pnet = _pair()
    rows = _rows(20, labels=3, seed=4)
    kw = dict(mode=mode, batch_size=8)
    want = _run(lambda n, s, **k: JaxPipeline(
        n, s, JaxCsv(label_index=-1, num_classes=3), **k),
        jnet, JaxMemory(), rows, 3, **kw)
    got = _run(lambda n, s, **k: StreamingPipeline(
        n, s, CsvRecordConverter(label_index=-1, num_classes=3),
        device=CPU, **k), pnet, InMemoryRecordSource(), rows, 3, **kw)
    assert len(got) == len(want) == (0 if mode == "fit" else 3)
    for (jx, jo), (px, po) in zip(want, got):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_allclose(po, jo, rtol=RTOL, atol=ATOL)
    assert [len(o) for _, o in got] == ([8, 8, 4] if got else [])
    np.testing.assert_allclose(pnet.get_flat_params(),
                               np.asarray(jnet.get_flat_params()),
                               rtol=RTOL, atol=ATOL)
    if mode != "predict":
        assert pnet.iteration == jnet.iteration == 3


def test_pipeline_batches_are_net_output_and_fit_on_the_same_rows():
    """Each micro-batch's predictions are ``net.output`` on the padded
    rows, and the trained params are a plain ``fit`` of the same
    micro-batches in the same order (bitwise)."""
    _, pnet = _pair()
    _, twin = _pair()
    rows = _rows(20, labels=3, seed=8)
    outs = _run(lambda n, s, **k: StreamingPipeline(
        n, s, CsvRecordConverter(label_index=-1, num_classes=3),
        device=CPU, **k), pnet, InMemoryRecordSource(), rows, 3,
        mode="both", batch_size=8)
    conv = CsvRecordConverter(label_index=-1, num_classes=3)
    conv_rows = [conv.convert(r) for r in rows]
    for b, (x, out) in enumerate(outs):
        chunk = conv_rows[8 * b:8 * b + 8]
        xs = np.stack([f for f, _ in chunk])
        ys = np.stack([l for _, l in chunk])
        padded = np.concatenate([xs, np.repeat(xs[-1:], 8 - len(xs), 0)])
        np.testing.assert_array_equal(
            out, twin.output(padded).numpy()[:len(xs)])
        idx = np.arange(8) % len(xs)
        twin.fit(DataSet(xs[idx], ys[idx]))
    np.testing.assert_array_equal(pnet.get_flat_params(),
                                  twin.get_flat_params())


def test_pipeline_span_and_batch_histogram():
    monitor.reset()
    net = _net()
    outs = _run(lambda n, s, **k: _pipe(
        n, s, CsvRecordConverter(label_index=None), **k), net,
        InMemoryRecordSource(), _rows(10), 3, mode="predict",
        batch_size=4)
    assert len(outs) == 3
    spans = monitor.tracer().events(name="streaming/batch")
    assert [e["attrs"] for e in spans] == [{"records": n} for n in (4, 4, 2)]
    assert monitor.counter("streaming_batches_total").value() == 3
    assert monitor.registry().histogram("streaming_batch_ms").stats()[
        "count"] == 3


def test_pipeline_thread_is_joined_on_stop():
    pipe = _pipe(_net(), InMemoryRecordSource(),
                 CsvRecordConverter(label_index=None))
    pipe.start()
    thread = pipe._thread
    pipe.stop(timeout=5.0)
    assert not thread.is_alive() and pipe._thread is None
    assert not [t for t in threading.enumerate() if t is thread]
