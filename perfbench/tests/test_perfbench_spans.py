"""The readers of the program's spans (``perfbench/spans.py``, the
``*_ms.stream`` and ``worker_host_ms.serve`` metrics) on synthetic rings:
each reads only the traced ``fit`` call's or the traced stretch's spans,
and returns None where there is nothing to read."""

import numpy as np
import pytest

from perfbench import run, spans

STREAM = {"iterator_ms.stream": "fit/iterator",
          "stage_ms.stream": "fit/stage",
          "dispatch_ms.stream": "fit/dispatch"}


def reader(metric):
    return run.load_module(run.HERE / "metrics" / f"{metric}.py", metric)


def ev(name, ident, parent, dur_ms, ts=0.0):
    return {"name": name, "id": ident, "parent": parent, "dur_ms": dur_ms,
            "ts": ts}


def fit_ring():
    """Two ``fit`` calls: the older one's children are ten times longer,
    and a span of another name sits under the newer one."""
    out = []
    for call, scale in ((1, 10.0), (2, 1.0)):
        top = 100 * call
        for k, name in enumerate(STREAM.values()):
            out += [ev(name, top + 10 * k + j, top, scale * (k + 1))
                    for j in range(2)]
        out.append(ev("fit/other", top + 99, top, 1e6))
        out.append(ev("fit/epoch", top, None, 1e6))
    return out


@pytest.mark.parametrize("metric,name", sorted(STREAM.items()))
def test_fit_readers_read_only_the_traced_call(metric, name, monkeypatch):
    events = fit_ring()
    out = {"trace": {"window_s": 1.0}, "readings": {"steps": 4}}
    k = list(STREAM.values()).index(name)
    assert spans.fit_child_ms(out, name, events) == 2 * (k + 1) / 4
    monkeypatch.setattr(spans, "ring", lambda: events)
    assert reader(metric).read(out) == 2 * (k + 1) / 4


@pytest.mark.parametrize("metric", sorted(STREAM))
def test_fit_readers_without_anything_to_read(metric, monkeypatch):
    out = {"trace": {"window_s": 1.0}, "readings": {"steps": 4}}
    # a program whose fit records only fit/epoch
    monkeypatch.setattr(spans, "ring",
                        lambda: [ev("fit/epoch", 1, None, 5.0)])
    assert reader(metric).read(out) is None
    monkeypatch.setattr(spans, "ring", lambda: [])
    assert reader(metric).read(out) is None
    monkeypatch.setattr(spans, "ring", fit_ring)
    assert reader(metric).read(dict(out, trace=None)) is None
    assert reader(metric).read(dict(out, readings={})) is None


def serve_ring():
    """Batches every 0.1 s from t=0 to t=2.0, each with its assemble and
    resolve (and a long forward, which is not read); requests up to
    t=2.0, the newest at 2.0.  The batch that starts then is held up by
    the profiler's stop: its assemble takes 2 s."""
    out = []
    for i in range(21):
        t, b = 0.1 * i, 1000 + i
        held = 2000.0 if i == 20 else 0.0
        out.append(ev("serve/request", 5000 + i, None, 9.0, t))
        out.append(ev("serve/assemble", 2000 + i, b, 1.0 + i + held, t))
        out.append(ev("serve/forward", 3000 + i, b, 50.0,
                      t + 0.001 + held / 1e3))
        out.append(ev("serve/resolve", 4000 + i, b, 0.5,
                      t + 0.05 + held / 1e3))
        out.append(ev("serve/batch", b, None, 60.0, t))
    return out


def test_worker_reader_reads_only_the_stretch(monkeypatch):
    events = serve_ring()
    out = {"trace": {"window_s": 0.55}, "readings": {}}
    # the batches at t=1.5 ... 1.9: assemble 16 ... 20 ms, resolve 0.5 ms;
    # the one at 2.0 ends after the newest request's start
    want = float(np.mean([1.0 + i + 0.5 for i in range(15, 20)]))
    assert spans.worker_host_ms(out, events) == pytest.approx(want)
    monkeypatch.setattr(spans, "ring", lambda: events)
    assert reader("worker_host_ms.serve").read(out) == pytest.approx(want)


def test_worker_reader_without_anything_to_read(monkeypatch):
    out = {"trace": {"window_s": 1.0}, "readings": {}}
    r = reader("worker_host_ms.serve")
    # a program that records the requests but no worker spans
    old = [e for e in serve_ring() if e["name"] in
           ("serve/request", "serve/queue_wait", "serve/batch")]
    monkeypatch.setattr(spans, "ring", lambda: old)
    assert r.read(out) is None
    monkeypatch.setattr(spans, "ring", lambda: [])
    assert r.read(out) is None
    monkeypatch.setattr(spans, "ring", serve_ring)
    assert r.read(dict(out, trace=None)) is None


def test_fit_readers_on_the_programs_own_spans():
    """A small windowed fit on the CPU: every reader of the stream cell
    finds its spans, and they add up to most of the call."""
    import torch
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import core
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    torch.manual_seed(0)
    conf = (NeuralNetConfiguration.builder().seed(3).updater("sgd")
            .learning_rate(0.1).list()
            .layer(core.DenseLayer(n_out=8))
            .layer(core.OutputLayer(n_out=3))
            .set_input_type(inputs.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.RandomState(0)
    x = rng.randn(96, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 96)]
    monitor.tracer().clear()
    net.fit(ListDataSetIterator(DataSet(x, y), 32), ingest="window",
            window=2)
    out = {"trace": {"window_s": 1.0}, "readings": {"steps": 3}}
    got = {m: reader(m).read(out) for m in STREAM}
    assert all(v is not None and v > 0 for v in got.values())
    (epoch,) = monitor.tracer().events(name="fit/epoch")
    kids = sum(e["dur_ms"] for e in monitor.tracer().events()
               if e["parent"] == epoch["id"])
    assert kids <= epoch["dur_ms"]
