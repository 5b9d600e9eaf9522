"""The port's spans inside ``fit``'s window and cache loops and their
place in the device trace.

- A live ``monitor.span`` opened on the thread that runs
  ``perfbench/trace.py``'s ``Profiler`` is a host event of the trace
  that encloses its ops; with the profiler off (or on another thread) no
  profiler range is entered.
- The windowed ``fit`` emits ``fit/iterator`` (one per call of the
  iterator, the one that ends the epoch too), ``fit/stage``, ``fit/copy``
  and ``fit/dispatch`` (one per window), the cache path ``fit/dispatch``
  (one per dispatch), and both ``fit/listeners`` (one per epoch with a
  listener), all children of their ``fit/epoch`` span, in both containers.
- The ``phase_data_ms``, ``phase_step_ms`` and ``phase_listener_ms``
  histograms of those paths count what the JAX package's count on the
  same data.
"""

import threading

import pytest
import torch

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JaxList
from deeplearning4j_tpu.optimize.listeners.listeners import \
    ScoreIterationListener as JaxScoreListener
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.monitor import tracing
from deeplearning4j_tpu_torch.optimize.listeners.listeners import \
    ScoreIterationListener
from perfbench.trace import Profiler
from test_torch_training_spans import _data, _pair

PHASES = ("data", "step", "listener")
KIDS = ("fit/iterator", "fit/stage", "fit/copy", "fit/dispatch",
        "fit/listeners")


@pytest.fixture(autouse=True)
def _isolated():
    monitor.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    jmonitor.reset()


class _Counting:
    """The tracer's profiler range, counting the ranges entered."""

    def __init__(self, real):
        self.real = real
        self.names = []

    def __call__(self, name):
        self.names.append(name)
        return self.real(name)


def _host(prof):
    return [(e.name(), e.start_ns(), e.end_ns(), e.activity_type())
            for e in prof.result.events()]


def test_a_span_is_a_host_event_that_encloses_its_ops():
    """The span's range is an op of the host's timeline, not a user
    annotation: the profiler copies those onto the device's timeline,
    where the trace's readers would count them as device work."""
    with Profiler() as prof:
        with monitor.span("outer/work"):
            torch.ones(64).mul(2.0)
    host = _host(prof)
    (outer,) = [e for e in host if e[0] == "outer/work"]
    assert outer[3] == "cpu_op"
    ops = [e for e in host if e[0] == "aten::mul"]
    assert ops
    assert all(outer[1] <= a and b <= outer[2] for _, a, b, _ in ops)
    (ev,) = monitor.tracer().events(name="outer/work")
    assert ev["dur_ms"] >= 0


def test_no_range_is_entered_with_the_profiler_off(monkeypatch):
    rf = _Counting(tracing._range)
    monkeypatch.setattr(tracing, "_range", rf)
    for _ in range(5):
        with monitor.span("off"):
            pass
    assert rf.names == []
    assert len(monitor.tracer().events(name="off")) == 5
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(10)
        with monitor.span("other/thread"):
            pass
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with Profiler():
        with monitor.span("on"):
            with monitor.span("on/inner"):
                pass
        go.set()
        done.wait(10)
        # record_span is after the fact: the ring only
        monitor.tracer().record_span("after", trace_id=1, ts=0.0,
                                     dur_ms=1.0)
    t.join(10)
    assert rf.names == ["on", "on/inner"]
    assert len(monitor.tracer().events(name="other/thread")) == 1


def _fit_both(container, ingest, rows, listen, epochs=2):
    x, y = _data(rows)
    jnet, pnet = _pair(container)
    if listen:
        jnet.set_listeners(JaxScoreListener(1000))
        pnet.set_listeners(ScoreIterationListener(1000))
    jnet.fit(JaxList(JaxDataSet(x, y), 32, shuffle=False), epochs=epochs,
             ingest=ingest)
    pnet.fit(ListDataSetIterator(DataSet(x, y), 32, shuffle=False),
             epochs=epochs, ingest=ingest)
    return jnet, pnet


def _kids_per_epoch(tracer):
    """[{child name: count}] per ``fit/epoch`` span, oldest first."""
    events = tracer.events()
    out = []
    for ep in (e for e in events if e["name"] == "fit/epoch"):
        kids = {}
        for e in events:
            if e["parent"] == ep["id"] and e["name"] in KIDS:
                kids[e["name"]] = kids.get(e["name"], 0) + 1
        out.append(kids)
    return out


@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("rows,listen", [(64, False), (70, False),
                                         (70, True)])
def test_windowed_fit_spans_per_epoch(container, rows, listen):
    """32-row batches: 64 rows are one window of two batches; 70 rows end
    in a 6-row batch, which opens a window of its own."""
    _fit_both(container, "window", rows, listen)
    batches = -(-rows // 32)
    windows = 1 if rows % 32 == 0 else 2
    want = {"fit/iterator": batches + 1, "fit/stage": windows,
            "fit/copy": windows, "fit/dispatch": windows}
    if listen:
        want["fit/listeners"] = 1
    assert _kids_per_epoch(monitor.tracer()) == [want, want]
    stages = monitor.tracer().events(name="fit/stage")
    assert sum(e["attrs"]["rows"] for e in stages) == 2 * rows
    assert sum(e["attrs"]["steps"]
               for e in monitor.tracer().events(name="fit/dispatch")) \
        == 2 * batches
    assert all(e["attrs"]["bytes"] > 0
               for e in monitor.tracer().events(name="fit/copy"))


@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("rows,listen", [(64, False), (70, False),
                                         (64, True)])
def test_cached_fit_spans_per_epoch(container, rows, listen):
    """Two epochs of 64 rows and no listener fuse into one dispatch; a
    tail batch is a dispatch of its own, a listener one epoch a dispatch
    and a replay."""
    _fit_both(container, "cache", rows, listen)
    got = _kids_per_epoch(monitor.tracer())
    if rows == 64 and not listen:
        assert got == [{"fit/dispatch": 1}]
        (d,) = monitor.tracer().events(name="fit/dispatch")
        assert d["attrs"] == {"steps": 4, "rows": 128}
        return
    want = {"fit/dispatch": 2 if rows % 32 else 1}
    if listen:
        want["fit/listeners"] = 1
    assert got == [want, want]
    assert sum(e["attrs"]["rows"]
               for e in monitor.tracer().events(name="fit/dispatch")) \
        == 2 * rows


def _phase_counts(snap):
    out = {}
    for p in PHASES:
        values = snap.get(f"phase_{p}_ms", {}).get("values", {})
        out[p] = sum(int(v["count"]) for v in values.values())
    return out


@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("ingest", ["window", "cache"])
@pytest.mark.parametrize("rows,listen", [(64, False), (70, False),
                                         (70, True), (64, True)])
def test_phase_counts_match_jax(container, ingest, rows, listen):
    _fit_both(container, ingest, rows, listen)
    got = _phase_counts(monitor.snapshot())
    want = _phase_counts(jmonitor.snapshot())
    assert got == want
    assert got["data"] > 0 and got["step"] > 0
    assert (got["listener"] > 0) == listen
    assert monitor.phase_breakdown()["data_ms"] > 0
