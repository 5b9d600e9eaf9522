"""The port's training trace spans against the JAX package's (ROADMAP C13):
``fit/epoch`` on every ``fit`` path of both containers, with the same
``epoch`` and ``path`` attrs (the cache path's ``fused`` and ``start``
too), one span an epoch (or a fused run of epochs); ``earlystopping/epoch``
around each early-stopping epoch; and ``ProfilerListener``'s one
``profiler/capture`` span with its ``log_dir``, parented on the context
current when the capture started (the twin of
``tests/test_tracing.py::test_profiler_listener_double_stop_guard``).

Span names and attrs are compared exactly; ids, timestamps and durations
are per process and not compared.
"""

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JaxList
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.earlystopping import config as jconfig
from deeplearning4j_tpu.earlystopping import termination as jterm
from deeplearning4j_tpu.earlystopping import trainer as jtrainer
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize.listeners.listeners import \
    ScoreIterationListener as JaxScoreListener
from deeplearning4j_tpu_torch import earlystopping as pes
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners.listeners import (
    ProfilerListener, ScoreIterationListener)


@pytest.fixture(autouse=True)
def _isolated():
    monitor.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    jmonitor.reset()


def _jconf(container):
    b = (JaxConf.builder().seed(7).updater("sgd").learning_rate(0.1)
         .activation("tanh"))
    if container == "graph":
        return (b.graph_builder().add_inputs("in")
                .add_layer("h", jcore.DenseLayer(n_in=4, n_out=8), "in")
                .add_layer("out", jcore.OutputLayer(n_in=8, n_out=3), "h")
                .set_outputs("out").build())
    return (b.list().layer(jcore.DenseLayer(n_out=8))
            .layer(jcore.OutputLayer(n_out=3))
            .set_input_type(jin.feed_forward(4)).build())


def _pair(container):
    jconf = _jconf(container)
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


def _data(n):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return x, y


def _spans(tracer, name):
    return [(e["name"], e.get("attrs", {}))
            for e in tracer.events(name=name)]


@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("ingest", ["batch", "window", "cache", "auto"])
@pytest.mark.parametrize("rows,listen", [(64, False), (70, False),
                                         (64, True)])
def test_fit_epoch_spans_match_jax(container, ingest, rows, listen):
    """Two epochs of ``fit(iterator)``: the same ``fit/epoch`` spans in
    both packages.  64 rows at batch 32 and no listener let the cache path
    fuse both epochs into one span (``fused=2``); a tail batch (70 rows)
    or a listener keeps one span an epoch."""
    x, y = _data(rows)
    jnet, pnet = _pair(container)
    if listen:
        jnet.set_listeners(JaxScoreListener(1000))
        pnet.set_listeners(ScoreIterationListener(1000))
    jnet.fit(JaxList(JaxDataSet(x, y), 32, shuffle=False), epochs=2,
             ingest=ingest)
    pnet.fit(ListDataSetIterator(DataSet(x, y), 32, shuffle=False),
             epochs=2, ingest=ingest)
    want = _spans(jmonitor.tracer(), "fit/epoch")
    got = _spans(monitor.tracer(), "fit/epoch")
    assert want and got == want
    assert pnet.epoch == jnet.epoch == 2


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_fit_epoch_span_on_a_single_batch_and_arrays_matches_jax(container):
    """``fit(DataSet)`` and ``fit(features, labels)`` take the per-batch
    path in both packages."""
    x, y = _data(16)
    jnet, pnet = _pair(container)
    jnet.fit(JaxDataSet(x, y), epochs=2)
    jnet.fit(x, y)
    pnet.fit(DataSet(x, y), epochs=2)
    pnet.fit(x, y)
    want = _spans(jmonitor.tracer(), "fit/epoch")
    assert want and _spans(monitor.tracer(), "fit/epoch") == want


def test_fit_epoch_span_parents_under_the_callers_span():
    """A fit inside a caller's span parents its epochs there."""
    x, y = _data(64)
    _, pnet = _pair("mln")
    with monitor.span("outer") as outer:
        pnet.fit(ListDataSetIterator(DataSet(x, y), 32), epochs=1,
                 ingest="batch")
    (ev,) = monitor.tracer().events(name="fit/epoch")
    assert ev["parent"] == outer


def test_earlystopping_epoch_spans_match_jax():
    """Three early-stopping epochs: one ``earlystopping/epoch`` span each
    (attr ``epoch``), each around that epoch's ``fit/epoch``."""
    x, y = _data(60)
    jnet, pnet = _pair("mln")

    def conf(mod, term):
        return mod.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                term.MaxEpochsTerminationCondition(3)])

    from deeplearning4j_tpu_torch.earlystopping import termination as pterm
    jtrainer.EarlyStoppingTrainer(
        conf(jconfig, jterm), jnet,
        JaxList(JaxDataSet(x, y), 20, shuffle=False)).fit()
    pes.EarlyStoppingTrainer(
        conf(pes.config, pterm), pnet,
        ListDataSetIterator(DataSet(x, y), 20, shuffle=False)).fit()
    for name in ("earlystopping/epoch", "fit/epoch"):
        want = _spans(jmonitor.tracer(), name)
        assert want and _spans(monitor.tracer(), name) == want
    outer = {e["id"]: e["attrs"]["epoch"]
             for e in monitor.tracer().events(name="earlystopping/epoch")}
    inner = monitor.tracer().events(name="fit/epoch")
    assert [outer[e["parent"]] for e in inner] == [0, 1, 2]


def test_profiler_listener_records_one_capture_span(tmp_path):
    """The port twin of the JAX double-stop test: one ``profiler/capture``
    event with the listener's ``log_dir``, a second ``stop()`` records
    nothing, and the span parents on the context current at the
    capture's start."""
    pl = ProfilerListener(str(tmp_path), start_iteration=0,
                          end_iteration=10)
    with monitor.span("fit/epoch", epoch=0) as outer:
        pl.iteration_done(None, 0)          # opens the capture window
    pl.stop()
    pl.stop()                               # idempotent
    (ev,) = monitor.tracer().events(name="profiler/capture")
    assert ev["attrs"]["log_dir"] == str(tmp_path)
    assert ev["parent"] == outer
    assert ev["dur_ms"] >= 0
    (opened,) = monitor.tracer().events(name="fit/epoch")
    assert ev["trace"] == opened["trace"] and ev["ts"] >= opened["ts"]
    assert pl.trace_path is not None


def test_profiler_capture_span_without_a_context_starts_a_trace(tmp_path):
    """With no open span the capture starts a trace of its own, as the
    JAX listener's does."""
    pl = ProfilerListener(str(tmp_path), start_iteration=0,
                          end_iteration=2)
    pl.iteration_done(None, 0)
    pl.iteration_done(None, 2)              # closes at end_iteration
    pl.stop()
    (ev,) = monitor.tracer().events(name="profiler/capture")
    assert ev["parent"] is None and ev["attrs"] == {"log_dir": str(tmp_path)}
