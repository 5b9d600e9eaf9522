"""The training harness of the port against the JAX package: listeners fire
at the same iterations with the same scores (the updater path and the
solver path), the epoch hooks run, ``ParamAndGradientIterationListener``
writes the same table, checkpoints restore in both packages, the profiler
capture closes, ``fit``'s ingest and resilience keywords, and ``clone``.

Tolerances: scores 1e-6 relative (the same float32 SGD or solver steps,
sums in another order; Adam's division by sqrt(v) would amplify that
noise in the small gradients); the parameter statistics of
ParamAndGradientIterationListener 1e-5 of the column's largest magnitude
(printed with 6 significant digits).
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JaxList
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize.listeners import listeners as jl
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import listeners as pl
from deeplearning4j_tpu_torch.utils import model_serializer as pms

SCORE_RTOL = 1e-6


def _conf(algo="stochastic_gradient_descent", updater="adam", dtype=None):
    b = (JaxConf.builder().seed(21).optimization_algo(algo)
         .updater(updater).learning_rate(0.05).activation("tanh"))
    if dtype:
        b = b.dtype(dtype)
    return (b.list().layer(jcore.DenseLayer(n_out=6))
            .layer(jcore.OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(jin.feed_forward(4)).build())


def _pair(conf):
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _data(n=48, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int)
                                    + (x[:, 1] > 0.5)]
    return x, y


class _Recorder:
    """Every hook call in order: ("start"|"end", epoch) and ("it", i)."""

    def __init__(self):
        self.calls = []

    def on_epoch_start(self, model):
        self.calls.append(("start", model.epoch))

    def on_epoch_end(self, model):
        self.calls.append(("end", model.epoch))

    def iteration_done(self, model, iteration):
        self.calls.append(("it", iteration))


def _attach(net, mod):
    out = io.StringIO()
    listeners = (mod.CollectScoresIterationListener(1),
                 mod.ScoreIterationListener(2, out=out),
                 mod.PerformanceListener(3), _Recorder())
    net.set_listeners(*listeners[:3])
    net.add_listener(listeners[3])
    return listeners, out


@pytest.mark.parametrize("algo", ["stochastic_gradient_descent", "lbfgs"])
def test_listeners_fire_alike(algo):
    """Two epochs over a shuffled iterator of 4 batches."""
    jnet, pnet = _pair(_conf(algo, updater="sgd"))
    x, y = _data()
    (pc, _, pp, pr), pout = _attach(pnet, pl)
    (jc, _, jp, jr), jout = _attach(jnet, jl)
    pnet.fit(ListDataSetIterator(DataSet(x, y), 12, shuffle=True, seed=4),
             epochs=2, ingest="batch")
    jnet.fit(JaxList(JaxDataSet(x, y), 12, shuffle=True, seed=4), epochs=2,
             ingest="batch")
    assert [i for i, _ in pc.scores] == [i for i, _ in jc.scores] == \
        list(range(1, 9))
    np.testing.assert_allclose([s for _, s in pc.scores],
                               [s for _, s in jc.scores], rtol=SCORE_RTOL)
    assert pr.calls == jr.calls
    assert pr.calls[:2] == [("start", 0), ("it", 1)]
    assert pr.calls[5:7] == [("end", 0), ("start", 1)]
    plines, jlines = pout.getvalue().splitlines(), jout.getvalue().splitlines()
    assert [ln.rsplit(" ", 1)[0] for ln in plines] == \
        [ln.rsplit(" ", 1)[0] for ln in jlines] == \
        [f"Score at iteration {i} is" for i in (2, 4, 6, 8)]
    np.testing.assert_allclose([float(ln.rsplit(" ", 1)[1]) for ln in plines],
                               [float(ln.rsplit(" ", 1)[1]) for ln in jlines],
                               rtol=1e-5)     # printed with 6 decimals
    assert [h[0] for h in pp.history] == [h[0] for h in jp.history] == [6]
    assert pnet.last_batch_size == 12
    assert np.isfinite(pp.average_samples_per_sec(skip=0))


def test_param_and_gradient_listener_writes_the_same_table(tmp_path):
    jnet, pnet = _pair(_conf(updater="sgd"))
    x, y = _data()
    paths = [str(tmp_path / f"{k}.tsv") for k in ("port", "jax")]
    pnet.set_listeners(pl.ParamAndGradientIterationListener(
        2, output_to_console=False, file_path=paths[0]))
    jnet.set_listeners(jl.ParamAndGradientIterationListener(
        2, output_to_console=False, file_path=paths[1]))
    for _ in range(4):
        pnet.fit(DataSet(x, y))
        jnet.fit(JaxDataSet(x, y), ingest="batch")
    rows = [[ln.split("\t") for ln in open(p).read().splitlines()]
            for p in paths]
    assert rows[0][0] == rows[1][0]         # the header
    assert len(rows[0]) == len(rows[1]) == 1 + 2 * 4
    got = np.array([[float(v) for v in r[2:]] for r in rows[0][1:]])
    want = np.array([[float(v) for v in r[2:]] for r in rows[1][1:]])
    assert [r[:2] for r in rows[0][1:]] == [r[:2] for r in rows[1][1:]]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(got[4:, 4:]).max() > 0    # the update columns move


def test_checkpoints_restore_in_both_packages(tmp_path):
    """Every 2 iterations, 2 kept; the last restores in the JAX package
    and in the port with the params, updater state and iteration."""
    _, pnet = _pair(_conf())
    x, y = _data()
    ck = pl.CheckpointListener(str(tmp_path), save_every_n_iterations=2,
                               keep_last=2)
    pnet.set_listeners(ck)
    pnet.fit(ListDataSetIterator(DataSet(x, y), 8), epochs=1)   # 6 steps
    assert [os.path.basename(p) for p in ck.saved] == \
        ["checkpoint_4.zip", "checkpoint_6.zip"]
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_4.zip",
                                            "checkpoint_6.zip"]
    last = ck.last_checkpoint()
    jnet = jms.restore_multi_layer_network(last)
    again = pms.restore_multi_layer_network(last, device="cpu")
    for net in (jnet, again):
        assert net.iteration == 6
        np.testing.assert_array_equal(np.asarray(net.get_flat_params()),
                                      pnet.get_flat_params())
        np.testing.assert_array_equal(
            np.asarray(net.get_flat_updater_state()),
            pnet.get_flat_updater_state())


def test_checkpoint_listener_epoch_mode_and_errors(tmp_path):
    _, pnet = _pair(_conf())
    x, y = _data()
    ck = pl.CheckpointListener(str(tmp_path / "ck"), save_every_epochs=2,
                               async_write=False)
    pnet.set_listeners(ck)
    pnet.fit(ListDataSetIterator(DataSet(x, y), 24), epochs=4)
    assert [os.path.basename(p) for p in ck.saved] == \
        ["checkpoint_4.zip", "checkpoint_8.zip"]
    with pytest.raises(ValueError):
        pl.CheckpointListener(str(tmp_path / "none"))
    bad = pl.CheckpointListener(str(tmp_path / "bad"),
                                save_every_n_iterations=1)
    os.rmdir(tmp_path / "bad")              # the write fails
    bad.iteration_done(pnet, 1)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        bad.flush()


def test_profiler_listener_captures_and_closes(tmp_path):
    _, pnet = _pair(_conf())
    x, y = _data()
    prof = pl.ProfilerListener(str(tmp_path), start_iteration=2,
                               end_iteration=100)
    pnet.set_listeners(prof)
    pnet.fit(ListDataSetIterator(DataSet(x, y), 12), epochs=1)
    # training ended before end_iteration: fit's finalize closed it
    assert prof.trace_path is not None
    trace = json.load(open(prof.trace_path))
    assert trace["traceEvents"]
    assert prof.phase_report()["iterations"] == 3
    prof.stop()                              # idempotent


def test_fit_finalizes_listeners_when_a_listener_raises(tmp_path):
    _, pnet = _pair(_conf())
    x, y = _data()
    prof = pl.ProfilerListener(str(tmp_path), start_iteration=1,
                               end_iteration=100)

    class Boom(pl.IterationListener):
        def iteration_done(self, model, iteration):
            if iteration == 2:
                raise RuntimeError("listener failed")

    pnet.set_listeners(prof, Boom())
    with pytest.raises(RuntimeError, match="listener failed"):
        pnet.fit(ListDataSetIterator(DataSet(x, y), 12))
    assert prof._prof is None and prof.trace_path is not None


def test_fit_ingest_and_resilience_keywords(tmp_path):
    """Every ``ingest`` value and the resilience keywords run (on a single
    DataSet the ingest mode does not apply, as in the JAX package); a
    resume restores the checkpoint's progress, and ``epochs`` is then the
    total target."""
    _, pnet = _pair(_conf())
    x, y = _data()
    ds = DataSet(x, y)
    with pytest.raises(ValueError, match="unknown ingest"):
        pnet.fit(ds, ingest="stream")
    for kw in ({"ingest": "cache"}, {"ingest": "window"}):
        pnet.fit(ds, **kw)
    assert pnet.iteration == pnet.epoch == 2
    pnet.fit(ds, checkpoint=str(tmp_path))
    assert len(os.listdir(tmp_path)) == 1
    pnet.fit(ds, resume_from=str(tmp_path), epochs=3)   # 3 done: no step
    assert pnet.iteration == 3
    pnet.fit(ds, ingest="batch")
    pnet.fit(ds, ingest="auto")
    assert pnet.iteration == 5


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_clone_copies_the_training_state(dtype):
    """Params, layer state, updater state with the fp32 masters and the
    iteration; the clone trains on as the original does and shares no
    tensor with it."""
    _, pnet = _pair(_conf(dtype=dtype))
    x, y = _data()
    pnet.fit(DataSet(x, y))
    twin = pnet.clone()
    assert twin.iteration == pnet.iteration == 1
    np.testing.assert_array_equal(twin.get_flat_params(),
                                  pnet.get_flat_params())
    np.testing.assert_array_equal(twin.get_flat_updater_state(),
                                  pnet.get_flat_updater_state())
    if dtype:
        assert "_master" in twin.updater_state[0]
    ptrs = {p.data_ptr() for tree in pnet.params for p in tree.values()}
    assert not ptrs & {p.data_ptr() for tree in twin.params
                       for p in tree.values()}
    pnet.fit(DataSet(x, y))
    twin.fit(DataSet(x, y))
    torch.testing.assert_close(torch.as_tensor(twin.get_flat_params()),
                               torch.as_tensor(pnet.get_flat_params()),
                               rtol=0, atol=0)
