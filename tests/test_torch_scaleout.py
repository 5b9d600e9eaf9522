"""The port's cluster tier (``deeplearning4j_tpu_torch/scaleout/``: the
broadcast tuple, the Export data path, the parameter-averaging master,
the frontends' distributed evaluation and the multi-host wiring) against
the JAX package's ``scaleout/`` on the same weights
(``nn/jax_weights.py``) and the same batches.

Tolerances: float64 nets with sgd at 1e-10 (params, score); float64 adam
and nesterovs at 1e-8 (the JAX updater keeps its betas and momentum in
float32, so its f64 steps differ from the port's by ~1e-9); the float32
flat updater-state vectors at 2 ulp (2.5e-7) and 1e-9 absolute; the
iteration exactly; the evaluators' counts (confusion matrix, ROC
tp/fp/fn/tn) exactly, the regression sums at 1e-10.  The port against
itself (workers=1 against ``fit``; the exported files) is bitwise.  The
cross-host mean of a 2-process gloo group is bitwise the JAX package's
numpy formula.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf.computation_graph import \
    MergeVertex as JMerge
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.scaleout import api as japi
from deeplearning4j_tpu.scaleout import data as jdata
from deeplearning4j_tpu.scaleout import frontend as jfront
from deeplearning4j_tpu.scaleout import param_avg as javg
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.jax_weights import load_jax_params
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.scaleout import api as papi
from deeplearning4j_tpu_torch.scaleout import data as pdata
from deeplearning4j_tpu_torch.scaleout import dcn as pdcn
from deeplearning4j_tpu_torch.scaleout import frontend as pfront
from deeplearning4j_tpu_torch.scaleout import param_avg as pavg

ROOT = Path(__file__).resolve().parents[1]
SGD_RTOL = 1e-10
F64_RTOL = 1e-8
STATE_RTOL = 2.5e-7


def _conf(updater="sgd", lr=0.1, seed=42, n_out=3, loss=None,
          activation=None):
    out = (jcore.OutputLayer(n_in=8, n_out=n_out) if loss is None else
           jcore.OutputLayer(n_in=8, n_out=n_out, loss=loss,
                             activation=activation))
    return (JConf.builder().seed(seed).dtype("float64").updater(updater)
            .learning_rate(lr).activation("tanh").weight_init("xavier")
            .list()
            .layer(jcore.DenseLayer(n_in=4, n_out=8))
            .layer(out).build())


def _pair(jconf):
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    load_jax_params(pnet, np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _raw(n_batches, b=8, seed=0, n_out=3, regression=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        x = rng.randn(b, 4)
        y = (rng.randn(b, n_out) if regression
             else np.eye(n_out)[rng.randint(0, n_out, b)])
        out.append((x, y))
    return out


def _jds(raw):
    return [JDS(x, y) for x, y in raw]


def _pds(raw):
    return [DataSet(x, y) for x, y in raw]


def _rtol(updater):
    return SGD_RTOL if updater == "sgd" else F64_RTOL


def _close_nets(jnet, pnet, rtol):
    a, b = np.asarray(jnet.get_flat_params()), pnet.get_flat_params()
    assert a.dtype == b.dtype
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol)
    ju = np.asarray(jnet.get_flat_updater_state()).astype(np.float32)
    pu = pnet.get_flat_updater_state()
    assert ju.shape == pu.shape
    np.testing.assert_allclose(pu, ju, rtol=STATE_RTOL, atol=1e-9)
    assert pnet.iteration == jnet.iteration
    assert pnet.score() == pytest.approx(float(jnet._score), rel=rtol)


# ------------------------------------------------------------- the tuple

def test_broadcast_tuple_from_a_jax_net_configures_a_port_worker():
    """The JAX master's broadcast (JSON + float arrays) builds a port
    replica holding its params, updater state and iteration bit for bit;
    one partition then trains as the JAX worker trains it."""
    jnet = JNet(_conf("adam")).init()
    jnet.fit(JDS(*_raw(1)[0]))
    jb = japi.NetBroadcastTuple.from_model(jnet)
    pb = papi.NetBroadcastTuple(**{
        f.name: getattr(jb, f.name)
        for f in dataclasses.fields(japi.NetBroadcastTuple)})
    replica = pb.build_model("cpu")
    assert replica.device.type == "cpu"
    np.testing.assert_array_equal(replica.get_flat_params(), jb.params)
    # the port's flat updater state is float32 (the updaterState.bin
    # payload); the JAX vector of a float64 net holds float64 moments
    np.testing.assert_array_equal(replica.get_flat_updater_state(),
                                  jb.updater_state.astype(np.float32))
    assert replica.iteration == jb.iteration == 1

    part = _raw(3, seed=1)
    jw = javg.ParameterAveragingTrainingWorker()
    # both workers from the float32 moments the port's replica holds
    jw.configure(dataclasses.replace(
        jb, updater_state=jb.updater_state.astype(np.float32)))
    jr = jw.process_partition(_jds(part))
    pw = pavg.ParameterAveragingTrainingWorker()
    pw.configure(pb, "cpu")
    pr = pw.process_partition(_pds(part))
    assert pr.batches_processed == jr.batches_processed == 3
    np.testing.assert_allclose(pr.params, jr.params, rtol=F64_RTOL,
                               atol=F64_RTOL)
    np.testing.assert_allclose(pr.updater_state, jr.updater_state,
                               rtol=STATE_RTOL, atol=1e-9)
    assert pr.score == pytest.approx(jr.score, rel=F64_RTOL)
    # the port's tuple of the trained replica crosses back
    back = japi.NetBroadcastTuple(**dataclasses.asdict(
        papi.NetBroadcastTuple.from_model(pw._net))).build_model()
    np.testing.assert_array_equal(np.asarray(back.get_flat_params()),
                                  pr.params)


def test_worker_keeps_its_replica_across_broadcasts():
    jnet, pnet = _pair(_conf())
    worker = pavg.ParameterAveragingTrainingWorker()
    worker.configure(papi.NetBroadcastTuple.from_model(pnet), "cpu")
    first = worker._net
    pnet.fit(_pds(_raw(1))[0])
    worker.configure(papi.NetBroadcastTuple.from_model(pnet), "cpu")
    assert worker._net is first
    np.testing.assert_array_equal(first.get_flat_params(),
                                  pnet.get_flat_params())
    assert first.iteration == pnet.iteration == 1


# ------------------------------------------------------------ data path

def _masked_raw(n, b=6, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, 5, 3).astype(np.float32),
             np.eye(2, dtype=np.float32)[rng.randint(0, 2, (b, 5))],
             (rng.rand(b, 5) > 0.3).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_exported_files_read_both_ways(tmp_path, writer):
    """One ``.npz`` a minibatch, masks included, written by either
    package and read bitwise by both, through ``load_dataset`` and the
    path iterator."""
    raw = _masked_raw(3)
    wmod = jdata if writer == "jax" else pdata
    ds_cls = JDS if writer == "jax" else DataSet
    export = wmod.DataSetExportFunction(str(tmp_path))
    paths = [export(ds_cls(f, l, features_mask=m, labels_mask=m))
             for f, l, m in raw]
    assert [os.path.basename(p) for p in paths] == [
        "dataset_0.npz", "dataset_1.npz", "dataset_2.npz"]
    for reader in (jdata, pdata):
        for p, (f, l, m) in zip(paths, raw):
            got = reader.load_dataset(p)
            for a, b in ((got.features, f), (got.labels, l),
                         (got.features_mask, m), (got.labels_mask, m)):
                assert np.asarray(a).dtype == b.dtype
                np.testing.assert_array_equal(np.asarray(a), b)
    it = pdata.PathDataSetIterator(paths)
    assert it.batch() == 6
    assert len(list(it)) == len(list(it)) == 3


def test_batch_and_export_rebatches_as_jax_does(tmp_path):
    """Re-batching 5 masked batches of 6 rows to 8: the same files, the
    same arrays, a ragged last file, in both packages."""
    raw = _masked_raw(5)
    jp = jdata.batch_and_export(
        [JDS(f, l, features_mask=m, labels_mask=m) for f, l, m in raw],
        str(tmp_path / "jax"), batch_size=8)
    pp = pdata.batch_and_export(
        [DataSet(f, l, features_mask=m, labels_mask=m) for f, l, m in raw],
        str(tmp_path / "port"), batch_size=8)
    assert [os.path.basename(p) for p in pp] == [
        os.path.basename(p) for p in jp]
    sizes = []
    for a, b in zip(jp, pp):
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for key in za.files:
                np.testing.assert_array_equal(zb[key], za[key])
            sizes.append(za["features"].shape[0])
    assert sizes == [8, 8, 8, 6]
    assert pdata.partition_evenly(list(range(7)), 3) == \
        jdata.partition_evenly(list(range(7)), 3)


# ------------------------------------------------------------ the master

@pytest.mark.parametrize("updater", ["sgd", "adam", "nesterovs"])
@pytest.mark.parametrize("approach", ["direct", "export"])
def test_master_matches_jax(tmp_path, approach, updater):
    """4 workers averaging every 2 batches over 11 batches (a ragged
    last split of 3), through the Direct approach and the Export approach
    (re-batched from 8 to 12 rows): params, updater state, iteration and
    score as the JAX master's."""
    jnet, pnet = _pair(_conf(updater))
    raw = _raw(11)
    kw = dict(num_workers=4, batch_size_per_worker=12,
              averaging_frequency=2)
    jexp = pexp = None
    if approach == "export":
        jexp, pexp = str(tmp_path / "jax"), str(tmp_path / "port")
    jm = javg.ParameterAveragingTrainingMaster(export_dir=jexp, **kw)
    pm = pavg.ParameterAveragingTrainingMaster(export_dir=pexp, **kw)
    jfront.ClusterMultiLayer(jnet, jm).fit(_jds(raw))
    pfront.ClusterMultiLayer(pnet, pm).fit(_pds(raw))
    _close_nets(jnet, pnet, _rtol(updater))
    assert [s["minibatches"] for s in pm.stats] == \
        [s["minibatches"] for s in jm.stats]
    assert all(s["fold_time_sec"] >= 0 for s in pm.stats)


def test_master_fit_paths_matches_jax(tmp_path):
    """``fit_paths`` on files the JAX package exported, both masters."""
    jnet, pnet = _pair(_conf("sgd"))
    paths = jdata.batch_and_export(_jds(_raw(6)), str(tmp_path))
    kw = dict(num_workers=2, averaging_frequency=2)
    jfront.ClusterMultiLayer(
        jnet, javg.ParameterAveragingTrainingMaster(**kw)).fit_paths(paths)
    pfront.ClusterMultiLayer(
        pnet, pavg.ParameterAveragingTrainingMaster(**kw)).fit_paths(paths)
    _close_nets(jnet, pnet, SGD_RTOL)


def test_single_worker_master_is_the_plain_fit():
    """num_workers=1: averaging over one worker is the identity, so the
    master is the sequential per-batch fit, bit for bit."""
    _, pnet = _pair(_conf("adam"))
    ref = pnet.clone()
    raw = _raw(8)
    pfront.ClusterMultiLayer(pnet, pavg.ParameterAveragingTrainingMaster(
        num_workers=1, averaging_frequency=8)).fit(_pds(raw))
    for ds in _pds(raw):
        ref.fit(ds)
    np.testing.assert_array_equal(pnet.get_flat_params(),
                                  ref.get_flat_params())
    np.testing.assert_array_equal(pnet.get_flat_updater_state(),
                                  ref.get_flat_updater_state())
    assert pnet.iteration == ref.iteration == 8
    assert pnet.score() == ref.score()


def test_fold_is_the_weighted_host_average():
    """Two workers with partitions of 2 and 1 batches: the master holds
    the batches-weighted float64 average of their results, bitwise the
    JAX formula (ElementAddFunction semantics)."""
    _, net = _pair(_conf("adam"))
    collected = []

    class Recording(pavg.ParameterAveragingTrainingWorker):
        def process_partition(self, partition):
            r = super().process_partition(partition)
            collected.append(r)
            return r

    pavg.ParameterAveragingTrainingMaster(
        num_workers=2, averaging_frequency=2,
        worker_factory=Recording).execute_training(net, _pds(_raw(3)))
    collected.sort(key=lambda r: -r.batches_processed)
    w = np.array([r.batches_processed for r in collected], np.float64)
    acc = np.zeros_like(collected[0].params, np.float64)
    for wi, r in zip(w, collected):
        acc += wi * r.params.astype(np.float64)
    np.testing.assert_array_equal(net.get_flat_params(), acc / w.sum())
    ust = np.zeros_like(collected[0].updater_state, np.float64)
    for wi, r in zip(w, collected):
        ust += wi * r.updater_state.astype(np.float64)
    np.testing.assert_array_equal(net.get_flat_updater_state(),
                                  (ust / w.sum()).astype(np.float32))
    assert net.iteration == 2


def test_graph_frontend_matches_jax():
    """``ClusterComputationGraph`` over a two-input graph: the master's
    fit and the distributed evaluate as the JAX package's."""
    gconf = (JConf.builder().seed(99).dtype("float64")
             .updater("sgd").learning_rate(0.1).activation("tanh")
             .weight_init("xavier").graph_builder()
             .add_inputs("a", "b")
             .add_vertex("merge", JMerge(), "a", "b")
             .add_layer("h", jcore.DenseLayer(n_in=4, n_out=6), "merge")
             .add_layer("out", jcore.OutputLayer(n_in=6, n_out=2), "h")
             .set_outputs("out").build())
    rng = np.random.RandomState(1)
    raw = [([rng.randn(8, 2), rng.randn(8, 2)],
            [np.eye(2)[rng.randint(0, 2, 8)]]) for _ in range(6)]
    jcg = JCG(gconf).init()
    pcg = ComputationGraph(ComputationGraphConfiguration.from_json(
        gconf.to_json()), device="cpu").init()
    load_jax_params(pcg, np.asarray(jcg.get_flat_params()))
    kw = dict(num_workers=3, averaging_frequency=1)
    jf = jfront.ClusterComputationGraph(
        jcg, javg.ParameterAveragingTrainingMaster(**kw))
    pf = pfront.ClusterComputationGraph(
        pcg, pavg.ParameterAveragingTrainingMaster(**kw))
    jf.fit([JMDS(features=f, labels=l) for f, l in raw])
    pf.fit([MultiDataSet(f, l) for f, l in raw])
    _close_nets(jcg, pcg, SGD_RTOL)
    je = jf.evaluate([JMDS(features=f, labels=l) for f, l in raw])
    pe = pf.evaluate([MultiDataSet(f, l) for f, l in raw])
    np.testing.assert_array_equal(pe.confusion.matrix, je.confusion.matrix)


# -------------------------------------------------- distributed evaluation

@pytest.fixture(scope="module")
def trained_pair():
    jnet, pnet = _pair(_conf("sgd"))
    raw = _raw(4, seed=5)
    for x, y in raw:
        jnet.fit(JDS(x, y))
        pnet.fit(DataSet(x, y))
    return jnet, pnet


def test_distributed_evaluate_matches_jax(trained_pair):
    jnet, pnet = trained_pair
    raw = _raw(7, seed=9)
    kw = dict(num_workers=3)
    je = jfront.ClusterMultiLayer(
        jnet, javg.ParameterAveragingTrainingMaster(**kw)).evaluate(
        _jds(raw))
    pf = pfront.ClusterMultiLayer(
        pnet, pavg.ParameterAveragingTrainingMaster(**kw))
    pe = pf.evaluate(_pds(raw))
    np.testing.assert_array_equal(pe.confusion.matrix, je.confusion.matrix)
    assert pe.accuracy() == je.accuracy()
    np.testing.assert_array_equal(pe.confusion.matrix,
                                  pnet.evaluate(_pds(raw)).confusion.matrix)
    js = jfront.ClusterMultiLayer(
        jnet, javg.ParameterAveragingTrainingMaster(**kw)).calculate_score(
        _jds(raw))
    assert pf.calculate_score(_pds(raw)) == pytest.approx(js, rel=SGD_RTOL)
    assert pf.calculate_score(_pds(raw), average=False) == pytest.approx(
        js * 7 * 8, rel=SGD_RTOL)


def test_distributed_roc_and_regression_match_jax():
    """Binary ROC counts exactly and the regression sums at 1e-10, each
    folded through ``merge()`` from 3 partitions."""
    for kind in ("roc", "regression"):
        if kind == "roc":
            conf = _conf("sgd", n_out=2)
            raw = _raw(5, seed=7, n_out=2)
        else:
            conf = _conf("sgd", n_out=2, loss="mse", activation="identity")
            raw = _raw(5, seed=7, n_out=2, regression=True)
        jnet, pnet = _pair(conf)
        jf = jfront.ClusterMultiLayer(
            jnet, javg.ParameterAveragingTrainingMaster(num_workers=3))
        pf = pfront.ClusterMultiLayer(
            pnet, pavg.ParameterAveragingTrainingMaster(num_workers=3))
        if kind == "roc":
            jr, pr = jf.evaluate_roc(_jds(raw)), pf.evaluate_roc(_pds(raw))
            for name in ("tp", "fp", "fn", "tn"):
                np.testing.assert_array_equal(getattr(pr, name),
                                              getattr(jr, name))
            assert pr.calculate_auc() == jr.calculate_auc()
        else:
            jr = jf.evaluate_regression(_jds(raw))
            pr = pf.evaluate_regression(_pds(raw))
            assert pr._n == jr._n == 40
            for name in ("_sum_err2", "_sum_abs", "_sum_y", "_sum_y2",
                         "_sum_p", "_sum_p2", "_sum_yp"):
                np.testing.assert_allclose(getattr(pr, name),
                                           getattr(jr, name),
                                           rtol=SGD_RTOL)


def test_distributed_masked_time_series_evaluate_matches_jax():
    """Padded RNN batches through the distributed path (the masked
    time-series route): the confusion matrix is the JAX package's and
    the container's own."""
    conf = (JConf.builder().seed(9).dtype("float64").updater("sgd")
            .learning_rate(0.1).weight_init("xavier").list()
            .layer(jrec.GravesLSTM(n_in=3, n_out=8, activation="tanh"))
            .layer(jrec.RnnOutputLayer(n_in=8, n_out=2)).build())
    jnet, pnet = _pair(conf)
    raw = _masked_raw(4)
    je = jfront.ClusterMultiLayer(
        jnet, javg.ParameterAveragingTrainingMaster(num_workers=2)
    ).evaluate([JDS(f, l, features_mask=m, labels_mask=m)
                for f, l, m in raw])
    pbatches = [DataSet(f, l, features_mask=m, labels_mask=m)
                for f, l, m in raw]
    pe = pfront.ClusterMultiLayer(
        pnet, pavg.ParameterAveragingTrainingMaster(num_workers=2)
    ).evaluate(pbatches)
    np.testing.assert_array_equal(pe.confusion.matrix, je.confusion.matrix)
    np.testing.assert_array_equal(pe.confusion.matrix,
                                  pnet.evaluate(pbatches).confusion.matrix)


# ------------------------------------------------------ multi-host wiring

def test_host_shard_partitions_paths():
    paths = [f"p{i}" for i in range(10)]
    from deeplearning4j_tpu.scaleout.dcn import host_shard as jshard
    for pid in range(3):
        assert pdcn.host_shard(paths, pid, 3) == jshard(paths, pid, 3)
    assert pdcn.host_shard(paths, 0, 3) == ["p0", "p3", "p6", "p9"]
    # without a process group: the whole list, as one JAX process
    assert pdcn.host_shard(paths) == paths


def test_single_process_mean_and_multi_host_loop_are_the_master():
    """With one process the cross-host mean is the identity and
    ``run_multi_host_training`` is the local master over every path."""
    flat = np.arange(5, dtype=np.float32)
    assert pdcn.cross_host_mean(flat, weight=3.0) is flat
    _, a = _pair(_conf("sgd"))
    b = a.clone()
    raw = _pds(_raw(4))
    shard = pdcn.run_multi_host_training(
        a, pavg.ParameterAveragingTrainingMaster(num_workers=2), raw)
    assert shard == raw
    pavg.ParameterAveragingTrainingMaster(num_workers=2).execute_training(
        b, raw)
    np.testing.assert_array_equal(a.get_flat_params(), b.get_flat_params())


_MEAN_CHILD = textwrap.dedent("""
    import json, os
    import numpy as np
    from deeplearning4j_tpu_torch.scaleout import dcn
    rank = int(os.environ["PROCESS_ID"])
    assert dcn.initialize_from_env(device="cpu")
    flat = np.random.RandomState(rank).randn(37).astype(np.{dtype})
    mean = dcn.cross_host_mean(flat, weight=float(rank + 2))
    shard = dcn.host_shard([f"p{{i}}" for i in range(5)])
    print(json.dumps({{"mean": mean.tolist(), "dtype": str(mean.dtype),
                      "shard": shard}}))
""")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cross_host_mean_in_a_gloo_pair_is_the_numpy_formula(dtype):
    """Two processes joined from the env contract
    (``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``, through
    ``initialize_from_env``) in a gloo group: each rank's ``cross_host_mean`` is
    bitwise the JAX package's formula over both ranks' ``[w·p, w]``
    float32 rows (summed in rank order), and ``host_shard`` takes the
    rank and the world size."""
    from deeplearning4j_tpu_torch.parallel.mesh import pick_coordinator_port
    port = str(pick_coordinator_port())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    code = _MEAN_CHILD.format(dtype=dtype)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT,
        env=dict(env, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 NUM_PROCESSES="2", PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rows = []
    for rank in range(2):
        flat = np.random.RandomState(rank).randn(37).astype(dtype)
        w = float(rank + 2)
        rows.append(np.concatenate([flat * w, [w]]).astype(np.float32))
    summed = np.stack(rows).sum(axis=0)
    want = (summed[:-1] / summed[-1]).astype(dtype)
    for rank, got in enumerate(outs):
        assert got["dtype"] == dtype
        np.testing.assert_array_equal(np.asarray(got["mean"], dtype), want)
        assert got["shard"] == [f"p{i}" for i in range(rank, 5, 2)]
