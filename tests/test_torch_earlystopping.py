"""Early stopping in the port (``earlystopping/``) against the JAX package:
the same scores per epoch, best epoch and termination reason for each of
the five termination conditions under SGD, the savers (a
``LocalFileModelSaver`` zip restores in the JAX package; the best model
restores to its recorded score; a ComputationGraph trains and restores
through the same trainer and saver), and the trainers' refusals.

Tolerances: validation scores 1e-6 relative (the same float32 SGD steps,
sums in another order); a restored model's score equals the recorded one
to 1e-6 relative (the zip holds the float32 params exactly).
"""

import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JaxList
from deeplearning4j_tpu.earlystopping import config as jconfig
from deeplearning4j_tpu.earlystopping import savers as jsavers
from deeplearning4j_tpu.earlystopping import scorecalc as jscore
from deeplearning4j_tpu.earlystopping import termination as jterm
from deeplearning4j_tpu.earlystopping import trainer as jtrainer
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch import earlystopping as pes
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

RTOL = 1e-6


class _JaxBatchTrainer(jtrainer.EarlyStoppingTrainer):
    """The JAX trainer on its per-batch ingest path, so that it trains on
    the iterator's batches in the iterator's order, as the port does."""

    def _fit_one_epoch(self):
        self.net.fit(self.iterator, ingest="batch")


class _PortBatchTrainer(pes.EarlyStoppingTrainer):
    """The port's trainer on its per-batch ingest path too (its ``"auto"``
    trains a cacheable iterator in a device permutation)."""

    def _fit_one_epoch(self):
        self.net.fit(self.iterator, ingest="batch")


def _pair(lr=0.1):
    conf = (JaxConf.builder().seed(17).updater("sgd").learning_rate(lr)
            .activation("tanh").list()
            .layer(jcore.DenseLayer(n_out=6))
            .layer(jcore.OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(jin.feed_forward(4)).build())
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _split(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(80, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int)
                                    + (x[:, 2] > 0.7)]
    return (x[:60], y[:60]), (x[60:], y[60:])


def _iterators(pkg):
    (xt, yt), (xv, yv) = _split()
    if pkg == "port":
        return (ListDataSetIterator(DataSet(xt, yt), 15, shuffle=True,
                                    seed=2),
                ListDataSetIterator(DataSet(xv, yv), 8))
    return (JaxList(JaxDataSet(xt, yt), 15, shuffle=True, seed=2),
            JaxList(JaxDataSet(xv, yv), 8))


CONDITIONS = {
    "max_epochs": (lambda m: [m.MaxEpochsTerminationCondition(4)], []),
    "score_improvement": (lambda m: [
        m.MaxEpochsTerminationCondition(9),
        m.ScoreImprovementEpochTerminationCondition(1, 10.0)], []),
    "best_score": (lambda m: [m.MaxEpochsTerminationCondition(9),
                              m.BestScoreEpochTerminationCondition(0.8)],
                   []),
    "max_score_iteration": (lambda m: [m.MaxEpochsTerminationCondition(9)],
                            lambda m: [
                                m.MaxScoreIterationTerminationCondition(
                                    0.5)]),
    "max_time_iteration": (lambda m: [m.MaxEpochsTerminationCondition(9)],
                           lambda m: [
                               m.MaxTimeIterationTerminationCondition(0)]),
}


def _run(pkg, name, saver=None, evaluate_every=1):
    net = _pair()[0 if pkg == "jax" else 1]
    mods = ((jconfig, jterm, jscore, _JaxBatchTrainer) if pkg == "jax"
            else (pes, pes, pes, _PortBatchTrainer))
    config_mod, term, score_mod, trainer_cls = mods
    epoch_conds, iter_conds = CONDITIONS[name]
    train, valid = _iterators(pkg)
    b = (config_mod.EarlyStoppingConfiguration.builder()
         .epoch_termination_conditions(*epoch_conds(term))
         .score_calculator(score_mod.DataSetLossCalculator(valid))
         .evaluate_every_n_epochs(evaluate_every))
    if iter_conds:
        b = b.iteration_termination_conditions(*iter_conds(term))
    if saver is not None:
        b = b.model_saver(saver).save_last_model(True)
    return trainer_cls(b.build(), net, train).fit(), net


def _same_result(got, want):
    assert got.termination_reason == want.termination_reason
    assert got.termination_details == want.termination_details
    assert got.best_model_epoch == want.best_model_epoch
    assert got.total_epochs == want.total_epochs
    assert sorted(got.score_vs_epoch) == sorted(want.score_vs_epoch)
    np.testing.assert_allclose(
        [got.score_vs_epoch[e] for e in sorted(got.score_vs_epoch)],
        [want.score_vs_epoch[e] for e in sorted(want.score_vs_epoch)],
        rtol=RTOL)
    np.testing.assert_allclose(got.best_model_score, want.best_model_score,
                               rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CONDITIONS))
def test_termination_matches_jax(name):
    (got, pnet), (want, _) = _run("port", name), _run("jax", name)
    _same_result(got, want)
    # an iteration condition stops before the epoch is counted or scored
    expect = {"max_epochs": 4, "score_improvement": 3,
              "max_score_iteration": 0, "max_time_iteration": 0}
    if name in expect:
        assert got.total_epochs == expect[name]
    assert got.best_model is not None


def test_score_every_second_epoch_matches_jax():
    (got, _), (want, _) = (_run("port", "max_epochs", evaluate_every=2),
                           _run("jax", "max_epochs", evaluate_every=2))
    _same_result(got, want)
    # the epoch conditions are checked only at the scored epochs
    assert sorted(got.score_vs_epoch) == [0, 2, 4]


def test_in_memory_saver_keeps_the_best_clone():
    saver = pes.InMemoryModelSaver()
    result, net = _run("port", "max_epochs", saver=saver)
    best = saver.get_best_model()
    assert best is result.best_model and best is not net
    _, valid = _iterators("port")
    np.testing.assert_allclose(
        pes.DataSetLossCalculator(valid).calculate_score(best),
        result.best_model_score, rtol=RTOL)
    assert saver.get_latest_model().iteration == net.iteration


def test_local_file_saver_zip_restores_in_both_packages(tmp_path):
    saver = pes.LocalFileModelSaver(str(tmp_path))
    result, net = _run("port", "max_epochs", saver=saver)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "bestModel.bin", "latestModel.bin"]
    best = result.best_model
    assert best.device.type == "cpu"
    _, valid = _iterators("port")
    np.testing.assert_allclose(
        pes.DataSetLossCalculator(valid).calculate_score(best),
        result.best_model_score, rtol=RTOL)
    jbest = jsavers.LocalFileModelSaver(str(tmp_path)).get_best_model()
    np.testing.assert_array_equal(np.asarray(jbest.get_flat_params()),
                                  best.get_flat_params())
    _, jvalid = _iterators("jax")
    np.testing.assert_allclose(
        jscore.DataSetLossCalculator(jvalid).calculate_score(jbest),
        result.best_model_score, rtol=RTOL)
    latest = jms.restore_multi_layer_network(str(tmp_path /
                                                 "latestModel.bin"))
    assert latest.iteration == net.iteration
    assert pes.LocalFileModelSaver(str(tmp_path / "empty"),
                                   device="cpu").get_best_model() is None


def _graph_pair():
    """The MLP of ``_pair`` as a two-branch ComputationGraph (a dense
    branch and a skip from the input, merged) in both packages."""
    from deeplearning4j_tpu.nn.computation_graph import \
        ComputationGraph as JaxCG
    from deeplearning4j_tpu.nn.conf.computation_graph import MergeVertex
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
        ComputationGraphConfiguration
    conf = (JaxConf.builder().seed(17).updater("sgd").learning_rate(0.1)
            .activation("tanh").graph_builder().add_inputs("in")
            .add_layer("d", jcore.DenseLayer(n_out=6), "in")
            .add_vertex("m", MergeVertex(), "d", "in")
            .add_layer("out", jcore.OutputLayer(
                n_out=3, activation="softmax", loss="mcxent"), "m")
            .set_outputs("out").set_input_types(jin.feed_forward(4))
            .build())
    jnet = JaxCG(conf).init()
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def test_a_graph_trains_under_early_stopping_and_its_best_zip_restores(
        tmp_path):
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    results = {}
    for pkg, net in zip(("jax", "port"), _graph_pair()):
        config_mod, term, score_mod, trainer_cls = (
            (jconfig, jterm, jscore, _JaxBatchTrainer) if pkg == "jax"
            else (pes, pes, pes, _PortBatchTrainer))
        train, valid = _iterators(pkg)
        saver = (pes.LocalFileModelSaver(str(tmp_path / pkg), device="cpu")
                 if pkg == "port" else jsavers.InMemoryModelSaver())
        conf = (config_mod.EarlyStoppingConfiguration.builder()
                .epoch_termination_conditions(
                    term.MaxEpochsTerminationCondition(4))
                .score_calculator(score_mod.DataSetLossCalculator(valid))
                .model_saver(saver).save_last_model(True).build())
        results[pkg] = (trainer_cls(conf, net, train).fit(), net, valid)
    jres, _, _ = results["jax"]
    pres, pnet, valid = results["port"]
    assert pres.best_model_epoch == jres.best_model_epoch
    assert pres.total_epochs == jres.total_epochs == 4
    np.testing.assert_allclose(
        [pres.score_vs_epoch[e] for e in sorted(pres.score_vs_epoch)],
        [jres.score_vs_epoch[e] for e in sorted(jres.score_vs_epoch)],
        rtol=RTOL)
    best = pres.best_model
    assert isinstance(best, ComputationGraph) and best is not pnet
    assert best.device.type == "cpu"
    np.testing.assert_allclose(
        pes.DataSetLossCalculator(valid).calculate_score(best),
        pres.best_model_score, rtol=RTOL)
    latest = pes.LocalFileModelSaver(str(tmp_path / "port"), device="cpu") \
        .get_latest_model()
    assert latest.iteration == pnet.iteration
    jbest = jsavers.LocalFileModelSaver(str(tmp_path / "port")) \
        .get_best_model()
    np.testing.assert_array_equal(np.asarray(jbest.get_flat_params()),
                                  best.get_flat_params())


def test_a_malformed_zip_is_refused_by_both_restores(tmp_path):
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        ModelSerializationError
    (tmp_path / "bestModel.bin").write_bytes(b"not a zip")
    saver = pes.LocalFileModelSaver(str(tmp_path), device="cpu")
    with pytest.raises(ModelSerializationError, match="not a valid model"):
        saver.get_best_model()


def test_parallel_trainer_waits_for_a9():
    """The parallel trainer, which waited for the ParallelWrapper (ROADMAP
    A9), now trains: ``tests/test_eval_earlystopping.py``'s
    ``test_early_stopping_parallel_trainer`` (4 workers, averaging every
    step, adam, 4 epochs of one round) gives the same epochs, best epoch
    and scores in both packages, on the same weights (rtol 2e-5: float32
    adam steps averaged over 4 workers, sums in another order)."""
    from deeplearning4j_tpu.earlystopping import savers as jsv
    from deeplearning4j_tpu.earlystopping.trainer import \
        EarlyStoppingParallelTrainer as JParallel

    def toy(pkg, seed=0):
        rng = np.random.RandomState(seed)
        x = rng.randn(128, 4)
        y = np.eye(3)[(x.sum(1) > 0).astype(int)]
        return (JaxList(JaxDataSet(x, y), 32) if pkg == "jax"
                else ListDataSetIterator(DataSet(x, y), 32))

    conf = (JaxConf.builder().seed(1).updater("adam").learning_rate(0.05)
            .activation("relu").weight_init("xavier").list()
            .layer(jcore.DenseLayer(n_in=4, n_out=16))
            .layer(jcore.OutputLayer(n_in=16, n_out=3)).build())
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))

    def config(m, saver, pkg):
        return (m.EarlyStoppingConfiguration.builder()
                .epoch_termination_conditions(
                    (jterm if pkg == "jax" else pes)
                    .MaxEpochsTerminationCondition(4))
                .score_calculator((jscore if pkg == "jax" else pes)
                                  .DataSetLossCalculator(toy(pkg, seed=9)))
                .model_saver(saver).build())

    jres = JParallel(config(jconfig, jsv.InMemoryModelSaver(), "jax"),
                     jnet, toy("jax"), workers=4,
                     averaging_frequency=1).fit()
    pres = pes.EarlyStoppingParallelTrainer(
        config(pes, pes.InMemoryModelSaver(), "port"), pnet, toy("port"),
        workers=4, averaging_frequency=1, devices=["cpu"] * 4).fit()
    assert pres.total_epochs == jres.total_epochs == 4
    assert pres.best_model_epoch == jres.best_model_epoch
    assert pres.best_model_score < 2.0
    np.testing.assert_allclose(pres.best_model_score, jres.best_model_score,
                               rtol=2e-5)
    assert sorted(pres.score_vs_epoch) == sorted(jres.score_vs_epoch)
    np.testing.assert_allclose(
        [pres.score_vs_epoch[e] for e in sorted(pres.score_vs_epoch)],
        [jres.score_vs_epoch[e] for e in sorted(jres.score_vs_epoch)],
        rtol=2e-5)
    assert pnet.iteration == jnet.iteration == 4
    np.testing.assert_allclose(pnet.get_flat_params(),
                               np.asarray(jnet.get_flat_params()),
                               rtol=2e-5, atol=2e-6)
