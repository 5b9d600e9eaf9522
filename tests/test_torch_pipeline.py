"""The port's single-process pipeline (``parallel/pipeline.py``) against
the JAX package's ``PipelineParallel`` (``tests/test_pipeline_parallel.
py``'s twins) and the serial step: the same stage ranges, one pipelined
step equal to the serial step for (stages, microbatches) in (2, 4),
(4, 4), (4, 8), several adam steps, and the same scope refusals.  The
stages run on ``devices=["cpu"] * S``.

Tolerances: float64 sgd at 1e-12 against the port's serial step and
1e-10 against JAX; float64 adam at 1e-8 against JAX (its betas are
float32).
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel.pipeline import \
    PipelineParallel as JPipeline
from deeplearning4j_tpu.parallel.pipeline import \
    partition_stages as jpartition
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.jax_weights import load_jax_params
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.mesh import MeshRuntime
from deeplearning4j_tpu_torch.parallel.pipeline import (PipelineParallel,
                                                        partition_stages)


def _conf(widths=(16, 12, 8), updater="sgd", lr=0.2, seed=11,
          dropout=0.0):
    b = (JConf.builder().seed(seed).updater(updater).learning_rate(lr)
         .activation("tanh").weight_init("xavier").dtype("float64")
         .list())
    for w in widths:
        b = b.layer(jcore.DenseLayer(n_out=w, dropout=dropout))
    b = b.layer(jcore.OutputLayer(n_out=3))
    return b.set_input_type(jin.feed_forward(6)).build()


def _pair(jconf):
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    load_jax_params(pnet, np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _data(b=16, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(b, 6)
    y = np.eye(3)[(X[:, 0] > 0).astype(int) + (X[:, 1] > 0).astype(int)]
    return X, y


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_partition_stages_matches_jax(stages):
    jnet, pnet = _pair(_conf(widths=(32, 16, 8, 8)))
    ranges = partition_stages(pnet.layers, pnet.params, stages)
    assert ranges == jpartition(jnet.layers, jnet.params, stages)
    assert ranges[0][0] == 0 and ranges[-1][1] == len(pnet.layers)
    for (a, b), (c, d) in zip(ranges, ranges[1:]):
        assert b == c and a < b


@pytest.mark.parametrize("stages,microbatches", [(2, 4), (4, 4), (4, 8)])
def test_pipeline_matches_serial_training_and_jax(stages, microbatches):
    jnet, pnet = _pair(_conf())
    _, ref = _pair(_conf())
    X, y = _data()
    JPipeline(jnet, stages=stages, microbatches=microbatches,
              devices=jax.devices()[:stages]).fit([JDS(X, y)])
    pp = PipelineParallel(pnet, stages=stages, microbatches=microbatches,
                          devices=["cpu"] * stages)
    pp.fit([DataSet(X, y)])
    ref.fit(DataSet(X, y))
    np.testing.assert_allclose(pnet.get_flat_params(),
                               ref.get_flat_params(), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(pnet.get_flat_params(),
                               np.asarray(jnet.get_flat_params()),
                               rtol=1e-10, atol=1e-10)
    assert pnet.iteration == jnet.iteration == 1
    assert float(pnet._score) == pytest.approx(float(jnet._score),
                                               rel=1e-10)


def test_pipeline_multi_step_adam_matches():
    jnet, pnet = _pair(_conf(updater="adam", lr=0.01))
    jp = JPipeline(jnet, stages=4, microbatches=4,
                   devices=jax.devices()[:4])
    pp = PipelineParallel(pnet, stages=4, microbatches=4,
                          devices=["cpu"] * 4)
    for step in range(4):
        X, y = _data(seed=step)
        jp.fit([JDS(X, y)])
        pp.fit([DataSet(X, y)])
    np.testing.assert_allclose(pnet.get_flat_params(),
                               np.asarray(jnet.get_flat_params()),
                               rtol=1e-8, atol=1e-8)
    assert pnet.iteration == 4


def test_pipeline_scope_checks():
    _, net = _pair(_conf())
    with pytest.raises(ValueError, match="not divisible"):
        PipelineParallel(net, stages=2, microbatches=3,
                         devices=["cpu"] * 2).fit([DataSet(*_data(b=16))])
    _, drop = _pair(_conf(widths=(8,), dropout=0.5))
    with pytest.raises(ValueError, match="dropout"):
        PipelineParallel(drop, stages=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="stages > "):
        PipelineParallel(_pair(_conf())[1], stages=5, devices=["cpu"] * 5)
    with pytest.raises(ValueError, match="stages > "):
        PipelineParallel(net, stages=3, devices=["cpu"] * 2)
    rconf = (JConf.builder().seed(1).updater("sgd").learning_rate(0.1)
             .weight_init("xavier").list()
             .layer(jrec.GravesLSTM(n_in=3, n_out=4))
             .layer(jrec.RnnOutputLayer(n_in=4, n_out=2)).build())
    with pytest.raises(ValueError, match="not feed-forward"):
        PipelineParallel(_pair(rconf)[1], stages=2, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PipelineParallel(net, stages=2)


def test_a_pipe_axis_across_processes_waits_for_the_next_slice():
    _, net = _pair(_conf())
    rt = MeshRuntime.local(pipe=2, devices=["cpu"] * 2)
    rt._process = (0, 2)          # a runtime that spans two processes
    with pytest.raises(NotImplementedError, match="next slice"):
        PipelineParallel(net, runtime=rt)
