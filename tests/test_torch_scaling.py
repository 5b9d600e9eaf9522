"""The port's scaling harness (``parallel/scaling.py``, the twins of
``tests/test_scaling.py``): the collective-overhead report's shape, the
workers=1 throughput, and the workers=1 efficiency of 1.  On the CPU."""

import numpy as np
import pytest

from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.scaling import (
    collective_overhead_report, measure_throughput, scaling_report)


def _factory():
    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater("sgd").learning_rate(0.1)
            .activation("tanh").weight_init("xavier").list()
            .layer(DenseLayer(n_in=4, n_out=8))
            .layer(OutputLayer(n_in=8, n_out=3)).build())
    return MultiLayerNetwork(conf, device="cpu")


def test_collective_overhead_report_shape():
    rep = collective_overhead_report(_factory, batch_size=16,
                                     feature_shape=(4,), n_classes=3,
                                     steps=2, trials=1, pipeline=2)
    assert set(rep) == {"plain_step_ms", "wrapper_step_ms", "overhead_ms",
                        "overhead_ratio", "batch", "device"}
    assert rep["plain_step_ms"] > 0 and rep["wrapper_step_ms"] > 0
    assert rep["batch"] == 16 and rep["device"] == "cpu"
    assert rep["overhead_ratio"] == pytest.approx(
        rep["wrapper_step_ms"] / rep["plain_step_ms"], rel=1e-2)
    assert rep["overhead_ms"] == pytest.approx(
        rep["wrapper_step_ms"] - rep["plain_step_ms"], abs=1e-2)


def test_measure_throughput_workers1_degenerate():
    tput = measure_throughput(_factory, workers=1, batch_size=8,
                              n_rounds=2, feature_shape=(4,), n_classes=3,
                              warmup_rounds=1)
    assert np.isfinite(tput) and tput > 0


def test_scaling_report_workers1_efficiency_is_one():
    rep = scaling_report(_factory, [1], batch_size=8, n_rounds=2,
                         feature_shape=(4,), n_classes=3, warmup_rounds=1)
    assert set(rep) == {1}
    assert rep[1]["workers"] == 1
    assert rep[1]["efficiency"] == pytest.approx(1.0)
    assert rep[1]["samples_per_sec"] > 0
