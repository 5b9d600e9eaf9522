"""TrainingMaster / TrainingWorker SPI (port of
``deeplearning4j_tpu/scaleout/api.py``; reference
``dl4j-spark/src/main/java/org/deeplearning4j/spark/api/TrainingMaster.java``
and ``TrainingWorker.java``): the master owns split sizing and
aggregation; the worker owns "fit my partition and hand back results".
Broadcast state travels as a :class:`NetBroadcastTuple` (reference
``api/worker/NetBroadcastTuple.java``: conf + params + updater state),
plain JSON + float arrays, so one crosses processes and packages: a tuple
made from a JAX-package network configures a port replica.

The flat params are the network's ``get_flat_params`` (layer/param order,
float64 for a float64 network, else float32) and the updater state its
``get_flat_updater_state`` (float32, the JAX package's leaf order).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from ..device import DeviceLike


@dataclasses.dataclass
class NetBroadcastTuple:
    """Conf+params+updater-state broadcast (reference
    ``NetBroadcastTuple.java``).  ``model_class`` selects the container
    (``MultiLayerNetwork`` | ``ComputationGraph``)."""

    model_class: str
    conf_json: str
    params: np.ndarray
    updater_state: Optional[np.ndarray]
    iteration: int = 0

    @staticmethod
    def from_model(net) -> "NetBroadcastTuple":
        net.init()
        return NetBroadcastTuple(
            model_class=type(net).__name__,
            conf_json=net.conf.to_json(),
            params=net.get_flat_params(),
            updater_state=net.get_flat_updater_state(),
            iteration=net.iteration,
        )

    def build_model(self, device: DeviceLike = None):
        """Materialize a fresh replica on ``device`` (None: the card; the
        per-executor model creation in reference
        ``ParameterAveragingTrainingWorker.getInitialModel:89``)."""
        if self.model_class == "MultiLayerNetwork":
            from ..nn.conf.neural_net_configuration import (
                MultiLayerConfiguration)
            from ..nn.multilayer import MultiLayerNetwork
            net = MultiLayerNetwork(
                MultiLayerConfiguration.from_json(self.conf_json),
                device=device).init()
        elif self.model_class == "ComputationGraph":
            from ..nn.computation_graph import ComputationGraph
            from ..nn.conf.computation_graph import (
                ComputationGraphConfiguration)
            net = ComputationGraph(
                ComputationGraphConfiguration.from_json(self.conf_json),
                device=device).init()
        else:
            raise ValueError(f"Unknown model class {self.model_class!r}")
        net.set_flat_params(self.params)
        if self.updater_state is not None and self.updater_state.size:
            net.set_flat_updater_state(self.updater_state)
        net.iteration = self.iteration
        return net


@dataclasses.dataclass
class WorkerResult:
    """What a worker hands back after one split (reference
    ``ParameterAveragingAggregationTuple``): flat params + updater state +
    how much data it actually consumed (weights the average)."""

    params: np.ndarray
    updater_state: Optional[np.ndarray]
    batches_processed: int
    score: float


class TrainingWorker:
    """Reference ``TrainingWorker.java`` contract."""

    def configure(self, broadcast: NetBroadcastTuple,
                  device: DeviceLike = None) -> None:
        raise NotImplementedError

    def process_partition(self, partition: Iterable) -> WorkerResult:
        """Fit every minibatch in ``partition``; return the result tuple."""
        raise NotImplementedError


class TrainingMaster:
    """Reference ``TrainingMaster.java`` contract: drive workers over a
    data source and fold their results back into the master model."""

    def execute_training(self, net, data_source) -> None:
        raise NotImplementedError

    def execute_training_paths(self, net, paths: Sequence[str]) -> None:
        raise NotImplementedError
