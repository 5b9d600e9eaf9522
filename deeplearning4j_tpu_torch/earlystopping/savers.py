"""Model savers (port of ``deeplearning4j_tpu/earlystopping/savers.py``;
reference ``earlystopping/saver/``)."""

from __future__ import annotations

import os

from ..device import DeviceLike


class InMemoryModelSaver:
    """Reference ``saver/InMemoryModelSaver``: keep clones of the best and
    the latest model (``clone()`` copies params, state, updater state and
    the fp32 masters)."""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, net, score: float) -> None:
        self._best = net.clone()

    def save_latest_model(self, net, score: float) -> None:
        self._latest = net.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver:
    """Reference ``saver/LocalFileModelSaver``: ``bestModel.bin`` and
    ``latestModel.bin`` model zips in a directory, written atomically by
    the port's serializer (the JAX package restores them too); a
    MultiLayerNetwork's or a ComputationGraph's.  Restored models land on
    ``device``; by default on the device of the last
    saved net, else the card."""

    def __init__(self, directory: str, device: DeviceLike = None):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)

    def _write(self, net, name: str) -> None:
        from ..utils.model_serializer import write_model
        if self.device is None:
            self.device = net.device
        write_model(net, os.path.join(self.directory, name))

    def _read(self, name: str):
        from ..utils.model_serializer import (restore_computation_graph,
                                              restore_multi_layer_network)
        path = os.path.join(self.directory, name)
        if not os.path.exists(path):
            return None
        try:
            return restore_multi_layer_network(path, device=self.device)
        except Exception:
            # not a MultiLayerNetwork zip: a ComputationGraph's, or a
            # malformed zip that the graph restore rejects too, with this
            # error chained
            return restore_computation_graph(path, device=self.device)

    def save_best_model(self, net, score: float) -> None:
        self._write(net, "bestModel.bin")

    def save_latest_model(self, net, score: float) -> None:
        self._write(net, "latestModel.bin")

    def get_best_model(self):
        return self._read("bestModel.bin")

    def get_latest_model(self):
        return self._read("latestModel.bin")
