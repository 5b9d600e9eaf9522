"""Cluster-training frontends (port of
``deeplearning4j_tpu/scaleout/frontend.py``): the reference's
``dl4j-spark/.../impl/multilayer/SparkDl4jMultiLayer.java``
(``fit(JavaRDD<DataSet>):216``, ``fitPaths:260``, distributed
``evaluate:516+``, ``calculateScore``) and
``impl/graph/SparkComputationGraph.java``: user-facing wrappers binding a
network to a :class:`TrainingMaster`, with distributed evaluation/scoring
— partitions are evaluated on worker replicas in parallel and the partial
``Evaluation``/``RegressionEvaluation``/``ROC`` objects fold together via
``merge()`` (the reference's RDD ``aggregate`` of IEvaluation).

Replicas live on the network's device (pool threads sharing one card);
outputs cross to the host once a batch, as float numpy, where the
evaluators accumulate, as in the JAX package.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..datasets.dataset import DataSet
from .api import NetBroadcastTuple, TrainingMaster
from .data import load_dataset, partition_evenly


def _host(out) -> np.ndarray:
    """A network output as host numpy (float32 for a bf16 output)."""
    if isinstance(out, torch.Tensor):
        out = out.detach()
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()
    return np.asarray(out)


def _iter_loaded(part: List):
    """Yield DataSets from a partition of DataSets and/or export paths,
    loading paths one at a time (peak memory = one minibatch, the
    PathSparkDataSetIterator behavior)."""
    for item in part:
        yield load_dataset(item) if isinstance(item, str) else item


class _ClusterFrontend:
    def __init__(self, net, training_master: TrainingMaster):
        self.net = net
        self.training_master = training_master

    def fit(self, data: Iterable[DataSet]):
        """Train over a dataset collection (the RDD analogue)."""
        self.training_master.execute_training(self.net, data)
        return self.net

    def fit_paths(self, paths: Sequence[str]):
        """Train from exported minibatch files (reference ``fitPaths``)."""
        self.training_master.execute_training_paths(self.net, paths)
        return self.net

    # ---- distributed evaluation (reference evaluate:516+) ----------------
    def _num_eval_workers(self) -> int:
        return getattr(self.training_master, "num_workers", 1)

    def _distributed_fold(self, data: Iterable, run_partition: Callable):
        """Broadcast the model, evaluate partitions on replicas in
        parallel, merge the partials (the RDD aggregate pattern of
        ``ParameterAveragingTrainingMaster``'s eval path).  Partitions are
        lists of DataSets and/or export paths; paths load lazily inside
        each worker."""
        items = list(data)
        n = min(self._num_eval_workers(), max(len(items), 1))
        parts = partition_evenly(items, n)
        if len(parts) <= 1:
            return run_partition(self.net, parts[0] if parts else [])
        broadcast = NetBroadcastTuple.from_model(self.net)

        def run(part):
            return run_partition(broadcast.build_model(self.net.device),
                                 part)

        with ThreadPoolExecutor(max_workers=len(parts)) as pool:
            partials = list(pool.map(run, parts))
        result = partials[0]
        for p in partials[1:]:
            result.merge(p)
        return result

    def evaluate(self, data: Iterable[DataSet]):
        """Distributed classification eval (reference
        ``SparkDl4jMultiLayer.evaluate``): per-partition Evaluation objects
        merged on the master.  Delegates each partition to the container's
        own ``evaluate`` so masks, time-series flattening, and
        multi-input graphs behave exactly as in local evaluation."""
        return self._distributed_fold(
            data, lambda net, part: net.evaluate(list(_iter_loaded(part))))

    @staticmethod
    def _labels_out_mask(net, ds):
        """(labels, output, eval mask) with the containers' mask
        conventions (features_mask into the forward, labels-else-features
        mask for time-series scoring)."""
        from ..nn.computation_graph import ComputationGraph, _as_multi
        if isinstance(net, ComputationGraph):
            mds = _as_multi(ds)
            out = net.output(*mds.features,
                             features_masks=mds.features_masks)
            if isinstance(out, (list, tuple)):
                raise ValueError(
                    "distributed eval requires a single-output graph")
            labels = np.asarray(mds.labels[0])
            mask = None
            if mds.labels_masks is not None:
                mask = mds.labels_masks[0]
            elif mds.features_masks is not None:
                mask = mds.features_masks[0]
        else:
            out = net.output(ds.features, features_mask=ds.features_mask)
            labels = np.asarray(ds.labels)
            mask = (ds.labels_mask if ds.labels_mask is not None
                    else ds.features_mask)
        return labels, _host(out), None if mask is None else np.asarray(mask)

    def evaluate_regression(self, data: Iterable[DataSet]):
        """Distributed regression eval (reference ``evaluateRegression``)."""
        from ..eval.regression import RegressionEvaluation

        def run_partition(net, part):
            ev = RegressionEvaluation()
            for ds in _iter_loaded(part):
                labels, out, mask = self._labels_out_mask(net, ds)
                ev.eval(labels, out, mask)
            return ev

        return self._distributed_fold(data, run_partition)

    def evaluate_roc(self, data: Iterable[DataSet],
                     threshold_steps: int = 30):
        """Distributed binary-ROC eval (reference ``evaluateROC``)."""
        from ..eval.roc import ROC

        def run_partition(net, part):
            roc = ROC(threshold_steps)
            for ds in _iter_loaded(part):
                labels, out, _ = self._labels_out_mask(net, ds)
                roc.eval(labels, out)
            return roc

        return self._distributed_fold(data, run_partition)

    def calculate_score(self, data: Iterable[DataSet],
                        average: bool = True) -> float:
        """Distributed loss over the collection (reference
        ``calculateScore:~560``: sum of per-example scores, optionally
        averaged)."""
        items = list(data)
        n = min(self._num_eval_workers(), max(len(items), 1))
        parts = partition_evenly(items, n)
        broadcast = NetBroadcastTuple.from_model(self.net) \
            if len(parts) > 1 else None

        def run(part):
            net = broadcast.build_model(self.net.device) \
                if broadcast is not None else self.net
            total, count = 0.0, 0
            for ds in _iter_loaded(part):
                b = ds.num_examples()
                total += float(net.score(ds)) * b
                count += b
            return total, count

        if len(parts) <= 1:
            results = [run(parts[0] if parts else [])]
        else:
            with ThreadPoolExecutor(max_workers=len(parts)) as pool:
                results = list(pool.map(run, parts))
        total = sum(r[0] for r in results)
        count = sum(r[1] for r in results)
        if not count:
            return float("nan")
        return total / count if average else total

    def get_network(self):
        return self.net

    def get_score(self) -> float:
        return float(self.net.score())


class ClusterMultiLayer(_ClusterFrontend):
    """``SparkDl4jMultiLayer`` analogue."""


class ClusterComputationGraph(_ClusterFrontend):
    """``SparkComputationGraph`` analogue."""
