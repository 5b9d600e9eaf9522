"""Cluster-training tier (port of ``deeplearning4j_tpu/scaleout``;
reference layer 5, SURVEY.md §2.6b): the analogue of
``deeplearning4j-scaleout/spark/dl4j-spark``: the
``TrainingMaster``/``TrainingWorker`` SPI, the parameter-averaging
master, the Export-style file-sharded data path, multi-host wiring, the
parameter server with its compressed wire, the asynchronous trainer and
the cluster NLP.

Spark's master/executor split maps to a coordinator + workers.  The
averaging master's workers are threads of one process (the Spark
``local[N]`` pattern, reference ``BaseSparkTest.java:45``) whose replicas
share the network's device; several hosts run the same master each over
its path shard and average through a ``torch.distributed`` group
(:mod:`.dcn`).  The asynchronous trainer's workers are OS processes that
talk to the parameter server over TCP.
"""

from .api import NetBroadcastTuple, TrainingMaster, TrainingWorker
from .data import (DataSetExportFunction, PathDataSetIterator,
                   batch_and_export)
from .frontend import ClusterComputationGraph, ClusterMultiLayer
from .param_avg import (ParameterAveragingTrainingMaster,
                        ParameterAveragingTrainingWorker)

__all__ = [
    "NetBroadcastTuple", "TrainingMaster", "TrainingWorker",
    "DataSetExportFunction", "PathDataSetIterator", "batch_and_export",
    "ClusterComputationGraph", "ClusterMultiLayer",
    "ParameterAveragingTrainingMaster", "ParameterAveragingTrainingWorker",
]
