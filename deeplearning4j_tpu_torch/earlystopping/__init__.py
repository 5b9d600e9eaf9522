"""Early stopping of the port (port of ``deeplearning4j_tpu/earlystopping``;
reference ``deeplearning4j-nn/.../earlystopping/``)."""

from .config import EarlyStoppingConfiguration, EarlyStoppingResult  # noqa: F401
from .savers import InMemoryModelSaver, LocalFileModelSaver  # noqa: F401
from .scorecalc import DataSetLossCalculator  # noqa: F401
from .termination import (BestScoreEpochTerminationCondition,  # noqa: F401
                          MaxEpochsTerminationCondition,
                          MaxScoreIterationTerminationCondition,
                          MaxTimeIterationTerminationCondition,
                          ScoreImprovementEpochTerminationCondition)
from .trainer import (EarlyStoppingParallelTrainer,  # noqa: F401
                      EarlyStoppingTrainer)
