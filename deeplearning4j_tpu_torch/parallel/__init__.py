"""Parallelism tier of the port.

- :mod:`mesh` — the pod runtime: one ``("data", "zero", "pipe")`` mesh of
  slots, each a (process, device) pair, over a device list in one process
  (a device may repeat) or a ``torch.distributed`` pod (NCCL on the
  cards, gloo on the CPU), with the one reduction every mean goes through.
- :mod:`parallel_wrapper` — data parallelism with local-SGD parameter
  averaging (the reference ParallelWrapper).
- :mod:`zero` — ZeRO-1 cross-replica weight-update sharding.
- :mod:`pipeline` — GPipe-style pipeline stages in one process.
- :mod:`sequence` — ring / Ulysses / ring+flash sequence parallelism over
  a list of time shards, one per device (a device may be named more than
  once, which is how one card runs an n-shard ring).
- :mod:`scaling` — the scaling and collective-overhead harness.
- :mod:`main` — the launcher: the ParallelWrapper CLI, the pod worker and
  its launcher, the fleet worker.

Not ported yet (the next slice): the multi-process ring flash attention,
the multi-process ``ring_lstm_scan`` and a pipe axis across processes.
"""

from .mesh import MeshRuntime, ensure_distributed  # noqa: F401
from .parallel_wrapper import ParallelWrapper  # noqa: F401
from .pipeline import PipelineParallel  # noqa: F401
from .scaling import measure_throughput, scaling_report  # noqa: F401
from .sequence import SequenceParallel  # noqa: F401
from .zero import ZeroShardedParallelWrapper  # noqa: F401
