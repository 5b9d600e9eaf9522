"""Observability and HTTP tier of the port (port of
``deeplearning4j_tpu/ui``):

- :mod:`storage` — the ``StatsStorage`` SPI with in-memory and sqlite-file
  backends (the file format is the JAX package's, readable both ways).
- :mod:`stats_listener` — ``StatsListener``, the training hook sampling
  score, learning rates, throughput, per-param histograms and magnitudes,
  process and card memory.
- :mod:`server` — ``UIServer``: the training dashboard, the remote stats
  receiver, and the serving front door (``POST /predict``, ``/metrics``,
  ``/trace``, ``/alerts``, ``/models``, ``/tenants``, ``/deploy``,
  ``/fleet``), plus ``RemoteStatsStorageRouter``.

Not ported yet (ROADMAP A11): ``components.py`` (the chart components),
``legacy.py`` (the Dropwizard-era listeners) and ``main.py``.
"""

from .storage import (FileStatsStorage, InMemoryStatsStorage, Persistable,
                      StatsStorage, StatsStorageRouter)
from .stats_listener import StatsListener
from .server import RemoteStatsStorageRouter, UIServer

__all__ = [
    "FileStatsStorage", "InMemoryStatsStorage", "Persistable",
    "RemoteStatsStorageRouter", "StatsListener", "StatsStorage",
    "StatsStorageRouter", "UIServer",
]
