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
- :mod:`components` — JSON-serializable chart, table and text components
  with server-side SVG rendering (the JAX package's strings).
- :mod:`legacy` — ``HistogramIterationListener`` and
  ``ConvolutionalIterationListener`` (the Dropwizard-era listeners).
- :mod:`main` — the dashboard's command line
  (``python -m deeplearning4j_tpu_torch.ui.main --port 9000``).
"""

from .storage import (FileStatsStorage, InMemoryStatsStorage, Persistable,
                      StatsStorage, StatsStorageRouter)
from .stats_listener import StatsListener
from .server import RemoteStatsStorageRouter, UIServer
from .components import (ChartHistogram, ChartLine, ChartScatter, Component,
                         ComponentDiv, ComponentTable, ComponentText,
                         StyleChart, StyleTable, StyleText, render_page,
                         render_to_file)
from .legacy import (ConvolutionalIterationListener,
                     HistogramIterationListener)

__all__ = [
    "FileStatsStorage", "InMemoryStatsStorage", "Persistable",
    "RemoteStatsStorageRouter", "StatsListener", "StatsStorage",
    "StatsStorageRouter", "UIServer",
    "ChartHistogram", "ChartLine", "ChartScatter", "Component",
    "ComponentDiv", "ComponentTable", "ComponentText", "StyleChart",
    "StyleTable", "StyleText", "render_page", "render_to_file",
    "ConvolutionalIterationListener", "HistogramIterationListener",
]
