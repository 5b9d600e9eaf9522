"""StatsListener: the training-side observability hook (port of
``deeplearning4j_tpu/ui/stats_listener.py``).

Equivalent of the reference's
``deeplearning4j-ui-parent/deeplearning4j-ui-model/src/main/java/org/
deeplearning4j/ui/stats/BaseStatsListener.java`` (735 LoC): an
``IterationListener`` that posts one static initialization report
(hardware/software info, ``BaseStatsListener.java:546-567``) and then, every
``update_frequency`` iterations, a stats report sampling score, effective
learning rates, throughput, per-param histograms + mean magnitudes and
update:param ratios, and process memory/GC (``StatsReport.java:44-242``,
memory+GC at ``BaseStatsListener.java:320-366``) into a
:class:`~deeplearning4j_tpu.ui.storage.StatsStorageRouter`.

Sampling runs on the host after the train step returns; the device
fetch of the param trees happens only on report iterations.  Update
magnitudes default to the param delta accumulated since the previous
report (a windowed delta, labelled as such in the report).  When the
device-side health layer is enabled (``monitor.enable_health()``) the
step itself computes exact per-step per-layer grad/update statistics,
and this listener switches the update:param ratios to those device
values — ``report["update_stats_source"]`` says which source produced
them.

The static report names the torch build (``torch_version``, where the
JAX package writes ``jax_version``), the model's device type as
``backend`` (``"cuda"`` or ``"cpu"``), and the card's name as
``device_kind``; an update on a CUDA model also carries the card's
``device_memory_allocated_mb`` and ``device_memory_peak_mb``
(``torch.cuda``) beside the process RSS.
"""

from __future__ import annotations

import gc
import platform
import resource
import time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from ..optimize.listeners.listeners import TrainingListener
from .storage import Persistable, StatsStorageRouter

TYPE_ID = "StatsListener"


def _param_tables(model) -> Dict[str, np.ndarray]:
    """Named numpy params from either network container."""
    return model.param_table()


def _device_of(model) -> torch.device:
    return torch.device(getattr(model, "device", "cpu"))


def _learning_rates(model, iteration: int) -> Dict[str, float]:
    """Effective per-layer lr at this iteration (reference
    ``StatsReport.reportLearningRates``)."""
    from ..nn import updaters as _updaters
    out = {}
    layers = getattr(model, "layers", None)
    if layers is not None:     # MultiLayerNetwork
        for i in range(len(layers)):
            conf = model._updater_conf(i)
            out[str(i)] = float(_updaters.learning_rate_for(conf, iteration))
    else:                      # ComputationGraph
        for name in model._layer_names():
            conf = model._updater_conf(name)
            out[name] = float(_updaters.learning_rate_for(conf, iteration))
    return out


class StatsListener(TrainingListener):
    """Sample training statistics into a stats-storage router.

    Parameters mirror the reference builder: ``update_frequency`` (post
    every N iterations), ``collect_histograms`` (param/update histograms),
    ``histogram_bins``.  ``session_id`` defaults to a fresh UUID per
    listener (reference uses the same scheme)."""

    def __init__(self, router: StatsStorageRouter,
                 update_frequency: int = 10,
                 session_id: Optional[str] = None,
                 worker_id: str = "worker_0",
                 collect_histograms: bool = True,
                 histogram_bins: int = 20):
        self.router = router
        self.update_frequency = max(1, update_frequency)
        self.session_id = session_id or f"session_{uuid.uuid4().hex[:12]}"
        self.worker_id = worker_id
        self.collect_histograms = collect_histograms
        self.histogram_bins = histogram_bins
        self._init_posted = False
        self._last_report_time: Optional[float] = None
        self._last_report_iter: Optional[int] = None
        self._last_params: Optional[Dict[str, np.ndarray]] = None

    # ---- static init report (BaseStatsListener.java:546-567) -------------
    def _post_init_report(self, model) -> None:
        device = _device_of(model)
        on_card = device.type == "cuda"
        data = {
            "report_type": "init",
            "hostname": platform.node(),
            "os": platform.platform(),
            "python": platform.python_version(),
            "torch_version": torch.__version__,
            "backend": device.type,
            "device_count": (torch.cuda.device_count() if on_card else 1),
            "device_kind": (torch.cuda.get_device_name(device)
                            if on_card else "cpu"),
            "model_class": type(model).__name__,
            "num_params": int(model.num_params()),
            "model_config_json": self._config_json(model),
        }
        self.router.put_static_info(Persistable(
            self.session_id, TYPE_ID, self.worker_id, time.time(), data))
        self._init_posted = True

    @staticmethod
    def _config_json(model) -> Optional[str]:
        try:
            return model.conf.to_json()
        except Exception:
            return None

    # ---- per-iteration hook ----------------------------------------------
    def iteration_done(self, model, iteration: int) -> None:
        if not self._init_posted:
            self._post_init_report(model)
        if iteration % self.update_frequency != 0:
            return
        now = time.time()
        params = _param_tables(model)

        report: Dict = {
            "report_type": "update",
            "iteration": iteration,
            "epoch": getattr(model, "epoch", 0),
            "score": float(model.score()),
            "learning_rates": _learning_rates(model, iteration),
        }

        # throughput (PerformanceListener.java:99-102 semantics)
        if self._last_report_time is not None:
            dt = now - self._last_report_time
            iters = iteration - (self._last_report_iter or 0)
            if dt > 0 and iters > 0:
                batches_per_sec = iters / dt
                bs = getattr(model, "last_batch_size", None)
                report["batches_per_sec"] = batches_per_sec
                if bs:
                    report["samples_per_sec"] = batches_per_sec * bs

        # param stats: mean magnitudes, update magnitudes (windowed delta),
        # update:param ratio (StatsReport.java:168-242)
        mean_mags: Dict[str, float] = {}
        update_mags: Dict[str, float] = {}
        ratios: Dict[str, float] = {}
        histograms: Dict[str, Dict] = {}
        for name, p in params.items():
            pm = float(np.mean(np.abs(p)))
            mean_mags[name] = pm
            if self._last_params is not None and name in self._last_params:
                um = float(np.mean(np.abs(p - self._last_params[name])))
                update_mags[name] = um
                ratios[name] = um / pm if pm > 0 else 0.0
            if self.collect_histograms:
                counts, edges = np.histogram(p.ravel(),
                                             bins=self.histogram_bins)
                histograms[name] = {
                    "min": float(edges[0]), "max": float(edges[-1]),
                    "counts": counts.tolist(),
                }
        report["param_mean_magnitudes"] = mean_mags
        report["update_stats_source"] = "windowed_delta"
        from ..monitor import health as _health
        hsnap = _health.last_for(model) if _health.enabled() else None
        if hsnap is not None:
            # Exact per-step device stats from the packed scan output:
            # per-layer update:param L2 ratios replace the windowed
            # approximation (params are keyed "<layer>_<param>"; every
            # param of a layer shares its layer's device ratio).
            dev_ratios = {
                name: hsnap["layers"][layer]["update_ratio"]
                for name in params
                for layer in [name.rsplit("_", 1)[0]]
                if layer in hsnap["layers"]}
            if dev_ratios:
                report["update_stats_source"] = "device_per_step"
                report["health"] = {
                    "state": _health.state(),
                    "loss": hsnap["loss"],
                    "flagged_steps": hsnap["flagged_steps"],
                    "layers": hsnap["layers"],
                }
                ratios = dev_ratios
                if update_mags:
                    report["update_mean_magnitudes"] = update_mags
                report["update_param_ratios"] = ratios
        if report["update_stats_source"] == "windowed_delta" and update_mags:
            report["update_mean_magnitudes"] = update_mags
            report["update_param_ratios"] = ratios
        if histograms:
            report["param_histograms"] = histograms

        # memory + GC (BaseStatsListener.java:320-366; JVM heap/GC becomes
        # process RSS + python gc generation counts)
        report["memory_rss_mb"] = \
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
        report["gc_counts"] = list(gc.get_count())
        device = _device_of(model)
        if device.type == "cuda":
            report["device_memory_allocated_mb"] = \
                torch.cuda.memory_allocated(device) / 2**20
            report["device_memory_peak_mb"] = \
                torch.cuda.max_memory_allocated(device) / 2**20

        self.router.put_update(Persistable(
            self.session_id, TYPE_ID, self.worker_id, now, report))
        self._last_report_time = now
        self._last_report_iter = iteration
        self._last_params = params
