"""Serving tier of the port (port of ``deeplearning4j_tpu/serving``):
``InferenceEngine`` coalesces concurrent ``predict()`` calls into
bucket-shaped batches (``BucketPolicy`` owns the (batch, timestep)
ladder), and ``SessionCache`` keeps per-session RNN carries and KV-cache
rings on the device for streaming and autoregressive decode.  Serving v2
adds ``ModelRegistry`` (N named models paged LRU under a device byte
budget), ``SloAdmissionController`` (p99-target, tenant-fair load
shedding), the int8 weight path of ``serving.quantize`` and the engine's
weight versions.  ``serving.fleet`` runs N engine processes behind a
consistent-hash ``FleetRouter`` (health checks, respawn at the same rank,
elastic scaling, route fractions), each worker warming from the weight
store and building into the per-model namespace of
``serving.compile_cache``.
"""

from .admission import SloAdmissionController
from .bucketing import (BucketPolicy, assemble_batch, batch_ladder,
                        pad_rows, pad_time, time_mask)
from .compile_cache import (enable as enable_compile_cache,
                            stats as compile_cache_stats)
from .engine import InferenceEngine, QueueFull, ServingError, SloShed
from .fleet import FleetError, FleetRouter, HashRing
from .quantize import (dequantize_host, dequantize_tree, quantize_leaf,
                       quantize_tree, tree_nbytes)
from .registry import ModelRegistry, UnknownModel
from .sessions import SessionCache, SessionError, SessionStateError

__all__ = ["BucketPolicy", "FleetError", "FleetRouter", "HashRing",
           "InferenceEngine", "ModelRegistry",
           "QueueFull", "ServingError", "SessionCache", "SessionError",
           "SessionStateError", "SloAdmissionController", "SloShed",
           "UnknownModel", "assemble_batch", "batch_ladder",
           "compile_cache_stats", "dequantize_host", "dequantize_tree",
           "enable_compile_cache", "pad_rows", "pad_time",
           "quantize_leaf", "quantize_tree", "time_mask", "tree_nbytes"]
