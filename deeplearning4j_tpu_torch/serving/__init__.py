"""Serving tier of the port (port of ``deeplearning4j_tpu/serving``):
``InferenceEngine`` coalesces concurrent ``predict()`` calls into
bucket-shaped batches (``BucketPolicy`` owns the (batch, timestep)
ladder), and ``SessionCache`` keeps per-session RNN carries and KV-cache
rings on the device for streaming and autoregressive decode.  Serving v2
adds ``ModelRegistry`` (N named models paged LRU under a device byte
budget), ``SloAdmissionController`` (p99-target, tenant-fair load
shedding), the int8 weight path of ``serving.quantize`` and the engine's
weight versions.  The fleet of worker processes and its compile cache
are not ported yet (ROADMAP A8).
"""

from .admission import SloAdmissionController
from .bucketing import (BucketPolicy, assemble_batch, batch_ladder,
                        pad_rows, pad_time, time_mask)
from .engine import InferenceEngine, QueueFull, ServingError, SloShed
from .quantize import (dequantize_host, dequantize_tree, quantize_leaf,
                       quantize_tree, tree_nbytes)
from .registry import ModelRegistry, UnknownModel
from .sessions import SessionCache, SessionError, SessionStateError

__all__ = ["BucketPolicy", "InferenceEngine", "ModelRegistry",
           "QueueFull", "ServingError", "SessionCache", "SessionError",
           "SessionStateError", "SloAdmissionController", "SloShed",
           "UnknownModel", "assemble_batch", "batch_ladder",
           "dequantize_host", "dequantize_tree", "pad_rows", "pad_time",
           "quantize_leaf", "quantize_tree", "time_mask", "tree_nbytes"]
