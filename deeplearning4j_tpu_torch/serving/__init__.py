"""Serving tier of the port (port of ``deeplearning4j_tpu/serving``):
``InferenceEngine`` coalesces concurrent ``predict()`` calls into
bucket-shaped batches (``BucketPolicy`` owns the (batch, timestep)
ladder), and ``SessionCache`` keeps per-session RNN carries and KV-cache
rings on the device for streaming and autoregressive decode.
"""

from .bucketing import (BucketPolicy, assemble_batch, batch_ladder,
                        pad_rows, pad_time, time_mask)
from .engine import InferenceEngine, QueueFull, ServingError
from .sessions import SessionCache, SessionError, SessionStateError

__all__ = ["BucketPolicy", "InferenceEngine", "QueueFull", "ServingError",
           "SessionCache", "SessionError", "SessionStateError",
           "assemble_batch", "batch_ladder", "pad_rows", "pad_time",
           "time_mask"]
