"""Precision policy: storage/compute/updater dtypes + fp32 master weights
(port of ``deeplearning4j_tpu/nn/precision.py``).

A :class:`PrecisionPolicy` is resolved once per network at ``init()``,
from three sources in precedence order:

1. ``DL4J_TPU_PRECISION`` env: ``fp32``/``float32``, ``bf16``/``bfloat16``
   (pure bf16, no masters) or ``mixed_bf16``/``mixed`` (bf16 params and
   activations, fp32 master copies in the updater state).
2. Explicit ``NeuralNetConfiguration`` fields: a non-default ``dtype``
   and/or a ``compute_dtype``.
3. Device default: **mixed_bf16 on a CUDA device, fp32 on the CPU** (the
   JAX package's "on a TPU" becomes "on the card").

Master-weight contract: with ``master_weights`` on, each layer's updater
state carries a ``"_master"`` dict of fp32 copies of its updatable params;
all updater math runs on the masters and the bf16 params are re-derived by
one cast per step.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

_ENV = "DL4J_TPU_PRECISION"

FP32 = "fp32"
BF16 = "bf16"
MIXED_BF16 = "mixed_bf16"

_MODE_ALIASES = {
    "fp32": FP32, "float32": FP32, "f32": FP32,
    "bf16": BF16, "bfloat16": BF16, "pure_bf16": BF16,
    "mixed_bf16": MIXED_BF16, "mixed": MIXED_BF16,
    "bf16_fp32_master": MIXED_BF16,
}

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Resolved dtype decisions for one network instance."""

    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    updater_dtype: torch.dtype
    master_weights: bool
    name: str

    @property
    def downcasts_output(self) -> bool:
        """True when activations are below fp32, so outputs are cast to
        fp32 before the loss, softmax and metrics (fp32-logits contract)."""
        return (self.compute_dtype.is_floating_point
                and self.compute_dtype.itemsize < 4)

    def describe(self) -> str:
        """The JAX package's text (dtype names without ``torch.``), which
        checkpoints stamp to refuse a resume under another policy."""
        def name(d):
            return str(d).rsplit(".", 1)[-1]
        return "%s(param=%s,compute=%s,updater=%s,masters=%d)" % (
            self.name, name(self.param_dtype), name(self.compute_dtype),
            name(self.updater_dtype), int(self.master_weights))


_FP32_POLICY = PrecisionPolicy(torch.float32, torch.float32, torch.float32,
                               False, FP32)
_BF16_POLICY = PrecisionPolicy(torch.bfloat16, torch.bfloat16,
                               torch.bfloat16, False, BF16)
_MIXED_POLICY = PrecisionPolicy(torch.bfloat16, torch.bfloat16,
                                torch.float32, True, MIXED_BF16)
_NAMED = {FP32: _FP32_POLICY, BF16: _BF16_POLICY, MIXED_BF16: _MIXED_POLICY}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype for a conf dtype string ("float32", "bfloat16")."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def env_mode() -> Optional[str]:
    """Canonical mode requested via DL4J_TPU_PRECISION, or None."""
    raw = os.environ.get(_ENV, "").strip().lower()
    if not raw:
        return None
    mode = _MODE_ALIASES.get(raw)
    if mode is None:
        raise ValueError("%s=%r not understood; expected one of %s"
                         % (_ENV, raw, sorted(set(_MODE_ALIASES))))
    return mode


def named_policy(mode: str) -> PrecisionPolicy:
    return _NAMED[_MODE_ALIASES[mode]]


def resolve_policy(gconf, device: torch.device) -> PrecisionPolicy:
    """Resolve the policy for one network from its GlobalConfig and the
    device it runs on."""
    conf_dtype = getattr(gconf, "dtype", "float32") or "float32"
    conf_compute = getattr(gconf, "compute_dtype", None)
    explicit = conf_dtype != "float32" or conf_compute is not None

    mode = env_mode()
    if mode is not None:
        return _NAMED[mode]
    if explicit:
        param = dtype_of(conf_dtype)
        compute = dtype_of(conf_compute) if conf_compute else param
        low_param = param.is_floating_point and param.itemsize < 4
        return PrecisionPolicy(
            param_dtype=param, compute_dtype=compute,
            updater_dtype=torch.float32 if low_param else param,
            master_weights=low_param, name="custom")
    return _MIXED_POLICY if device.type == "cuda" else _FP32_POLICY


def publish(policy: PrecisionPolicy) -> None:
    """Expose the resolved policy on the metrics registry: the
    ``precision_param_bits``, ``precision_compute_bits`` and
    ``precision_master_weights`` gauges."""
    from .. import monitor
    monitor.gauge("precision_param_bits").set(
        policy.param_dtype.itemsize * 8)
    monitor.gauge("precision_compute_bits").set(
        policy.compute_dtype.itemsize * 8)
    monitor.gauge("precision_master_weights").set(
        int(policy.master_weights))
