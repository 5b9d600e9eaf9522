"""Layer/config validation (port of the list-configuration part of
``deeplearning4j_tpu/nn/conf/validation.py``).  Hard inconsistencies
raise; suspicious but legal combinations log a warning."""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")

_KNOWN_GRAD_NORM = {"none", "renormalizel2perlayer",
                    "renormalizel2perparamtype",
                    "clipelementwiseabsolutevalue",
                    "clipl2perlayer", "clipl2perparamtype"}


def validate_layer(layer, index: Optional[int] = None,
                   require_shapes: bool = True) -> None:
    where = f"layer {index}" if index is not None else type(layer).__name__
    n_in = getattr(layer, "n_in", None)
    n_out = getattr(layer, "n_out", None)
    if require_shapes and n_out is not None and n_out <= 0:
        raise ValueError(f"{where}: n_out must be positive (got {n_out}); "
                         f"set n_out or provide an input type")
    if n_in is not None and n_in < 0:
        raise ValueError(f"{where}: n_in is negative ({n_in})")
    dropout = getattr(layer, "dropout", None)
    if dropout is not None and not 0.0 <= float(dropout) < 1.0:
        raise ValueError(f"{where}: dropout must be in [0, 1), got "
                         f"{dropout}")
    for reg in ("l1", "l2"):
        v = getattr(layer, reg, None)
        if v is not None and float(v) < 0:
            raise ValueError(f"{where}: {reg} must be >= 0, got {v}")
    act = getattr(layer, "activation", None)
    if isinstance(act, str):
        from .. import activations
        activations.get(act)
    loss = getattr(layer, "loss", None)
    if isinstance(loss, str):
        from .. import lossfunctions
        lossfunctions.get(loss)
    if dropout is not None and float(dropout) > 0.9:
        logger.warning("%s: dropout %.2f keeps <10%% of activations — "
                       "likely a keep-prob/drop-prob mixup", where, dropout)


def validate_multi_layer_configuration(mlc) -> None:
    shapes_known = mlc.input_type is not None
    for i, layer in enumerate(mlc.layers):
        validate_layer(layer, index=i, require_shapes=shapes_known)
    gn = getattr(mlc.conf, "gradient_normalization", None)
    if isinstance(gn, str) and gn.lower().replace("_", "") \
            not in _KNOWN_GRAD_NORM:
        raise ValueError(f"unknown gradient_normalization {gn!r}")
    if mlc.backprop_type == "tbptt":
        raise NotImplementedError("truncated BPTT is not ported yet")
