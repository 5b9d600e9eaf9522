"""Device resolution for the port's entry points.

Every entry point (``MultiLayerNetwork(conf, device=None)``,
``ops.attention.flash_attention(..., device=None)``) runs on the CUDA card
unless the caller asks for the CPU.  With no card present and no explicit
``device="cpu"``, resolution raises: the port never carries on silently on
the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``cuda``).  Raises ``RuntimeError`` when a
    CUDA device is asked for (or defaulted to) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def same_device(tensor: torch.Tensor, device: Optional[torch.device]) -> None:
    """Raise unless ``tensor`` lives on ``device`` (device types compared,
    plus the index when both carry one)."""
    if device is None:
        return
    if tensor.device.type != device.type or (
            device.index is not None and tensor.device.index is not None
            and tensor.device.index != device.index):
        raise ValueError(
            f"tensor on {tensor.device} but the call asked for {device}")
