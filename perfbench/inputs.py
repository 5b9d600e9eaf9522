"""The benchmark's inputs, all made from ``--seed``: weights, batch-norm
state, images and labels.  Both the program and the reference are
handed what these functions make.  Each kind of input draws from its own
device generator, seeded from the run's seed and the kind's tag, in a
few large calls."""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference import ops


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag``'s stream of the run seeded ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as the program stores it: bf16 values under a bf16 policy."""
    if precision in ("mixed_bf16", "bf16"):
        return t.to(torch.bfloat16).float()
    return t


def make_weights(leaves: List[Tuple[str, tuple, str]], seed: int, device,
                 precision: str) -> Dict[str, torch.Tensor]:
    """He-normal kernels (sqrt(2 / fan_in)) and constant leaves (gammas,
    biases, betas) as the leaf list says: one normal draw for all
    kernels, views of it per leaf."""
    kernels = [(k, s) for k, s, init in leaves if init == "he"]
    total = sum(int(np.prod(s)) for _, s in kernels)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for leaf, shape, init in leaves:
        if init == "he":
            n = int(np.prod(shape))
            w = flat[at:at + n].reshape(shape) * ops.he_scale(shape)
            at += n
        else:
            w = torch.full(shape, float(init), device=device)
        out[leaf] = rounded(w, precision)
    return out


def make_state(leaves: List[Tuple[str, tuple, str]], device,
               precision: str) -> Dict[str, torch.Tensor]:
    return {leaf: rounded(torch.full(shape, float(init), device=device),
                          precision) for leaf, shape, init in leaves}


def make_images(n: int, cfg, seed: int, tag: str, device) -> np.ndarray:
    """``n`` uint8 NHWC images, drawn on ``device``, returned on the
    host."""
    shape = (n, cfg["height"], cfg["width"], cfg["channels"])
    g = generator(seed, tag, device)
    return torch.randint(0, 256, shape, generator=g, device=device,
                         dtype=torch.uint8).cpu().numpy()


def make_labels(n: int, classes: int, seed: int, tag: str,
                device) -> np.ndarray:
    """``n`` one-hot float32 labels over ``classes``, on the host."""
    g = generator(seed, tag, device)
    idx = torch.randint(0, classes, (n,), generator=g, device=device)
    return torch.nn.functional.one_hot(idx, classes).float().cpu().numpy()


def decode(u8: np.ndarray, device) -> torch.Tensor:
    """uint8 pixels to float32 in [0, 1], as ImagePreProcessingScaler's
    ``u8 / 255`` computes them."""
    t = torch.from_numpy(np.ascontiguousarray(u8)).to(device)
    return t.float() / torch.tensor(255.0, device=device)
