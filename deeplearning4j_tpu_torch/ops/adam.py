"""The updater's Adam step over fp32 masters as one kernel a leaf.

Kernel, hand-written CUDA for Hopper in ``csrc/adam_update.cu``:
``adam_master_step_kernel`` reads the gradient (bf16 or f32), the f32
master, m and v once and writes the new m, v, master and the storage param
(the master's round-to-nearest-even cast: bf16, or f32 where the leaf is
f32) once, in the operation order of ``nn/updaters.py``'s Adam
(``compute_update``) and master write (``apply_layer_updates``), bit for
bit.  It replaces no TPU kernel (the JAX package leaves this chain to
XLA's fusion); it replaces the port's ~14 full-size torch passes a leaf.
Bound by bytes: 28 a bf16 parameter.

Two forms of one kernel: in place, where it writes the new values into
the tensors it reads (a captured step's static trees, so the step copies
nothing back), and out of place, into fresh tensors (the eager paths, a
capture's warm-up steps, a step that keeps old and new trees side by side
for the health guard).  The caller names the form.

:func:`takes` is the rule for a leaf the kernel takes (device and dtypes);
:func:`master_step` launches the kernel for it, and raises on a layout the
kernel cannot take in the form asked for.  Each launch adds one to
``LAUNCHES["adam_master_step"]``; a replayed graph launches without the
wrapper and counts nothing.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from . import kernel_build

Tensor = torch.Tensor
Alpha = Union[float, Tensor]

_SOURCE = "adam_update.cu"
LAUNCHES = {"adam_master_step": 0}
_DTYPES = (torch.bfloat16, torch.float32)
_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LOCK:
        LAUNCHES["adam_master_step"] = 0


class Scalars(NamedTuple):
    """The host scalars of the step, each rounded to f32 as PyTorch rounds
    a Python scalar that multiplies or adds to an f32 tensor."""
    b1: float
    omb1: float
    b2: float
    omb2: float
    eps: float


def scalars(b1: float, b2: float, eps: float) -> Scalars:
    f = np.float32
    return Scalars(float(f(b1)), float(f(1 - b1)), float(f(b2)),
                   float(f(1 - b2)), float(f(eps)))


def on_card(*tensors: Tensor) -> bool:
    """Every tensor on one CUDA device."""
    dev = tensors[0].device
    return dev.type == "cuda" and all(t.device == dev for t in tensors)


def takes(g: Tensor, w: Tensor, m: Tensor, v: Tensor,
          storage: Optional[Tensor]) -> bool:
    """Whether the kernel takes this leaf: all on one CUDA device, ``g``
    bf16 or f32, ``w`` (the master, or an f32 param that has none), ``m``
    and ``v`` f32, ``storage`` (the param beside a master, or None) bf16
    or f32."""
    state = [w, m, v] + ([] if storage is None else [storage])
    return (on_card(g, *state) and g.dtype in _DTYPES
            and all(t.dtype == torch.float32 for t in (w, m, v))
            and (storage is None or storage.dtype in _DTYPES))


def _outputs(w: Tensor, m: Tensor, v: Tensor, storage: Optional[Tensor],
             in_place: bool):
    """``(w', m', v', param', storage_out)``: the tensors the step writes
    and returns; ``storage_out`` is None where no param is written beside
    the master."""
    if in_place:
        w1, m1, v1 = w, m, v
    else:
        w1, m1, v1 = (torch.empty(w.shape, dtype=torch.float32,
                                  device=w.device) for _ in range(3))
    if storage is None:                 # an f32 param is its own master
        return w1, m1, v1, w1, None
    if storage.dtype == torch.float32 and not in_place:
        return w1, m1, v1, w1, None     # as ``.to(float32)`` returns it
    if in_place and storage.data_ptr() == w.data_ptr():
        return w1, m1, v1, storage, None
    p1 = storage if in_place else torch.empty(
        w.shape, dtype=storage.dtype, device=w.device)
    return w1, m1, v1, p1, p1


def master_step(g: Tensor, w: Tensor, m: Tensor, v: Tensor,
                storage: Optional[Tensor], alpha: Alpha, sc: Scalars,
                in_place: bool) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One Adam step of a leaf :func:`takes`: ``(w', m', v', param')``.
    ``in_place`` writes them into ``w``, ``m``, ``v`` and ``storage``
    (returned), which must then be contiguous; else into fresh contiguous
    tensors, read from contiguous copies of any input that is not.
    ``alpha``: a host float (eager) or a 0-dim device tensor the kernel
    reads on the card (a captured step's table entry)."""
    state = [w, m, v] + ([] if storage is None else [storage])
    if not takes(g, w, m, v, storage):
        raise ValueError("adam_master_step takes f32 w, m, v and a bf16/f32 "
                         "g and storage on one card")
    if any(t.shape != w.shape for t in (g, *state)):
        raise ValueError("adam_master_step: the leaf's tensors differ in "
                         "shape")
    if in_place and not all(t.is_contiguous() for t in state):
        raise ValueError("adam_master_step writes in place only into "
                         "contiguous tensors")
    w1, m1, v1, p1, p_out = _outputs(w, m, v, storage, in_place)
    g, w, m, v = (t.contiguous() for t in (g, w, m, v))
    if isinstance(alpha, Tensor):
        if alpha.numel() != 1 or alpha.device != w.device:
            raise ValueError("a tensor alpha is one value on the leaf's card")
        alpha = alpha.to(torch.float64)
        alpha_dev, alpha_host = alpha.data_ptr(), 0.0
    else:
        alpha_dev, alpha_host = None, float(alpha)
    with torch.cuda.device(w.device):
        rc = _lib().dl4j_adam_master_step(
            g.data_ptr(), int(g.dtype == torch.bfloat16), w.data_ptr(),
            m.data_ptr(), v.data_ptr(), w1.data_ptr(), m1.data_ptr(),
            v1.data_ptr(), None if p_out is None else p_out.data_ptr(),
            int(p_out is not None and p_out.dtype == torch.bfloat16),
            w.numel(), *sc, alpha_dev, alpha_host,
            torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel adam_master_step failed to launch: "
                           f"CUDA error {rc}")
    with _LOCK:
        LAUNCHES["adam_master_step"] += 1
    return w1, m1, v1, p1


# ------------------------------------------------------------ the library
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "dl4j_adam_master_step": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _L]
    + [_F] * 5 + [_P, _F, _P],
}
_bound = None


def _lib():
    """The kernel library with every C function's signature declared."""
    global _bound
    if _bound is None:
        with _LOCK:
            if _bound is None:
                lib = kernel_build.load(_SOURCE)
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _bound = lib
    return _bound
