"""Flash attention and the KV-cache ring (port of
``deeplearning4j_tpu/ops/attention.py``).

Kernels, hand-written CUDA for Hopper in ``csrc/flash_attention.cu``:

- K1 ``flash_fwd``: streaming-softmax forward, plain (``normalized``) or
  with the per-row logsumexp (``normalized_lse``), one templated body.
  Replaces the Pallas ``_make_flash_kernel`` launched by ``_flash_forward``.
- K2 ``flash_bwd_dkdv`` and K3 ``flash_bwd_dq``: the fused two-pass
  backward that rebuilds P from the saved logsumexp, sharing one tile
  function.  Replace ``_make_dkdv_kernel``/``_make_dq_kernel`` launched by
  ``flash_attention_bwd``.

Beside each kernel is its plain PyTorch version (``flash_forward_plain``,
``flash_dkdv_plain``, ``flash_dq_plain``) running the same tiled
streaming arithmetic.  A wrapper runs the plain version only for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises.  Each
launch adds one to ``LAUNCHES[<kernel>]``.

Layouts are the JAX package's: q, k, v are (batch, T, heads, d); the
logsumexp and D = rowsum(dO * O) are (batch, T, heads) float32; gradients
come out float32 and are cast once, at the autograd boundary, to the
input dtype.

``kv_ring_update``/``kv_ring_attention`` are the inference tier, plain
torch: dense attention against a fixed-capacity KV ring with exact cursor
masking (masked slots use the -1e30 sentinel, so they exp to exactly 0.0
and results are independent of the ring capacity).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device, same_device
from . import kernel_build

Tensor = torch.Tensor

_NEG_INF = -1e30
TILE = 64                  # the kernels' q-tile and k-tile rows
MAX_HEAD_DIM = 128
_SOURCE = "flash_attention.cu"

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ the library
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "dl4j_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _F,
                       _I, _I, _I, _P],
    "dl4j_flash_bwd_dkdv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _L, _L, _L, _F, _I, _I, _P],
    "dl4j_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L,
                          _L, _L, _F, _I, _I, _P],
}
_bound = None


def _lib():
    """The kernel library with every C function's signature declared."""
    global _bound
    if _bound is None:
        lib = kernel_build.load(_SOURCE)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _bound = lib
    return _bound


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: CUDA "
                           f"error {rc}")


def _check_kernel_inputs(name: str, *tensors: Tensor) -> None:
    """What the kernels take: CUDA, float32 or bfloat16 (all the same),
    one (B, T, H, d) shape with d <= 128, contiguous."""
    ref = tensors[0]
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {ref.dtype} not supported "
                        "(float32 or bfloat16)")
    if ref.dim() != 4 or ref.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: expected (batch, T, heads, d<=128), got "
                         f"{tuple(ref.shape)}")
    for t in tensors:
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{name}: all inputs must be on one CUDA "
                             "device")
        if t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError(f"{name}: inputs differ in dtype or shape")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _check_row_stats(name: str, ref: Tensor, *stats: Tensor) -> None:
    for s in stats:
        if (s.dtype != torch.float32 or s.shape != ref.shape[:3]
                or s.device != ref.device or not s.is_contiguous()):
            raise ValueError(f"{name}: row statistics must be contiguous "
                             f"float32 {tuple(ref.shape[:3])} on "
                             f"{ref.device}")


def _geometry(x: Tensor):
    B, T, H, D = x.shape
    sb, st, sh, _ = x.stride()
    return B, T, H, D, sb, st, sh


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _validate_qkv(q: Tensor, k: Tensor, v: Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected (batch, T, heads, d), got "
                         f"{tuple(q.shape)}")
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")


def _bhtd(x: Tensor) -> Tensor:
    """(B, T, H, d) -> (B, H, T, d) float32 (a view when already f32)."""
    return x.float().permute(0, 2, 1, 3)


def _btrow(x: Tensor) -> Tensor:
    """(B, T, H) row statistic -> (B, H, T, 1)."""
    return x.permute(0, 2, 1).unsqueeze(-1)


# ---------------------------------------------------------------- K1
def flash_forward_plain(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                        sm_scale: float, with_lse: bool,
                        block: int = TILE):
    """Plain PyTorch twin of K1: the streaming softmax over k-blocks of
    ``block`` keys with a running max, denominator and f32 accumulator,
    the -1e30 sentinel and ``alive`` guard, and the ``acc / max(l, 1e-30)``
    finalize.  All queries are processed at once per k-block.  Returns
    ``out`` in q's dtype, plus the (B, T, H) f32 logsumexp when
    ``with_lse``."""
    B, T, H, D = q.shape
    qf, kf, vf = _bhtd(q), _bhtd(k), _bhtd(v)
    dev = q.device
    m = torch.full((B, H, T, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, T, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, T, D), dtype=torch.float32, device=dev)
    q_pos = torch.arange(T, device=dev)[:, None]
    for k0 in range(0, T, block):
        kb, vb = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        s = (qf @ kb.transpose(-1, -2)) * sm_scale
        if causal:
            k_pos = torch.arange(k0, k0 + kb.shape[2], device=dev)[None, :]
            s = torch.where(q_pos >= k_pos, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alive = m_new > _NEG_INF / 2
        p = torch.where(alive, torch.exp(s - m_new), 0.0)
        corr = torch.where(alive, torch.exp(m - m_new), 0.0)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ vb
        m = m_new
    denom = torch.clamp_min(l, 1e-30)
    out = (acc / denom).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    if not with_lse:
        return out
    lse = (m + torch.log(denom))[..., 0].permute(0, 2, 1).contiguous()
    return out, lse


def flash_forward(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                  sm_scale: float, with_lse: bool):
    """K1.  ``out`` (and the f32 logsumexp when ``with_lse``): the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    _validate_qkv(q, k, v)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, sm_scale, with_lse)
    _check_kernel_inputs("flash_fwd", q, k, v)
    B, T, H, D, sb, st, sh = _geometry(q)
    out = torch.empty_like(q)
    lse = (torch.empty((B, T, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    rc = _lib().dl4j_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, B, T, H, D, sb, st, sh,
        float(sm_scale), int(causal), int(q.dtype == torch.bfloat16),
        int(with_lse), _stream())
    _check_rc(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return (out, lse) if with_lse else out


# ------------------------------------------------------------- K2 / K3
def _bwd_tile_plain(qf, kb, vb, dof, L, Dr, k0, causal, sm_scale):
    """The shared P-rebuild of both backward passes for one k-block
    against every query: (p, ds), each (B, H, T, block)."""
    s = (qf @ kb.transpose(-1, -2)) * sm_scale
    p = torch.exp(s - L)
    if causal:
        T = qf.shape[2]
        q_pos = torch.arange(T, device=qf.device)[:, None]
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=qf.device)[None, :]
        p = torch.where(q_pos >= k_pos, p, 0.0)
    dp = dof @ vb.transpose(-1, -2)
    ds = p * (dp - Dr) * sm_scale
    return p, ds


def _plain_bwd_inputs(q, k, v, dout, L, Drow):
    return (_bhtd(q), _bhtd(k), _bhtd(v), _bhtd(dout), _btrow(L),
            _btrow(Drow))


def flash_dkdv_plain(q, k, v, dout, L, Drow, causal: bool, sm_scale: float,
                     block: int = TILE) -> Tuple[Tensor, Tensor]:
    """Plain twin of K2: per k-block, dV = P^T dO and dK = dS^T Q summed
    over all queries.  Returns f32 (dk, dv) in (B, T, H, d)."""
    qf, kf, vf, dof, Lr, Dr = _plain_bwd_inputs(q, k, v, dout, L, Drow)
    dks, dvs = [], []
    for k0 in range(0, k.shape[1], block):
        kb, vb = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        p, ds = _bwd_tile_plain(qf, kb, vb, dof, Lr, Dr, k0, causal,
                                sm_scale)
        dvs.append(p.transpose(-1, -2) @ dof)
        dks.append(ds.transpose(-1, -2) @ qf)
    back = lambda xs: torch.cat(xs, dim=2).permute(0, 2, 1, 3).contiguous()
    return back(dks), back(dvs)


def flash_dq_plain(q, k, v, dout, L, Drow, causal: bool, sm_scale: float,
                   block: int = TILE) -> Tensor:
    """Plain twin of K3: dQ = sum over k-blocks of dS K.  f32
    (B, T, H, d)."""
    qf, kf, vf, dof, Lr, Dr = _plain_bwd_inputs(q, k, v, dout, L, Drow)
    dq = torch.zeros_like(qf)
    for k0 in range(0, k.shape[1], block):
        kb, vb = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        _, ds = _bwd_tile_plain(qf, kb, vb, dof, Lr, Dr, k0, causal,
                                sm_scale)
        dq = dq + ds @ kb
    return dq.permute(0, 2, 1, 3).contiguous()


def flash_dkdv(q, k, v, dout, L, Drow, *, causal: bool,
               sm_scale: float) -> Tuple[Tensor, Tensor]:
    """K2: f32 (dk, dv).  ``dout`` has q's dtype."""
    if q.device.type == "cpu":
        return flash_dkdv_plain(q, k, v, dout, L, Drow, causal, sm_scale)
    _check_kernel_inputs("flash_bwd_dkdv", q, k, v, dout)
    _check_row_stats("flash_bwd_dkdv", q, L, Drow)
    B, T, H, D, sb, st, sh = _geometry(q)
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rc = _lib().dl4j_flash_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        L.data_ptr(), Drow.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, H, D, sb, st, sh, float(sm_scale), int(causal),
        int(q.dtype == torch.bfloat16), _stream())
    _check_rc(rc, "flash_bwd_dkdv")
    LAUNCHES["flash_bwd_dkdv"] += 1
    return dk, dv


def flash_dq(q, k, v, dout, L, Drow, *, causal: bool,
             sm_scale: float) -> Tensor:
    """K3: f32 dq.  ``dout`` has q's dtype."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, dout, L, Drow, causal, sm_scale)
    _check_kernel_inputs("flash_bwd_dq", q, k, v, dout)
    _check_row_stats("flash_bwd_dq", q, L, Drow)
    B, T, H, D, sb, st, sh = _geometry(q)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rc = _lib().dl4j_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        L.data_ptr(), Drow.data_ptr(), dq.data_ptr(),
        B, T, H, D, sb, st, sh, float(sm_scale), int(causal),
        int(q.dtype == torch.bfloat16), _stream())
    _check_rc(rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                        L: Tensor, g: Tensor, *, causal: bool,
                        sm_scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused flash backward: f32 (dq, dk, dv) from the forward's ``out``
    and per-row logsumexp ``L``, via K2 then K3.  D = rowsum(dO * O) is
    plain torch.  ``g`` is cast to q's dtype (autograd hands it over in
    that dtype already)."""
    _validate_qkv(q, k, v)
    g = g.to(q.dtype).contiguous()
    Drow = (g.float() * out.float()).sum(dim=-1).contiguous()
    L = L.contiguous()
    dk, dv = flash_dkdv(q, k, v, g, L, Drow, causal=causal,
                        sm_scale=sm_scale)
    dq = flash_dq(q, k, v, g, L, Drow, causal=causal, sm_scale=sm_scale)
    return dq, dk, dv


# ------------------------------------------------------------- autograd
class _FlashAttention(torch.autograd.Function):
    """K1 in lse mode forward, K2 + K3 backward; gradients are cast once
    to the input dtype here."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        out, lse = flash_forward(q, k, v, causal=causal, sm_scale=sm_scale,
                                 with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g,
                                         causal=ctx.causal,
                                         sm_scale=ctx.sm_scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    device: DeviceLike = None) -> Tensor:
    """Flash attention over (batch, T, heads, d) q/k/v, differentiable.

    ``device`` defaults to the card and must match the tensors; with no
    card, pass ``device="cpu"`` (the plain versions then run).  With a
    gradient needed the forward runs K1 in lse mode and the backward K2 and
    K3; otherwise K1 in the plain normalized mode.  ``sm_scale`` defaults
    to 1/sqrt(d)."""
    dev = resolve_device(device)
    _validate_qkv(q, k, v)
    for t in (q, k, v):
        same_device(t, dev)
    scale = (float(sm_scale) if sm_scale is not None
             else 1.0 / math.sqrt(q.shape[-1]))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), scale)
    return flash_forward(q, k, v, causal=bool(causal), sm_scale=scale,
                         with_lse=False)


# ------------------------------------------------------ KV-cache ring
def kv_ring_update(k_cache: Tensor, v_cache: Tensor, cursor: int,
                   k_new: Tensor, v_new: Tensor):
    """Write (batch, heads, T, d) keys/values into the ring at ``cursor``.
    Updates the caches IN PLACE (no second ring in memory) and returns
    them.  Raises when ``cursor + T`` exceeds the capacity, where the JAX
    package's ``dynamic_update_slice`` would clamp."""
    cursor = int(cursor)
    t, cap = k_new.shape[2], k_cache.shape[2]
    if cursor < 0 or cursor + t > cap:
        raise ValueError(f"write of {t} slots at cursor {cursor} exceeds "
                         f"the ring capacity {cap}")
    k_cache[:, :, cursor:cursor + t] = k_new.to(k_cache.dtype)
    v_cache[:, :, cursor:cursor + t] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def kv_ring_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                      cursor: int, *,
                      sm_scale: Optional[float] = None) -> Tensor:
    """Dense masked attention of (batch, T, heads, d) queries against a
    (batch, heads, cache_len, d) ring: slot ``c`` is visible to query
    ``t`` iff ``c <= cursor + t``.  Softmax in f32 (f64 for f64 inputs);
    the context comes back in q's dtype."""
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(
            f"kv_ring_attention wants (B,T,H,d) q and (B,H,C,d) cache, got "
            f"q {tuple(q.shape)}, k {tuple(k_cache.shape)}")
    scale = (float(sm_scale) if sm_scale is not None
             else 1.0 / math.sqrt(q.shape[-1]))
    acc = torch.promote_types(q.dtype, torch.float32)
    cap, t = k_cache.shape[2], q.shape[1]
    s = torch.einsum("bthd,bhcd->bhtc", q.to(acc), k_cache.to(acc)) * scale
    valid = (torch.arange(cap, device=q.device)[None, :]
             <= int(cursor) + torch.arange(t, device=q.device)[:, None])
    s = torch.where(valid, s, torch.tensor(_NEG_INF, dtype=acc,
                                           device=q.device))
    # every query sees at least its own key: the row max is finite and
    # masked slots exp to exactly 0.0
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("bhtc,bhcd->bthd", p, v_cache.to(acc))
    return ctx.to(q.dtype)
