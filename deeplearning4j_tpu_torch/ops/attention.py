"""Flash attention and the KV-cache ring (port of
``deeplearning4j_tpu/ops/attention.py``).

Kernels, hand-written CUDA for Hopper in ``csrc/flash_attention.cu``:

- K1 ``flash_fwd``: streaming-softmax forward, plain (``normalized``) or
  with the per-row logsumexp (``normalized_lse``), one templated body.
  Replaces the Pallas ``_make_flash_kernel`` launched by ``_flash_forward``.
- K4 ``flash_fwd_partials``: the same body in mode ``partials``, the
  unnormalized (acc, m, l) of q against one K/V segment whose length may
  differ from q's.  Replaces the kernel launched by
  ``flash_attention_partial``; the ring flash attention merges these.
  For bf16 q/k/v K1 and K4 run on the tensor cores and round P to bf16 as
  the operand of P V (the softmax statistics stay f32): on the Hopper body
  (``flash_fwd_sm90.cuh``: wgmma fed by TMA, 128-key tiles) when TMA can
  address the rows (d a multiple of 8, 16-byte aligned bases and strides),
  else on the mma.sync body (64-key tiles); f32 inputs keep an all-f32
  scalar body.  ``fwd_route`` names the body a call takes (the library's
  own predicate) and ``fwd_key_tile`` its key tile, which the rounding twin
  must share: the running max, and so the rounding of P, depends on where
  key tiles start.
- K2 ``flash_bwd_dkdv`` and K3 ``flash_bwd_dq``: the fused two-pass
  backward that rebuilds P from the saved logsumexp, sharing one
  elementwise core.  Replace ``_make_dkdv_kernel``/``_make_dq_kernel``
  launched by ``flash_attention_bwd``.  K/V may be one segment of a longer
  sequence (``Tk != Tq``): with the global logsumexp and D the gradients
  are that segment's exact contribution, and contributions of segments
  sum.  For bf16 q/k/v and dO they run on the tensor cores and round P and
  dS to bf16 as operands of the gradient products: on the Hopper bodies
  (``flash_bwd_sm90.cuh``: wgmma fed by TMA; K2 128 keys a block against
  streamed query tiles, K3 128 queries against streamed key tiles) when
  TMA can address the rows, else on the mma.sync bodies; f32 inputs, or an
  f32 dO with bf16 q, keep an all-f32 scalar body.  ``bwd_route`` names
  the body a call takes and ``bwd_key_tile`` K3's key tile, which the
  rounding twin shares: K3's f32 sum over key tiles follows it (the
  rounding of P and dS, rebuilt from L, does not depend on the tile).

Beside each kernel is its plain PyTorch version (``flash_forward_plain``
in its three modes, ``flash_dkdv_plain``, ``flash_dq_plain``; each with
``operand_dtype=torch.bfloat16`` for the tensor-core rounding) running the
same tiled streaming arithmetic.  A wrapper runs the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises.  Each launch adds one to ``LAUNCHES[<kernel>]`` and to
``BODY_LAUNCHES[<kernel>][<body>]``.

Layouts are the JAX package's: q, k, v are (batch, T, heads, d); the
logsumexp and D = rowsum(dO * O) are (batch, Tq, heads) float32; gradients
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
import threading
from typing import Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device, same_device
from . import kernel_build

Tensor = torch.Tensor

_NEG_INF = -1e30
TILE = 64                  # the kernels' q-tile and k-tile rows
MAX_HEAD_DIM = 128
_SOURCE = "flash_attention.cu"
_FWD_MODES = ("normalized", "normalized_lse", "partials")

LAUNCHES = {"flash_fwd": 0, "flash_fwd_partials": 0, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
# every kernel's bodies, indexed by what dl4j_flash_fwd_route and
# dl4j_flash_bwd_route return: the scalar f32 body, the mma.sync body
# (fwd_tc, dkdv_tc, dq_tc) and the Hopper body (wgmma, TMA)
FWD_BODIES = ("scalar", "tc", "sm90")
BODY_LAUNCHES = {name: dict.fromkeys(FWD_BODIES, 0) for name in LAUNCHES}
# keys of a streamed K/V tile of each K1/K4 body at every d (TILE, FWD_BK
# and SM90_BK in the CUDA sources)
FWD_KEY_TILES = {"scalar": TILE, "tc": TILE, "sm90": 128}
# keys of a streamed K/V tile of each K3 body, at d <= 64 and at d > 64
# (TILE; TcCfg::BS; SM90_DQ_BK_D64 and SM90_DQ_BK_D128)
DQ_KEY_TILES = {"scalar": (TILE, TILE), "tc": (64, 32), "sm90": (128, 64)}
_TMA_ENCODE_FAILED = 100000      # + the CUresult, from any entry point
# guards the counts (replicas launch from several threads of one process,
# as the cluster tier's pool threads do) and the library's first load
_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        for counts in BODY_LAUNCHES.values():
            for body in counts:
                counts[body] = 0


def count_launch(name: str, body: str) -> None:
    """Add one launch of kernel ``name`` on ``body`` to the counts (what
    every wrapper does after its kernel launched; safe from any thread)."""
    with _LOCK:
        LAUNCHES[name] += 1
        BODY_LAUNCHES[name][body] += 1


def _check_head_dim(d: int) -> None:
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside (0, {MAX_HEAD_DIM}]")


def fwd_key_tile(d: int, body: str) -> int:
    """Keys of a K/V tile that K1/K4's ``body`` (one of ``FWD_BODIES``)
    streams at head dim ``d``: the ``block`` of the plain twin that rounds
    P as that body does."""
    _check_head_dim(d)
    return FWD_KEY_TILES[body]


def bwd_key_tile(d: int, body: str) -> int:
    """Keys of a K/V tile that K3's ``body`` (one of ``FWD_BODIES``)
    streams at head dim ``d``: the ``block`` of ``flash_dq_plain`` that
    sums dQ over key tiles as that body does."""
    _check_head_dim(d)
    return DQ_KEY_TILES[body][d > 64]


# ------------------------------------------------------------ the library
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_GEOM = [_I] * 5 + [_L] * 6       # B, Tq, Tk, H, d, q strides, k strides
_SIGNATURES = {
    "dl4j_flash_fwd": [_P] * 5 + _GEOM + [_F, _I, _I, _I, _P],
    "dl4j_flash_fwd_partials": [_P] * 6 + _GEOM + [_F, _I, _I, _P],
    "dl4j_flash_fwd_route": [_P] * 3 + _GEOM + [_I],
    "dl4j_flash_bwd_route": [_P] * 4 + _GEOM + [_I, _I],
    "dl4j_flash_bwd_dkdv": [_P] * 8 + _GEOM + [_F, _I, _I, _I, _P],
    "dl4j_flash_bwd_dq": [_P] * 7 + _GEOM + [_F, _I, _I, _I, _P],
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


def _launch(name: str, fn: str, device: torch.device, *args,
            body: str) -> None:
    """Call one C entry point with ``device`` (the tensors' card) current
    and on that card's current stream, raise on a refused launch (or a
    tensor map a Hopper body could not encode), count it, and count the
    ``body`` it ran.  The launch and the kernels' shared-memory
    opt-in act on the current device, so on any card but the current one
    they would go to the wrong card without the guard."""
    with torch.cuda.device(device):
        rc = getattr(_lib(), fn)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if rc >= _TMA_ENCODE_FAILED:
        raise RuntimeError(f"CUDA kernel {name}: a tensor map could not be "
                           f"encoded (CUresult {rc - _TMA_ENCODE_FAILED})")
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: CUDA "
                           f"error {rc}")
    count_launch(name, body)


def fwd_route(q: Tensor, k: Tensor, v: Tensor) -> str:
    """The body (one of ``FWD_BODIES``) that K1/K4 launch for these CUDA
    tensors, as the library decides it: by dtype, shape and alignment."""
    return FWD_BODIES[_lib().dl4j_flash_fwd_route(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *_geometry(q, k),
        int(q.dtype == torch.bfloat16))]


def bwd_route(q: Tensor, k: Tensor, v: Tensor, dout: Tensor) -> str:
    """The body (one of ``FWD_BODIES``) that K2/K3 launch for these CUDA
    tensors, as the library decides it: by dtype (q's and dO's), shape and
    alignment."""
    bf16 = q.dtype == torch.bfloat16
    return FWD_BODIES[_lib().dl4j_flash_bwd_route(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        *_geometry(q, k), int(bf16),
        int(bf16 and dout.dtype == torch.float32))]


def _check_on_card(name: str, ref: Tensor, t: Tensor) -> None:
    if t.device.type != "cuda" or t.device != ref.device:
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if not t.is_contiguous():
        raise ValueError(f"{name}: inputs must be contiguous")


def _check_kernel_inputs(name: str, q: Tensor, k: Tensor, v: Tensor,
                         dout: Optional[Tensor] = None) -> None:
    """What the kernels take: q on a CUDA device, float32 or bfloat16,
    (B, Tq, H, d) with d <= 128, contiguous; k and v on q's device in q's
    dtype, contiguous (their shapes were held against q's by
    ``_validate_qkv``); a cotangent in q's shape, in q's dtype or
    float32."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if q.dim() != 4 or q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: expected (batch, T, heads, d<=128), got "
                         f"{tuple(q.shape)}")
    for t in (q, k, v):
        _check_on_card(name, q, t)
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: inputs differ in dtype")
    if dout is not None:
        if dout.dtype not in (q.dtype, torch.float32):
            raise TypeError(f"{name}: dO dtype {dout.dtype} (q's dtype or "
                            "float32)")
        _check_on_card(name, q, dout)
        if dout.shape != q.shape:
            raise ValueError(f"{name}: dO shape {tuple(dout.shape)} is not "
                             f"q's {tuple(q.shape)}")


def _check_row_stats(name: str, ref: Tensor, *stats: Tensor) -> None:
    for s in stats:
        if (s.dtype != torch.float32 or s.shape != ref.shape[:3]
                or s.device != ref.device or not s.is_contiguous()):
            raise ValueError(f"{name}: row statistics must be contiguous "
                             f"float32 {tuple(ref.shape[:3])} on "
                             f"{ref.device}")


def _geometry(q: Tensor, k: Tensor):
    """B, Tq, Tk, H, d, then q's and k's (batch, time, head) strides."""
    B, Tq, H, D = q.shape
    return (B, Tq, k.shape[1], H, D, *q.stride()[:3], *k.stride()[:3])


def _validate_qkv(q: Tensor, k: Tensor, v: Tensor, same_t: bool) -> None:
    """The JAX package's shape rules: k and v alike; q may have another T
    unless ``same_t``; batch, heads and d agree."""
    if q.dim() != 4:
        raise ValueError(f"expected (batch, T, heads, d), got "
                         f"{tuple(q.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if same_t and q.shape != k.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != \
            (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"q and k/v disagree on batch/heads/d: "
                         f"{tuple(q.shape)} vs {tuple(k.shape)}")


def _default_scale(q: Tensor, sm_scale: Optional[float]) -> float:
    return (float(sm_scale) if sm_scale is not None
            else 1.0 / math.sqrt(q.shape[-1]))


def _bhtd(x: Tensor) -> Tensor:
    """(B, T, H, d) -> (B, H, T, d) float32 (a view when already f32)."""
    return x.float().permute(0, 2, 1, 3)


def _btrow(x: Tensor) -> Tensor:
    """(B, T, H) row statistic -> (B, H, T, 1)."""
    return x.permute(0, 2, 1).unsqueeze(-1)


def _rows_back(x: Tensor) -> Tensor:
    """(B, H, T, 1) -> contiguous (B, T, H)."""
    return x[..., 0].permute(0, 2, 1).contiguous()


# ---------------------------------------------------------------- K1 / K4
def flash_forward_plain(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                        sm_scale: float, mode: str = "normalized",
                        block: int = TILE, operand_dtype=None):
    """Plain PyTorch twin of K1 and K4, one body for the three modes of
    ``_make_flash_kernel``: the streaming softmax over k-blocks of
    ``block`` keys with a running max, denominator and f32 accumulator,
    the -1e30 sentinel and ``alive`` guard; all queries at once per
    k-block; causal masking by local positions (query i sees key j <= i).
    Only the finalize differs:

    - ``normalized``: ``out`` = acc / max(l, 1e-30) in q's dtype;
    - ``normalized_lse``: ``(out, lse)`` with the (B, Tq, H) f32
      logsumexp m + log(max(l, 1e-30));
    - ``partials``: the f32 ``(acc, m, l)``, unnormalized.

    ``operand_dtype=torch.bfloat16`` rounds p to bf16 as the operand of
    ``p @ v`` only, as the tensor-core kernel does (bf16 q/k/v): m, l and
    the correction stay f32, l sums the unrounded p.  ``None`` is the
    all-f32 twin.
    """
    if mode not in _FWD_MODES:
        raise ValueError(f"unknown kernel mode {mode!r}")
    B, Tq, H, D = q.shape
    qf, kf, vf = _bhtd(q), _bhtd(k), _bhtd(v)
    dev = q.device
    m = torch.full((B, H, Tq, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=dev)
    q_pos = torch.arange(Tq, device=dev)[:, None]
    for k0 in range(0, k.shape[1], block):
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
        if operand_dtype is not None:
            p = p.to(operand_dtype).float()
        acc = acc * corr + p @ vb
        m = m_new
    if mode == "partials":
        return (acc.permute(0, 2, 1, 3).contiguous(), _rows_back(m),
                _rows_back(l))
    denom = torch.clamp_min(l, 1e-30)
    out = (acc / denom).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    if mode == "normalized":
        return out
    return out, _rows_back(m + torch.log(denom))


def flash_forward(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                  sm_scale: float, with_lse: bool):
    """K1.  ``out`` (and the f32 logsumexp when ``with_lse``): the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    _validate_qkv(q, k, v, same_t=True)
    if q.device.type == "cpu":
        return flash_forward_plain(
            q, k, v, causal, sm_scale,
            "normalized_lse" if with_lse else "normalized")
    _check_kernel_inputs("flash_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch("flash_fwd", "dl4j_flash_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, *_geometry(q, k),
            float(sm_scale), int(causal), int(q.dtype == torch.bfloat16),
            int(with_lse), body=fwd_route(q, k, v))
    return (out, lse) if with_lse else out


def flash_attention_partial(q: Tensor, k: Tensor, v: Tensor, *,
                            causal: bool = False,
                            sm_scale: Optional[float] = None
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """K4: unnormalized attention of ``q`` (B, Tq, H, d) against ONE K/V
    segment ``k``, ``v`` (B, Tk, H, d), Tk may differ from Tq.

    Returns ``(acc, m, l)``: acc (B, Tq, H, d) f32, the exp-weighted value
    sum; m, l (B, Tq, H) f32, the row max and denominator.  Partials of
    different segments merge exactly by the log-sum-exp rule (see
    ``parallel/sequence.py``); the output is ``acc / l``.  ``causal``
    masks by local positions, right for the diagonal ring step where both
    shards share their global offset.  A row that sees no key gives
    (0, -1e30, 0).  Not differentiable; callers own the backward.  The
    plain version for CPU tensors, the kernel for CUDA tensors."""
    _validate_qkv(q, k, v, same_t=False)
    scale = _default_scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, scale, "partials")
    _check_kernel_inputs("flash_fwd_partials", q, k, v)
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch("flash_fwd_partials", "dl4j_flash_fwd_partials", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), *_geometry(q, k), scale,
            int(causal), int(q.dtype == torch.bfloat16),
            body=fwd_route(q, k, v))
    return acc, m, l


# ------------------------------------------------------------- K2 / K3
def _bwd_tile_plain(qf, kb, vb, dof, L, Dr, k0, causal, sm_scale,
                    operand_dtype=None):
    """The shared P-rebuild of both backward passes for one k-block
    against every query: (p, ds), each (B, H, Tq, block), causal by local
    positions.  With ``operand_dtype`` (bf16) both are rounded to it, as
    the tensor-core kernels round them to operands of the gradient
    products; ``None`` keeps them f32."""
    s = (qf @ kb.transpose(-1, -2)) * sm_scale
    p = torch.exp(s - L)
    if causal:
        T = qf.shape[2]
        q_pos = torch.arange(T, device=qf.device)[:, None]
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=qf.device)[None, :]
        p = torch.where(q_pos >= k_pos, p, 0.0)
    dp = dof @ vb.transpose(-1, -2)
    ds = p * (dp - Dr) * sm_scale
    if operand_dtype is not None:
        p, ds = p.to(operand_dtype).float(), ds.to(operand_dtype).float()
    return p, ds


def _plain_bwd_inputs(q, k, v, dout, L, Drow):
    return (_bhtd(q), _bhtd(k), _bhtd(v), _bhtd(dout), _btrow(L),
            _btrow(Drow))


def flash_dkdv_plain(q, k, v, dout, L, Drow, causal: bool, sm_scale: float,
                     block: int = TILE, operand_dtype=None
                     ) -> Tuple[Tensor, Tensor]:
    """Plain twin of K2: per k-block, dV = P^T dO and dK = dS^T Q summed
    over all queries.  Returns f32 (dk, dv) in k's (B, Tk, H, d).
    ``operand_dtype=torch.bfloat16`` rounds P and dS as the tensor-core
    kernel does (bf16 q/k/v and dO); ``None`` is the all-f32 twin."""
    qf, kf, vf, dof, Lr, Dr = _plain_bwd_inputs(q, k, v, dout, L, Drow)
    dks, dvs = [], []
    for k0 in range(0, k.shape[1], block):
        kb, vb = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        p, ds = _bwd_tile_plain(qf, kb, vb, dof, Lr, Dr, k0, causal,
                                sm_scale, operand_dtype)
        dvs.append(p.transpose(-1, -2) @ dof)
        dks.append(ds.transpose(-1, -2) @ qf)
    back = lambda xs: torch.cat(xs, dim=2).permute(0, 2, 1, 3).contiguous()
    return back(dks), back(dvs)


def flash_dq_plain(q, k, v, dout, L, Drow, causal: bool, sm_scale: float,
                   block: int = TILE, operand_dtype=None) -> Tensor:
    """Plain twin of K3: dQ = sum over k-blocks of ``block`` keys of
    dS K, in key order (the f32 order of a body over its key tile,
    ``bwd_key_tile``).  f32 (B, Tq, H, d); ``operand_dtype`` as in
    ``flash_dkdv_plain``."""
    qf, kf, vf, dof, Lr, Dr = _plain_bwd_inputs(q, k, v, dout, L, Drow)
    dq = torch.zeros_like(qf)
    for k0 in range(0, k.shape[1], block):
        kb, vb = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        _, ds = _bwd_tile_plain(qf, kb, vb, dof, Lr, Dr, k0, causal,
                                sm_scale, operand_dtype)
        dq = dq + ds @ kb
    return dq.permute(0, 2, 1, 3).contiguous()


def _bwd_launch_args(q, k, v, dout, L, Drow):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            L.data_ptr(), Drow.data_ptr())


def _bwd_flags(q, dout, causal, sm_scale):
    bf16 = q.dtype == torch.bfloat16
    return (float(sm_scale), int(causal), int(bf16),
            int(bf16 and dout.dtype == torch.float32))


def flash_dkdv(q, k, v, dout, L, Drow, *, causal: bool,
               sm_scale: float) -> Tuple[Tensor, Tensor]:
    """K2: f32 (dk, dv) of the K/V segment ``k``, ``v`` (Tk may differ
    from Tq).  ``dout`` has q's shape, in q's dtype or float32; ``L`` and
    ``Drow`` are the (B, Tq, H) logsumexp and rowsum(dO * O)."""
    _validate_qkv(q, k, v, same_t=False)
    if q.device.type == "cpu":
        return flash_dkdv_plain(q, k, v, dout, L, Drow, causal, sm_scale)
    _check_kernel_inputs("flash_bwd_dkdv", q, k, v, dout)
    _check_row_stats("flash_bwd_dkdv", q, L, Drow)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dkdv", "dl4j_flash_bwd_dkdv", q.device,
            *_bwd_launch_args(q, k, v, dout, L, Drow), dk.data_ptr(),
            dv.data_ptr(), *_geometry(q, k),
            *_bwd_flags(q, dout, causal, sm_scale),
            body=bwd_route(q, k, v, dout))
    return dk, dv


def flash_dq(q, k, v, dout, L, Drow, *, causal: bool,
             sm_scale: float) -> Tensor:
    """K3: f32 dq, this K/V segment's contribution.  Inputs as K2's."""
    _validate_qkv(q, k, v, same_t=False)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, dout, L, Drow, causal, sm_scale)
    _check_kernel_inputs("flash_bwd_dq", q, k, v, dout)
    _check_row_stats("flash_bwd_dq", q, L, Drow)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dq", "dl4j_flash_bwd_dq", q.device,
            *_bwd_launch_args(q, k, v, dout, L, Drow), dq.data_ptr(),
            *_geometry(q, k), *_bwd_flags(q, dout, causal, sm_scale),
            body=bwd_route(q, k, v, dout))
    return dq


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor,
                        out: Optional[Tensor], L: Tensor, g: Tensor, *,
                        causal: bool, sm_scale: float,
                        D_row: Optional[Tensor] = None
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused flash backward: f32 (dq, dk, dv) from the forward's per-row
    logsumexp ``L``, via K2 then K3.

    ``k``/``v`` may be one K/V SEGMENT of a longer sequence (Tk != Tq):
    with the GLOBAL ``L`` and ``D_row`` the results are that segment's
    exact contribution, and contributions of segments sum, which the ring
    backward in ``parallel/sequence.py`` is built on.  ``D_row`` =
    rowsum(dO * out), (B, Tq, H), is computed from ``out`` when not given;
    segment callers pass the global one and ``out=None``.  The cotangent
    ``g`` is never rounded: D and the kernels' dO use it in f32 (a bf16
    ``g`` with bf16 q goes to the kernels as it is; they widen it
    exactly), as the JAX package's ``g.astype(f32)`` does."""
    if out is None and D_row is None:
        raise ValueError("flash_attention_bwd needs `out` (to derive "
                         "D = rowsum(dO*out)) or an explicit `D_row`")
    keep = g.dtype == q.dtype == torch.bfloat16
    dout = (g if keep else g.float()).contiguous()
    if D_row is None:
        D_row = (g.float() * out.float()).sum(dim=-1)
    Drow = D_row.float().contiguous()
    L = L.contiguous()
    dk, dv = flash_dkdv(q, k, v, dout, L, Drow, causal=causal,
                        sm_scale=sm_scale)
    dq = flash_dq(q, k, v, dout, L, Drow, causal=causal, sm_scale=sm_scale)
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
    _validate_qkv(q, k, v, same_t=True)
    for t in (q, k, v):
        same_device(t, dev)
    scale = _default_scale(q, sm_scale)
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
    Returns new cache tensors, copies of the ring with the chunk written
    at the cursor, and never writes into its arguments: a caller that
    keeps the old carry (a session whose step failed, a decode that
    branches from one prefix) still holds the old ring, as with the JAX
    package's ``dynamic_update_slice``.  Raises when ``cursor + T``
    exceeds the capacity, where ``dynamic_update_slice`` would clamp."""
    cursor = int(cursor)
    t, cap = k_new.shape[2], k_cache.shape[2]
    if cursor < 0 or cursor + t > cap:
        raise ValueError(f"write of {t} slots at cursor {cursor} exceeds "
                         f"the ring capacity {cap}")
    return tuple(torch.slice_scatter(cache, new.to(cache.dtype), dim=2,
                                     start=cursor, end=cursor + t)
                 for cache, new in ((k_cache, k_new), (v_cache, v_new)))


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
