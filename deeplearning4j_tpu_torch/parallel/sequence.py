"""Sequence parallelism (port of ``deeplearning4j_tpu/parallel/sequence.py``):
ring attention, all-to-all (Ulysses) attention and the ring flash
attention.

The JAX package runs each primitive inside ``shard_map`` over a ``seq``
mesh axis, one time shard per chip, with ``lax.ppermute`` handing blocks
round the ring.  Here one process holds the ring as a list of shards,
shard ``i`` on ``devices[i]``, in ring order: shard ``j`` holds global
timesteps ``[j * t, (j + 1) * t)``.  A ``ppermute`` hop becomes a rotation
of the list, each block copied with ``.to`` onto its new shard's device; a
device may appear more than once (no copy is made between a device and
itself), which is how one card runs an n-shard ring and how the CPU tests
run one, as the JAX tests run theirs on 8 virtual CPU devices.

- :func:`ring_attention`: the streaming-softmax ring in plain torch, K/V
  blocks rotating (XLA in the JAX package).
- :func:`ring_flash_attention`: each ring step's local block runs K4
  (``flash_attention_partial``) and the partials merge by the exact
  log-sum-exp rule; its backward is the fused ring backward, where the
  q-side package (q, dO, logsumexp, D, dq accumulator) travels and each
  shard folds in its K/V segment's contribution through K2/K3 in segment
  form.  Memory stays O(T/n · d) per shard both ways.
- :func:`ulysses_attention`: all-to-all from time shards to head shards,
  dense attention over the whole sequence per head group, and back.
- :func:`ring_lstm_scan`: the sequence-parallel peephole LSTM, each
  shard's chain run from the carry handed in by its left neighbour and
  recomputed in the backward pass, so each shard keeps O(T/n) residuals.
- :class:`SequenceParallel`: full-shape (batch, T, heads, d) in and out;
  autograd flows through the split, the ``.to`` copies and the gather.

Not ported yet: a multi-process ring over ``torch.distributed`` (NCCL).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..nn.layers.recurrent import lstm_input_projection, lstm_scan_preact
from ..ops.attention import (_NEG_INF, _default_scale as _scale,
                             flash_attention, flash_attention_bwd,
                             flash_attention_partial)

Tensor = torch.Tensor
Shards = Sequence[Tensor]

IMPLS = ("ring", "ulysses", "ring_flash", "flash")


def _check_shards(qs: Shards, ks: Shards, vs: Shards) -> None:
    n = len(qs)
    if n == 0 or len(ks) != n or len(vs) != n:
        raise ValueError(f"need one q, k and v shard per ring position, got "
                         f"{len(qs)}, {len(ks)}, {len(vs)}")
    shape = qs[0].shape
    if len(shape) != 4:
        raise ValueError(f"expected (batch, t_local, heads, d) shards, got "
                         f"{tuple(shape)}")
    for x in (*qs, *ks, *vs):
        if x.shape != shape:
            raise ValueError(f"shards differ in shape: {tuple(x.shape)} vs "
                             f"{tuple(shape)}")


def _empty_partials(q: Tensor):
    """The streaming-softmax state before any key: acc 0, m -1e30
    (the masked-score sentinel, which keeps exp() and where() NaN-free),
    l 0, all f32 on q's device."""
    rows = q.shape[:3]
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full(rows, _NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros(rows, dtype=torch.float32, device=q.device))


def _rotate(blocks: list, devices: List[torch.device]) -> list:
    """One ring hop (``ppermute`` with the cyclic +1 permutation): shard i
    hands its tuple of blocks to shard i + 1."""
    n = len(blocks)
    return [tuple(x.to(devices[i]) for x in blocks[(i - 1) % n])
            for i in range(n)]


def _step_causal(causal: bool, q_shard: int, kv_shard: int):
    """What one ring step of the causal schedule computes for the queries
    of ``q_shard`` against the keys of ``kv_shard``: ``None`` when every
    key lies in the queries' future (the step is skipped), else whether the
    step masks causally by local positions (the diagonal)."""
    if not causal:
        return False
    if kv_shard > q_shard:
        return None
    return kv_shard == q_shard


# --------------------------------------------------------------------- ring
def ring_attention(qs: Shards, ks: Shards, vs: Shards, *,
                   causal: bool = False,
                   sm_scale: Optional[float] = None) -> List[Tensor]:
    """Blockwise ring attention over time shards (lists in ring order):
    each shard's output equals full attention on the gathered sequence up
    to float association.  Accumulation is float32 for any input dtype;
    outputs come back in q's dtype on each q shard's device."""
    _check_shards(qs, ks, vs)
    n, t = len(qs), qs[0].shape[1]
    devices = [q.device for q in qs]
    scale = _scale(qs[0], sm_scale)
    qf = [q.float() * scale for q in qs]
    state = [_empty_partials(q) for q in qs]
    kv = list(zip(ks, vs))
    for r in range(n):
        for i in range(n):
            src = (i - r) % n            # origin of the resident block
            (o, m, l), (k_blk, v_blk) = state[i], kv[i]
            s = torch.einsum("bqhd,bkhd->bqhk", qf[i], k_blk.float())
            if causal:
                dev = devices[i]
                q_pos = i * t + torch.arange(t, device=dev)
                k_pos = src * t + torch.arange(k_blk.shape[1], device=dev)
                s = torch.where(q_pos[None, :, None, None]
                                >= k_pos[None, None, None, :], s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # exp(_NEG_INF - _NEG_INF) would be 1; gate fully-masked rows
            alive = m_new > _NEG_INF / 2
            p = torch.where(alive[..., None],
                            torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.where(alive, torch.exp(m - m_new), 0.0)
            o = o * corr[..., None] + torch.einsum("bqhk,bkhd->bqhd", p,
                                                   v_blk.float())
            state[i] = (o, m_new, l * corr + p.sum(dim=-1))
        kv = _rotate(kv, devices)
    return [(o / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
            for (o, _, l), q in zip(state, qs)]


def _full_attention(q: Tensor, k: Tensor, v: Tensor, *,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> Tensor:
    """Single-device dense attention, the correctness oracle of the
    sharded paths; float32 softmax, output in q's dtype."""
    scale = _scale(q, sm_scale)
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(keep[None, :, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", p, v.float()).to(q.dtype)


# --------------------------------------------------------------- ring+flash
def _merge(o1, m1, l1, o2, m2, l2):
    """Exact log-sum-exp combination of two unnormalized partials."""
    m = torch.maximum(m1, m2)
    a1 = torch.where(m1 > _NEG_INF / 2, torch.exp(m1 - m), 0.0)
    a2 = torch.where(m2 > _NEG_INF / 2, torch.exp(m2 - m), 0.0)
    return o1 * a1[..., None] + o2 * a2[..., None], m, l1 * a1 + l2 * a2


def _ring_flash_forward(qs, ks, vs, causal: bool, scale: float):
    """Per shard: out in q's dtype and the f32 logsumexp of its rows over
    the whole sequence.  Ring step r: shard i holds the K/V block of shard
    (i - r) % n, as in the JAX scan.  A step whose keys are all in the
    future launches nothing: merging (0, -1e30, 0) is the identity, and
    the diagonal step (r = 0) always comes first."""
    n = len(qs)
    devices = [q.device for q in qs]
    state = [_empty_partials(q) for q in qs]
    kv = list(zip(ks, vs))
    for r in range(n):
        for i in range(n):
            local = _step_causal(causal, i, (i - r) % n)
            if local is None:
                continue
            part = flash_attention_partial(qs[i], *kv[i], causal=local,
                                           sm_scale=scale)
            state[i] = _merge(*state[i], *part)
        if r < n - 1:
            kv = _rotate(kv, devices)
    outs, lses = [], []
    for (o, m, l), q in zip(state, qs):
        l_safe = torch.clamp_min(l, 1e-30)
        outs.append((o / l_safe[..., None]).to(q.dtype))
        lses.append(m + torch.log(l_safe))
    return outs, lses


def _ring_flash_backward(qs, ks, vs, outs, lses, gs, causal: bool,
                         scale: float):
    """The fused ring backward: the q-side package (q, dO, L, D, dq
    accumulator) of shard (i - r) % n visits K/V shard i at step r, which
    folds in its segment's exact contribution (K2/K3 with the global L and
    D); after n hops each package, with its dq, is home.  Causality from
    the K/V side: a package from a later shard sees the segment fully, the
    home package is locally causal, one from an earlier shard contributes
    nothing (skipped; adding zeros is the identity)."""
    n = len(qs)
    devices = [q.device for q in qs]
    pkgs = [(q, g, L, (g.float() * o.float()).sum(dim=-1),
             torch.zeros(q.shape, dtype=torch.float32, device=q.device))
            for q, g, L, o in zip(qs, gs, lses, outs)]
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for k in ks]
    dvs = [torch.zeros_like(dk) for dk in dks]
    for r in range(n):
        for i in range(n):
            local = _step_causal(causal, (i - r) % n, i)
            if local is None:
                continue
            q_r, do_r, L_r, D_r, dq_r = pkgs[i]
            # contributions come back f32 and accumulate in f32; the one
            # cast to the input dtype happens at the autograd boundary
            dq_c, dk_c, dv_c = flash_attention_bwd(
                q_r, ks[i], vs[i], None, L_r, do_r, causal=local,
                sm_scale=scale, D_row=D_r)
            dks[i] = dks[i] + dk_c
            dvs[i] = dvs[i] + dv_c
            pkgs[i] = (q_r, do_r, L_r, D_r, dq_r + dq_c)
        pkgs = _rotate(pkgs, devices)
    return ([pkg[4].to(q.dtype) for pkg, q in zip(pkgs, qs)],
            [dk.to(k.dtype) for dk, k in zip(dks, ks)],
            [dv.to(v.dtype) for dv, v in zip(dvs, vs)])


class _RingFlash(torch.autograd.Function):
    """The ring flash forward and its fused ring backward over n shards,
    passed flat as (q_0..q_{n-1}, k_0.., v_0..)."""

    @staticmethod
    def forward(ctx, causal: bool, scale: float, *shards):
        n = len(shards) // 3
        qs, ks, vs = shards[:n], shards[n:2 * n], shards[2 * n:]
        outs, lses = _ring_flash_forward(qs, ks, vs, causal, scale)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.causal, ctx.scale, ctx.n = causal, scale, n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n, saved = ctx.n, ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[j * n:(j + 1) * n] for j in range(5))
        dqs, dks, dvs = _ring_flash_backward(
            qs, ks, vs, outs, lses, [g.contiguous() for g in gs],
            ctx.causal, ctx.scale)
        return (None, None, *dqs, *dks, *dvs)


def ring_flash_attention(qs: Shards, ks: Shards, vs: Shards, *,
                         causal: bool = False,
                         sm_scale: Optional[float] = None) -> List[Tensor]:
    """Ring attention whose per-step local block runs the flash kernel K4,
    differentiable through the fused ring backward (K2/K3 in segment
    form).  ``qs``, ``ks``, ``vs``: one (batch, t_local, heads, d) shard per
    ring position, in ring order, each on its own device.  Causality has
    three cases per step, as in the JAX package: K/V from an earlier shard
    (fully visible), from this shard (locally causal), from a later shard
    (skipped).  Returns the output shards in q's dtype.  On the CPU the
    kernels' plain versions run."""
    _check_shards(qs, ks, vs)
    shards = [x.contiguous() for x in (*qs, *ks, *vs)]
    return list(_RingFlash.apply(bool(causal), _scale(qs[0], sm_scale),
                                 *shards))


# ------------------------------------------------------------------ ulysses
def ulysses_attention(qs: Shards, ks: Shards, vs: Shards, *,
                      causal: bool = False,
                      sm_scale: Optional[float] = None) -> List[Tensor]:
    """All-to-all (DeepSpeed-Ulysses-style) sequence parallelism: time
    shards become head shards (shard j gathers heads
    ``[j h/n, (j+1) h/n)`` of the whole sequence), dense attention runs per
    head group, and the output is swapped back.  Needs
    ``heads % n_shards == 0``."""
    _check_shards(qs, ks, vs)
    n, h = len(qs), qs[0].shape[2]
    if h % n != 0:
        raise ValueError(f"heads={h} not divisible by seq shards={n}")
    devices = [q.device for q in qs]
    hn = h // n

    def to_headshard(xs):
        return [torch.cat([x[:, :, j * hn:(j + 1) * hn].to(devices[j])
                           for x in xs], dim=1) for j in range(n)]

    def to_timeshard(ys):
        t = ys[0].shape[1] // n
        return [torch.cat([y[:, i * t:(i + 1) * t].to(devices[i])
                           for y in ys], dim=2) for i in range(n)]

    outs = [_full_attention(qh, kh, vh, causal=causal, sm_scale=sm_scale)
            for qh, kh, vh in zip(to_headshard(qs), to_headshard(ks),
                                  to_headshard(vs))]
    return to_timeshard(outs)


# --------------------------------------------------------- sequence-par LSTM
def ring_lstm_scan(W: Tensor, RW: Tensor, b: Tensor, xs: Shards, carry,
                   masks: Optional[Shards] = None, *, afn, gate_fn):
    """Sequence-parallel peephole-LSTM scan, the sharded twin of
    ``nn/layers/recurrent.lstm_scan``.

    ``xs``: one (batch, t_local, n_in) time shard per ring position, in
    ring order, each on its own device; ``masks``: their (batch, t_local)
    masks, or None; ``carry``: the (h, c) entering the whole sequence.
    Returns the (batch, t_local, H) output shards, each on its shard's
    device, and the final (h, c) of the whole sequence on every shard's
    device (a list, one pair per shard).

    Each shard projects its inputs once (``x @ W + b`` over t_local
    steps), then runs its recurrent chain from the carry its left
    neighbour hands over (``.to`` its device).  The chain is recomputed in
    the backward pass (``torch.utils.checkpoint``), so a shard keeps its
    (batch, t_local, 4H) projection and no per-step residuals: O(T/n) per
    shard.  The JAX package runs every shard in every round in lockstep
    and commits only the owner's output; one process runs each shard
    once, in ring order, with the same outputs and carries."""
    if masks is not None and len(masks) != len(xs):
        raise ValueError(f"need one mask per shard: {len(xs)} shards, "
                         f"{len(masks)} masks")
    outs = []
    state = tuple(carry)
    for i, x in enumerate(xs):
        dev = x.device
        rw = RW.to(dev)
        xw = lstm_input_projection(W.to(dev), b.to(dev), x)
        mask = None if masks is None else masks[i]

        def chain(rw, xw, h, c, mask=mask):
            out, (h, c) = lstm_scan_preact(rw, xw, (h, c), afn=afn,
                                           gate_fn=gate_fn, mask=mask)
            return out, h, c

        out, h, c = checkpoint(chain, rw, xw, *(a.to(dev) for a in state),
                               use_reentrant=False)
        outs.append(out)
        state = (h, c)
    finals = [tuple(a.to(x.device) for a in state) for x in xs]
    return outs, finals


# ----------------------------------------------------------------- wrapper
class SequenceParallel:
    """Shards (batch, T, ...) tensors over a ring of devices and runs the
    sequence-parallel attention: full-shape tensors in and out.

    ``devices``: one entry per ring position; ``None`` means every CUDA
    device (raises with no card).  Naming one device n times runs an
    n-shard ring on it, e.g. ``["cuda"] * 4`` on one card or
    ``["cpu"] * 4`` on the CPU, where the kernels' plain versions run."""

    def __init__(self, devices=None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass devices=['cpu'] * n "
                    "to run the ring on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("SequenceParallel needs at least one device")
        self.n = len(self.devices)

    def _split(self, x: Tensor) -> List[Tensor]:
        return [c.to(d).contiguous()
                for c, d in zip(torch.chunk(x, self.n, dim=1), self.devices)]

    def attention(self, q: Tensor, k: Tensor, v: Tensor, *,
                  causal: bool = False, impl: str = "ring") -> Tensor:
        """Full-shape (batch, T, heads, d) in and out; T % n_shards == 0.

        ``impl``: ``"ring"``, ``"ulysses"`` and ``"ring_flash"`` shard the
        sequence over the devices; ``"flash"`` runs the one-device flash
        attention (K1-K3) on the first device.  The output lies on q's
        device."""
        if impl == "flash":
            return flash_attention(q, k, v, causal=causal,
                                   device=self.devices[0])
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; use 'ring', "
                             f"'ulysses', 'ring_flash', or 'flash'")
        if q.shape[1] % self.n:
            raise ValueError(
                f"sequence length {q.shape[1]} not divisible by "
                f"{self.n} seq shards")
        fn = {"ring": ring_attention, "ulysses": ulysses_attention,
              "ring_flash": ring_flash_attention}[impl]
        outs = fn(self._split(q), self._split(k), self._split(v),
                  causal=causal)
        return torch.cat([o.to(q.device) for o in outs], dim=1)
