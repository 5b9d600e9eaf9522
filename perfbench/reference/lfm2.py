"""Plain float32 LFM2-MoE (Liquid AI's ``Lfm2MoeForCausalLM``, the model
of https://huggingface.co/LiquidAI/LFM2-8B-A1B): a decoder of gated
short convolutions and grouped-query attention, each followed by a dense
SwiGLU (the first ``num_dense_layers``) or a mixture of SwiGLU experts,
then RMSNorm and the vocabulary head.

Decoder layer: ``h = x + op(RMSNorm(x))``, ``y = h + ffn(RMSNorm(h))``;
RMSNorm ``x * rsqrt(mean(x^2) + eps) * w``.
- conv: ``[B, C, x~] = split3(x W_in)``; ``v[t] = sum_j conv[j] * (B
  x~)[t - L + 1 + j]`` per channel (zeros before the start); out ``(C
  v) W_out``.
- attention: q, k, v of ``num_attention_heads``, ``num_key_value_heads``
  and ``num_key_value_heads`` heads of hidden / heads, RMSNorm over each
  head of q and k, RoPE (rotate-half, theta ``rope_theta``, positions
  0..T-1), causal softmax at 1/sqrt(head dim), query head h on KV head
  h // (heads / kv heads), out ``W_o``.
- MoE: ``s = sigmoid(x W_r)``; the experts ``topk(s + expert_bias)``;
  weights ``s`` at them over their sum + 1e-6, times
  ``routed_scaling_factor``; ``sum_e w_e (silu(x W1_e) * x W3_e) W2_e``
  over the chosen, every token to all of its experts (a loop over the
  experts).
- loss: the softmax cross-entropy of the next token, the mean over
  tokens.

Departures from the published model: the head is a leaf of its own (the
model ties it to the embedding); ``expert_bias`` is given, not updated
by a balancing rule (HF's modelling code updates it nowhere); weights
are drawn at a stated scale (the harness's).  Leaves are named
``layer<i>/<param>`` after the program's layer list (``models/lfm2.py``:
the embedding, then each decoder layer's mixer and feed-forward, the
final norm, the head), and are kept in its layouts: kernels (in, out),
experts stacked first, the convolution's taps (L, hidden).

The attention scores are recomputed in the backward
(``torch.utils.checkpoint``), so one sequence of 4,096 tokens trains in
float32 beside the weights and Adam's state.  ``quant`` ("fp8",
"bf16") rounds every product's operands and result, and the gradients
through them, to that format (``ops.q``), the statistics and the update
staying in float32.  With ``strict_fp32``
(TF32 off) everything else is IEEE float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import ops

Leaves = List[Tuple[str, tuple, object]]


def layer_plan(cfg) -> List[Tuple[int, str]]:
    """(index, kind) of every layer of the program's list: ``embed``,
    ``conv``, ``attn``, ``dense``, ``moe``, ``norm``, ``head``."""
    plan, i = [(0, "embed")], 1
    for j, kind in enumerate(cfg["layer_types"]):
        plan.append((i, "conv" if kind == "conv" else "attn"))
        plan.append((i + 1, "dense" if j < cfg["num_dense_layers"]
                     else "moe"))
        i += 2
    return plan + [(i, "norm"), (i + 1, "head")]


def _head_dim(cfg) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def leaves(cfg) -> Leaves:
    """(name, shape, init) of every parameter: init ``"w"`` is a kernel
    drawn at the configuration's scale, a number a constant fill."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    hd = _head_dim(cfg)
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    e, f, fd = (cfg["num_experts"], cfg["moe_intermediate_size"],
                cfg["intermediate_size"])
    out: Leaves = []
    for i, kind in layer_plan(cfg):
        p = f"layer{i}/"
        if kind == "embed":
            out.append((p + "W", (v, d), "w"))
        elif kind == "head":
            out.append((p + "W", (d, v), "w"))
        elif kind == "norm":
            out.append((p + "w", (d,), 1.0))
        else:
            out.append((p + "norm", (d,), 1.0))
        if kind == "conv":
            out += [(p + "W_in", (d, 3 * d), "w"),
                    (p + "conv", (cfg["conv_L_cache"], d), "w"),
                    (p + "W_out", (d, d), "w")]
        elif kind == "attn":
            out += [(p + "q_norm", (hd,), 1.0), (p + "k_norm", (hd,), 1.0),
                    (p + "Wq", (d, q), "w"), (p + "Wk", (d, kv), "w"),
                    (p + "Wv", (d, kv), "w"), (p + "Wo", (q, d), "w")]
        elif kind == "dense":
            out += [(p + "W1", (d, fd), "w"), (p + "W3", (d, fd), "w"),
                    (p + "W2", (fd, d), "w")]
        elif kind == "moe":
            out += [(p + "router", (d, e), "w"), (p + "w1", (e, d, f), "w"),
                    (p + "w3", (e, d, f), "w"), (p + "w2", (e, f, d), "w")]
    return out


def state_leaves(cfg) -> Leaves:
    """``expert_bias`` of every MoE layer: init ``"bias"``, drawn by the
    harness."""
    return [(f"layer{i}/expert_bias", (cfg["num_experts"],), "bias")
            for i, kind in layer_plan(cfg) if kind == "moe"]


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    t, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] \
        * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)[None, :, None, :]
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * torch.cos(ang) + half * torch.sin(ang)


def _conv(cfg, P, p, h, quant):
    d = cfg["hidden_size"]
    bcx = ops.dense(h, P[p + "W_in"], None, quant)
    b, c, x = bcx[..., :d], bcx[..., d:2 * d], bcx[..., 2 * d:]
    u = b * x
    taps = ops.q(P[p + "conv"], quant)
    n, t = taps.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, n - 1, 0))
    v = sum(up[:, j:j + t] * taps[j] for j in range(n))
    return ops.dense(c * ops.q(v, quant), P[p + "W_out"], None, quant)


def _attention(cfg, P, p, h, quant):
    b, t, _ = h.shape
    hd, eps = _head_dim(cfg), cfg["norm_eps"]
    nh, nk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    q = ops.dense(h, P[p + "Wq"], None, quant).reshape(b, t, nh, hd)
    k = ops.dense(h, P[p + "Wk"], None, quant).reshape(b, t, nk, hd)
    v = ops.dense(h, P[p + "Wv"], None, quant).reshape(b, t, nk, hd)
    q = _rope(rms_norm(q, P[p + "q_norm"], eps), cfg["rope_theta"])
    k = _rope(rms_norm(k, P[p + "k_norm"], eps), cfg["rope_theta"])
    kv_of = torch.arange(nh, device=h.device) // (nh // nk)
    q = ops.q(q, quant).permute(0, 2, 1, 3)                 # b, nh, t, hd
    k = ops.q(k, quant)[:, :, kv_of].permute(0, 2, 1, 3)
    v = ops.q(v, quant)[:, :, kv_of].permute(0, 2, 1, 3)
    # the (heads, T, T) scores are made again in the backward, not kept
    ctx = checkpoint(_softmax_attention, q, k, v, quant, use_reentrant=False)
    ctx = ctx.permute(0, 2, 1, 3).reshape(b, t, nh * hd)
    return ops.dense(ctx, P[p + "Wo"], None, quant)


def _softmax_attention(q, k, v, quant):
    t = q.shape[2]
    s = ops.q(q @ k.transpose(-1, -2), quant) / math.sqrt(q.shape[-1])
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    pr = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return ops.q(ops.q(pr, quant) @ v, quant)


def _dense_ffn(P, p, h, quant):
    a = F.silu(ops.dense(h, P[p + "W1"], None, quant)) \
        * ops.dense(h, P[p + "W3"], None, quant)
    return ops.dense(a, P[p + "W2"], None, quant)


def route(cfg, x, w_router, bias, quant=None):
    """(weights (N, k), experts (N, k)) of rows ``x`` (N, hidden)."""
    s = torch.sigmoid(ops.dense(x, w_router, None, quant))
    experts = torch.topk(s + bias, cfg["num_experts_per_tok"],
                         dim=-1).indices
    w = torch.gather(s, 1, experts)
    w = w / (w.sum(-1, keepdim=True) + 1e-6)
    return w * cfg["routed_scaling_factor"], experts


def _moe(cfg, P, S, p, h, quant, choices):
    b, t, d = h.shape
    x = h.reshape(b * t, d)
    w, experts = route(cfg, x, P[p + "router"], S[p + "expert_bias"], quant)
    if choices is not None:
        choices.append(experts.detach())
    out = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        rows, slot = torch.nonzero(experts == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        a = F.silu(ops.dense(xe, P[p + "w1"][e], None, quant)) \
            * ops.dense(xe, P[p + "w3"][e], None, quant)
        ye = ops.dense(a, P[p + "w2"][e], None, quant)
        out = out.index_add(0, rows, ye * w[rows, slot].unsqueeze(-1))
    return out.reshape(b, t, d)


def hidden(cfg, P: Dict, S: Dict, ids: torch.Tensor,
           quant: Optional[str] = None,
           choices: Optional[list] = None) -> torch.Tensor:
    """The final RMSNorm's output (batch, time, hidden) for ids (batch,
    time); ``choices`` collects each MoE layer's (tokens, k) experts."""
    eps = cfg["norm_eps"]
    x = None
    for i, kind in layer_plan(cfg):
        p = f"layer{i}/"
        if kind == "embed":
            x = P[p + "W"][ids.long()]
        elif kind == "norm":
            return rms_norm(x, P[p + "w"], eps)
        elif kind != "head":
            h = rms_norm(x, P[p + "norm"], eps)
            if kind == "conv":
                x = x + _conv(cfg, P, p, h, quant)
            elif kind == "attn":
                x = x + _attention(cfg, P, p, h, quant)
            elif kind == "dense":
                x = x + _dense_ffn(P, p, h, quant)
            else:
                x = x + _moe(cfg, P, S, p, h, quant, choices)
    raise ValueError("no final norm in the layer plan")


def head_key(cfg) -> str:
    return f"layer{layer_plan(cfg)[-1][0]}/W"


def forward(cfg, P: Dict, S: Dict, ids: torch.Tensor, train: bool = False,
            quant: Optional[str] = None):
    """(logits (batch, time, vocab), state) of ids (batch, time); the
    state is unchanged (``expert_bias`` moves by no gradient)."""
    return ops.dense(hidden(cfg, P, S, ids, quant), P[head_key(cfg)], None,
                     quant), {}


def forward_flops(cfg, seq_len: int) -> float:
    """Matrix-product FLOPs of one sequence's forward: every projection,
    the router, the experts at top-k, attention's QK^T and PV over the
    causal half (T^2/2 pairs), the head."""
    d, v, t = cfg["hidden_size"], cfg["vocab_size"], seq_len
    hd = _head_dim(cfg)
    nh, nk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    macs = t * d * v              # the head; the embedding is a gather
    for _, kind in layer_plan(cfg):
        if kind == "conv":
            macs += t * (3 * d * d + d * d)
        elif kind == "attn":
            macs += t * d * (2 * nh * hd + 2 * nk * hd)
            macs += 2 * nh * hd * t * t / 2
        elif kind == "dense":
            macs += t * 3 * d * cfg["intermediate_size"]
        elif kind == "moe":
            macs += t * (d * cfg["num_experts"] + cfg["num_experts_per_tok"]
                         * 3 * d * cfg["moe_intermediate_size"])
    return 2.0 * macs


def attention_flops(cfg, seq_len: int) -> float:
    """What K1-K3 compute for one sequence's training step, counted as
    the mathematics needs it: forward QK^T and PV, backward dV, dP, dQ and
    dK, over the causal half, no recomputation: 6 products of 2 T^2/2 d
    FLOPs a head."""
    t, nh = seq_len, cfg["num_attention_heads"]
    n_attn = sum(kind == "attn" for _, kind in layer_plan(cfg))
    return n_attn * nh * 6 * 2.0 * t * t / 2 * _head_dim(cfg)


def expert_flops(cfg, seq_len: int) -> float:
    """The routed experts' products in one sequence's training step: three
    GEMMs of every token's top-k slots, forward and the two gradients."""
    n_moe = sum(kind == "moe" for _, kind in layer_plan(cfg))
    return n_moe * 3 * 2.0 * seq_len * cfg["num_experts_per_tok"] * 3 \
        * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def loss_and_grads(cfg, P: Dict, S: Dict, ids: torch.Tensor,
                   labels: torch.Tensor, quant: Optional[str] = None,
                   chunk: int = 1024,
                   choices: Optional[list] = None) -> float:
    """The batch's mean next-token loss, its gradient accumulated into
    each leaf's ``.grad``, one sequence at a time and the head's logits
    ``chunk`` tokens at a time (each chunk's backward at once), so the
    float32 step fits beside the weights and Adam's state.  ``P``'s
    leaves must require grad."""
    n = labels.numel()
    w = P[head_key(cfg)]
    total = 0.0
    for i in range(ids.shape[0]):
        h = hidden(cfg, P, S, ids[i:i + 1], quant, choices)
        hd = h.detach().requires_grad_(True)
        for a in range(0, ids.shape[1], chunk):
            logits = ops.dense(hd[:, a:a + chunk], w, None, quant)
            lo = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 labels[i, a:a + chunk].reshape(-1).long(),
                                 reduction="sum") / n
            lo.backward()
            total += float(lo.detach())
            del logits, lo
        h.backward(hd.grad)
        del h, hd
    return total


def adam(P: Dict, m: Dict, v: Dict, step: int, lr: float, b1: float,
         b2: float, eps: float = 1e-8) -> None:
    """Adam in place on each leaf's ``.grad``, in DL4J's form: ``m = b1 m
    + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``w -= alpha m / (sqrt(v)
    + eps)`` with ``alpha = lr sqrt(1 - b2^t) / (1 - b1^t)``."""
    t = step + 1
    alpha = lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
    with torch.no_grad():
        for k, p in P.items():
            g = p.grad
            m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(alpha * m[k] / (v[k].sqrt() + eps))
            p.grad = None


def three_steps(cfg, P: Dict, S: Dict, batches, quant: Optional[str] = None,
                first_grad: Optional[Callable] = None,
                choices: Optional[list] = None) -> List[float]:
    """Train ``P`` (float32, in place) with the configuration's Adam on
    each ``(ids, labels)`` of ``batches``; returns each step's loss.
    ``first_grad(name, g)`` sees each leaf's first gradient before the
    first update; ``choices`` collects the first forward's routing."""
    lr, b1, b2 = (cfg["learning_rate"], cfg["adam_mean_decay"],
                  cfg["adam_var_decay"])
    m = {k: torch.zeros_like(p) for k, p in P.items()}
    v = {k: torch.zeros_like(p) for k, p in P.items()}
    for p in P.values():
        p.requires_grad_(True)
    losses = []
    for step, (ids, labels) in enumerate(batches):
        losses.append(loss_and_grads(cfg, P, S, ids, labels, quant,
                                     choices=choices if step == 0 else None))
        if step == 0 and first_grad is not None:
            for k, p in P.items():
                first_grad(k, p.grad)
        adam(P, m, v, step, lr, b1, b2)
    for p in P.values():
        p.requires_grad_(False)
    return losses
