"""Language-model training traffic: ``fit(iterator)`` over seeded token
sequences, int32 ids and int32 next-token labels, through the epoch
cache and its captured step.

Set-up builds the network (its ``init()`` draws every weight on the
host, timed as the reading ``init_s``), writes the run's weights and
``expert_bias`` into it, runs ``output()`` on the first batch (the
inference path, and the program's routing of a first forward), then
drives the first three steps with the window's own call,
``fit(iterator)``: one step on sequences [0, batch), then two on [batch,
3 batch), reading each leaf's first gradient from Adam's first moment
(g = m / (1 - beta1)) and its change after the three (fp32 masters), to
the host.  A warm-up ``fit`` over the whole iterator captures the step
for the window's dataset.  The window is whole ``fit(iterator)`` calls,
synchronized at both ends, until ``--seconds`` have passed; with
``--trace 1`` it is one profiled call, and the MoE layers' device
counters are read before and after it (``expert_load_max``).  After the
window the network is freed and the float32 reference repeats the three
steps from the same weights and rows, a sequence at a time
(``reference/lfm2.py`` ``three_steps``), each leaf held to the program's
as it is made.

Traffic keys: ``metric``, ``examples`` (sequences), ``batch``,
``seq_len``, ``ingest`` (``cache``), ``zipf_s`` (the ids' Zipf
exponent over the vocabulary).
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import inputs, program

#: leaves whose reference gradient is under this share of the median
#: leaf's are not compared (``train_fit``'s rule)
NEGLIGIBLE = 1e-3


def weight_stream(model, cfg, seed: int, device):
    """``(leaf, weights)`` of every leaf in turn, float32 holding the
    program's storage values: kernels normal(0, ``init_std``) drawn leaf
    after leaf from one generator, constants filled.  One leaf at a time
    exists, for a caller that needs each only once."""
    g = inputs.generator(seed, "weights", device)
    for leaf, shape, init in model.leaves(cfg):
        if init == "w":
            w = torch.randn(shape, generator=g, device=device)
            w.mul_(cfg["init_std"])
        else:
            w = torch.full(shape, float(init), device=device)
        yield leaf, inputs.rounded(w, cfg["precision"])


def make_weights(model, cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of :func:`weight_stream` at once."""
    return dict(weight_stream(model, cfg, seed, device))


def make_state(model, cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """``expert_bias`` of every MoE layer, normal(0, ``expert_bias_std``)
    in float32 (the program keeps it so)."""
    g = inputs.generator(seed, "expert_bias", device)
    return {leaf: torch.randn(shape, generator=g, device=device)
            * cfg["expert_bias_std"]
            for leaf, shape, _ in model.state_leaves(cfg)}


def make_tokens(n: int, length: int, vocab: int, s: float, seed: int,
                device) -> np.ndarray:
    """(n, length) int32 ids drawn Zipf(``s``) over the vocabulary (id r-1
    at rank r), on ``device``, returned on the host."""
    g = inputs.generator(seed, "tokens", device)
    ranks = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    cdf = torch.cumsum(ranks.pow(-s), 0)
    cdf = cdf / cdf[-1]
    u = torch.rand((n, length), generator=g, device=device,
                   dtype=torch.float64)
    ids = torch.searchsorted(cdf, u).clamp_max(vocab - 1)
    return ids.to(torch.int32).cpu().numpy()


def iterator(x: np.ndarray, y: np.ndarray, batch: int):
    """The user's iterator: a ListDataSetIterator over int32 ids and
    labels."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    return ListDataSetIterator(DataSet(x, y), batch)


class _Scores:
    """A listener that keeps each step's score."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration):
        self.scores.append(float(model.score()))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def counters(net) -> torch.Tensor:
    """The MoE layers' (layers, experts) routed-token counts, host int64
    (one device read)."""
    from deeplearning4j_tpu_torch.monitor import moe
    return torch.from_numpy(moe.publish_expert_tokens(net))


def program_routing(net, x: np.ndarray) -> List[torch.Tensor]:
    """``output()`` of the rows ``x``, recording each MoE layer's (tokens,
    k) expert choice on the host: the program's routing of a first
    forward."""
    from deeplearning4j_tpu_torch.ops import moe
    real, seen = moe.route, []

    def record(*a, **k):
        w, experts = real(*a, **k)
        seen.append(experts)
        return w, experts
    moe.route = record
    try:
        out = net.output(x)
        if not torch.isfinite(out[:, -1]).all():
            raise RuntimeError("output() gave a non-finite row")
    finally:
        moe.route = real
    del out
    return [e.cpu() for e in seen]


def checked_steps(net, model, cfg, x, y, batch: int, seed: int, device,
                  ingest: str) -> dict:
    """The first three steps through ``fit(iterator)``: one on rows
    [0, batch), then two on [batch, 3 batch).  Returns each step's score,
    each leaf's first gradient (Adam's first moment after one step over
    1 - beta1) and each leaf's change after the three (fp32 masters;
    ``expert_bias``), on the host."""
    b1 = cfg["adam_mean_decay"]
    names = [k for k, _, _ in model.leaves(cfg)]
    snames = [k for k, _, _ in model.state_leaves(cfg)]
    net.fit(iterator(x[:batch], y[:batch], batch), ingest=ingest)
    losses = [float(net.score())]
    grads = {k: (program.read(net, k, "m").float() / (1.0 - b1)).cpu()
             for k in names}
    keep = _Scores()
    net.add_listener(keep)
    try:
        net.fit(iterator(x[batch:3 * batch], y[batch:3 * batch], batch),
                ingest=ingest)
    finally:
        net.listeners.remove(keep)
    losses += keep.scores
    change = {k: (program.read(net, k, "master").float() - w).cpu()
              for k, w in weight_stream(model, cfg, seed, device)}
    s0 = make_state(model, cfg, seed, device)
    change.update({k: (program.read(net, k, "state").float() - s0[k]).cpu()
                   for k in snames})
    return {"losses": losses, "grads": grads, "changes": change}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


class LeafNorms:
    """Per-leaf norms of one side against the reference, taken as the
    reference makes each leaf: the reference's, the side's and their
    difference's."""

    def __init__(self, side: Dict[str, torch.Tensor]):
        self.side = side
        self.ref: Dict[str, float] = {}
        self.got: Dict[str, float] = {}
        self.diff: Dict[str, float] = {}

    def __call__(self, k: str, want: torch.Tensor) -> None:
        a = self.side[k].to(want.device)
        self.ref[k] = _norm(want)
        self.got[k] = _norm(a)
        self.diff[k] = _norm(a - want)


def reference_steps(model, cfg, x, y, batch: int, seed: int, device, got,
                    quant=None, ignore_bias: bool = False) -> dict:
    """The reference's three steps from the same weights and rows, each
    leaf's first gradient and change held to ``got``'s (a dict of host
    tensors by leaf) as it is made, and the first forward's routing.
    ``quant`` computes it in that format, ``ignore_bias`` chooses the
    experts without ``expert_bias``: controls and a fault in the
    program's place."""
    from perfbench.reference import ops
    ops.strict_fp32()
    P = make_weights(model, cfg, seed, device)
    S = make_state(model, cfg, seed, device)
    if ignore_bias:
        S = {k: torch.zeros_like(v) for k, v in S.items()}
    batches = [(torch.from_numpy(x[a:a + batch]).to(device),
                torch.from_numpy(y[a:a + batch]).to(device))
               for a in (0, batch, 2 * batch)]
    s0 = {k: v.clone() for k, v in S.items()}
    grads = LeafNorms(got["grads"])
    choices: list = []
    losses = model.three_steps(cfg, P, S, batches, quant, grads, choices)
    changes = LeafNorms(got["changes"])
    for k, w in weight_stream(model, cfg, seed, device):
        changes(k, P.pop(k) - w)
    for k, v in S.items():
        changes(k, v - s0[k])
    return {"losses": losses, "grads": grads, "changes": changes,
            "choices": choices}


def reference_side(model, cfg, x, y, batch: int, seed: int, device,
                   quant=None, ignore_bias: bool = False) -> dict:
    """The reference in the program's place (a control in ``quant``, or
    the fault that chooses without ``expert_bias``): what
    :func:`checked_steps` returns, and the first forward's routing."""
    from perfbench.reference import ops
    ops.strict_fp32()
    P = make_weights(model, cfg, seed, device)
    S = make_state(model, cfg, seed, device)
    if ignore_bias:
        S = {k: torch.zeros_like(v) for k, v in S.items()}
    batches = [(torch.from_numpy(x[a:a + batch]).to(device),
                torch.from_numpy(y[a:a + batch]).to(device))
               for a in (0, batch, 2 * batch)]
    grads: Dict[str, torch.Tensor] = {}
    choices: list = []
    losses = model.three_steps(
        cfg, P, S, batches, quant,
        lambda k, g: grads.__setitem__(k, g.detach().cpu()), choices)
    change = {k: (P.pop(k) - w).cpu()
              for k, w in weight_stream(model, cfg, seed, device)}
    change.update({k: torch.zeros(v.shape) for k, v in S.items()})
    return {"losses": losses, "grads": grads, "changes": change,
            "choices": choices}


def route_agree(prog: List[torch.Tensor], ref: List[torch.Tensor],
                n_seqs: int) -> float:
    """The share of the program's (token, expert) choices that the
    reference made too, at the worst MoE layer.  ``prog`` holds one
    (tokens, k) tensor a layer for the whole batch, ``ref`` one a layer
    for each sequence in turn."""
    layers = len(prog)
    if not layers or len(ref) != layers * n_seqs:
        return float("nan")
    worst = 1.0
    for i in range(layers):
        r = torch.cat([ref[s * layers + i].cpu() for s in range(n_seqs)])
        a = prog[i]
        same = (a.unsqueeze(-1) == r.unsqueeze(-2)).any(-1).float().mean()
        worst = min(worst, float(same))
    return worst


def compare(got: dict, want: dict) -> dict:
    """``train_fit.compare``'s numbers from per-leaf norms: the loss gaps,
    and for the first gradient and the change after three steps each
    leaf's error and gap of norms over the reference's norm of that leaf
    or of the median leaf, whichever is larger, at the worst and the
    median leaf, and the error at the head's leaf (``head_*_err``)."""
    loss = max(abs(a - b) / abs(b) for a, b in
               zip(got["losses"], want["losses"]))
    if len(got["losses"]) != len(want["losses"]):
        loss = float("inf")
    g = want["grads"]
    g_med = statistics.median(g.ref.values())
    kept = {k for k, v in g.ref.items() if v >= NEGLIGIBLE * g_med}
    head = list(g.ref)[-1].split("/")[0]
    out = {"loss_gap": loss,
           "loss1_gap": abs(got["losses"][0] - want["losses"][0])
           / abs(want["losses"][0])}
    for name, norms, keys in (
            ("grad", g, kept),
            ("change", want["changes"],
             kept | (set(want["changes"].ref) - set(g.ref)))):
        med = statistics.median(norms.ref[k] for k in keys)
        floor = {k: max(norms.ref[k], med, 1e-30) for k in keys}
        gaps = {k: abs(norms.got[k] - norms.ref[k]) / floor[k] for k in keys}
        errs = {k: norms.diff[k] / floor[k] for k in keys}
        out[f"{name}_err"] = max(errs.values())
        out[f"{name}_err_median"] = statistics.median(errs.values())
        out[f"{name}_gap"] = max(gaps.values())
        out[f"{name}_gap_median"] = statistics.median(gaps.values())
        out[f"head_{name}_err"] = max(
            e for k, e in errs.items() if k.split("/")[0] == head)
    return out


def worst_leaves(norms: LeafNorms, n: int = 4) -> list:
    """The ``n`` leaves farthest off, by error over the reference's norm."""
    rel = {k: norms.diff[k] / max(norms.ref[k], 1e-30) for k in norms.ref}
    return sorted(rel.items(), key=lambda kv: -kv[1])[:n]


def load(net, model, cfg, seed: int, device) -> None:
    """The run's weights and ``expert_bias`` into the program, its
    routed-token counters at zero."""
    state = make_state(model, cfg, seed, device)
    for key, tree in net._items(net.net_state):
        if "expert_tokens" in tree:
            state[f"layer{key}/expert_tokens"] = torch.zeros_like(
                tree["expert_tokens"])
    program.load(net, make_weights(model, cfg, seed, device), state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    cfg, traffic, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    model = ctx.model
    n, batch, t = (int(traffic["examples"]), int(traffic["batch"]),
                   int(traffic["seq_len"]))
    t_init = time.perf_counter()
    net = program.build(cfg, dev)
    init_s = time.perf_counter() - t_init
    policy = net._pol().name
    if dev.type == "cuda" and policy != cfg["precision"]:
        raise RuntimeError(f"the network runs {policy}, the configuration "
                           f"states {cfg['precision']}")
    load(net, model, cfg, seed, dev)
    ids = make_tokens(n, t + 1, cfg["vocab_size"], float(traffic["zipf_s"]),
                      seed, dev)
    x, y = ids[:, :-1].copy(), ids[:, 1:].copy()
    routed = program_routing(net, x[:batch])
    ingest = traffic["ingest"]
    t_checked = time.perf_counter()
    got = checked_steps(net, model, cfg, x, y, batch, seed, dev, ingest)
    checked_s = time.perf_counter() - t_checked
    it = iterator(x, y, batch)
    from deeplearning4j_tpu_torch.ops import attention
    attention.reset_launches()
    net.fit(it, ingest=ingest)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    # K1-K3's wrappers run in the capture's warm-up steps and the capture
    # (a replay runs none): launches per kernel, and on the Hopper bodies
    launches = [attention.LAUNCHES[k] for k in
                ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")]
    sm90 = [attention.BODY_LAUNCHES[k]["sm90"] for k in
            ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")]

    prof = None
    calls = 0
    before = counters(net) if ctx.trace else None
    if ctx.trace:
        prof = ctx.profiler().__enter__()
    t_start = time.perf_counter()
    while True:
        net.fit(it, ingest=ingest)
        calls += 1
        sync(dev)
        window = time.perf_counter() - t_start
        if ctx.trace or window >= ctx.seconds:
            break
    if prof is not None:
        prof.__exit__(None, None, None)
    last = float(net.score())
    steps = calls * -(-n // batch)
    samples = calls * n
    readings = {}
    if before is not None:
        moved = (counters(net) - before).double()
        even = samples * t * cfg["num_experts_per_tok"] / cfg["num_experts"]
        readings["expert_load_max"] = float(moved.max()) / even
        readings["expert_tokens_traced_total"] = int(moved.sum())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = (ctx.summarize(prof, window) if prof is not None else None)
    del net, it, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = reference_steps(model, cfg, x, y, batch, seed, dev, got)
    reference_s = time.perf_counter() - t_ref
    checks = compare(got, want)
    checks["route_agree"] = route_agree(routed, want["choices"], batch)
    return {
        "e2e": {traffic["metric"]: samples / window, "setup_s": setup_s},
        "attempted": steps, "failed": 0 if np.isfinite(last) else steps,
        "checks": checks, "peak_bytes": peak, "trace": summary,
        "readings": dict(
            readings, samples=samples, steps=steps, window_s=window,
            init_s=init_s, checked_s=checked_s, reference_s=reference_s,
            flash_launches_capture=launches,
            flash_launches_capture_sm90=sm90,
            step_flops_per_sample=3.0 * model.forward_flops(cfg, t),
            attention_flops_per_sample=model.attention_flops(cfg, t),
            expert_flops_per_sample=model.expert_flops(cfg, t),
            losses=got["losses"], ref_losses=want["losses"],
            worst_grad_leaves=worst_leaves(want["grads"]),
            worst_change_leaves=worst_leaves(want["changes"])),
    }
