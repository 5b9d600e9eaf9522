"""Training traffic: ``fit(iterator)`` over seeded uint8 images behind
the pixel scaler, the program's uint8 wire.

Set-up builds one network and drives it through its first three steps
with the window's own call, ``fit(iterator)``, on the first rows of the
window's images (one step, then two), reading what the check needs after
the first and the third.  A warm-up ``fit`` over the whole iterator
captures the step for the window's dataset (the window path, which
captures nothing, warms on ``warm_examples`` rows).  The window is whole
``fit(iterator)`` calls, synchronized at both ends, until ``--seconds``
have passed; with ``--trace 1`` it is one profiled call.  After the
window the network is freed and the plain reference follows the same
three steps from the same weights.

Traffic keys: ``metric`` (the name the cell reports its samples a
second under), ``examples``, ``batch``, ``ingest`` (the data path that
``fit`` takes for a dataset of that size, asked for by name so that a
run fails rather than measure another path: ``cache`` or ``window``),
``warm_examples`` (the rows of the warm-up ``fit``, all by default).
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from perfbench import inputs, program
from perfbench.reference import ops, train as ref_train

#: leaves whose reference gradient is under this share of the median
#: leaf's are not compared (they move by round-off alone)
NEGLIGIBLE = 1e-3


def iterator(u8: np.ndarray, labels: np.ndarray, batch: int):
    """The user's iterator: a ListDataSetIterator over uint8 images with
    an ImagePreProcessingScaler."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.datasets.normalizers import \
        ImagePreProcessingScaler
    it = ListDataSetIterator(DataSet(u8, labels), batch)
    it.set_preprocessor(ImagePreProcessingScaler())
    return it


class _Scores:
    """A listener that keeps each step's score."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration):
        self.scores.append(float(model.score()))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def checked_steps(net, model, cfg, u8, labels, batch: int, seed: int,
                  device, ingest: str) -> dict:
    """The first three steps through ``fit(iterator)``: one on rows
    [0, batch), then two on [batch, 3 batch).  Returns each step's score,
    each leaf's first gradient (from the momentum after one step:
    v = -lr g), and each leaf's change after the three (fp32 masters,
    running statistics), the tensors copied to the host."""
    lr = cfg["learning_rate"]
    names = [k for k, _, _ in model.leaves(cfg)]
    snames = [k for k, _, _ in model.state_leaves(cfg)]
    net.fit(iterator(u8[:batch], labels[:batch], batch), ingest=ingest)
    losses = [float(net.score())]
    grads = {k: (program.read(net, k, "v").float() / -lr).cpu()
             for k in names}
    keep = _Scores()
    net.add_listener(keep)
    try:
        net.fit(iterator(u8[batch:3 * batch], labels[batch:3 * batch],
                         batch), ingest=ingest)
    finally:
        net.listeners.remove(keep)
    losses += keep.scores
    w0 = inputs.make_weights(model.leaves(cfg), seed, device,
                             cfg["precision"])
    s0 = inputs.make_state(model.state_leaves(cfg), device, cfg["precision"])
    change = {k: (program.read(net, k, "master").float() - w0[k]).cpu()
              for k in names}
    change.update({k: (program.read(net, k, "state").float() - s0[k]).cpu()
                   for k in snames})
    del w0, s0
    return {"losses": losses, "grads": grads, "changes": change}


def reference_steps(model, cfg, u8, labels, batch: int, seed: int, device,
                    quant=None) -> dict:
    """The reference's three steps from the same weights and rows."""
    ops.strict_fp32()
    P = inputs.make_weights(model.leaves(cfg), seed, device,
                            cfg["precision"])
    S = inputs.make_state(model.state_leaves(cfg), device, cfg["precision"])
    batches = []
    for a, b in ((0, batch), (batch, 2 * batch), (2 * batch, 3 * batch)):
        batches.append((inputs.decode(u8[a:b], device),
                        torch.from_numpy(labels[a:b]).to(device)))
    return ref_train.three_steps(model, cfg, P, S, batches, quant)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def compare(got: dict, want: dict):
    """What a run can compare with the reference: the worst step's loss
    gap and the first step's; and for the first gradient and for the change after three
    steps, each leaf's error (the norm of the difference) and the gap
    of its norm, over the reference's norm of that leaf or of the median
    leaf, whichever is larger, at the worst leaf (``*_err``, ``*_gap``)
    and at the median leaf (``*_err_median``, ``*_gap_median``), and the
    error at the worst leaf of the output layer, the last layer in graph
    order (``head_*_err``), whose gradient carries each row's own label
    and no relu or pool that rounding can flip.  Leaves whose reference
    gradient is under ``NEGLIGIBLE`` of the median leaf's are left out.
    Returns the numbers and the leaves left out."""
    loss = max(abs(a - b) / abs(b) for a, b in
               zip(got["losses"], want["losses"]))
    if len(got["losses"]) != len(want["losses"]):
        loss = float("inf")
    g_ref = {k: _norm(v) for k, v in want["grads"].items()}
    g_med = statistics.median(g_ref.values())
    kept = {k for k, v in g_ref.items() if v >= NEGLIGIBLE * g_med}
    head = list(want["grads"])[-1].split("/")[0]
    out = {"loss_gap": loss,
           "loss1_gap": abs(got["losses"][0] - want["losses"][0])
           / abs(want["losses"][0])}
    for name, what, keys in (
            ("grad", "grads", kept),
            ("change", "changes",
             kept | (set(want["changes"]) - set(g_ref)))):
        a, b = got[what], want[what]
        ref = {k: _norm(b[k]) for k in keys}
        med = statistics.median(ref.values())
        floor = {k: max(ref[k], med, 1e-30) for k in keys}
        gaps = [abs(_norm(a[k]) - ref[k]) / floor[k] for k in keys]
        errs = [_norm(a[k].to(b[k].device) - b[k]) / floor[k] for k in keys]
        out[f"{name}_err"] = max(errs)
        out[f"{name}_err_median"] = statistics.median(errs)
        out[f"{name}_gap"] = max(gaps)
        out[f"{name}_gap_median"] = statistics.median(gaps)
        out[f"head_{name}_err"] = max(
            e for k, e in zip(keys, errs) if k.split("/")[0] == head)
    return out, sorted(set(g_ref) - kept)


def run(ctx) -> dict:
    cfg, traffic, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    model = ctx.model
    n, batch = int(traffic["examples"]), int(traffic["batch"])
    net = program.build(cfg, dev)
    policy = net._pol().name
    if dev.type == "cuda" and policy != cfg["precision"]:
        raise RuntimeError(f"the network runs {policy}, the configuration "
                           f"states {cfg['precision']}")
    program.load(net,
                 inputs.make_weights(model.leaves(cfg), seed, dev,
                                     cfg["precision"]),
                 inputs.make_state(model.state_leaves(cfg), dev,
                                   cfg["precision"]))
    u8 = inputs.make_images(n, cfg, seed, "images", dev)
    labels = inputs.make_labels(n, cfg["n_classes"], seed, "labels", dev)
    ingest = traffic["ingest"]
    got = checked_steps(net, model, cfg, u8, labels, batch, seed, dev,
                        ingest)
    it = iterator(u8, labels, batch)
    warm = int(traffic.get("warm_examples", n))
    # the cache path uploads and captures for the window's own dataset;
    # the window path warms on one window of its rows
    net.fit(it if warm >= n else iterator(u8[:warm], labels[:warm], batch),
            ingest=ingest)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    prof = None
    calls = 0
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
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = (ctx.summarize(prof, window) if prof is not None else None)
    del net, it, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_steps(model, cfg, u8, labels, batch, seed, dev)
    checks, left_out = compare(got, want)
    flops = 3.0 * model.forward_flops(cfg)
    return {
        "e2e": {traffic["metric"]: samples / window, "setup_s": setup_s},
        "attempted": steps, "failed": 0 if np.isfinite(last) else steps,
        "checks": checks, "peak_bytes": peak, "trace": summary,
        "readings": {"samples": samples, "steps": steps, "window_s": window,
                     "step_flops_per_sample": flops,
                     "losses": got["losses"], "ref_losses": want["losses"],
                     "leaves_left_out": left_out},
    }
