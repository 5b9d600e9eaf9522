"""Scaling harness of the data-parallel tier (port of
``deeplearning4j_tpu/parallel/scaling.py``).

``scaling_report``'s efficiency is ``throughput(N) / (N *
throughput(1))``.  Workers that share one card time-slice it, so on one
card that ratio measures the wrapper's overhead, not scaling; what one
card can bound is :func:`collective_overhead_report`: a ``ParallelWrapper``
round at ``workers=1`` (the staging, the mean over one slot, the
bookkeeping) against the plain per-batch step on the same batch.  Every
clock is read with the card synchronized on both sides.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..datasets.dataset import DataSet
from .parallel_wrapper import ParallelWrapper


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_throughput(net_factory: Callable[[], object], workers: int,
                       batch_size: int = 128, n_rounds: int = 10,
                       averaging_frequency: int = 1,
                       feature_shape=(784,), n_classes: int = 10,
                       warmup_rounds: int = 2,
                       devices: Optional[list] = None) -> float:
    """Samples/s of data-parallel training at ``workers`` replicas over
    ``devices`` (default: the network's device named ``workers`` times).
    One round moves ``workers * averaging_frequency * batch_size``
    samples."""
    rng = np.random.RandomState(0)
    k = averaging_frequency

    def make_batches(n):
        return [DataSet(
            rng.randn(batch_size, *feature_shape).astype(np.float32),
            np.eye(n_classes, dtype=np.float32)[
                rng.randint(0, n_classes, batch_size)])
            for _ in range(n * k * workers)]

    net = net_factory()
    net.init()
    devices = devices if devices is not None else [net.device] * workers
    pw = ParallelWrapper(net, workers=workers, averaging_frequency=k,
                         devices=devices)
    pw.fit(make_batches(warmup_rounds))
    batches = make_batches(n_rounds)
    _sync(net.device)
    t0 = time.perf_counter()
    pw.fit(batches)
    _sync(net.device)
    elapsed = time.perf_counter() - t0
    return len(batches) * batch_size / elapsed


def scaling_report(net_factory: Callable[[], object],
                   worker_counts: List[int], **kw) -> Dict[int, dict]:
    """Throughput and efficiency per worker count (efficiency relative to
    the per-replica throughput at the smallest count)."""
    out: Dict[int, dict] = {}
    base = None
    for w in worker_counts:
        tput = measure_throughput(net_factory, w, **kw)
        if base is None:
            base = tput / w
        out[w] = {
            "workers": w,
            "samples_per_sec": round(tput, 1),
            "efficiency": round(tput / (w * base), 4),
        }
    return out


def collective_overhead_report(net_factory: Callable[[], object],
                               batch_size: int = 256,
                               feature_shape=(784,), n_classes: int = 10,
                               steps: int = 40, trials: int = 3,
                               pipeline: int = 4) -> dict:
    """The cost of the wrapper's round on one device: a staged
    ``workers=1`` round (its step, the mean over one slot and the fold
    back into the model) against the plain ``_train_step`` on the same
    batch, each run ``pipeline * steps`` times between two
    synchronizations, best of ``trials``.  Returns both step times, their
    difference and ratio."""
    rng = np.random.RandomState(0)
    f = rng.rand(batch_size, *feature_shape).astype(np.float32)
    l = np.eye(n_classes, dtype=np.float32)[
        rng.randint(0, n_classes, batch_size)]
    ds = DataSet(f, l)

    # --- the plain step ---------------------------------------------------
    net = net_factory()
    net.init()
    device = net.device
    batch = net._batch(ds)
    state = [net.params, net.updater_state, net.net_state, 0]

    def plain_dispatch():
        (state[0], state[1], state[2], score, _, _) = net._train_step(
            state[0], state[1], state[2],
            lambda p, s: net._loss_fn(p, s, *batch, net._rng, True),
            state[3])
        state[3] += 1
        return score

    def timed(dispatch) -> float:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(pipeline * steps):
            dispatch()
        _sync(device)
        return time.perf_counter() - t0

    plain_dispatch()
    plain = min(timed(plain_dispatch) for _ in range(trials)) / (
        pipeline * steps)

    # --- the wrapper's round at workers=1 ---------------------------------
    net2 = net_factory()
    net2.init()
    pw = ParallelWrapper(net2, workers=1, averaging_frequency=1,
                         devices=[net2.device])
    staged = pw._stage_round([ds])

    def pw_dispatch():
        pw._dispatch_round(staged)

    pw_dispatch()
    wrapped = min(timed(pw_dispatch) for _ in range(trials)) / (
        pipeline * steps)
    return {"plain_step_ms": round(plain * 1e3, 4),
            "wrapper_step_ms": round(wrapped * 1e3, 4),
            "overhead_ms": round((wrapped - plain) * 1e3, 4),
            "overhead_ratio": round(wrapped / plain, 4),
            "batch": batch_size, "device": str(device)}
