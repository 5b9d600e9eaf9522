"""Serving traffic: an open-loop stream of image requests into the
program's ``InferenceEngine``.

The schedule is made before the window from the seed.  Every seed gets
the same multiset of request sizes and of gaps between arrivals, in its
own order within blocks of a few tenths of a second: sizes in the counts
the mix's weights give, gaps the quantiles of an exponential
distribution at the offered rate (a Poisson stream).  Each request carries ``k`` float32 images, a slice of a pool
made from the seed before the window.  The generator never blocks: a
request the engine refuses fails.  Each request is timed from when it
was due to when its result is back on the host, so a stall delays the
requests behind it too; one that fails or never comes counts as
infinitely late.  After the window the answers of a seeded sample of
requests, the largest among them, are compared with the plain
reference's.

Traffic keys: ``rate_images_per_s``, ``sizes`` and ``weights``,
``block_requests`` (the fewest requests a block holds; by default the
fewest in which every size comes in its share), ``pool_images``, ``calibration_images``, ``check_rows``, ``engine`` (the
engine's keyword arguments), ``warm_seconds`` (the same traffic sent in
set-up), ``trace_seconds``.
"""

from __future__ import annotations

import gc
import math
import threading
import time

import numpy as np
import torch

from perfbench import inputs, program
from perfbench.reference import ops, train as ref_train

#: how long after the window closes answers are still waited for
GRACE_S = 60.0


def block_size(weights, largest: int = 100) -> int:
    """The fewest requests in which every size comes in the exact share
    its weight gives (at most ``largest``)."""
    for n in range(1, largest + 1):
        if all(abs(w * n - round(w * n)) < 1e-9 for w in weights):
            return n
    return largest


def schedule(traffic, seed: int, seconds: float):
    """(due seconds from the window's start, images, pool offset) of
    every request of a window.  The window is made of blocks, each with
    the sizes in their exact shares and the gaps the quantiles of the
    exponential distribution at the offered rate, in the seed's order
    inside each block: every seed offers the same work, and no seed
    crowds more large requests into one stretch than a block holds."""
    sizes = np.asarray(traffic["sizes"], dtype=np.int64)
    weights = np.asarray(traffic["weights"], dtype=np.float64)
    weights = weights / weights.sum()
    req_rate = traffic["rate_images_per_s"] / float(sizes @ weights)
    unit = block_size(weights)
    block = unit * max(1, -(-int(traffic.get("block_requests", unit))
                             // unit))
    per = np.round(weights * block).astype(np.int64)
    per[np.argmax(weights)] += block - per.sum()
    base_sizes = np.repeat(sizes, per)
    q = (np.arange(block) + 0.5) / block
    base_gaps = -np.log1p(-q) / req_rate
    blocks = max(1, int(round(req_rate * seconds / block)))
    rng = np.random.default_rng(inputs.sub_seed(seed, "schedule"))
    ks = np.concatenate([rng.permutation(base_sizes) for _ in range(blocks)])
    gaps = np.concatenate([rng.permutation(base_gaps)
                           for _ in range(blocks)])
    gaps *= seconds / gaps.sum()   # the window holds every gap, the last
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    offsets = rng.integers(0, traffic["pool_images"] - ks + 1)
    return due, ks, offsets


def percentile(values, p: float) -> float:
    """The ``p``-th percentile (nearest rank) of ``values``."""
    v = sorted(values)
    return float(v[max(0, math.ceil(p / 100.0 * len(v)) - 1)])


def row_gaps(probs: np.ndarray, ref_logits: torch.Tensor) -> dict:
    """Per row, the served answer against the reference's: the
    log-probabilities, each row centred on its mean, over the spread
    (standard deviation) of the reference's row, as the largest gap of
    one class (``max``) and the root-mean-square gap (``rms``)."""
    z = torch.log(torch.from_numpy(np.asarray(probs, np.float64))
                  .clamp_min(1e-300))
    r = torch.log_softmax(ref_logits.double().cpu(), -1)
    z = z - z.mean(-1, keepdim=True)
    r = r - r.mean(-1, keepdim=True)
    sd = r.std(-1)
    return {"max": ((z - r).abs().amax(-1) / sd).tolist(),
            "rms": ((z - r).square().mean(-1).sqrt() / sd).tolist()}


def summarize_rows(rows: dict) -> dict:
    """The numbers compared over every sampled row."""
    if not rows["max"]:
        return {"logit_gap": float("inf"), "logit_rms_gap": float("inf")}
    return {"logit_gap": max(rows["max"]), "logit_rms_gap": max(rows["rms"])}


class Engine:
    """The program's engine over the configuration's network."""

    def __init__(self, ctx, weights, state):
        from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
        net = program.build(ctx.cfg, ctx.device)
        policy = net._pol().name
        if ctx.device.type == "cuda" and policy != ctx.cfg["precision"]:
            raise RuntimeError(f"the network runs {policy}, the "
                               f"configuration states "
                               f"{ctx.cfg['precision']}")
        program.load(net, weights, state)
        self.engine = InferenceEngine(net, **ctx.traffic["engine"]).start()
        cfg = ctx.cfg
        self.engine.warmup((cfg["height"], cfg["width"], cfg["channels"]))
        self.engine.end_warmup()

    def submit(self, x):
        return self.engine.predict_async(x, block=False)

    def stop(self):
        self.engine.stop()


def calibrated_state(ctx, weights):
    """Running statistics as a trained network holds them: the batch
    statistics of calibration images under the reference's forward."""
    cfg, model = ctx.cfg, ctx.model
    state = inputs.make_state(model.state_leaves(cfg), ctx.device,
                              cfg["precision"])
    if not state:
        return state
    ops.strict_fp32()
    u8 = inputs.make_images(ctx.traffic["calibration_images"], cfg,
                            ctx.seed, "calibration", ctx.device)
    stats = ref_train.batch_statistics(model, cfg, weights, state,
                                       inputs.decode(u8, ctx.device))
    return {k: inputs.rounded(v, cfg["precision"]) for k, v in stats.items()}


def prepare(ctx, engine_cls=Engine):
    """The engine, warmed on its ladder and on one request of each size,
    and the pool of images requests are cut from."""
    cfg, traffic, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    weights = inputs.make_weights(ctx.model.leaves(cfg), seed, dev,
                                  cfg["precision"])
    state = calibrated_state(ctx, weights)
    pool = inputs.decode(inputs.make_images(
        traffic["pool_images"], cfg, seed, "pool", dev), dev).cpu().numpy()
    server = engine_cls(ctx, weights, state)
    del weights, state
    for k in sorted(set(int(k) for k in traffic["sizes"])):
        server.submit(pool[:k]).result()
    return server, pool


class Tally:
    """What the window keeps of its requests: when each answer came (inf
    until it comes, and for one that fails) and the answers of the
    requests the check may sample (``keep``).  No future or request is
    held, so the heap the garbage collector walks does not grow with
    the window."""

    def __init__(self, n: int, keep=()):
        self.done = np.full(n, np.inf)
        self.keep = set(keep)
        self.answers = {}
        self.pending = 0
        self.cv = threading.Condition()

    def sent(self, i: int, fut) -> None:
        with self.cv:
            self.pending += 1
        fut.add_done_callback(lambda f, i=i: self.settle(i, f))

    def settle(self, i: int, fut) -> None:
        t = time.perf_counter()
        if fut.exception() is None:
            self.done[i] = t
            if i in self.keep:
                self.answers[i] = fut.result()
        with self.cv:
            self.pending -= 1
            self.cv.notify_all()

    def wait(self, deadline: float) -> None:
        with self.cv:
            self.cv.wait_for(lambda: self.pending == 0,
                             max(0.0, deadline - time.perf_counter()))


class GcClock:
    """Milliseconds spent in full (generation 2) collections while
    running."""

    def __init__(self):
        self.ms, self.count, self._t = 0.0, 0, None

    def __call__(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.ms += (time.perf_counter() - self._t) * 1e3
            self.count += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def settle_heap() -> None:
    """End set-up as a serving process ends its start-up: the heap
    collected, then frozen, so that a full collection in the window
    walks only what the window allocates.  Without it each full
    collection walks the whole heap of the interpreter, the libraries
    and the engine, some 0.1 s with every thread stopped, two to five
    times a window."""
    gc.collect()
    gc.freeze()


def drive(server, pool, due, ks, offs, seconds: float, profiler=None,
          trace_seconds: float = 0.0, on_stop=None, keep=()) -> dict:
    """Send every request when it is due and wait for the answers, up to
    ``GRACE_S`` past the window's close, keeping the answers of the
    requests in ``keep``.  With ``profiler`` (a ``trace.Profiler``), the
    last ``trace_seconds`` of the window are profiled; the profiler stops,
    and ``on_stop()`` is called (its result is returned as ``at_stop``),
    once the last request is sent, so that stopping it delays no send."""
    n = len(due)
    tally = Tally(n, keep)
    late = 0.0
    prof, prof_at, at_stop = None, None, None
    t_prof = seconds - trace_seconds
    t_start = time.perf_counter()
    with GcClock() as clock:
        for i in range(n):
            t_due = t_start + due[i]
            if profiler is not None and prof_at is None and due[i] >= t_prof:
                prof = profiler().__enter__()
                prof_at = [time.perf_counter(), None]
            wait = t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late = max(late, time.perf_counter() - t_due)
            try:
                fut = server.submit(pool[offs[i]:offs[i] + ks[i]])
            except Exception:          # refused: counts as infinitely late
                continue
            tally.sent(i, fut)
        if prof_at is not None:
            at_stop = on_stop() if on_stop else None
            prof.__exit__(None, None, None)
            prof_at[1] = time.perf_counter()
        t_close = t_start + seconds
        tally.wait(t_close + GRACE_S)
    done = tally.done.copy()
    lat_ms = (done - (t_start + due)) * 1e3
    fifths = np.minimum((due * 5 / seconds).astype(int), 4)
    return {"lat_ms": lat_ms, "done": done, "answers": dict(tally.answers),
            "late_ms": late * 1e3, "t_close": t_close, "prof": prof,
            "prof_at": prof_at, "at_stop": at_stop,
            "p95_ms": percentile(lat_ms, 95),
            "p95_by_fifth_ms": [percentile(lat_ms[fifths == f], 95)
                                for f in range(5) if np.any(fifths == f)],
            "gc_full_ms": clock.ms, "gc_full": clock.count,
            "images_per_s": float(ks[done <= t_close].sum())
            / max(seconds, 1e-9),
            "failed": int((~np.isfinite(lat_ms)).sum())}


def run(ctx, engine_cls=Engine) -> dict:
    traffic, dev, seed = ctx.traffic, ctx.device, ctx.seed
    due, ks, offs = schedule(traffic, seed, ctx.seconds)
    server, pool = prepare(ctx, engine_cls)
    # a stretch of the same traffic, answered before the window: the
    # engine's first seconds under traffic are slower than the rest
    if traffic["warm_seconds"] > 0:
        warm = schedule(traffic, inputs.sub_seed(seed, "warm"),
                        traffic["warm_seconds"])
        drive(server, pool, *warm, traffic["warm_seconds"])
    settle_heap()
    setup_s = time.perf_counter() - ctx.t0
    w = drive(server, pool, due, ks, offs, ctx.seconds,
              ctx.profiler if ctx.trace else None,
              traffic["trace_seconds"],
              on_stop=lambda: (server_spans("serve/queue_wait"),
                               server_spans("serve/batch")),
              keep=candidates(ks, seed, traffic["check_rows"]))
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    readings = {"requests": len(due), "images": int(ks.sum()),
                "generator_late_ms": float(w["late_ms"]),
                "p50_ms": percentile(w["lat_ms"], 50),
                "p95_ms": w["p95_ms"],
                "p99_ms": percentile(w["lat_ms"], 99),
                "p95_by_fifth_ms": w["p95_by_fifth_ms"],
                "gc_full": w["gc_full"], "gc_full_ms": w["gc_full_ms"],
                "forward_flops_per_image": ctx.model.forward_flops(ctx.cfg)}
    summary = None
    if w["prof_at"] is not None:
        a, b = w["prof_at"]
        summary = ctx.summarize(w["prof"], b - a)
        served = (w["done"] >= a) & (w["done"] <= b)
        readings["images_in_trace"] = int(ks[served].sum())
        # the spans recorded while the profiler ran, read as it stopped
        waits, batches = w["at_stop"]
        start = time.time() - (time.perf_counter() - a)
        readings["queue_wait_ms"] = [e["dur_ms"] for e in waits
                                     if e["ts"] >= start]
        readings["batch_rows"] = [e.get("attrs", {}).get("rows", 0)
                                  for e in batches if e["ts"] >= start]
        readings["max_batch_size"] = traffic["engine"]["max_batch_size"]
    server.stop()
    del server, w["prof"]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check_answers(ctx, pool, ks, offs, w["answers"],
                           np.isfinite(w["done"]), seed)
    return {
        "e2e": {"serve_p95_ms": w["p95_ms"],
                "serve_images_per_s": w["images_per_s"],
                "setup_s": setup_s},
        "attempted": len(due), "failed": w["failed"],
        "checks": checks, "peak_bytes": peak, "trace": summary,
        "readings": readings,
    }


def server_spans(name: str):
    from deeplearning4j_tpu_torch import monitor
    return monitor.tracer().events(name=name)


def _order(ks, seed: int):
    """The seeded order in which requests are drawn for the check."""
    rng = np.random.default_rng(inputs.sub_seed(seed, "check"))
    return rng.permutation(len(ks))


def sample(ks, seed: int, rows: int, answered):
    """A seeded sample of answered requests, up to ``rows`` images: the
    first largest in the seeded order, then the others in that order."""
    order = [int(i) for i in _order(ks, seed) if answered[i]]
    out, total = [], 0
    if order:
        top = max(ks[i] for i in order)
        first = next(i for i in order if ks[i] == top)
        order = [first] + [i for i in order if i != first]
    for i in order:
        if out and total + ks[i] > rows:
            continue
        out.append(i)
        total += ks[i]
    return out


def candidates(ks, seed: int, rows: int, largest: int = 8):
    """The requests whose answers the window keeps: those the check would
    draw first, twice ``rows`` images of them, and the first ``largest``
    of the largest size, so that a few failed requests still leave a
    full sample."""
    order = _order(ks, seed)
    top = int(np.max(ks)) if len(ks) else 0
    keep = [int(i) for i in order if ks[i] == top][:largest]
    total = 0
    for i in order:
        if total >= 2 * rows:
            break
        keep.append(int(i))
        total += int(ks[i])
    return keep


def check_answers(ctx, pool, ks, offs, answers: dict, answered, seed: int,
                  quant=None) -> dict:
    """Every request must be answered (``answered``); a sample of the
    answers (``answers``: index to answer) is held to the reference."""
    cfg, model, dev = ctx.cfg, ctx.model, ctx.device
    missing = int(len(ks) - np.sum(answered))
    picks = sample(ks, seed, ctx.traffic["check_rows"], answered)
    ops.strict_fp32()
    P = inputs.make_weights(model.leaves(cfg), seed, dev, cfg["precision"])
    S = calibrated_state(ctx, P)
    rows = {"max": [], "rms": []}
    if picks:
        x = np.concatenate([pool[offs[i]:offs[i] + ks[i]] for i in picks])
        ref = ref_train.logits(model, cfg, P, S,
                               torch.from_numpy(x).to(dev), quant)
        got = [np.asarray(answers.get(i, np.empty(0))) for i in picks]
        if any(g.shape != (ks[i], ref.shape[1])
               for g, i in zip(got, picks)):
            rows = {k: [float("inf")] for k in rows}
        else:
            rows = row_gaps(np.concatenate(got), ref)
    return {"missing_answers": float(missing), **summarize_rows(rows)}
