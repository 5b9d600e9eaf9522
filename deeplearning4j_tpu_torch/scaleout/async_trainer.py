"""K-OS-process asynchronous Hogwild training against the TCP
parameter server (port of ``deeplearning4j_tpu/scaleout/async_trainer.py``):
the Aeron media driver + workers in separate processes, run at K > 1.

The launcher (:func:`run_async`) owns the store + TCP front-end and
spawns K **OS processes** (``python -m
deeplearning4j_tpu_torch.scaleout.async_trainer --worker ...``), each of
which rebuilds the same small model deterministically from its seed,
trains on its own i.i.d. data shard, and pushes compressed deltas over
the negotiated wire (``compression.py``): staleness-bounded pulls —
a worker keeps training on its local replica and re-pulls the
consolidated parameters only when the push-ack version says it has
fallen more than ``staleness_bound`` versions behind.

:func:`run_sync_dp` is the synchronous data-parallel baseline the
TensorFlow system paper (PAPERS.md) says async should beat under
stragglers: K barriered workers, parameter averaging every round —
with one seeded straggler (``DL4J_TPU_FAULT_SLOW_WORKER_MS=rank:ms``)
every round collapses to the straggler's pace, while the async run
only loses the straggler's own contribution.

Fault points ride ``resilience/faults.py``: the launcher arms
``DL4J_TPU_FAULT_DIE_AT_STEP`` in one worker's environment to SIGKILL
it mid-run (the survives-a-worker-kill criterion) and
``DL4J_TPU_FAULT_SLOW_WORKER_MS=rank:ms`` in every worker's
environment to make exactly one of them straggle.

Devices: a worker takes ``--device`` (default ``cuda``; no CPU fallback,
the CPU only when asked) and trains its replica there, each worker its
own process and CUDA context on one card; ``run_async`` and
``run_sync_dp`` take ``device`` (None: the card, through
``device.resolve_device``) and pass it on.  The JAX package's workers
train on the CPU (its launcher sets ``JAX_PLATFORMS=cpu``).  A worker's
report carries ``ready_s``, the seconds from its spawn to the end of its
warm-up step.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import monitor as _monitor
from ..device import DeviceLike, resolve_device
from ..resilience import faults as _faults

N_IN = 4
N_CLASSES = 3

#: lock-shard / wire-chunk size for the scenario's small tier-1 model —
#: deliberately far below DEFAULT_CHUNK_SIZE so K pushes actually
#: exercise disjoint-chunk concurrency
SCENARIO_CHUNK_SIZE = 64


def build_net(seed: int = 11, lr: float = 0.3, device: DeviceLike = None):
    """Deterministic small model (4-16-3, sgd) on ``device`` (None: the
    card): every process rebuilding with the same seed holds bit-identical
    initial parameters, so no weight broadcast crosses the wire."""
    from ..nn.conf import inputs
    from ..nn.conf.neural_net_configuration import NeuralNetConfiguration
    from ..nn.layers.core import DenseLayer, OutputLayer
    from ..nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder()
            .seed(seed).updater("sgd").learning_rate(lr)
            .activation("tanh").weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=N_CLASSES))
            .set_input_type(inputs.feed_forward(N_IN))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def make_batches(n_batches: int, batch: int, seed: int):
    """Deterministic synthetic 3-class task (learnable to ~0.85+):
    ``y = (x0 > 0) + (x1 > 0)`` over standard-normal features."""
    from ..datasets.dataset import DataSet

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        X = rng.randn(batch, N_IN).astype(np.float32)
        y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0).astype(int)
        out.append(DataSet(X, np.eye(N_CLASSES, dtype=np.float32)[y]))
    return out


def eval_accuracy(net, n: int = 1024, seed: int = 99) -> float:
    rng = np.random.RandomState(seed)
    X = rng.randn(n, N_IN).astype(np.float32)
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0).astype(int)
    return float(np.mean(net.predict(X).cpu().numpy() == y))


# ------------------------------------------------------------ worker


def worker_main(argv: Optional[List[str]] = None) -> int:
    """One Hogwild worker process.  Prints exactly one JSON line on
    stdout when done; the launcher parses it."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--host", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--codec", default="")
    ap.add_argument("--staleness-bound", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--duration", type=float, default=0.0,
                    help="time-boxed mode: train until this many "
                    "seconds after warmup (rounds becomes a cap of 10x)")
    ap.add_argument("--batches-per-push", type=int, default=2)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--data-seed", type=int, default=100)
    ap.add_argument("--trace-out", default="",
                    help="write this process's span ring as a "
                    "trace-dump JSON file on exit")
    ap.add_argument("--device", default="cuda",
                    help="where the replica trains (cuda or cpu; no "
                    "fallback)")
    ap.add_argument("--spawn-ts", type=float, default=None,
                    help="the launcher's wall clock at spawn (for ready_s)")
    args = ap.parse_args(argv)

    from .param_server import TcpParameterServerClient

    coded = args.codec not in ("", "f64", "raw")
    device = resolve_device(args.device)
    net = build_net(seed=args.seed, device=device)
    batches = make_batches(max(args.rounds * args.batches_per_push, 8),
                           args.batch, args.data_seed + args.rank)
    client = TcpParameterServerClient(
        args.host, args.port, codec=args.codec if coded else None)

    with _monitor.span("async_worker/run", rank=args.rank,
                       codec=args.codec or "f64"):
        params = client.pull_coded() if coded else client.pull()
        net.set_flat_params(params)
        net._fit_batch(batches[0])       # warm-up step, uncounted
        net.set_flat_params(params)
        net.score()                      # the warm-up's work is done
        ready_s = (time.time() - args.spawn_ts
                   if args.spawn_ts else None)

        t0 = time.perf_counter()
        deadline = t0 + args.duration if args.duration > 0 else None
        max_rounds = (args.rounds if deadline is None
                      else args.rounds * 10)
        rounds_done = samples = pulls = 0
        staleness_max = 0
        b = 0
        for r in range(max_rounds):
            if deadline is not None and time.perf_counter() >= deadline:
                break
            _faults.maybe_die(r)         # the preemption simulator
            _faults.slow_worker(args.rank)
            start = net.get_flat_params()
            for _ in range(args.batches_per_push):
                net._fit_batch(batches[b % len(batches)])
                b += 1
                samples += args.batch
            delta = net.get_flat_params() - start
            if coded:
                client.push_delta(delta)
                staleness_max = max(staleness_max, client.staleness())
                if client.staleness() > args.staleness_bound:
                    net.set_flat_params(client.pull_coded())
                    pulls += 1
            else:
                client.push(delta)
                net.set_flat_params(client.pull())
                pulls += 1
            rounds_done += 1
        elapsed = time.perf_counter() - t0

    if args.trace_out:
        with open(args.trace_out, "w") as fh:
            json.dump({"pid": os.getpid(),
                       "events": _monitor.tracer().events()}, fh,
                      default=str)
    client.close()
    print(json.dumps({
        "rank": args.rank, "rounds": rounds_done, "samples": samples,
        "pulls": pulls, "staleness_max": staleness_max,
        "loop_elapsed_s": round(elapsed, 4), "device": str(device),
        "ready_s": None if ready_s is None else round(ready_s, 3),
    }), flush=True)
    return 0


# ------------------------------------------------------------ launcher


def _wire_bytes_total() -> float:
    snap = _monitor.counter(
        "scaleout_wire_bytes_total",
        "parameter-server wire bytes by direction and codec").snapshot()
    return float(sum(snap["values"].values()))


def _spawn_worker(host: str, port: int, rank: int, *, codec: str,
                  staleness_bound: int, rounds: int, duration: float,
                  batches_per_push: int, batch: int, seed: int,
                  data_seed: int, straggler: Optional[Tuple[int, float]],
                  die_at_round: Optional[Tuple[int, int]],
                  trace_dir: Optional[str],
                  device: torch.device) -> subprocess.Popen:
    env = dict(os.environ)
    for key in list(env):
        if key.startswith(_faults.ENV_PREFIX):
            del env[key]
    if straggler is not None:
        # every worker shares the same targeted spec; only the matching
        # rank sleeps (resilience/faults.py)
        env[_faults.ENV_PREFIX + "SLOW_WORKER_MS"] = (
            f"{straggler[0]}:{straggler[1]}")
    if die_at_round is not None and die_at_round[0] == rank:
        env[_faults.ENV_PREFIX + "DIE_AT_STEP"] = str(die_at_round[1])
    cmd = [sys.executable, "-m",
           "deeplearning4j_tpu_torch.scaleout.async_trainer", "--worker",
           "--host", host, "--port", str(port), "--rank", str(rank),
           "--codec", codec or "", "--staleness-bound",
           str(staleness_bound), "--rounds", str(rounds),
           "--duration", str(duration), "--batches-per-push",
           str(batches_per_push), "--batch", str(batch),
           "--seed", str(seed), "--data-seed", str(data_seed),
           "--device", str(device), "--spawn-ts", repr(time.time())]
    if trace_dir:
        cmd += ["--trace-out",
                os.path.join(trace_dir, f"worker{rank}.trace.json")]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def run_async(k: int = 3, codec: str = "topk8", rounds: int = 20,
              duration: float = 0.0, batches_per_push: int = 2,
              batch: int = 32, staleness_bound: Optional[int] = None,
              seed: int = 11, data_seed: int = 100,
              chunk_size: int = SCENARIO_CHUNK_SIZE,
              straggler: Optional[Tuple[int, float]] = None,
              die_at_round: Optional[Tuple[int, int]] = None,
              trace_dir: Optional[str] = None,
              timeout: float = 300.0, device: DeviceLike = None) -> Dict:
    """K-subprocess Hogwild run; returns the scenario record (final
    accuracy from the consolidated server parameters, throughput over
    surviving workers, per-run wire bytes from the server-side
    counters).

    ``straggler=(rank, ms)`` arms the targeted straggler fault in every
    worker; ``die_at_round=(rank, round)`` SIGKILLs one worker mid-run
    (the preemption simulator) — the run must survive it.  The launcher's
    copy of the model (the store's init, the final accuracy) and every
    worker live on ``device`` (None: the card).  Every worker is reaped
    before this returns, the killed one included.
    """
    from .param_server import ParameterServer, TcpParameterServer

    device = resolve_device(device)
    if staleness_bound is None:
        staleness_bound = 2 * k   # ~one pull every two rounds at K pushes
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    net = build_net(seed=seed, device=device)
    store = ParameterServer(net.get_flat_params(),
                            update_scale=1.0 / k, chunk_size=chunk_size)
    srv = TcpParameterServer(store)
    wire0 = _wire_bytes_total()
    t0 = time.perf_counter()
    procs = [_spawn_worker(srv.host, srv.port, r, codec=codec,
                           staleness_bound=staleness_bound,
                           rounds=rounds, duration=duration,
                           batches_per_push=batches_per_push,
                           batch=batch, seed=seed, data_seed=data_seed,
                           straggler=straggler,
                           die_at_round=die_at_round,
                           trace_dir=trace_dir, device=device)
             for r in range(k)]
    workers: List[Dict] = []
    returncodes: List[int] = []
    errors: Dict[int, str] = {}
    try:
        for rank, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            returncodes.append(p.returncode)
            line = out.strip().splitlines()[-1] if out.strip() else ""
            if p.returncode == 0 and line:
                workers.append(json.loads(line))
            elif p.returncode == 0:
                raise RuntimeError(
                    f"worker exited 0 without a report: {err[-2000:]}")
            else:
                errors[rank] = err[-2000:]
        wall = time.perf_counter() - t0
        net.set_flat_params(store.pull())
    finally:
        # reap every worker, whatever stopped the loop above
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        srv.close()

    samples = sum(w["samples"] for w in workers)
    loop_elapsed = max((w["loop_elapsed_s"] for w in workers),
                      default=0.0)
    if duration > 0:
        throughput = samples / duration
    else:
        throughput = samples / loop_elapsed if loop_elapsed else 0.0
    return {
        "mode": "async", "k": k, "codec": codec or "f64",
        "staleness_bound": staleness_bound,
        "rounds": rounds, "batch": batch,
        "batches_per_push": batches_per_push,
        "samples": samples, "wall_s": round(wall, 3),
        "samples_per_sec": round(throughput, 1),
        "accuracy": eval_accuracy(net),
        "pushes": store.pushes, "version": store.version,
        "wire_bytes": _wire_bytes_total() - wire0,
        "workers": workers, "returncodes": returncodes,
        "pids": [p.pid for p in procs], "device": str(device),
        "stderr_tails": errors,
        "survivors": len(workers),
        "staleness_max": max((w["staleness_max"] for w in workers),
                             default=0),
    }


def run_sync_dp(k: int = 3, rounds: int = 20, duration: float = 0.0,
                batches_per_push: int = 2, batch: int = 32,
                seed: int = 11, data_seed: int = 100,
                straggler: Optional[Tuple[int, float]] = None,
                device: DeviceLike = None) -> Dict:
    """Synchronous data-parallel baseline: K barriered workers,
    parameter averaging every round.  Same model, same per-worker data
    shards, same straggler fault point as :func:`run_async` — so the
    crossover measurement isolates ONE variable, the barrier.  The K
    replicas are threads of this process on ``device`` (None: the
    card)."""
    net = build_net(seed=seed, device=resolve_device(device))
    replicas = [net.clone() for _ in range(k)]
    shards = [make_batches(max(rounds * batches_per_push, 8), batch,
                           data_seed + r) for r in range(k)]
    if straggler is not None:
        _faults.configure(slow_worker_ms=straggler)
    try:
        global_params = net.get_flat_params()
        results = [None] * k

        def round_worker(rank: int, r: int, barrier: threading.Barrier):
            _faults.slow_worker(rank)
            replica = replicas[rank]
            replica.set_flat_params(global_params)
            for i in range(batches_per_push):
                replica._fit_batch(
                    shards[rank][(r * batches_per_push + i)
                                 % len(shards[rank])])
            results[rank] = replica.get_flat_params()
            barrier.wait()

        def one_round(r: int) -> None:
            nonlocal global_params
            barrier = threading.Barrier(k + 1)
            threads = [threading.Thread(target=round_worker,
                                        args=(rank, r, barrier),
                                        daemon=True)
                       for rank in range(k)]
            for t in threads:
                t.start()
            barrier.wait()           # the sync-DP barrier itself
            for t in threads:
                t.join()
            global_params = np.mean(results, axis=0)

        # a warm-up step outside the timed region (same treatment the
        # async workers give themselves)
        warm = net.clone()
        warm.set_flat_params(global_params)
        warm._fit_batch(shards[0][0])

        t0 = time.perf_counter()
        deadline = t0 + duration if duration > 0 else None
        max_rounds = rounds if deadline is None else rounds * 10
        rounds_done = samples = 0
        for r in range(max_rounds):
            if deadline is not None and time.perf_counter() >= deadline:
                break
            one_round(r)
            rounds_done += 1
            samples += k * batches_per_push * batch
        elapsed = time.perf_counter() - t0
    finally:
        if straggler is not None:
            _faults.reset()

    net.set_flat_params(global_params)
    throughput = (samples / duration if duration > 0
                  else (samples / elapsed if elapsed else 0.0))
    return {
        "mode": "sync_dp", "k": k, "rounds": rounds_done,
        "batch": batch, "batches_per_push": batches_per_push,
        "samples": samples, "wall_s": round(elapsed, 3),
        "samples_per_sec": round(throughput, 1),
        "accuracy": eval_accuracy(net),
    }


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--worker" in argv:
        return worker_main(argv)
    print("usage: python -m deeplearning4j_tpu_torch.scaleout.async_trainer "
          "--worker ... (workers are spawned by run_async)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
