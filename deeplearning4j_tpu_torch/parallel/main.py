"""The port's launcher: the ParallelWrapper CLI, the pod worker and its
launcher, and the serving-fleet worker (port of
``deeplearning4j_tpu/parallel/main.py``).

- ParallelWrapper CLI (reference ``ParallelWrapperMain.java``):
  ``python -m deeplearning4j_tpu_torch.parallel.main --model-path m.zip
  --iterator-factory mypkg.data:make_iterator --workers 4 [--devices
  cuda:0,cuda:0,cuda:0,cuda:0]`` loads a model zip, fits it through a
  ``ParallelWrapper`` from a ``module:callable`` iterator factory and
  optionally saves it and streams stats to a remote UI.
- Pod worker: ``--pod-worker --coordinator host:port --num-processes K
  --process-id i --data D --zero Z --mode dp|zero --steps N --device
  cuda|cpu`` (or the ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/
  ``PROCESS_ID`` env contract) joins the pod's ``torch.distributed``
  group (NCCL on ``cuda``, the default, with no CPU fallback; gloo on
  ``cpu``), trains the seed-deterministic pod scenario (:func:`build_pod_net`,
  :func:`make_pod_batches`), writes sharded pod checkpoints, resumes from
  the newest with ``--resume auto``, and prints one JSON report line:
  per-step fp32 scores and the SHA-256 of the final params.
- Pod launcher: ``--spawn-local K`` starts K pod workers on this machine
  (:func:`run_pod`, with coordinator-port retry and a mid-run SIGKILL and
  relaunch-with-resume through ``die_at``).  Its workers always form a
  process group, a group of one at K=1, so the 1-process run goes
  through the same backend as the K-process one.
- ``--fleet-worker`` runs one serving-fleet worker
  (:func:`~deeplearning4j_tpu_torch.serving.fleet.fleet_worker_main`).

The scenario is seed-deterministic in data and model, so a K-process pod
trains bit-identical (per-step scores, param SHA-256) to the 1-process
run of the same mesh shape.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import subprocess
import sys
import time
import zipfile
from typing import Any, Dict, List, Optional, Sequence


def _resolve_factory(spec: str):
    module, sep, attr = spec.partition(":")
    if not sep:
        raise ValueError(
            f"iterator factory must be 'module:callable', got {spec!r}")
    return getattr(importlib.import_module(module), attr)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.parallel.main",
        description="Data-parallel training (ParallelWrapperMain)")
    p.add_argument("--model-path", required=True,
                   help="serialized model zip (ModelSerializer format)")
    p.add_argument("--iterator-factory", required=True,
                   help="module:callable returning a DataSetIterator")
    p.add_argument("--workers", type=int, default=None,
                   help="worker replicas (default: one a device)")
    p.add_argument("--devices", default=None,
                   help="comma-separated devices, one a worker (default: "
                        "every visible card; e.g. cuda:0,cuda:0)")
    p.add_argument("--device", default=None,
                   help="device the model loads onto (default: the card)")
    p.add_argument("--averaging-frequency", type=int, default=1)
    p.add_argument("--average-updaters", action="store_true", default=True)
    p.add_argument("--no-average-updaters", dest="average_updaters",
                   action="store_false")
    p.add_argument("--prefetch-size", type=int, default=2)
    p.add_argument("--report-score", action="store_true")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--model-output-path", default=None,
                   help="save the trained model here")
    p.add_argument("--ui-url", default=None,
                   help="remote UIServer base url to stream stats to")
    return p


def load_model(path: str, device=None):
    """A model zip as a ``MultiLayerNetwork`` or a ``ComputationGraph``,
    by what its configuration describes."""
    from ..utils import model_serializer as ms
    with zipfile.ZipFile(path) as zf:
        conf = json.loads(zf.read(ms.CONFIG_JSON))
    if "network_inputs" in conf or "vertices" in conf:
        return ms.restore_computation_graph(path, device=device)
    return ms.restore_multi_layer_network(path, device=device)


# ======================================================================
# Pod mode: the deterministic DP / DP x ZeRO scenario over the mesh
# ======================================================================

N_IN = 4
N_CLASSES = 3


def build_pod_net(seed: int = 11, lr: float = 0.05, device=None):
    """The pod model (4-16-3, tanh, adam: the updater carries moments, so
    the zero axis has real bytes to shard)."""
    from ..nn.conf import inputs
    from ..nn.conf.neural_net_configuration import NeuralNetConfiguration
    from ..nn.layers.core import DenseLayer, OutputLayer
    from ..nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder()
            .seed(seed).updater("adam").learning_rate(lr)
            .activation("tanh").weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=N_CLASSES))
            .set_input_type(inputs.feed_forward(N_IN))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def make_pod_batches(step: int, workers: int, batch: int,
                     data_seed: int) -> List:
    """The global batch of one pod step, split into ``workers``
    per-replica DataSets, seeded by ``(data_seed, step)`` only: every
    process (and the JAX package) makes the identical global batch."""
    import numpy as np
    from ..datasets.dataset import DataSet

    rng = np.random.RandomState(data_seed + step)
    X = rng.randn(workers * batch, N_IN).astype(np.float32)
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0).astype(int)
    Y = np.eye(N_CLASSES, dtype=np.float32)[y]
    return [DataSet(X[i * batch:(i + 1) * batch],
                    Y[i * batch:(i + 1) * batch])
            for i in range(workers)]


def param_sha(net) -> str:
    """SHA-256 of the float32 flat params (the pod's parity stamp)."""
    import numpy as np
    flat = np.asarray(net.get_flat_params(), "<f4")
    return hashlib.sha256(flat.tobytes()).hexdigest()


def pod_worker_main(argv: Optional[Sequence[str]] = None) -> int:
    """One pod process: join the mesh, train the scenario (resuming from
    the newest pod checkpoint with ``--resume auto``), print one JSON
    report line."""
    import numpy as np

    ap = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.parallel.main (pod worker)")
    ap.add_argument("--pod-worker", action="store_true")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (flags > env; see "
                         "parallel.mesh)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:<local rank>, NCCL) or cpu (gloo)")
    ap.add_argument("--data", type=int, default=None,
                    help="data axis degree (default: fills the pod)")
    ap.add_argument("--zero", type=int, default=1)
    ap.add_argument("--mode", choices=("dp", "zero"), default="dp")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16,
                    help="per-replica batch size")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--data-seed", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="pod-checkpoint every N steps (0: off)")
    ap.add_argument("--resume", choices=("none", "auto"), default="none")
    ap.add_argument("--measure-collectives", action="store_true")
    args = ap.parse_args(argv)

    if args.device.startswith("cuda"):
        # bitwise K-vs-1 parity needs the deterministic kernels, set
        # before the first CUDA call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    torch.use_deterministic_algorithms(True)
    from ..resilience import checkpoint as _ckpt
    from ..resilience import faults as _faults
    from .mesh import MeshRuntime
    from .parallel_wrapper import ParallelWrapper
    from .zero import ZeroShardedParallelWrapper

    runtime = MeshRuntime(data=args.data, zero=args.zero,
                          coordinator=args.coordinator,
                          num_processes=args.num_processes,
                          process_id=args.process_id, device=args.device,
                          group_of_one=True)
    device = runtime.devices[0]
    net = build_pod_net(seed=args.seed, lr=args.lr, device=device)
    if args.mode == "zero":
        wrapper = ZeroShardedParallelWrapper(net, runtime=runtime)
        state_axis = "zero"
    else:
        wrapper = ParallelWrapper(net, runtime=runtime, prefetch_size=0,
                                  averaging_frequency=1)
        state_axis = "data"
    w = runtime.dp_degree

    def ustate():
        return (wrapper.state_tree() if args.mode == "zero"
                else wrapper.worker_state())

    # ---- resume ---------------------------------------------------------
    start_step = 0
    scores: List[float] = []
    resumed_from = None
    if args.resume == "auto" and args.checkpoint_dir:
        restored = _ckpt.pod_restore(
            runtime, args.checkpoint_dir,
            {"params": net.params, "ustate": ustate()})
        if restored is not None:
            trees, manifest = restored
            from .mesh import tree_to
            net.params = tree_to(trees["params"], device)
            if args.mode == "zero":
                wrapper.load_state(trees["ustate"])
            else:
                wrapper.load_worker_state(trees["ustate"])
            extra = manifest["extra"]
            net.iteration = int(extra["iteration"])
            start_step = int(extra["next_step"])
            scores = [float(s) for s in extra["scores"]]
            resumed_from = manifest["step"]

    # ---- train ----------------------------------------------------------
    t0 = time.perf_counter()
    ustate_bytes = 0
    for step in range(start_step, args.steps):
        _faults.maybe_die(step)
        wrapper.fit(make_pod_batches(step, w, args.batch, args.data_seed))
        scores.append(float(np.float32(float(net._score))))
        ustate_bytes = runtime.publish_state_bytes(ustate(),
                                                   axis=state_axis)
        if (args.checkpoint_dir and args.checkpoint_every
                and (step + 1) % args.checkpoint_every == 0):
            _ckpt.pod_save(
                runtime, args.checkpoint_dir, step + 1,
                {"params": net.params, "ustate": ustate()},
                extra={"next_step": step + 1,
                       "iteration": int(net.iteration),
                       "scores": scores, "mode": args.mode})
            _ckpt.prune_pod_checkpoints(runtime, args.checkpoint_dir)
    elapsed = time.perf_counter() - t0

    report: Dict[str, Any] = {
        "process_id": runtime.process_index,
        "num_processes": runtime.process_count,
        "topology": runtime.topology(),
        "device": str(device),
        "backend": (torch.distributed.get_backend()
                    if torch.distributed.is_initialized() else None),
        "mode": args.mode,
        "steps": args.steps,
        "start_step": start_step,
        "resumed_from": resumed_from,
        "scores": scores,
        "param_sha": param_sha(net),
        "updater_state_bytes": int(ustate_bytes),
        "elapsed_s": round(elapsed, 3),
    }
    if args.measure_collectives:
        report["collectives"] = {
            k: v for k, v in runtime.measure_collectives().items()}
    runtime.barrier("pod_done")
    print(json.dumps(report), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


# ------------------------------------------------------- pod launcher

def _spawn_pod_worker(rank: int, k: int, port: int, *,
                      data: int, zero: int, mode: str, steps: int,
                      batch: int, seed: int, data_seed: int, device: str,
                      checkpoint_dir: Optional[str],
                      checkpoint_every: int, resume: str,
                      die_at: Optional[tuple],
                      measure_collectives: bool) -> subprocess.Popen:
    from ..resilience import faults as _faults
    env = dict(os.environ)
    for key in list(env):
        if key.startswith(_faults.ENV_PREFIX):
            del env[key]
    if die_at is not None and die_at[0] == rank:
        env[_faults.ENV_PREFIX + "DIE_AT_STEP"] = str(die_at[1])
    env["LOCAL_RANK"] = str(rank)
    env["LOCAL_WORLD_SIZE"] = str(k)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.main",
           "--pod-worker", "--device", device,
           "--data", str(data), "--zero", str(zero),
           "--mode", mode, "--steps", str(steps), "--batch", str(batch),
           "--seed", str(seed), "--data-seed", str(data_seed),
           "--resume", resume,
           "--coordinator", f"127.0.0.1:{port}",
           "--num-processes", str(k), "--process-id", str(rank)]
    if checkpoint_dir:
        cmd += ["--checkpoint-dir", checkpoint_dir,
                "--checkpoint-every", str(checkpoint_every)]
    if measure_collectives:
        cmd += ["--measure-collectives"]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def run_pod(k: int = 2, data: Optional[int] = None, zero: int = 1,
            mode: str = "dp", steps: int = 8, batch: int = 16,
            seed: int = 11, data_seed: int = 100, device: str = "cuda",
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 0, resume: str = "none",
            die_at: Optional[tuple] = None, relaunch: bool = False,
            measure_collectives: bool = False,
            timeout: float = 420.0) -> Dict[str, Any]:
    """Start a K-process pod on this machine (each process on ``device``:
    ``cuda:<rank>`` over NCCL, or the CPU over gloo) and collect the
    per-process JSON reports.  Every worker is reaped before it returns.

    ``die_at=(rank, step)`` arms ``DL4J_TPU_FAULT_DIE_AT_STEP`` in one
    worker: it is SIGKILLed entering ``step``, the survivors fail or hang
    in the next collective, and ``run_pod`` kills them.  With
    ``relaunch=True`` the pod is then relaunched on a fresh coordinator
    port with ``--resume auto`` (under ``result["resumed"]``)."""
    from .mesh import is_port_clash, retry_on_port_clash

    def launch(port: int):
        procs = [_spawn_pod_worker(
            r, k, port, data=data or k, zero=zero, mode=mode,
            steps=steps, batch=batch, seed=seed, data_seed=data_seed,
            device=device, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume,
            die_at=die_at, measure_collectives=measure_collectives)
            for r in range(k)]
        outs: List[tuple] = [None] * k
        try:
            if die_at is not None:
                victim = procs[die_at[0]]
                try:
                    outs[die_at[0]] = victim.communicate(timeout=timeout)
                except subprocess.TimeoutExpired:
                    victim.kill()
                    outs[die_at[0]] = victim.communicate()
                grace = time.monotonic() + 10.0
                for r, p in enumerate(procs):
                    if r == die_at[0]:
                        continue
                    while p.poll() is None and time.monotonic() < grace:
                        time.sleep(0.1)
                    if p.poll() is None:
                        p.kill()
                    outs[r] = p.communicate()
            else:
                for r, p in enumerate(procs):
                    try:
                        outs[r] = p.communicate(timeout=timeout)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        outs[r] = p.communicate()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        rcs = [p.returncode for p in procs]
        if any(is_port_clash((o or "") + (e or ""))
               for (o, e), rc in zip(outs, rcs) if rc != 0):
            return False, outs
        return True, (procs, outs, rcs)

    procs, outs, rcs = retry_on_port_clash(launch)
    reports: List[Optional[Dict[str, Any]]] = []
    for (out, err), rc in zip(outs, rcs):
        line = out.strip().splitlines()[-1] if out and out.strip() else ""
        if rc == 0 and line:
            reports.append(json.loads(line))
        elif rc == 0:
            raise RuntimeError(
                f"pod worker exited 0 without a report: {err[-2000:]}")
        else:
            reports.append(None)
    result: Dict[str, Any] = {
        "k": k, "data": data or k, "zero": zero, "mode": mode,
        "steps": steps, "batch": batch, "device": device,
        "returncodes": rcs, "reports": reports,
        "pids": [p.pid for p in procs],
        "reaped": all(p.poll() is not None for p in procs),
        "killed": die_at is not None,
        "stderr_tail": [(e or "")[-2000:] for _, e in outs],
    }
    live = [r for r in reports if r]
    if live:
        result["scores"] = live[0]["scores"]
        result["param_sha"] = live[0]["param_sha"]
        result["updater_state_bytes"] = max(
            r["updater_state_bytes"] for r in live)
    if die_at is not None and relaunch:
        result["resumed"] = run_pod(
            k=k, data=data, zero=zero, mode=mode, steps=steps,
            batch=batch, seed=seed, data_seed=data_seed, device=device,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume="auto",
            die_at=None, measure_collectives=measure_collectives,
            timeout=timeout)
    return result


def pod_driver_main(argv: Sequence[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.parallel.main (pod launcher)")
    ap.add_argument("--spawn-local", type=int, metavar="K", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", type=int, default=None)
    ap.add_argument("--zero", type=int, default=1)
    ap.add_argument("--mode", choices=("dp", "zero"), default="dp")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--data-seed", type=int, default=100)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", choices=("none", "auto"), default="none")
    ap.add_argument("--measure-collectives", action="store_true")
    args = ap.parse_args(argv)
    result = run_pod(k=args.spawn_local, data=args.data, zero=args.zero,
                     mode=args.mode, steps=args.steps, batch=args.batch,
                     seed=args.seed, data_seed=args.data_seed,
                     device=args.device,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every,
                     resume=args.resume,
                     measure_collectives=args.measure_collectives)
    print(json.dumps(result, indent=2))
    return 0 if all(rc == 0 for rc in result["returncodes"]) else 1


def main(argv: Optional[Sequence[str]] = None):
    argv_list = list(sys.argv[1:] if argv is None else argv)
    if "--spawn-local" in argv_list:
        return pod_driver_main(argv_list)
    if "--pod-worker" in argv_list or "--coordinator" in argv_list:
        return pod_worker_main(argv_list)
    if "--fleet-worker" in argv_list:
        from ..serving.fleet import fleet_worker_main
        return fleet_worker_main(argv_list)

    from ..utils import model_serializer
    from .parallel_wrapper import ParallelWrapper

    args = build_parser().parse_args(argv_list)
    net = load_model(args.model_path, device=args.device)
    iterator = _resolve_factory(args.iterator_factory)()
    devices = args.devices.split(",") if args.devices else None
    pw = ParallelWrapper(net, workers=args.workers,
                         averaging_frequency=args.averaging_frequency,
                         average_updaters=args.average_updaters,
                         report_score=args.report_score,
                         prefetch_size=args.prefetch_size, devices=devices)
    if args.ui_url:
        from ..ui import StatsListener
        from ..ui.server import RemoteStatsStorageRouter
        pw.set_listeners(StatsListener(RemoteStatsStorageRouter(
            args.ui_url)))
    pw.fit(iterator, epochs=args.epochs)
    if args.model_output_path:
        model_serializer.write_model(net, args.model_output_path)
    return net


if __name__ == "__main__":
    out = main()
    sys.exit(out if isinstance(out, int) else 0)
