"""Kill/resume parity harness (port of
``deeplearning4j_tpu/resilience/chaos.py``): the executable proof that a
training run SIGKILLed mid-epoch and resumed from its last checkpoint
produces a per-step loss sequence bit-identical to the same run left
uninterrupted, on the epoch-cache path (on the card, the replays of
captured CUDA graphs).

The harness runs the same tiny-network training child three times (the
first two side by side):

1. *reference*: to completion, no faults;
2. *victim*: with ``DL4J_TPU_FAULT_DIE_AT_STEP`` armed, so the fault layer
   SIGKILLs the process mid-epoch, after a mid-epoch checkpoint exists
   (the fault point sits after the checkpoint hook, like a preemption
   notice arriving between steps);
3. *resume*: the same working directory with ``--resume``: restores the
   newest valid checkpoint and trains to the same total-epoch target.

Each child appends ``{"iteration": i, "score": s}`` JSONL per step (one
flushed line per step, so the victim's partial trace survives the
SIGKILL) and writes ``done.json`` with a SHA-256 of the final float32 flat
params.  Parity: every iteration 1..total is covered, the overlapping
iterations (steps the victim ran past its last checkpoint, run again by
the resume) agree bitwise, and the final param hashes match.

The child is ``python -m deeplearning4j_tpu_torch.resilience.chaos
--workdir DIR [--device cuda|cpu]`` (the card by default).  On the card
it sets ``CUBLAS_WORKSPACE_CONFIG`` and
``torch.use_deterministic_algorithms(True)`` before its first CUDA call:
otherwise cuBLAS may pick another reduction order in the resumed process,
and the scores differ for reasons that are not the harness's.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, Optional

from ..utils.fileio import atomic_write_json

SCORES_JSONL = "scores.jsonl"
DONE_JSON = "done.json"
CKPT_DIR = "checkpoints"

#: cuBLAS's setting for reproducible reductions under deterministic
#: algorithms
CUBLAS_WORKSPACE = ":4096:8"


def build_net(seed: int = 7, n_in: int = 6, n_classes: int = 3,
              device=None):
    """A deterministic small MultiLayerNetwork on ``device`` (the card
    unless ``"cpu"``)."""
    from ..nn.conf import inputs
    from ..nn.conf.neural_net_configuration import NeuralNetConfiguration
    from ..nn.layers.core import DenseLayer, OutputLayer
    from ..nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder()
            .seed(seed).updater("adam").learning_rate(0.05)
            .activation("tanh").weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=10))
            .layer(OutputLayer(n_out=n_classes))
            .set_input_type(inputs.feed_forward(n_in))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def build_iterator(n: int = 64, n_in: int = 6, n_classes: int = 3,
                   batch: int = 8, seed: int = 0):
    """A deterministic synthetic dataset the epoch cache takes (its
    shuffle order comes from the cache path's own permutation)."""
    import numpy as np

    from ..datasets.dataset import DataSet
    from ..datasets.iterators import ListDataSetIterator

    rng = np.random.RandomState(seed)
    X = rng.randn(n, n_in).astype(np.float32)
    y = np.eye(n_classes, dtype=np.float32)[rng.randint(0, n_classes, n)]
    return ListDataSetIterator(DataSet(X, y), batch, shuffle=True, seed=3)


class _ScoreTap:
    """Listener appending per-iteration scores as JSONL, one flushed line
    per step, so a SIGKILL loses nothing already replayed."""

    def __init__(self, path: str):
        self._fh = open(path, "a", buffering=1)

    def iteration_done(self, model, iteration: int) -> None:
        score = float(model._score) if model._score is not None else None
        self._fh.write(json.dumps({"iteration": int(iteration),
                                   "score": score}) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())


def _params_sha256(net) -> str:
    import numpy as np
    flat = np.asarray(net.get_flat_params(), "<f4")
    return hashlib.sha256(flat.tobytes()).hexdigest()


def deterministic_card() -> None:
    """Reproducible card reductions: cuBLAS's workspace setting and
    deterministic algorithms, set before the first CUDA call."""
    import torch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    torch.use_deterministic_algorithms(True)


def child_main(workdir: str, epochs: int, every_steps: int, resume: bool,
               device: Optional[str] = None) -> int:
    """The training child (its own process; the parent arms the die fault
    through the environment)."""
    if device != "cpu":
        deterministic_card()
    from .checkpoint import CheckpointManager

    net = build_net(device=device)
    it = build_iterator()
    net.set_listeners(_ScoreTap(os.path.join(workdir, SCORES_JSONL)))
    ckpt = CheckpointManager(os.path.join(workdir, CKPT_DIR),
                             every_steps=every_steps, keep_last=4)
    net.fit(it, epochs=epochs, checkpoint=ckpt,
            resume_from="auto" if resume else None)
    # atomic: the parent reads DONE_JSON of a child that may be killed at
    # any instant, and a torn marker would read as a torn run
    atomic_write_json(
        os.path.join(workdir, DONE_JSON),
        {"params_sha256": _params_sha256(net),
         "iteration": int(net.iteration),
         "epoch": int(net.epoch),
         "score": float(net.score()),
         "device": str(net.device)})
    return 0


def start_child(workdir: str, epochs: int, every_steps: int,
                resume: bool = False, die_at_step: Optional[int] = None,
                device: Optional[str] = None) -> subprocess.Popen:
    """Start the training child as a subprocess, the die fault armed
    through ``DL4J_TPU_FAULT_DIE_AT_STEP``."""
    env = dict(os.environ)
    # the package's parent directory, so the child imports this checkout
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    env.pop("DL4J_TPU_FAULT_DIE_AT_STEP", None)
    if die_at_step is not None:
        env["DL4J_TPU_FAULT_DIE_AT_STEP"] = str(die_at_step)
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.resilience.chaos",
           "--workdir", workdir, "--epochs", str(epochs),
           "--every-steps", str(every_steps)]
    if device is not None:
        cmd += ["--device", str(device)]
    if resume:
        cmd.append("--resume")
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def wait_child(proc: subprocess.Popen,
               timeout: float = 300.0) -> subprocess.CompletedProcess:
    """Wait for a child of :func:`start_child`; kill it past ``timeout``
    and raise."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def run_child(workdir: str, epochs: int, every_steps: int,
              resume: bool = False, die_at_step: Optional[int] = None,
              device: Optional[str] = None,
              timeout: float = 300.0) -> subprocess.CompletedProcess:
    """Run the training child to its end (or its death)."""
    return wait_child(start_child(workdir, epochs, every_steps, resume,
                                  die_at_step, device), timeout)


def read_scores(workdir: str) -> Dict[int, float]:
    """iteration -> score; later lines (the resumed run covering again
    the steps past the last checkpoint) override earlier ones."""
    out: Dict[int, float] = {}
    path = os.path.join(workdir, SCORES_JSONL)
    if not os.path.exists(path):
        return out
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rec = json.loads(line)
                out[int(rec["iteration"])] = rec["score"]
    return out


def run_chaos(workdir: Optional[str] = None, epochs: int = 3,
              every_steps: int = 3, die_at_step: Optional[int] = None,
              device: Optional[str] = None) -> Dict:
    """The whole kill/resume experiment; returns its record (``parity``
    is the verdict).  ``device`` is the children's (the card unless
    ``"cpu"``)."""
    it = build_iterator()
    steps_per_epoch = it._ds.num_examples() // it._batch
    total = epochs * steps_per_epoch \
        + epochs * (1 if it._ds.num_examples() % it._batch else 0)
    if die_at_step is None:
        # mid-epoch (the second epoch), past at least one mid-epoch save
        die_at_step = steps_per_epoch + every_steps + 2
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="dl4j-chaos-")
    ref_dir = os.path.join(workdir, "ref")
    kill_dir = os.path.join(workdir, "kill")
    os.makedirs(ref_dir, exist_ok=True)
    os.makedirs(kill_dir, exist_ok=True)

    # the reference and the victim are independent: they run side by side
    ref_proc = start_child(ref_dir, epochs, every_steps, device=device)
    victim = run_child(kill_dir, epochs, every_steps,
                       die_at_step=die_at_step, device=device)
    ref = wait_child(ref_proc)
    if ref.returncode != 0:
        raise RuntimeError(f"reference run failed:\n{ref.stderr[-4000:]}")
    resumed = run_child(kill_dir, epochs, every_steps, resume=True,
                        device=device)
    if resumed.returncode != 0:
        raise RuntimeError(f"resume run failed:\n{resumed.stderr[-4000:]}")

    scores_ref = read_scores(ref_dir)
    scores_res = read_scores(kill_dir)
    with open(os.path.join(ref_dir, DONE_JSON)) as fh:
        done_ref = json.load(fh)
    with open(os.path.join(kill_dir, DONE_JSON)) as fh:
        done_res = json.load(fh)

    covered = (set(scores_res) == set(range(1, total + 1))
               and set(scores_ref) == set(range(1, total + 1)))
    mismatches = [i for i in scores_ref
                  if scores_res.get(i) != scores_ref[i]]
    params_match = done_ref["params_sha256"] == done_res["params_sha256"]
    parity = covered and not mismatches and params_match
    return {
        "metric": "chaos_kill_resume_parity",
        "value": 1 if parity else 0,
        "unit": "bool",
        "parity": parity,
        "victim_killed": victim.returncode != 0,
        "victim_returncode": victim.returncode,
        "die_at_step": die_at_step,
        "total_steps": total,
        "steps_compared": len(scores_ref),
        "score_mismatches": len(mismatches),
        "coverage_ok": covered,
        "params_match": params_match,
        "device": done_res.get("device"),
        "workdir": workdir,
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="chaos training child (see the module docstring)")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--every-steps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    return child_main(args.workdir, args.epochs, args.every_steps,
                      args.resume, args.device)


if __name__ == "__main__":
    raise SystemExit(main())
