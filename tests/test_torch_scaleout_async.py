"""The port's K-process Hogwild trainer (``deeplearning4j_tpu_torch/
scaleout/async_trainer.py``) on the CPU: worker processes started with
``--device cpu`` against the port's TCP parameter server converge inside
the 0.08 accuracy band of the synchronous baseline (the JAX package's
``bench_scaleout`` parity band), survive a SIGKILL, and are all reaped;
without a card the entry points refuse to run unless asked for the CPU.
The data and the model are the JAX package's (``make_batches`` bitwise,
the same 4-16-3 configuration)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.scaleout import async_trainer as jat
from deeplearning4j_tpu_torch import monitor as pmon
from deeplearning4j_tpu_torch.resilience import faults as pfaults
from deeplearning4j_tpu_torch.scaleout import async_trainer as at

BAND = 0.08


@pytest.fixture(autouse=True)
def _isolated():
    pmon.reset()
    pfaults.reset()
    yield
    pmon.reset()
    pfaults.reset()


def _reaped(rec):
    for pid in rec["pids"]:
        try:
            os.kill(pid, 0)
        except OSError:
            continue
        return False
    return True


@pytest.fixture(scope="module")
def sync_rec():
    return at.run_sync_dp(k=2, rounds=10, device="cpu")


def test_data_and_model_are_the_jax_ones(sync_rec):
    for a, b in zip(at.make_batches(3, 8, 100), jat.make_batches(3, 8, 100)):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert at.build_net(device="cpu").conf.to_json() == \
        jat.build_net().conf.to_json()
    assert sync_rec["mode"] == "sync_dp" and sync_rec["rounds"] == 10
    assert sync_rec["accuracy"] > 0.70, sync_rec


def test_two_worker_processes_converge_inside_the_band(sync_rec):
    rec = at.run_async(k=2, codec="topk8", rounds=10, device="cpu")
    assert rec["returncodes"] == [0, 0] and rec["survivors"] == 2
    assert rec["pushes"] == 20 and rec["wire_bytes"] > 0
    assert all(w["rounds"] == 10 and w["device"] == "cpu"
               and w["ready_s"] > 0 for w in rec["workers"])
    assert rec["staleness_max"] >= 1
    assert abs(rec["accuracy"] - sync_rec["accuracy"]) <= BAND, (
        rec["accuracy"], sync_rec["accuracy"])
    assert _reaped(rec)


def test_the_run_survives_a_worker_kill(sync_rec):
    """One of three workers is SIGKILLed at round 3 with compression on:
    the run finishes, the survivors' pushes land, the model converges
    inside the band, and every worker (the killed one too) is reaped."""
    rec = at.run_async(k=3, codec="topk8", rounds=10, die_at_round=(2, 3),
                       device="cpu")
    assert rec["returncodes"][2] == -9
    assert rec["survivors"] == 2 and rec["pushes"] >= 20
    assert abs(rec["accuracy"] - sync_rec["accuracy"]) <= BAND, (
        rec["accuracy"], sync_rec["accuracy"])
    assert _reaped(rec)


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        at.run_async(k=1, rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        at.run_sync_dp(k=1, rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        at.build_net()
    # a worker started without --device asks for the card and exits
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.scaleout."
         "async_trainer", "--worker", "--host", "127.0.0.1", "--port", "9",
         "--rank", "0"], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode != 0 and "CUDA" in out.stderr
