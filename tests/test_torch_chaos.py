"""The port's kill/resume harness (``resilience/chaos.py``) on the CPU: a
training child SIGKILLed mid-epoch by the fault layer and resumed from
its last checkpoint covers every iteration with scores bitwise equal to
an uninterrupted run's, and ends on the same params (their SHA-256).  The
children are ``python -m deeplearning4j_tpu_torch.resilience.chaos
--device cpu``; on the card the same harness runs from ``chip_smoke.py``.
"""

import json
import os

from deeplearning4j_tpu.resilience import chaos as jchaos
from deeplearning4j_tpu_torch.resilience import chaos


def test_kill_resume_parity_on_the_cpu(tmp_path):
    report = chaos.run_chaos(workdir=str(tmp_path), device="cpu")
    assert report["victim_killed"], report
    assert report["victim_returncode"] == -9, report
    assert report["coverage_ok"], report
    assert report["score_mismatches"] == 0, report
    assert report["params_match"], report
    assert report["parity"] and report["device"] == "cpu", report
    assert report["steps_compared"] == report["total_steps"] == 24
    # the victim died past a mid-epoch save and left a partial trace
    with open(os.path.join(str(tmp_path), "kill", chaos.SCORES_JSONL)) as fh:
        iterations = [json.loads(line)["iteration"] for line in fh]
    assert iterations[0] == 1 and max(iterations) == 24
    assert len(iterations) > 24      # the resume covered steps again


def test_the_workload_is_the_jax_harness_workload():
    """The same network shape, data and iterator settings as the JAX
    package's harness (its draws differ: each package initialises with
    its own stream)."""
    p, j = chaos.build_iterator(), jchaos.build_iterator()
    assert (p._batch, p._shuffle, p._seed) == (j._batch, j._shuffle,
                                               j._seed)
    assert (p._ds.features == j._ds.features).all()
    assert (p._ds.labels == j._ds.labels).all()
    pnet, jnet = chaos.build_net(device="cpu"), jchaos.build_net()
    assert pnet.conf.to_json() == jnet.conf.to_json()
    assert pnet.num_params() == jnet.num_params()


def test_read_scores_keeps_the_last_line_of_an_iteration(tmp_path):
    path = tmp_path / chaos.SCORES_JSONL
    path.write_text("\n".join(json.dumps(r) for r in (
        {"iteration": 1, "score": 0.5}, {"iteration": 2, "score": 0.4},
        {"iteration": 2, "score": 0.3})) + "\n\n")
    assert chaos.read_scores(str(tmp_path)) == {1: 0.5, 2: 0.3}
    assert chaos.read_scores(str(tmp_path / "missing")) == {}
