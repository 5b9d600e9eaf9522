"""Real pods of the port (``parallel/main.py`` ``run_pod``): worker
processes over ``torch.distributed`` with the gloo backend on the CPU,
each a subprocess with a 120 s limit.  The JAX counterparts are the
slow-marked pods of ``tests/test_mesh.py``; these stay in tier-1, small
(the 4-16-3 adam scenario, 6 steps of 16 rows a replica).  The dp pods
of 2 processes and of 1 run once for the file, side by side.

- dp: 2 processes bitwise equal to the 1-process run of the same mesh
  (its slots in one process, a group of one), and to the wrapper in
  process with no group at all; within rtol 2e-5 of the JAX package's
  local ``ParallelWrapper`` on the same scenario and weights;
- zero: 2 processes bitwise equal to the same mesh's slots in this
  process, within rtol 2e-5 of the JAX big-batch ``fit``, and each
  process holds half the updater state;
- a SIGKILL at a step, then a relaunch that resumes from the newest pod
  checkpoint, bitwise equal to the uninterrupted pods of 2 and of 1.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from deeplearning4j_tpu_torch.parallel import main as pmain
from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
    ParallelWrapper
from deeplearning4j_tpu_torch.parallel.zero import \
    ZeroShardedParallelWrapper

RTOL = 2e-5
STEPS = 6
BATCH = 16


def _pod(**kw):
    kw.setdefault("steps", STEPS)
    kw.setdefault("batch", BATCH)
    return pmain.run_pod(device="cpu", timeout=120, **kw)


def _ok(result, k):
    assert result["returncodes"] == [0] * k, result["stderr_tail"]
    assert result["reaped"]
    assert {r["param_sha"] for r in result["reports"]} == {
        result["param_sha"]}
    assert all(r["backend"] == "gloo" and r["device"] == "cpu"
               for r in result["reports"])


@pytest.fixture(scope="module")
def dp_pods():
    """The uninterrupted dp pods of the data=2 mesh: 2 processes, and 1
    process holding both slots."""
    with ThreadPoolExecutor(2) as pool:
        multi = pool.submit(_pod, k=2, data=2, mode="dp")
        single = pool.submit(_pod, k=1, data=2, mode="dp")
        return multi.result(), single.result()


def _jax_pod_net():
    """The JAX package's pod net carrying the port's initial weights
    (their random streams differ)."""
    from deeplearning4j_tpu.parallel import main as jmain
    jnet = jmain.build_pod_net(seed=11)
    port = pmain.build_pod_net(seed=11, device="cpu")
    jnet.set_flat_params(port.get_flat_params())
    return jmain, jnet


def test_pod_dp_two_processes_bitwise_and_near_jax(dp_pods):
    multi, single = dp_pods
    _ok(multi, 2)
    _ok(single, 1)
    assert multi["scores"] == single["scores"]
    assert multi["param_sha"] == single["param_sha"]
    assert single["reports"][0]["topology"] == {
        "data": 2, "zero": 1, "pipe": 1, "num_processes": 1}
    # the wrapper in this process, with no process group, on the scenario
    net = pmain.build_pod_net(seed=11, device="cpu")
    pw = ParallelWrapper(net, workers=2, prefetch_size=0,
                         devices=["cpu"] * 2)
    scores = []
    for step in range(STEPS):
        pw.fit(pmain.make_pod_batches(step, 2, BATCH, 100))
        scores.append(float(np.float32(float(net._score))))
    assert scores == multi["scores"]
    assert pmain.param_sha(net) == multi["param_sha"]
    # the JAX package's local ParallelWrapper on the same scenario
    from deeplearning4j_tpu.parallel.parallel_wrapper import \
        ParallelWrapper as JPW
    jmain, jnet = _jax_pod_net()
    jpw = JPW(jnet, workers=2, prefetch_size=0)
    jscores = []
    for step in range(STEPS):
        jb = jmain.make_pod_batches(step, 2, BATCH, 100)
        pb = pmain.make_pod_batches(step, 2, BATCH, 100)
        for a, b in zip(jb, pb):
            np.testing.assert_array_equal(np.asarray(a.features),
                                          b.features)
        jpw.fit(jb)
        jscores.append(float(jnet._score))
    np.testing.assert_allclose(multi["scores"], jscores, rtol=RTOL)
    np.testing.assert_allclose(net.get_flat_params(),
                               np.asarray(jnet.get_flat_params()),
                               rtol=RTOL, atol=RTOL)


def test_pod_zero_two_processes_bitwise_and_state_halves():
    zero2 = _pod(k=2, data=1, zero=2, mode="zero")
    _ok(zero2, 2)
    # the same mesh's two zero slots in this process, no group
    net = pmain.build_pod_net(seed=11, device="cpu")
    zw = ZeroShardedParallelWrapper(net, workers=2, devices=["cpu"] * 2)
    scores = []
    for step in range(STEPS):
        zw.fit(pmain.make_pod_batches(step, 2, BATCH, 100))
        scores.append(float(np.float32(float(net._score))))
    assert zero2["scores"] == scores
    assert zero2["param_sha"] == pmain.param_sha(net)
    # each process holds one of the two slices of adam's m and v; one
    # process holds both, and a dp replica the whole state
    total = net.num_params()
    half = 2 * 4 * (-(-total // 2))
    assert [r["updater_state_bytes"] for r in zero2["reports"]] == [half] * 2
    assert zw.runtime.addressable_state_bytes(zw.state_tree()) == 2 * half
    assert zero2["updater_state_bytes"] <= 0.6 * (2 * 4 * total)
    # the JAX package's single-process big-batch fit of the same steps
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    jmain, jnet = _jax_pod_net()
    jscores = []
    for step in range(STEPS):
        jb = jmain.make_pod_batches(step, 2, BATCH, 100)
        jnet.fit(JDS(np.concatenate([np.asarray(b.features) for b in jb]),
                     np.concatenate([np.asarray(b.labels) for b in jb])))
        jscores.append(float(jnet._score))
    np.testing.assert_allclose(zero2["scores"], jscores, rtol=RTOL)


def test_pod_kill_and_resume_matches_uninterrupted(tmp_path, dp_pods):
    d = str(tmp_path / "ckpt")
    interrupted = _pod(k=2, data=2, mode="dp", checkpoint_dir=d,
                       checkpoint_every=2, die_at=(1, 4), relaunch=True)
    assert interrupted["returncodes"][1] == -9
    assert interrupted["reaped"]
    resumed = interrupted["resumed"]
    _ok(resumed, 2)
    assert resumed["reports"][0]["start_step"] == 4
    assert resumed["reports"][0]["resumed_from"] == 4
    for clean in dp_pods:
        assert resumed["scores"] == clean["scores"]
        assert resumed["param_sha"] == clean["param_sha"]
