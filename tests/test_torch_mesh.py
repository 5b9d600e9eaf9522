"""The port's MeshRuntime (``parallel/mesh.py``) against the JAX package's
(``tests/test_mesh.py``'s twins): the bootstrap contract (flags > env,
idempotent, conflict-refusing, the backend from the device, NCCL's one
card a rank), the port-clash helpers, the ``("data", "zero", "pipe")``
mesh over a device list that repeats the CPU, the one reduction (the
sum in slot order, then / n), the updater-state gauge, and the pod
checkpoints, including one written by the JAX package's local runtime
restored into the port and written back with the shard entries byte for
byte.  Process groups are made only in subprocesses.

Tolerances: the reductions are exact (the same additions in the same
order); checkpoint round trips are bitwise.
"""

import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.parallel import mesh as M
from deeplearning4j_tpu_torch.parallel.mesh import MeshRuntime, Sharded
from deeplearning4j_tpu_torch.resilience import (CheckpointCorruptError,
                                                 list_pod_checkpoints,
                                                 pod_restore, pod_save,
                                                 prune_pod_checkpoints,
                                                 verify_pod_checkpoint)

ROOT = Path(__file__).resolve().parents[1]


def _cpu(n):
    return ["cpu"] * n


# ------------------------------------------------------------ bootstrap

def test_resolve_topology_precedence_flags_over_env():
    env = {M.ENV_COORDINATOR: "envhost:1111", M.ENV_NUM_PROCESSES: "4",
           M.ENV_PROCESS_ID: "3"}
    assert M.resolve_topology(env=env) == {
        "coordinator": "envhost:1111", "num_processes": 4, "process_id": 3}
    assert M.resolve_topology("flag:2222", 2, 1, env=env) == {
        "coordinator": "flag:2222", "num_processes": 2, "process_id": 1}
    assert M.resolve_topology(coordinator="flag:2222", env=env) == {
        "coordinator": "flag:2222", "num_processes": 4, "process_id": 3}
    assert M.resolve_topology(env={}) is None
    assert M.resolve_topology(num_processes=8, env={}) is None


@pytest.mark.parametrize("n,pid", [(0, 0), (2, 2), (2, -1)])
def test_resolve_topology_validates(n, pid):
    with pytest.raises(ValueError):
        M.resolve_topology("h:1", n, pid, env={})


@pytest.fixture
def clean_bootstrap(monkeypatch):
    for var in (M.ENV_COORDINATOR, M.ENV_NUM_PROCESSES, M.ENV_PROCESS_ID,
                M.ENV_LOCAL_RANK, M.ENV_LOCAL_WORLD_SIZE):
        monkeypatch.delenv(var, raising=False)
    M._reset_bootstrap_for_tests()
    yield
    M._reset_bootstrap_for_tests()


def test_ensure_distributed_idempotent_and_conflict(clean_bootstrap):
    assert M.initialized_topology() is None
    assert M.ensure_distributed() is False
    assert M.initialized_topology() is None
    # NUM_PROCESSES=1 records the shape without forming a group
    assert M.ensure_distributed("127.0.0.1:39999", 1, 0) is False
    assert M.initialized_topology() == {
        "coordinator": "127.0.0.1:39999", "num_processes": 1,
        "process_id": 0}
    assert not torch.distributed.is_initialized()
    assert M.ensure_distributed("127.0.0.1:39999", 1, 0) is False
    with pytest.raises(RuntimeError, match="conflicting"):
        M.ensure_distributed("127.0.0.1:39999", 2, 0)
    with pytest.raises(RuntimeError, match="conflicting"):
        M.ensure_distributed("other:1234", 1, 0)


def test_nccl_pod_with_more_ranks_than_cards_raises_before_init(
        clean_bootstrap, monkeypatch):
    """Two ranks on a one-card machine: NCCL needs one card a rank, so
    the bootstrap raises before any process group exists, and nothing
    falls back to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card a rank"):
        M.ensure_distributed("127.0.0.1:39997", 2, 0, device="cuda")
    assert not torch.distributed.is_initialized()
    assert M.initialized_topology() is None


def test_the_device_defaults_to_the_card(clean_bootstrap):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.ensure_distributed("127.0.0.1:39996", 2, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshRuntime.local(data=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.default_devices()


def test_remote_coordinator_pod_without_local_rank_raises(
        clean_bootstrap, monkeypatch):
    """Two ranks of one multi-card machine behind a non-loopback
    coordinator, with no LOCAL_RANK: neither can tell which card is its
    own, so the bootstrap raises before init instead of putting both on
    cuda:0; with LOCAL_RANK each takes cuda:<local rank>."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for pid in (0, 1):
        with pytest.raises(RuntimeError, match=M.ENV_LOCAL_RANK):
            M.ensure_distributed("10.0.0.7:39995", 2, pid, device="cuda")
    assert not torch.distributed.is_initialized()
    assert M.initialized_topology() is None
    topo = {"coordinator": "10.0.0.7:39995", "num_processes": 2,
            "process_id": 1}
    monkeypatch.setenv(M.ENV_LOCAL_RANK, "1")
    monkeypatch.setenv(M.ENV_LOCAL_WORLD_SIZE, "2")
    monkeypatch.setattr(M, "resolve_device", lambda d: torch.device(d))
    assert M.process_device("cuda", topo) == torch.device("cuda", 1)


def test_local_placement_and_process_device():
    topo = {"coordinator": "127.0.0.1:1", "num_processes": 3,
            "process_id": 2}
    assert M.local_placement(topo, env={}) == (2, 3)
    remote = dict(topo, coordinator="10.0.0.7:1")
    assert M.local_placement(remote, env={}) is None
    assert M.local_placement(dict(remote, num_processes=1, process_id=0),
                             env={}) == (0, 1)
    assert M.local_placement(topo, env={M.ENV_LOCAL_RANK: "1",
                                        M.ENV_LOCAL_WORLD_SIZE: "2"}) \
        == (1, 2)
    assert M.process_device("cpu", topo).type == "cpu"


_GROUP_OF_ONE = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
from deeplearning4j_tpu_torch.parallel import mesh as M
port = M.pick_coordinator_port()
rt = M.MeshRuntime(data=2, coordinator=f"127.0.0.1:{port}",
                   num_processes=1, process_id=0, device="cpu",
                   group_of_one=True)
assert torch.distributed.get_backend() == "gloo"
assert rt.process_count == 1 and not rt.is_multiprocess
assert rt.devices == [torch.device("cpu")] * 2
vals = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 5.0])]
out = rt.mean_over(vals)
assert [o.tolist() for o in out] == [[2.0, 3.5], [2.0, 3.5]]
for dtype in (torch.bfloat16, torch.float64, torch.int64):
    got = rt.gather_over([v.to(dtype) for v in vals], ("data",))
    assert [[t.dtype for t in g] for g in got] == [[dtype] * 2] * 2
    assert [t.tolist() for t in got[1]] == [v.to(dtype).tolist()
                                            for v in vals]
half = rt.mean_over([v.to(torch.bfloat16) for v in vals])
assert half[0].dtype == torch.bfloat16 and half[0].tolist() == [2.0, 3.5]
assert M.ensure_distributed(f"127.0.0.1:{port}", 1, 0) is False
try:
    M.ensure_distributed(f"127.0.0.1:{port}", 2, 0)
except RuntimeError as e:
    assert "conflicting" in str(e)
else:
    raise AssertionError("a conflicting topology was accepted")
rt.barrier()
M._reset_bootstrap_for_tests()
assert not torch.distributed.is_initialized()
print("ok")
"""


def test_group_of_one_forms_a_gloo_group_on_the_cpu():
    """A pod worker's group of one (the K=1 pod): gloo on the CPU, the
    collectives through the group, idempotent, conflict-refusing; run in
    a subprocess so that no process group outlives it."""
    out = subprocess.run([sys.executable, "-c", _GROUP_OF_ONE, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# --------------------------------------------------------- port helpers

def test_is_port_clash_markers():
    assert M.is_port_clash("... EADDRINUSE ...")
    assert M.is_port_clash("bind: Address already in use")
    assert M.is_port_clash("The server socket has failed to listen on any "
                           "local network address. port: 1 (errno: 98 - "
                           "Address already in use)")
    assert not M.is_port_clash("worker exited cleanly")


def test_retry_on_port_clash_retries_with_fresh_ports():
    seen = []

    def launch(port):
        seen.append(port)
        return (len(seen) >= 3, {"port": port})

    assert M.retry_on_port_clash(launch, attempts=4) == {"port": seen[-1]}
    assert len(seen) == 3 and all(1 <= p <= 65535 for p in seen)


def test_retry_on_port_clash_gives_up():
    calls = []

    def launch(port):
        calls.append(port)
        return (False, "EADDRINUSE")

    with pytest.raises(RuntimeError, match="clashed"):
        M.retry_on_port_clash(launch, attempts=3)
    assert len(calls) == 3


# ------------------------------------------------------- local runtime

def test_mesh_runtime_shapes_and_topology():
    rt = MeshRuntime.local(data=2, zero=2, devices=_cpu(4))
    assert M.AXES == ("data", "zero", "pipe")
    assert (rt.data_degree, rt.zero_degree, rt.pipe_degree) == (2, 2, 1)
    assert rt.dp_degree == 4 and rt.slot_count == 4
    assert rt.is_multiprocess is False and rt.process_count == 1
    assert rt.topology() == {"data": 2, "zero": 2, "pipe": 1,
                             "num_processes": 1}
    assert "data=2" in rt.describe() and "zero=2" in rt.describe()
    assert [rt.coords(s) for s in range(4)] == [
        (0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    assert rt.group_of(0, ("zero",)) == [0, 1]
    assert rt.group_of(3, ("data",)) == [1, 3]
    assert rt.group_of(2, ("data", "zero")) == [0, 1, 2, 3]
    assert monitor.gauge("mesh_axis_size").value(axis="zero") == 2


def test_mesh_runtime_infers_data_degree():
    rt = MeshRuntime.local(data=None, zero=2, devices=_cpu(8))
    assert rt.data_degree == 4 and len(rt.devices) == 8


@pytest.mark.parametrize("kw", [dict(data=64, zero=2), dict(data=1, zero=0),
                                dict(data=None, zero=16)])
def test_mesh_runtime_rejects_bad_shapes(kw):
    with pytest.raises(ValueError):
        MeshRuntime.local(devices=_cpu(8), **kw)


def test_one_device_named_n_times_holds_n_slots_without_copies():
    """A slot list may repeat a device; the mean is the left-to-right sum
    on the first slot's device, divided by n, and no copy is made
    between a device and itself."""
    rt = MeshRuntime.local(data=3, devices=_cpu(3))
    vals = [torch.tensor([0.1, 1.0], dtype=torch.float64) * (i + 1)
            for i in range(3)]
    out = rt.mean_over(vals)
    want = ((vals[0] + vals[1]) + vals[2]) / 3
    assert all(torch.equal(o, want) for o in out)
    assert out[0] is out[1] is out[2]          # .to onto itself: no copy
    sums = rt.sum_over(vals, ("data",))
    assert torch.equal(sums[0], (vals[0] + vals[1]) + vals[2])


def test_mean_trees_flattens_per_dtype_and_keeps_structure():
    rt = MeshRuntime.local(data=2, devices=_cpu(2))
    trees = [{"w": torch.full((2, 3), float(i)), "n": None,
              "d": [torch.tensor([1.0, 2.0], dtype=torch.float64) * i],
              "i": torch.tensor([7 + i])} for i in range(2)]
    out = rt.mean_trees(trees)
    assert out[0]["n"] is None
    assert torch.equal(out[1]["w"], torch.full((2, 3), 0.5))
    assert out[0]["d"][0].dtype == torch.float64
    assert torch.equal(out[0]["d"][0], torch.tensor([0.5, 1.0],
                                                   dtype=torch.float64))
    assert out[0]["i"].item() == 7 and out[1]["i"].item() == 8


def test_gather_over_zero_axis_in_slot_order():
    rt = MeshRuntime.local(data=2, zero=2, devices=_cpu(4))
    vals = [torch.tensor([float(s)]) for s in range(4)]
    got = rt.gather_over(vals, ("zero",))
    assert [[t.item() for t in g] for g in got] == [[0, 1], [0, 1],
                                                    [2, 3], [2, 3]]


def test_state_bytes_dedupe_and_gauge():
    """Per-slot state counts each distinct window once: a stacked
    (slots, ...) state and the same bytes as one tensor read alike."""
    rt = MeshRuntime.local(data=2, zero=2, devices=_cpu(4))
    host = torch.zeros((8, 4), dtype=torch.float32)       # 128 bytes
    assert rt.addressable_state_bytes({"m": host}) == 128
    per_slot = [{"m": torch.zeros(8)} for _ in range(4)]
    stacked = rt.stack_slots(per_slot)
    assert isinstance(stacked["m"], Sharded)
    assert stacked["m"].global_shape == (4, 8)
    assert rt.addressable_state_bytes(stacked) == 128
    rep = Sharded((2, 8), torch.float32,
                  [(((0, 1), (0, 8)), torch.zeros(1, 8)),
                   (((0, 1), (0, 8)), torch.zeros(1, 8))])
    assert rt.addressable_state_bytes({"m": rep}) == 32
    assert rt.publish_state_bytes(stacked, axis="zero") == 128
    assert monitor.gauge(M.STATE_BYTES_GAUGE).value(axis="zero") == 128


def test_measure_collectives_publishes_per_axis():
    rt = MeshRuntime.local(data=2, zero=2, devices=_cpu(4))
    out = rt.measure_collectives(size=256, repeats=1)
    assert set(out) == {"data/all_reduce", "data/all_gather",
                        "zero/all_reduce", "zero/all_gather"}
    assert all(v > 0 for v in out.values())


def test_worker_generator_is_a_function_of_seed_iteration_and_slot():
    def draw(*key):
        return torch.rand(4, generator=M.worker_generator(
            *key, torch.device("cpu")))
    assert torch.equal(draw(7, 3, 1), draw(7, 3, 1))
    assert not torch.equal(draw(7, 3, 1), draw(7, 3, 0))
    assert not torch.equal(draw(7, 3, 1), draw(7, 4, 1))
    assert not torch.equal(draw(7, 3, 1), draw(8, 3, 1))


# ------------------------------------------------- pod checkpoints

def _trees(rt):
    rng = np.random.RandomState(3)
    params = {"w": rng.randn(6, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    rows = rng.randn(rt.zero_degree, 8).astype(np.float32)
    ustate = {"m": Sharded((rt.zero_degree, 8), torch.float32, [
        (((z, z + 1), (0, 8)), torch.from_numpy(rows[z:z + 1]))
        for z in range(rt.zero_degree)])}
    staged = {"params": {k: torch.from_numpy(v) for k, v in params.items()},
              "ustate": ustate}
    return params, rows, staged


def _templates():
    return {"params": {"w": torch.zeros(6, 4), "b": torch.zeros(4)},
            "ustate": {"m": torch.zeros(2, 8)}}


def test_pod_checkpoint_roundtrip(tmp_path):
    rt = MeshRuntime.local(data=2, zero=2, devices=_cpu(4))
    params, rows, staged = _trees(rt)
    d = str(tmp_path)
    pod_save(rt, d, step=7, trees=staged, extra={"next_step": 8})
    pdirs = list_pod_checkpoints(d)
    assert len(pdirs) == 1 and pdirs[0].endswith("pod-0000000007")
    verify_pod_checkpoint(pdirs[0], topology=rt.topology())
    trees, manifest = pod_restore(rt, d, _templates())
    assert manifest["step"] == 7 and manifest["extra"]["next_step"] == 8
    assert manifest["topology"] == rt.topology()
    np.testing.assert_array_equal(trees["params"]["w"].numpy(), params["w"])
    np.testing.assert_array_equal(trees["params"]["b"].numpy(), params["b"])
    np.testing.assert_array_equal(trees["ustate"]["m"].numpy(), rows)


def test_pod_checkpoint_keeps_bfloat16_bits(tmp_path):
    rt = MeshRuntime.local(data=1, devices=_cpu(1))
    w = torch.randn(5, 3).to(torch.bfloat16)
    pod_save(rt, str(tmp_path), step=1, trees={"params": {"w": w}})
    trees, _ = pod_restore(rt, str(tmp_path),
                           {"params": {"w": torch.zeros(5, 3)}})
    assert trees["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(trees["params"]["w"].view(torch.int16),
                       w.view(torch.int16))


def test_pod_checkpoint_refuses_wrong_topology(tmp_path):
    rt = MeshRuntime.local(data=2, zero=2, devices=_cpu(4))
    _, _, staged = _trees(rt)
    d = str(tmp_path)
    pod_save(rt, d, step=1, trees=staged, extra={})
    pdir = list_pod_checkpoints(d)[0]
    other = MeshRuntime.local(data=4, zero=1, devices=_cpu(4))
    with pytest.raises(CheckpointCorruptError, match="topology"):
        verify_pod_checkpoint(pdir, topology=other.topology())
    assert pod_restore(other, d, _templates()) is None
    with pytest.raises(CheckpointCorruptError, match="topology"):
        pod_restore(other, d, _templates(), step=1)


def test_pod_checkpoint_missing_manifest_is_invisible(tmp_path):
    rt = MeshRuntime.local(data=2, zero=2, devices=_cpu(4))
    _, _, staged = _trees(rt)
    d = str(tmp_path)
    pod_save(rt, d, step=1, trees=staged, extra={})
    pod_save(rt, d, step=2, trees=staged, extra={})
    pdirs = list_pod_checkpoints(d)
    assert [os.path.basename(p) for p in pdirs] == ["pod-0000000002",
                                                    "pod-0000000001"]
    os.remove(os.path.join(pdirs[0], "pod-manifest.json"))
    assert [os.path.basename(p) for p in list_pod_checkpoints(d)] == [
        "pod-0000000001"]
    _, manifest = pod_restore(rt, d, _templates())
    assert manifest["step"] == 1
    assert pod_restore(rt, str(tmp_path / "empty"), _templates()) is None


def test_pod_checkpoint_detects_shard_corruption(tmp_path):
    rt = MeshRuntime.local(data=2, zero=2, devices=_cpu(4))
    _, _, staged = _trees(rt)
    d = str(tmp_path)
    pod_save(rt, d, step=3, trees=staged, extra={})
    pdir = list_pod_checkpoints(d)[0]
    path = os.path.join(pdir, "shard-00000.zip")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(CheckpointCorruptError):
        verify_pod_checkpoint(pdir, topology=rt.topology())
    assert pod_restore(rt, d, _templates()) is None
    with pytest.raises(CheckpointCorruptError):
        pod_restore(rt, d, _templates(), step=3)


def test_prune_pod_checkpoints(tmp_path):
    rt = MeshRuntime.local(data=2, zero=2, devices=_cpu(4))
    _, _, staged = _trees(rt)
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        pod_save(rt, d, step=step, trees=staged, extra={})
    assert prune_pod_checkpoints(rt, d, keep_last=2) == 2
    assert [os.path.basename(p) for p in list_pod_checkpoints(d)] == [
        "pod-0000000004", "pod-0000000003"]


# ------------------------------------------- crossing the packages

def _jax_pod_pair(tmp_path):
    """A JAX ParallelWrapper-shaped pod checkpoint: an adam net's params
    (replicated) and its updater state stacked per worker over a local
    data=2 runtime, written by the JAX package's ``pod_save``."""
    from jax.sharding import PartitionSpec as P
    import jax
    from deeplearning4j_tpu.nn.conf import inputs as jin
    from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.layers import core as jcore
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.parallel.mesh import MeshRuntime as JRuntime
    from deeplearning4j_tpu.resilience import checkpoint as jck
    conf = (JConf.builder().seed(5).updater("adam").learning_rate(0.05)
            .activation("tanh").list()
            .layer(jcore.DenseLayer(n_out=6))
            .layer(jcore.OutputLayer(n_out=3))
            .set_input_type(jin.feed_forward(4)).build())
    jnet = JNet(conf).init()
    rng = np.random.RandomState(0)
    jnet.fit(np.float32(rng.randn(8, 4)),
             np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)])
    jrt = JRuntime.local(data=2, devices=jax.devices()[:2])
    stacked = jax.tree.map(
        lambda a: np.stack([np.asarray(a), np.asarray(a) * 2.0]),
        jnet.updater_state)
    trees = {"params": jrt.put_tree(jnet.params, P()),
             "ustate": jrt.put_tree(stacked, P(("data", "zero")))}
    jck.pod_save(jrt, str(tmp_path / "jax"), 4, trees,
                 extra={"next_step": 4})
    return conf, jnet, jrt, stacked, jck


def _entries(pdir):
    with zipfile.ZipFile(os.path.join(pdir, "shard-00000.zip")) as zf:
        table = json.loads(zf.read("shards.json"))["shards"]
        data = {e["entry"]: zf.read(e["entry"]) for e in table}
    for e in table:
        e.pop("sha256")
    return table, data


def test_a_jax_pod_checkpoint_crosses_both_ways(tmp_path):
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    conf, jnet, jrt, stacked, jck = _jax_pod_pair(tmp_path)
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pw = ParallelWrapper(pnet, workers=2, devices=_cpu(2))
    rt = pw.runtime
    trees, manifest = pod_restore(
        rt, str(tmp_path / "jax"),
        {"params": pnet.params, "ustate": pw.worker_state()})
    assert manifest["topology"] == rt.topology()
    pnet.params = trees["params"]
    pw.load_worker_state(trees["ustate"])
    np.testing.assert_array_equal(pnet.get_flat_params(),
                                  np.asarray(jnet.get_flat_params()))
    np.testing.assert_array_equal(pnet.get_flat_updater_state(),
                                  np.asarray(jnet.get_flat_updater_state()))
    np.testing.assert_array_equal(
        pw._worker_ustate[1][0]["v"]["W"].numpy(),
        np.asarray(stacked[0]["v"]["W"][1]))
    pod_save(rt, str(tmp_path / "port"), 4,
             {"params": pnet.params, "ustate": pw.worker_state()},
             extra={"next_step": 4})
    jt, jd = _entries(list_pod_checkpoints(str(tmp_path / "jax"))[0])
    pt, pd = _entries(list_pod_checkpoints(str(tmp_path / "port"))[0])
    assert pt == jt
    assert pd == jd                             # every entry byte for byte
    # and back: the JAX package restores the port's checkpoint
    back, _ = jck.pod_restore(
        jrt, str(tmp_path / "port"),
        {"params": jnet.params, "ustate": stacked})
    for a, b in zip(M.tree_leaves(back["ustate"]), M.tree_leaves(stacked)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
