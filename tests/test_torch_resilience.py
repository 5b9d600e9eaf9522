"""The port's fault-tolerant training runtime (``resilience/checkpoint.py``,
``resilience/faults.py``) and ``fit``'s ``checkpoint=``/``resume_from=``,
against the JAX package's where both write the same thing.

- a checkpoint is written atomically, verifies against its SHA-256
  manifest, restores (and opens as a model zip); ``keep_last`` prunes;
  a corrupted file is refused with ``CheckpointCorruptError`` and
  ``latest()`` falls back to the one before;
- ``epochs`` is the total target when resuming;
- a resume from a mid-epoch checkpoint is bit-identical to the
  uninterrupted run on the cache path, in both containers and under
  bf16 with fp32 masters; the batch path warns and restarts the epoch;
- the fault variables parse as the JAX package's;
- a checkpoint's model entries (configuration, coefficients, updater
  state, layer state) are byte-identical to the JAX package's for the
  same weights, and each package restores the other's.
"""

import json
import os
import time
import zipfile

import numpy as np
import pytest

from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.resilience import checkpoint as jckpt
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience import checkpoint as ckpt_mod
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.checkpoint import (
    CheckpointCorruptError, CheckpointManager, list_checkpoints, restore,
    verify_checkpoint)
from deeplearning4j_tpu_torch.utils.model_serializer import \
    restore_multi_layer_network

from test_torch_ingest import _arrays, _net


@pytest.fixture(autouse=True)
def _isolated():
    monitor.reset()
    faults.configure()
    ckpt_mod._reset_status()
    yield
    monitor.reset()
    faults.reset()
    ckpt_mod._reset_status()


def _it(n=64, batch=8):
    """8 steps an epoch, shuffled on the cache path."""
    x, y = _arrays(n=n)
    return ListDataSetIterator(DataSet(x, y), batch, shuffle=True, seed=3)


def _same(a, b):
    np.testing.assert_array_equal(a.get_flat_params(), b.get_flat_params())
    np.testing.assert_array_equal(a.get_flat_updater_state(),
                                  b.get_flat_updater_state())


# ------------------------------------------------- checkpoint mechanics
def test_write_verify_restore(tmp_path):
    net = _net()
    net.fit(_it(), epochs=1)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    path = mgr.save(net, step_in_epoch=0)
    assert [n for n in os.listdir(tmp_path) if n.startswith(".")] == []
    manifest = verify_checkpoint(path)
    assert manifest["num_params"] == net.num_params()
    assert set(manifest["entries"]) >= {"configuration.json",
                                        "coefficients.bin",
                                        "updaterState.bin", "resume.json"}
    again = _net()
    rs = restore(again, path)
    assert (rs.iteration, rs.epoch, rs.step_in_epoch) == (8, 1, 0)
    _same(again, net)
    assert again._rng.get_state().tolist() == net._rng.get_state().tolist()
    zipped = restore_multi_layer_network(path, device="cpu")
    np.testing.assert_array_equal(zipped.get_flat_params(),
                                  net.get_flat_params())
    assert monitor.counter(ckpt_mod.WRITES_TOTAL).value() == 1
    assert monitor.counter(ckpt_mod.RESTORES_TOTAL).value() == 1
    status = ckpt_mod.status()
    assert status["iteration"] == 8 and status["resumed_from"]["path"] == \
        path


@pytest.mark.parametrize("ingest", ["batch", "cache"])
def test_a_checkpoint_keeps_the_score(tmp_path, ingest):
    """The score a fit leaves (a device scalar on the cache path) is
    written as a float and read back."""
    net = _net()
    net.fit(_it(), epochs=1, ingest=ingest)
    path = CheckpointManager(str(tmp_path), async_write=False).save(net)
    rs = restore(_net(), path)
    assert isinstance(rs.score, float)
    assert rs.score == float(net.score())


def test_keep_last_prunes_the_oldest(tmp_path):
    net = _net()
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_write=False)
    for _ in range(5):
        net.fit(_it(), epochs=1)
        mgr.save(net)
    kept = list_checkpoints(str(tmp_path))
    its = [int(os.path.basename(p)[len("checkpoint-"):-len(".zip")])
           for p in kept]
    assert its == [40, 32]
    assert monitor.counter(ckpt_mod.PRUNED_TOTAL).value() == 3


def test_the_background_writer_flushes(tmp_path):
    net = _net()
    mgr = CheckpointManager(str(tmp_path), every_steps=4)
    net.fit(_it(), epochs=2, checkpoint=mgr)
    assert len(list_checkpoints(str(tmp_path))) == 3      # keep_last
    assert mgr.latest().endswith("checkpoint-0000000016.zip")


def test_corruption_is_refused_with_a_diagnostic(tmp_path):
    net = _net()
    net.fit(_it(), epochs=1)
    mgr = CheckpointManager(str(tmp_path), keep_last=4, async_write=False)
    good = mgr.save(net)
    net.fit(_it(), epochs=1)
    bad = mgr.save(net)
    faults.corrupt_file(bad)
    with pytest.raises(CheckpointCorruptError) as err:
        verify_checkpoint(bad)
    assert bad in str(err.value)
    with pytest.raises(CheckpointCorruptError):
        restore(_net(), bad)
    assert mgr.latest() == good
    # a directory resume walks the files newest first: it skips the bad
    # one, counted, and restores the good one
    assert ckpt_mod.resume_for_fit(_net(), str(tmp_path), None).path == good
    assert monitor.counter(ckpt_mod.CORRUPT_SKIPPED).value() >= 1


def test_the_corrupt_checkpoint_fault(tmp_path):
    net = _net()
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    faults.configure(corrupt_checkpoint=1)
    path = mgr.save(net)
    assert mgr.latest() is None
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(path)
    assert monitor.counter(faults.INJECTIONS_TOTAL).value(
        point="corrupt_checkpoint") == 1


def test_a_resume_under_another_policy_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PRECISION", "mixed_bf16")
    net = _net()
    path = CheckpointManager(str(tmp_path), async_write=False).save(net)
    monkeypatch.setenv("DL4J_TPU_PRECISION", "fp32")
    with pytest.raises(CheckpointCorruptError, match="precision policy"):
        restore(_net(), path)


# ------------------------------------------------------- fit and resume
def test_epochs_is_the_total_target_on_resume(tmp_path):
    net = _net()
    net.fit(_it(), epochs=3,
            checkpoint=CheckpointManager(str(tmp_path), async_write=False))
    again = _net()
    again.fit(_it(), epochs=3, resume_from=str(tmp_path))
    assert again.iteration == net.iteration == 24
    _same(again, net)
    more = _net()
    more.fit(_it(), epochs=4, resume_from=str(tmp_path))
    assert more.iteration == 32 and more.epoch == 4


def test_resume_auto_needs_a_manager_and_cold_starts(tmp_path):
    with pytest.raises(ValueError, match="needs checkpoint="):
        _net().fit(_it(), resume_from="auto")
    net = _net()
    net.fit(_it(), epochs=1, checkpoint=str(tmp_path / "empty"),
            resume_from="auto")
    assert net.iteration == 8
    with pytest.raises(FileNotFoundError):
        _net().fit(_it(), resume_from=str(tmp_path / "nothing.zip"))


def _mid_epoch(directory):
    for path in list_checkpoints(directory):
        with zipfile.ZipFile(path) as zf:
            resume = json.loads(zf.read("resume.json"))
        if resume["step_in_epoch"] > 0 and resume["epoch"] == 1:
            return path, resume
    raise AssertionError("no mid-epoch checkpoint")


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_a_mid_epoch_resume_is_bit_identical(tmp_path, container):
    """A cadence of 3 steps over 8-step epochs checkpoints mid-epoch; the
    resumed run re-derives the epoch's order and ends where the
    uninterrupted run ends, bit for bit (the cadence itself is inert)."""
    ref = _net(container)
    ref.fit(_it(), epochs=3)
    run = _net(container)
    run.fit(_it(), epochs=3, checkpoint=CheckpointManager(
        str(tmp_path), every_steps=3, keep_last=8))
    _same(run, ref)
    path, resume = _mid_epoch(str(tmp_path))
    assert resume["iteration"] % 8 == resume["step_in_epoch"]
    resumed = _net(container)
    resumed.fit(_it(), epochs=3, resume_from=path)
    assert resumed.iteration == ref.iteration == 24
    _same(resumed, ref)


def test_a_mid_epoch_resume_is_bit_identical_under_mixed_bf16(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PRECISION", "mixed_bf16")
    ref = _net()
    assert ref._pol().master_weights
    ref.fit(_it(), epochs=3)
    run = _net()
    run.fit(_it(), epochs=3, checkpoint=CheckpointManager(
        str(tmp_path), every_steps=3, keep_last=8))
    _same(run, ref)
    path, _ = _mid_epoch(str(tmp_path))
    resumed = _net()
    resumed.fit(_it(), epochs=3, resume_from=path)
    _same(resumed, ref)
    for layer, state in enumerate(resumed.updater_state):
        for k, m in state[updaters.MASTER_KEY].items():
            np.testing.assert_array_equal(
                resumed.params[layer][k].float().numpy(),
                m.bfloat16().float().numpy())


def test_the_batch_path_warns_and_restarts_the_epoch(tmp_path):
    net = _net()
    net.fit(_it(), epochs=2, checkpoint=CheckpointManager(
        str(tmp_path), every_steps=3, keep_last=8, async_write=False))
    path, _ = _mid_epoch(str(tmp_path))
    again = _net()
    with pytest.warns(RuntimeWarning, match="mid-epoch"):
        again.fit(_it(), epochs=2, ingest="batch", resume_from=path)
    assert again.epoch == 2


def test_the_preemption_point_follows_the_save(tmp_path, monkeypatch):
    """``maybe_die`` runs after each save: a process armed to die at step
    6 has its checkpoint of step 6 behind it."""
    deaths = []
    monkeypatch.setattr(faults.os, "kill", lambda pid, sig: deaths.append(
        sorted(os.listdir(tmp_path))))
    faults.configure(die_at_step=6)
    net = _net()
    net.fit(_it(), epochs=1, checkpoint=CheckpointManager(
        str(tmp_path), every_steps=3, async_write=False))
    assert deaths[0] == ["checkpoint-0000000003.zip",
                         "checkpoint-0000000006.zip"]


# ---------------------------------------------------------------- faults
def test_fault_variables_parse_as_in_jax(monkeypatch):
    from deeplearning4j_tpu.resilience import faults as jfaults
    env = {"DL4J_TPU_FAULT_DIE_AT_STEP": "17",
           "DL4J_TPU_FAULT_CORRUPT_CHECKPOINT": "2",
           "DL4J_TPU_FAULT_DROP_CONNECTION": "1",
           "DL4J_TPU_FAULT_SLOW_WORKER_MS": "1.5"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    faults.reset()
    jfaults.reset()
    try:
        assert faults.spec() == jfaults.spec() == {
            "die_at_step": 17, "corrupt_checkpoint": 2,
            "drop_connection": 1, "slow_worker_ms": 1.5,
            "slow_worker_rank": None}
        assert faults.corrupt_checkpoint() and faults.corrupt_checkpoint()
        assert not faults.corrupt_checkpoint()
        assert faults.drop_connection() and not faults.drop_connection()
        t0 = time.perf_counter()
        faults.slow_worker()
        assert time.perf_counter() - t0 >= 0.001
    finally:
        for k in env:
            monkeypatch.delenv(k)
        jfaults.reset()


def test_a_slow_worker_can_be_one_rank(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FAULT_SLOW_WORKER_MS", "2:40")
    faults.reset()
    assert (faults.spec()["slow_worker_rank"],
            faults.spec()["slow_worker_ms"]) == (2, 40.0)
    t0 = time.perf_counter()
    faults.slow_worker(rank=0)
    faults.slow_worker()
    assert time.perf_counter() - t0 < 0.030
    t0 = time.perf_counter()
    faults.slow_worker(rank=2)
    assert time.perf_counter() - t0 >= 0.035
    faults.configure(slow_worker_ms=(1, 5.0))
    assert faults.spec()["slow_worker_rank"] == 1


# ------------------------------------------------------ JAX byte identity
def _bn_conf():
    return (JaxConf.builder().seed(5).updater("adam").learning_rate(0.05)
            .activation("tanh").weight_init("xavier").list()
            .layer(jcore.DenseLayer(n_out=8))
            .layer(jnorm.BatchNormalization())
            .layer(jcore.OutputLayer(n_out=3))
            .set_input_type(jin.feed_forward(6)).build())


_MODEL_ENTRIES = ("configuration.json", "coefficients.bin",
                  "updaterState.bin", "state.bin")


def test_model_entries_are_the_jax_bytes(tmp_path):
    """A JAX network trained 2 epochs is checkpointed by the JAX package;
    the port restores that checkpoint, writes its own, and its model
    entries are the JAX bytes; the JAX package restores the port's."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JaxList
    x, y = _arrays(n=32)
    jnet = JaxNet(_bn_conf()).init()
    jnet.fit(JaxList(JaxDataSet(x, y), 8), epochs=2, ingest="batch")
    jpath = jckpt.CheckpointManager(str(tmp_path / "jax"),
                                    async_write=False).save(jnet)
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _bn_conf().to_json()), device="cpu").init()
    rs = restore(pnet, jpath)
    assert (rs.iteration, rs.epoch) == (8, 2)
    ppath = CheckpointManager(str(tmp_path / "port"),
                              async_write=False).save(pnet)
    with zipfile.ZipFile(jpath) as jz, zipfile.ZipFile(ppath) as pz:
        for name in _MODEL_ENTRIES:
            assert pz.read(name) == jz.read(name), name
        assert "rng_state" in json.loads(pz.read("resume.json"))
    back = JaxNet(_bn_conf()).init()
    jckpt.restore(back, ppath)
    np.testing.assert_array_equal(np.asarray(back.get_flat_params()),
                                  np.asarray(jnet.get_flat_params()))


def test_atomic_text_and_json_writes_match_jax(tmp_path):
    from deeplearning4j_tpu.utils import fileio as jfileio
    from deeplearning4j_tpu_torch.utils import fileio
    obj = {"b": [1, 2.5, None], "a": "ü"}
    for mod, tag in ((jfileio, "jax"), (fileio, "port")):
        mod.atomic_write_text(str(tmp_path / f"{tag}.txt"), "ünï\ncode")
        mod.atomic_write_json(str(tmp_path / f"{tag}.json"), obj,
                              sort_keys=True, indent=1)
    for ext in ("txt", "json"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "jax.json", "jax.txt", "port.json", "port.txt"]
