"""The port's ``cloud/`` against the JAX package's: twins of every test of
``tests/test_cloud.py`` on the port's classes (local storage round trip,
backend selection and the gated SDKs, the remote iterator and its cache,
the provisioner's env, scripts and quoting, the env driving
``scaleout.dcn``), plus:

- the port's ``RemoteDataSetIterator`` reads ``.npz`` batches the JAX
  ``scaleout.data`` wrote, bitwise, and the JAX iterator reads the port's;
- both provisioners write identical ``cluster.json`` and
  ``launch_host{i}.sh`` files (bytes and modes);
- the port's ``parallel.mesh.resolve_topology`` and ``scaleout.dcn`` read
  the provisioned env.

Every comparison is exact (bytes, arrays, strings).
"""

import json
import os
import shlex
import stat

import numpy as np
import pytest

from deeplearning4j_tpu.cloud import \
    RemoteDataSetIterator as JaxRemoteDataSetIterator
from deeplearning4j_tpu.cloud import TpuPodProvisioner as JaxProvisioner
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.scaleout.data import \
    batch_and_export as jax_batch_and_export
from deeplearning4j_tpu_torch.cloud import (LocalFilesystemStorage,
                                            RemoteDataSetIterator,
                                            TpuPodProvisioner, get_storage)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.parallel import mesh
from deeplearning4j_tpu_torch.scaleout import dcn
from deeplearning4j_tpu_torch.scaleout.data import batch_and_export


# ----------------------------------------------------------------- storage

def test_local_storage_round_trip(tmp_path):
    st = LocalFilesystemStorage()
    src = tmp_path / "a.txt"
    src.write_text("hello")
    uri = f"file://{tmp_path}/bucket/key/a.txt"
    st.upload(str(src), uri)
    assert st.exists(uri)
    dest = tmp_path / "b.txt"
    st.download(uri, str(dest))
    assert dest.read_text() == "hello"
    listed = st.list(f"file://{tmp_path}/bucket")
    assert listed == [uri]
    st.delete(uri)
    assert not st.exists(uri)


def test_get_storage_selects_backend(tmp_path):
    assert isinstance(get_storage(str(tmp_path)), LocalFilesystemStorage)
    assert isinstance(get_storage(f"file://{tmp_path}"),
                      LocalFilesystemStorage)
    with pytest.raises((ImportError, NotImplementedError)):
        get_storage("s3://bucket/key")
    with pytest.raises((ImportError, NotImplementedError)):
        get_storage("gs://bucket/key")


def _batches(seed, n=5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 3).astype(np.float32),
             np.eye(2, dtype=np.float32)[rng.randint(0, 2, 8)])
            for _ in range(n)]


def test_remote_dataset_iterator(tmp_path):
    batches = [DataSet(x, y) for x, y in _batches(0)]
    export_dir = str(tmp_path / "export")
    batch_and_export(batches, export_dir, batch_size=8)
    cache = str(tmp_path / "cache")
    it = RemoteDataSetIterator(export_dir, cache_dir=cache)
    out = list(it)
    assert len(out) == 5
    assert out[0].features.shape == (8, 3)
    # second pass hits the cache (files already downloaded)
    it.reset()
    assert len(list(it)) == 5
    assert len(os.listdir(cache)) == 5


def test_remote_iterator_empty_prefix_raises(tmp_path):
    with pytest.raises(ValueError):
        RemoteDataSetIterator(str(tmp_path))


def test_get_storage_rejects_unknown_scheme():
    with pytest.raises(ValueError, match="unsupported storage scheme"):
        get_storage("hdfs://bucket/data")


def test_remote_iterator_no_basename_collision(tmp_path):
    """Same-named objects in different prefixes must cache separately."""
    for shard, val in (("shard0", 0.0), ("shard1", 1.0)):
        d = tmp_path / "data" / shard
        d.mkdir(parents=True)
        np.savez(d / "dataset_0.npz",
                 features=np.full((4, 2), val, np.float32),
                 labels=np.eye(2, dtype=np.float32)[[0, 1, 0, 1]])
    it = RemoteDataSetIterator(str(tmp_path / "data"),
                               cache_dir=str(tmp_path / "cache"))
    out = list(it)
    assert len(out) == 2
    vals = sorted(float(np.asarray(b.features)[0, 0]) for b in out)
    assert vals == [0.0, 1.0]


def test_remote_iterator_batch_does_not_consume(tmp_path):
    batches = [DataSet(x, y) for x, y in _batches(0, 3)]
    batch_and_export(batches, str(tmp_path / "e"), batch_size=8)
    it = RemoteDataSetIterator(str(tmp_path / "e"))
    it.reset()
    next(it)
    next(it)
    assert it.batch() == 8
    assert it._pos == 2                # batch() must not move the cursor
    next(it)
    with pytest.raises(StopIteration):
        next(it)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_other_packages_batches(tmp_path, writer):
    """``.npz`` minibatches written by one package's ``scaleout.data``
    come out of the other package's iterator bitwise, in the same order,
    through a ``file://`` bucket."""
    raw = _batches(4, 12)
    src = str(tmp_path / "export")
    if writer == "jax":
        jax_batch_and_export([JaxDataSet(x, y) for x, y in raw], src)
    else:
        batch_and_export([DataSet(x, y) for x, y in raw], src)
    uri = f"file://{src}"
    reader = RemoteDataSetIterator if writer == "jax" else \
        JaxRemoteDataSetIterator
    got = list(reader(uri, cache_dir=str(tmp_path / "cache")))
    # the listing is sorted by name: dataset_0, dataset_1, dataset_10, ...
    order = sorted(range(len(raw)), key=lambda i: f"dataset_{i}.npz")
    assert len(got) == len(raw)
    for ds, i in zip(got, order):
        x, y = raw[i]
        assert np.array_equal(np.asarray(ds.features), x)
        assert np.asarray(ds.features).dtype == np.float32
        assert np.array_equal(np.asarray(ds.labels), y)


def test_the_port_iterator_trains_a_net_like_the_list(tmp_path):
    """The remote batches fitted on the CPU give the params of a fit over
    the same batches in memory (the same ingest path), bitwise."""
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ExistingDataSetIterator
    from serving_pairs import dense_conf, port_net
    rng = np.random.RandomState(2)
    raw = [(rng.randn(8, 4).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)])
           for _ in range(4)]
    batch_and_export([DataSet(x, y) for x, y in raw],
                     str(tmp_path / "b"))
    remote = port_net(dense_conf())
    plain = port_net(dense_conf())
    plain.set_flat_params(remote.get_flat_params())
    remote.fit(RemoteDataSetIterator(f"file://{tmp_path}/b"),
               ingest="batch")
    plain.fit(ExistingDataSetIterator([DataSet(x, y) for x, y in raw]),
              ingest="batch")
    assert np.array_equal(remote.get_flat_params(), plain.get_flat_params())


# ------------------------------------------------------------ provisioning

def test_provisioner_env_matches_dcn_contract():
    p = TpuPodProvisioner(4, "10.0.0.1", command="python train.py")
    env = p.host_env(2)
    assert env["COORDINATOR_ADDRESS"] == "10.0.0.1:8476"
    assert env["NUM_PROCESSES"] == "4"
    assert env["PROCESS_ID"] == "2"
    with pytest.raises(ValueError):
        p.host_env(4)


def test_provisioner_write_scripts(tmp_path):
    p = TpuPodProvisioner(2, "host0", coordinator_port=9999,
                          command="python -m train",
                          env={"EXTRA": "1"})
    paths = p.write(str(tmp_path / "out"))
    assert len(paths) == 3             # cluster.json + 2 scripts
    spec = json.loads(open(paths[0]).read())
    assert spec["num_processes"] == 2
    assert spec["hosts"][1]["env"]["PROCESS_ID"] == "1"
    script = open(paths[2]).read()
    assert "export COORDINATOR_ADDRESS=host0:9999" in script
    assert "export EXTRA=1" in script
    assert script.rstrip().endswith("exec python -m train")
    assert os.stat(paths[1]).st_mode & stat.S_IXUSR


def test_provisioner_shell_quotes_hostile_env():
    p = TpuPodProvisioner(1, "h", env={"TOKEN": "a'b$HOME`x`"})
    script = p.launch_script(0)
    assert f"export TOKEN={shlex.quote(chr(97)+chr(39)+'b$HOME`x`')}" \
        in script


def test_provisioner_env_drives_dcn_initialize(monkeypatch):
    """The emitted env is exactly what ``scaleout.dcn.initialize_from_env``
    reads: one process records the topology and forms no group."""
    monkeypatch.setattr(mesh, "_initialized", None)
    p = TpuPodProvisioner(1, "127.0.0.1")
    for k, v in p.host_env(0).items():
        monkeypatch.setenv(k, v)
    assert dcn.initialize_from_env(device="cpu") is False
    assert mesh._initialized == {"coordinator": "127.0.0.1:8476",
                                 "num_processes": 1, "process_id": 0}


@pytest.mark.parametrize("hosts,extra", [
    (1, {}), (3, {"EXTRA": "1", "TOKEN": "a'b$HOME`x`"})])
def test_both_provisioners_write_identical_files(tmp_path, hosts, extra):
    cmd = ("python -m deeplearning4j_tpu_torch.parallel.main --pod-worker "
           "--steps 8")
    paths = {}
    for side, cls in (("jax", JaxProvisioner), ("port", TpuPodProvisioner)):
        paths[side] = cls(hosts, "10.1.2.3", coordinator_port=9911,
                          command=cmd, env=extra).write(
            str(tmp_path / side))
    assert [os.path.basename(p) for p in paths["port"]] == \
        [os.path.basename(p) for p in paths["jax"]]
    for a, b in zip(paths["port"], paths["jax"]):
        assert open(a, "rb").read() == open(b, "rb").read()
        assert os.stat(a).st_mode == os.stat(b).st_mode


def test_resolve_topology_reads_the_provisioned_env():
    p = TpuPodProvisioner(4, "10.0.0.9", coordinator_port=1234)
    for pid in range(4):
        assert mesh.resolve_topology(env=p.host_env(pid)) == {
            "coordinator": "10.0.0.9:1234", "num_processes": 4,
            "process_id": pid}
    # flags come first, as for the JAX package's dcn
    assert mesh.resolve_topology(process_id=3, env=p.host_env(0))[
        "process_id"] == 3
