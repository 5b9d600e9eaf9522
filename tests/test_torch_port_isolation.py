"""The port stands alone: importing every module of
``deeplearning4j_tpu_torch`` pulls in neither ``jax`` nor the JAX package,
``chip_smoke.py`` imports neither, and the entry points refuse to run
without a card unless the caller asks for the CPU."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deeplearning4j_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "deeplearning4j_tpu" or m.startswith("deeplearning4j_tpu."))
print(len(names), bad)
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_importing_every_port_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 15
    assert bad == "[]"


_BLOCKED_IMPORT = """
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "deeplearning4j_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    importlib.import_module(name)
print("ok")
"""

#: the graph tier, the language tools and the readers (ROADMAP A10, A4)
NEW_MODULES = [
    "deeplearning4j_tpu_torch.graph", "deeplearning4j_tpu_torch.graph.api",
    "deeplearning4j_tpu_torch.graph.graph",
    "deeplearning4j_tpu_torch.graph.iterators",
    "deeplearning4j_tpu_torch.graph.deepwalk",
    "deeplearning4j_tpu_torch.nlp.lang", "deeplearning4j_tpu_torch.nlp.lattice",
    "deeplearning4j_tpu_torch.nlp.jax_tables",
    "deeplearning4j_tpu_torch.datasets.records",
    "deeplearning4j_tpu_torch.datasets.cifar",
    "deeplearning4j_tpu_torch.datasets.lfw",
    "deeplearning4j_tpu_torch.datasets.curves",
]


def test_new_modules_import_with_jax_blocked():
    """The graph tier, ``lang``/``lattice`` and the readers import, and a
    DeepWalk epoch, a Japanese tokenizer and a CIFAR batch run, with every
    import of ``jax`` or the JAX package refused."""
    run = _BLOCKED_IMPORT + """
from deeplearning4j_tpu_torch.graph import DeepWalk, Graph
from deeplearning4j_tpu_torch.nlp.lang import JapaneseTokenizerFactory
from deeplearning4j_tpu_torch.datasets.cifar import CifarDataSetIterator
g = Graph(6)
for i in range(6):
    g.add_edge(i, (i + 1) % 6)
DeepWalk(vector_size=4, device="cpu").fit(g, walk_length=5)
assert JapaneseTokenizerFactory().create("犬と猫").get_tokens() == [
    "犬", "と", "猫"]
assert next(iter(CifarDataSetIterator(2, 4))).features.shape == (2, 32, 32, 3)
"""
    env = _clean_env()
    env["CIFAR_DIR"] = env["HOME"] = str(ROOT / "tests" / "no_such_dir")
    out = subprocess.run([sys.executable, "-c", run] + NEW_MODULES,
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    assert not set(_imported_roots(path)) & {"jax", "jaxlib",
                                             "deeplearning4j_tpu"}


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Here, with no CUDA device, the script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, env=_clean_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.attention import flash_attention
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    conf = (NeuralNetConfiguration.builder().list()
            .layer(RnnOutputLayer(n_out=3))
            .set_input_type(inputs.recurrent(4)).build())
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiLayerNetwork(conf)
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention(q, q, q)
    assert MultiLayerNetwork(conf, device="cpu").device.type == "cpu"
    from deeplearning4j_tpu_torch.nlp import (Glove, ParagraphVectors,
                                              SequenceVectors, Word2Vec)
    from deeplearning4j_tpu_torch.nlp.serializer import (
        load_binary_word_vectors, load_txt_vectors, read_full_model)
    for cls in (Word2Vec, Glove, ParagraphVectors, SequenceVectors):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls()
        assert cls(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        Word2Vec.Builder().layer_size(4).build()
    from deeplearning4j_tpu_torch.graph import DeepWalk
    with pytest.raises(RuntimeError, match="CUDA"):
        DeepWalk()
    assert DeepWalk.Builder().device("cpu").build().device.type == "cpu"
    w2v = Word2Vec.Builder().layer_size(4).min_word_frequency(1) \
        .device("cpu").build()
    w2v.fit(["a b c a b", "c a b c"])
    assert w2v.lookup_table.syn0.device.type == "cpu"
    assert w2v.lookup_table.syn0.shape == (3, 4)
    for load in (load_txt_vectors, load_binary_word_vectors,
                 read_full_model):
        with pytest.raises(RuntimeError, match="CUDA"):
            load(__file__)
    meta = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError, match="asked for"):
        flash_attention(meta, meta, meta, device="cpu")


#: the pretraining families and the kill/resume harness (ROADMAP A6, A7)
PRETRAIN_MODULES = [
    "deeplearning4j_tpu_torch.nn.layers.pretrain",
    "deeplearning4j_tpu_torch.nn.layers.variational",
    "deeplearning4j_tpu_torch.nn.layers.training",
    "deeplearning4j_tpu_torch.gradientcheck",
    "deeplearning4j_tpu_torch.resilience.chaos",
]


def test_pretraining_modules_import_with_jax_blocked():
    """The pretraining layers, the gradient checker and the harness
    import, and an RBM + VAE + center-loss stack pretrains and takes a
    step, with every import of ``jax`` or the JAX package refused."""
    run = _BLOCKED_IMPORT + """
import numpy as np
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers.pretrain import RBM
from deeplearning4j_tpu_torch.nn.layers.training import CenterLossOutputLayer
from deeplearning4j_tpu_torch.nn.layers.variational import (
    VariationalAutoencoder)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience import chaos
conf = (NeuralNetConfiguration.builder().seed(1).list()
        .layer(RBM(n_in=5, n_out=4))
        .layer(VariationalAutoencoder(n_in=4, n_out=3,
                                      encoder_layer_sizes=(4,),
                                      decoder_layer_sizes=(4,)))
        .layer(CenterLossOutputLayer(n_in=3, n_out=2))
        .pretrain(True).build())
net = MultiLayerNetwork(conf, device="cpu").init()
rng = np.random.RandomState(0)
net.fit(DataSet(rng.rand(6, 5), np.eye(2)[rng.randint(0, 2, 6)]))
assert net._pretrain_done and net.iteration == 3
assert chaos.build_net(device="cpu").num_params() > 0
"""
    out = subprocess.run([sys.executable, "-c", run] + PRETRAIN_MODULES,
                         cwd=ROOT, env=_clean_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


#: the serving fleet, its build cache, the HTTP tier, the launcher and
#: the compile watch and step-time attributor (ROADMAP A8)
FLEET_MODULES = [
    "deeplearning4j_tpu_torch.serving.fleet",
    "deeplearning4j_tpu_torch.serving.compile_cache",
    "deeplearning4j_tpu_torch.ui", "deeplearning4j_tpu_torch.ui.storage",
    "deeplearning4j_tpu_torch.ui.stats_listener",
    "deeplearning4j_tpu_torch.ui.server",
    "deeplearning4j_tpu_torch.parallel.main",
    "deeplearning4j_tpu_torch.monitor.attribution",
    "deeplearning4j_tpu_torch.monitor.jit_watch",
]


def test_fleet_modules_import_with_jax_blocked():
    """The fleet tier imports, a router picks, a UIServer answers and a
    canary ramps, with every import of ``jax`` or the JAX package
    refused."""
    run = _BLOCKED_IMPORT + """
import json, urllib.request
from deeplearning4j_tpu_torch.deploy import FleetCanary
from deeplearning4j_tpu_torch.monitor import AlertEngine, StepAttributor
from deeplearning4j_tpu_torch.serving.fleet import FleetRouter, HashRing
from deeplearning4j_tpu_torch.ui import UIServer
ring = HashRing()
ring.add("w0")
assert ring.lookup("s") == "w0"
assert isinstance(AlertEngine().attributor, StepAttributor)
ui = UIServer(port=0).start()
doc = json.loads(urllib.request.urlopen(
    f"http://127.0.0.1:{ui.port}/healthz").read())
ui.stop()
assert doc["status"] == "ok"
router = FleetRouter(k=1, model="mlp", device="cpu")
assert router.status()["running"] is False
"""
    out = subprocess.run([sys.executable, "-c", run] + FLEET_MODULES,
                         cwd=ROOT, env=_clean_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_POD_CHILD = _BLOCKED_IMPORT + """
import runpy
import os
sys.argv = ["main", "--pod-worker", "--device", "cpu", "--coordinator",
            "127.0.0.1:" + os.environ["POD_PORT"], "--num-processes", "1",
            "--process-id", "0", "--data", "2", "--steps", "2"]
try:
    runpy.run_module("deeplearning4j_tpu_torch.parallel.main",
                     run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu")))
"""

#: the parallel tier (ROADMAP A9)
PARALLEL_MODULES = [
    "deeplearning4j_tpu_torch.parallel.mesh",
    "deeplearning4j_tpu_torch.parallel.parallel_wrapper",
    "deeplearning4j_tpu_torch.parallel.zero",
    "deeplearning4j_tpu_torch.parallel.pipeline",
    "deeplearning4j_tpu_torch.parallel.scaling",
    "deeplearning4j_tpu_torch.parallel.main",
    "deeplearning4j_tpu_torch.resilience.checkpoint",
]


def test_parallel_modules_import_with_jax_blocked():
    """The parallel tier imports, and a wrapper round, a ZeRO step and a
    pipelined step run on the CPU, with every import of ``jax`` or the
    JAX package refused; without a card its entry points refuse to run
    unless the caller asks for the CPU."""
    run = _BLOCKED_IMPORT + """
import numpy as np
import torch
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.parallel import (MeshRuntime, ParallelWrapper,
                                               PipelineParallel,
                                               ZeroShardedParallelWrapper)
from deeplearning4j_tpu_torch.parallel.main import build_pod_net
rng = np.random.RandomState(0)
batches = [DataSet(rng.randn(4, 4).astype(np.float32),
                   np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)])
           for _ in range(2)]
net = build_pod_net(device="cpu")
ParallelWrapper(net, workers=2, devices=["cpu"] * 2).fit(batches)
ZeroShardedParallelWrapper(net, workers=2, devices=["cpu"] * 2).fit(batches)
PipelineParallel(net, stages=2, microbatches=2,
                 devices=["cpu"] * 2).fit(batches)
assert net.iteration == 4
if not torch.cuda.is_available():
    for make in (lambda: MeshRuntime.local(data=1),
                 lambda: ParallelWrapper(net, workers=1),
                 lambda: build_pod_net()):
        try:
            make()
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("ran without a card")
"""
    out = subprocess.run([sys.executable, "-c", run] + PARALLEL_MODULES,
                         cwd=ROOT, env=_clean_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_WORKER_CHILD = _BLOCKED_IMPORT + """
import runpy
sys.argv = ["main", "--fleet-worker", "--device", "cpu", "--model", "mlp"]
runpy.run_module("deeplearning4j_tpu_torch.parallel.main",
                 run_name="__main__")
"""


def test_fleet_worker_child_loads_no_jax(tmp_path):
    """A fleet worker started as the router starts it, with every import
    of ``jax`` or the JAX package refused, becomes ready (its ready line
    names the CPU) and exits cleanly when its stdin closes; and a pod
    worker, the launcher's other mode, trains with neither ``jax`` nor
    the JAX package in ``sys.modules``."""
    import json
    env = _clean_env()
    env["DL4J_TPU_FLEET_COMPILE_CACHE"] = str(tmp_path / "cache")
    proc = subprocess.Popen(
        [sys.executable, "-c", _WORKER_CHILD],
        cwd=ROOT, env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        from deeplearning4j_tpu_torch.serving.fleet import wait_ready
        ready = wait_ready(proc, timeout=60)
        assert ready["fleet_worker_ready"] and ready["device"] == "cpu"
        assert ready["warmup_buckets"] == 5 and \
            ready["bucket_compiles_after_warmup"] == 5
        assert ready["cache_dir"].startswith(str(tmp_path / "cache"))
        proc.stdin.close()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    from deeplearning4j_tpu_torch.parallel.mesh import pick_coordinator_port
    env = _clean_env()
    env["POD_PORT"] = str(pick_coordinator_port())
    out = subprocess.run(
        [sys.executable, "-c", _POD_CHILD], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    report = json.loads(lines[-2])
    assert report["device"] == "cpu" and report["backend"] == "gloo"
    assert len(report["scores"]) == 2 and report["param_sha"]
    assert lines[-1] == "[]"


#: the cluster-training tier (ROADMAP A11's scaleout)
SCALEOUT_MODULES = [
    "deeplearning4j_tpu_torch.scaleout",
    "deeplearning4j_tpu_torch.scaleout.api",
    "deeplearning4j_tpu_torch.scaleout.data",
    "deeplearning4j_tpu_torch.scaleout.param_avg",
    "deeplearning4j_tpu_torch.scaleout.frontend",
    "deeplearning4j_tpu_torch.scaleout.dcn",
    "deeplearning4j_tpu_torch.scaleout.compression",
    "deeplearning4j_tpu_torch.scaleout.param_server",
    "deeplearning4j_tpu_torch.scaleout.async_trainer",
    "deeplearning4j_tpu_torch.scaleout.nlp",
]


def test_scaleout_modules_import_with_jax_blocked():
    """The cluster tier imports, and a master split, a coded push and
    pull through the TCP server and a cluster Word2Vec run on the CPU,
    with every import of ``jax`` or the JAX package refused; without a
    card its entry points refuse to run unless asked for the CPU."""
    run = _BLOCKED_IMPORT + """
import numpy as np
import torch
from deeplearning4j_tpu_torch.scaleout import (
    ClusterMultiLayer, ParameterAveragingTrainingMaster)
from deeplearning4j_tpu_torch.scaleout import async_trainer as at
from deeplearning4j_tpu_torch.scaleout.nlp import ClusterWord2Vec
from deeplearning4j_tpu_torch.scaleout.param_server import (
    ParameterServer, TcpParameterServer, TcpParameterServerClient)
net = at.build_net(device="cpu")
ClusterMultiLayer(net, ParameterAveragingTrainingMaster(
    num_workers=2, averaging_frequency=1)).fit(at.make_batches(4, 8, 0))
assert net.iteration == 2
store = ParameterServer(np.zeros(8), chunk_size=4)
srv = TcpParameterServer(store)
with TcpParameterServerClient(srv.host, srv.port, codec="topk8") as c:
    c.push_delta(np.ones(8))
    assert c.pull_coded().shape == (8,)
srv.close()
w2v = ClusterWord2Vec(num_workers=2, layer_size=4, min_word_frequency=1,
                      device="cpu").fit(["a b c a b", "c a b c"] * 2)
assert w2v.model.lookup_table.syn0.shape == (3, 4)
if not torch.cuda.is_available():
    for make in (at.build_net, lambda: at.run_sync_dp(k=1, rounds=1),
                 lambda: ClusterWord2Vec(num_workers=2)):
        try:
            make()
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("ran without a card")
"""
    out = subprocess.run([sys.executable, "-c", run] + SCALEOUT_MODULES,
                         cwd=ROOT, env=_clean_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _scaleout_child(module, *args):
    """A child running ``python -m module args`` with ``jax`` and the JAX
    package refused, printing the refused roots it loaded at exit."""
    return _BLOCKED_IMPORT + f"mod, argv = {module!r}, {list(args)!r}" + (
        _SCALEOUT_CHILD)


_SCALEOUT_CHILD = """
import runpy
sys.argv = ["child"] + argv
try:
    runpy.run_module(mod, run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu")))
"""


def test_async_worker_and_serve_children_load_no_jax():
    """The parameter server's ``--serve`` child and an async worker
    child, started as the driver starts them but with every import of
    ``jax`` or the JAX package refused: the server prints its address,
    the worker trains against it on the CPU, reports, and neither has
    ``jax`` or the JAX package in ``sys.modules``."""
    import json
    serve = subprocess.Popen(
        [sys.executable, "-c", _scaleout_child(
            "deeplearning4j_tpu_torch.scaleout.param_server", "--serve",
            "--dim", "131", "--chunk-size", "64")],
        cwd=ROOT, env=_clean_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        assert serve.stdout.readline().strip() == "ok"  # the prelude's
        addr = json.loads(serve.stdout.readline())
        worker = subprocess.run(
            [sys.executable, "-c", _scaleout_child(
                "deeplearning4j_tpu_torch.scaleout.async_trainer",
                "--worker", "--device", "cpu", "--host", addr["host"],
                "--port", str(addr["port"]), "--rank", "0", "--codec",
                "topk8", "--rounds", "3")],
            cwd=ROOT, env=_clean_env(), capture_output=True, text=True,
            timeout=120)
        assert worker.returncode == 0, worker.stderr
        lines = worker.stdout.strip().splitlines()
        report = json.loads(lines[-2])
        assert report["rounds"] == 3 and report["device"] == "cpu"
        assert lines[-1] == "[]"
        # the server child's own modules, printed when it stops
        serve.send_signal(2)
        out, err = serve.communicate(timeout=30)
        assert serve.returncode == 0, err
        assert out.strip().splitlines()[-1] == "[]"
    finally:
        if serve.poll() is None:
            serve.kill()
            serve.wait()


#: clustering, t-SNE and the streaming tier (ROADMAP A11.1, A11.2)
CLUSTERING_STREAMING_MODULES = [
    "deeplearning4j_tpu_torch.clustering",
    "deeplearning4j_tpu_torch.clustering.kmeans",
    "deeplearning4j_tpu_torch.clustering.kdtree",
    "deeplearning4j_tpu_torch.clustering.vptree",
    "deeplearning4j_tpu_torch.plot", "deeplearning4j_tpu_torch.plot.tsne",
    "deeplearning4j_tpu_torch.streaming",
    "deeplearning4j_tpu_torch.streaming.broker",
    "deeplearning4j_tpu_torch.streaming.pipeline",
    "deeplearning4j_tpu_torch.streaming.sources",
    "deeplearning4j_tpu_torch.streaming.conversion",
]


def test_clustering_and_streaming_modules_import_with_jax_blocked():
    """Clustering, t-SNE and the streaming tier import, and k-means, a
    t-SNE and a broker-fed pipeline run on the CPU, with every import of
    ``jax`` or the JAX package refused; without a card
    ``KMeansClustering``, ``Tsne`` and ``StreamingPipeline`` refuse to
    run unless asked for the CPU."""
    run = _BLOCKED_IMPORT + """
import time
import numpy as np
import torch
from deeplearning4j_tpu_torch.clustering import KMeansClustering, VPTree
from deeplearning4j_tpu_torch.plot import Tsne
from deeplearning4j_tpu_torch.nn.conf import inputs
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.streaming import (
    BrokerRecordSource, CsvRecordConverter, StreamBroker, StreamConsumer,
    StreamProducer, StreamingPipeline)
x = np.random.RandomState(0).randn(40, 3).astype(np.float32)
assert KMeansClustering(2, device="cpu").apply_to(x).cluster_count() == 2
assert VPTree(x).knn(x[0], k=2)[0][0] == 0
assert Tsne(perplexity=5.0, max_iter=5, device="cpu").fit(x).coords.shape \\
    == (40, 2)
conf = (NeuralNetConfiguration.builder().list()
        .layer(DenseLayer(n_out=4)).layer(OutputLayer(n_out=2))
        .set_input_type(inputs.feed_forward(3)).build())
net = MultiLayerNetwork(conf, device="cpu").init()
broker = StreamBroker()
prod = StreamProducer(broker.host, broker.port)
prod.produce("t", ["%f,%f,%f,%d" % (*r, i % 2) for i, r in enumerate(x)])
src = BrokerRecordSource(StreamConsumer(broker.host, broker.port, "g",
                                        ["t"]))
pipe = StreamingPipeline(net, src, CsvRecordConverter(num_classes=2),
                         mode="both", batch_size=8, device="cpu").start()
deadline = time.time() + 20
while pipe.batches_processed < 5 and time.time() < deadline:
    time.sleep(0.02)
pipe.stop()
assert pipe.batches_processed == 5 and not pipe.errors
src.close()
prod.close()
broker.close()
if not torch.cuda.is_available():
    for make in (lambda: KMeansClustering(2), lambda: Tsne(),
                 lambda: StreamingPipeline(net, src, CsvRecordConverter(
                     num_classes=2))):
        try:
            make()
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("ran without a card")
"""
    out = subprocess.run([sys.executable, "-c", run]
                         + CLUSTERING_STREAMING_MODULES, cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


NATIVE_UTILS_MODULES = [
    "deeplearning4j_tpu_torch.nativeops",
    "deeplearning4j_tpu_torch.nn.native_runtime",
    "deeplearning4j_tpu_torch.datasets.native_io",
    "deeplearning4j_tpu_torch.utils",
    "deeplearning4j_tpu_torch.utils.reference_serializer",
    "deeplearning4j_tpu_torch.utils.model_guesser",
    "deeplearning4j_tpu_torch.utils.time_series",
    "deeplearning4j_tpu_torch.utils.time_source",
    "deeplearning4j_tpu_torch.utils.parallelism",
]


def test_native_and_utils_modules_import_with_jax_blocked():
    """The native tier and the new ``utils`` modules import, and the
    native data tier, the runner and the native engine run on the CPU,
    with every import of ``jax`` or the JAX package refused; without a
    card ``NativeClient()``, a ``NativeModelRunner`` at its default device
    and ``MagicQueue()`` refuse to run unless asked for the CPU."""
    run = _BLOCKED_IMPORT + """
import numpy as np
import torch
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.nativeops import NativeClient
from deeplearning4j_tpu_torch.nn.conf import inputs
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.native_runtime import NativeModelRunner
from deeplearning4j_tpu_torch.serving import InferenceEngine
from deeplearning4j_tpu_torch.utils.parallelism import MagicQueue
x = np.random.RandomState(0).randn(16, 3).astype(np.float32)
y = np.eye(2, dtype=np.float32)[np.arange(16) % 2]
it = AsyncDataSetIterator(ListDataSetIterator(DataSet(x, y), 4,
                                              shuffle=True))
assert it.native and len(list(it)) == 4
it.close()
conf = (NeuralNetConfiguration.builder().list()
        .layer(DenseLayer(n_out=4)).layer(OutputLayer(n_out=2))
        .set_input_type(inputs.feed_forward(3)).build())
net = MultiLayerNetwork(conf, device="cpu").init()
with NativeModelRunner(net, device="cpu") as runner:
    assert np.array_equal(runner.output(x), net.output(x).numpy())
eng = InferenceEngine(net, backend="native").start()
assert eng.predict(x[:2]).shape == (2, 2)
eng.stop()
if not torch.cuda.is_available():
    for make in (lambda: NativeClient(), lambda: NativeModelRunner(net),
                 lambda: MagicQueue()):
        try:
            make()
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("ran without a card")
"""
    out = subprocess.run([sys.executable, "-c", run] + NATIVE_UTILS_MODULES,
                         cwd=ROOT, env=_clean_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         sorted(PORT.rglob("*.cu")) +
                         sorted(PORT.rglob("*.cc")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_a_path_under_native(path):
    """The port keeps its own copy of the JAX package's C++ and compiles
    nothing from ``native/``: no source names a path there."""
    text = path.read_text()
    for name in ("native/dataloader", "native/pjrt_shim", "native/Makefile",
                 "native/build", "libdl4jtpu_native"):
        assert name not in text
    # no directory named "native" joined onto a path (the JAX package's
    # os.path.join(<repo root>, "native"))
    assert not re.search(r"join\([^)]*[\"']native[\"']\)", text)


UI_CLOUD_BRIDGE_ANALYZE_MODULES = [
    "deeplearning4j_tpu_torch.ui.components",
    "deeplearning4j_tpu_torch.ui.legacy",
    "deeplearning4j_tpu_torch.ui.main",
    "deeplearning4j_tpu_torch.cloud",
    "deeplearning4j_tpu_torch.cloud.storage",
    "deeplearning4j_tpu_torch.cloud.provision",
    "deeplearning4j_tpu_torch.keras.bridge",
    "deeplearning4j_tpu_torch.analyze",
    "deeplearning4j_tpu_torch.analyze.lockgraph",
    "deeplearning4j_tpu_torch.analyze.sanitizer",
]


def test_ui_cloud_bridge_analyze_modules_import_with_jax_blocked():
    """The UI components, the legacy listeners, ``ui.main``, ``cloud/``,
    the Keras bridge and the runtime analyzers import, and the armed lock
    graph and sanitizer report into the port's registry, with every import
    of ``jax``, the JAX package or ``tools.analyze`` refused; without a
    card the bridge refuses to start unless asked for the CPU."""
    run = _BLOCKED_IMPORT.replace(
        'if root in ("jax", "jaxlib", "deeplearning4j_tpu"):',
        'if root in ("jax", "jaxlib", "deeplearning4j_tpu") or '
        'name.startswith("tools.analyze"):') + """
import os
import threading
import numpy as np
import torch
os.environ["DL4J_TPU_LOCK_DEBUG"] = "1"
os.environ["DL4J_TPU_SANITIZE"] = "1"
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.analyze import lockgraph
from deeplearning4j_tpu_torch.keras.bridge import KerasBridgeServer
from deeplearning4j_tpu_torch.monitor.jit_watch import WatchedCall
from deeplearning4j_tpu_torch.monitor.locks import make_lock
from deeplearning4j_tpu_torch.ui import components, main
a, b = make_lock("t.a"), make_lock("t.b")
assert isinstance(a, lockgraph.InstrumentedLock)
for x, y in ((a, b), (b, a)):
    with x:
        with y:
            pass
assert monitor.counter("lockgraph_cycles_total").value() == 1
f = WatchedCall(lambda t: t + 1, name="t.f")
f(torch.ones(2))
monitor.sanitize_end_warmup()
f(torch.ones(3))
assert monitor.counter("sanitizer_violations_total").value(
    kind="recompile_after_warmup") == 1
assert components.ChartLine("x").to_json().startswith('{"component_type"')
server = main.serve(["--port", "0"], block=False)
server.stop()
with KerasBridgeServer(port=0, device="cpu") as bridge:
    pass
if not torch.cuda.is_available():
    try:
        KerasBridgeServer(port=0)
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("ran without a card")
"""
    out = subprocess.run([sys.executable, "-c", run]
                         + UI_CLOUD_BRIDGE_ANALYZE_MODULES, cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "ok"
    assert "UIServer listening at http://127.0.0.1:" in out.stdout


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_tools_analyze(path):
    """The port keeps its own copies of the lock graph and the sanitizer:
    no source imports ``tools`` (the JAX package's analyzer)."""
    assert "tools" not in set(_imported_roots(path))
