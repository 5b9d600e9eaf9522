"""The port stands alone: importing every module of
``deeplearning4j_tpu_torch`` pulls in neither ``jax`` nor the JAX package,
``chip_smoke.py`` imports neither, and the entry points refuse to run
without a card unless the caller asks for the CPU."""

import ast
import os
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
