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
