"""The last modules on the card, at small sizes (``chip_smoke.py`` phase
25's (a), (d) and (e) in miniature).  Marked ``gpu``: without a CUDA device
every test skips (the decision is made inside the fixture).  This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_ui_cloud_gpu.py

- a narrow LeNet fitted from a ``file://`` bucket through
  ``RemoteDataSetIterator`` equals, bitwise, a plain fit over a
  ``ListDataSetIterator`` of the same batches (deterministic cuDNN), and
  the legacy listeners on it give ``np.histogram`` of ``param_table()``
  and the grids of an eager ``feed_forward``;
- armed (``DL4J_TPU_LOCK_DEBUG=1``, ``DL4J_TPU_SANITIZE=1``): the captured
  epoch-cache fit and a decode session across cache-len hops count their
  dispatches at the budgets' ceilings, with no violation and no lock
  cycle;
- the Keras bridge on the card: ``predict`` over TCP bitwise
  ``output()``, ``save`` over the wire restoring the params bytewise.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.analyze import lockgraph, sanitizer
from deeplearning4j_tpu_torch.cloud import (LocalFilesystemStorage,
                                            RemoteDataSetIterator)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.keras.bridge import (KerasBridgeClient,
                                                   KerasBridgeServer)
from deeplearning4j_tpu_torch.nn.conf import inputs
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers.attention import CausalSelfAttention
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    ConvolutionLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.scaleout.data import DataSetExportFunction
from deeplearning4j_tpu_torch.serving import InferenceEngine
from deeplearning4j_tpu_torch.ui.legacy import (
    ConvolutionalIterationListener, HistogramIterationListener,
    activation_grid, host_map)
from deeplearning4j_tpu_torch.utils.model_serializer import \
    restore_multi_layer_network

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def deterministic_cudnn():
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = prev


def _lenet(device):
    conf = (NeuralNetConfiguration.builder().seed(3).updater("adam")
            .learning_rate(1e-3).weight_init("xavier")
            .activation("identity").list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(5, 5)))
            .layer(SubsamplingLayer(pooling_type="max"))
            .layer(ConvolutionLayer(n_out=8, kernel_size=(5, 5)))
            .layer(SubsamplingLayer(pooling_type="max"))
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(inputs.convolutional_flat(28, 28, 1)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 784).astype(np.float32),
            np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])


class _Witness:
    def __init__(self, probe, every):
        self.probe, self.every, self.tables, self.grids = probe, every, {}, {}

    def iteration_done(self, model, iteration):
        if iteration % self.every:
            return
        self.tables[iteration] = model.param_table()
        self.grids[iteration] = [activation_grid(host_map(a[0]))
                                 for a in model.feed_forward(self.probe)
                                 if a.ndim == 4]


def test_bucket_fit_equals_the_plain_fit_with_the_listeners(
        cuda, deterministic_cudnn, tmp_path):
    x, y = _data(8 * 64)
    export = DataSetExportFunction(str(tmp_path / "export"))
    storage = LocalFilesystemStorage()
    for i in range(8):
        rows = slice(i * 64, (i + 1) * 64)
        storage.upload(export(DataSet(x[rows], y[rows])),
                       f"file://{tmp_path}/bucket/batch_{i:04d}.npz")
    remote, plain = _lenet(cuda), _lenet(cuda)
    plain.set_flat_params(remote.get_flat_params())
    hist = HistogramIterationListener(frequency=4)
    conv = ConvolutionalIterationListener(
        x[:4], frequency=4, output_dir=str(tmp_path / "png"))
    witness = _Witness(x[:4], 4)
    remote.set_listeners(hist, conv, witness)
    remote.fit(RemoteDataSetIterator(f"file://{tmp_path}/bucket"),
               ingest="batch")
    plain.fit(ListDataSetIterator(DataSet(x, y), 64), ingest="batch")
    assert remote.get_flat_params().tobytes() == \
        plain.get_flat_params().tobytes()
    for name, (it, edges, counts) in hist.histograms.items():
        want_counts, want_edges = np.histogram(witness.tables[8][name],
                                               bins=hist.bins)
        assert it == 8
        assert np.array_equal(counts, want_counts)
        assert np.array_equal(edges, want_edges)
    assert len(conv.written) == 2 * len(witness.grids[8]) == 8


def test_armed_cache_fit_and_decode_session_meet_their_ceilings(
        cuda, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_LOCK_DEBUG", "1")
    monkeypatch.setenv("DL4J_TPU_SANITIZE", "1")
    lockgraph.reset()
    sanitizer.reset()
    monitor.reset()
    try:
        net = _lenet(cuda)
        x, y = _data(8 * 64 + 16, seed=1)
        src = ListDataSetIterator(DataSet(x, y), 64)
        net.fit(src, ingest="cache")
        monitor.sanitize_end_warmup()
        net.fit(src, epochs=2, ingest="cache")
        assert sanitizer.state().enforced()["fit.epoch_cache"] == {
            "occurrences": 2, "dispatches": 4, "ceilings": 4}

        conf = (NeuralNetConfiguration.builder().seed(5).list()
                .layer(CausalSelfAttention(n_out=16, n_heads=4,
                                           cache_len=32))
                .layer(RnnOutputLayer(n_out=4, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(inputs.recurrent(8, 16)).build())
        att = MultiLayerNetwork(conf, device=cuda).init()
        tok = np.random.RandomState(2).randn(20, 1, 8).astype(np.float32)
        with InferenceEngine(att, max_batch_size=1, max_latency_ms=1,
                             timestep_buckets=(16,)) as engine:
            engine.warmup((16, 8))
            engine.warmup_decode((8,))
            monitor.sanitize_end_warmup()
            for t in range(20):
                engine.predict_session("s", tok[t])
            engine.predict(np.zeros((1, 16, 8), np.float32))
        dec = sanitizer.state().enforced()["serving.decode_step"]
        assert dec["occurrences"] == 19
        assert dec["dispatches"] == dec["ceilings"] == 19 + 5  # 5 hops
        assert sanitizer.violations() == []
        assert monitor.gauge("lockgraph_edges").value() > 0
        lockgraph.graph().assert_acyclic()
    finally:
        lockgraph.reset()
        sanitizer.reset()


def test_the_bridge_serves_a_card_net(cuda, tmp_path):
    net = _lenet(cuda)
    x = _data(64, seed=4)[0]
    with KerasBridgeServer(port=0) as server:
        mid = server.register(net)
        client = KerasBridgeClient(server.host, server.port)
        try:
            got = np.asarray(client.call("predict", model_id=mid,
                                         features=x.tolist())["output"],
                             np.float32)
            path = client.call("save", model_id=mid,
                               path=str(tmp_path / "net.zip"))["path"]
        finally:
            client.close()
    assert server.entry.device.type == "cuda"
    want = net.output(x).detach().float().cpu().numpy()
    assert np.array_equal(got, want)
    back = restore_multi_layer_network(path, device=cuda)
    assert back.get_flat_params().tobytes() == \
        net.get_flat_params().tobytes()
