"""Clustering, t-SNE and the streaming pipeline on the card against the
port's CPU runs.  Marked ``gpu``: without a CUDA device every test skips
(the decision is made inside the fixture).  This file imports no JAX, so
it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_clustering_gpu.py

- k-means: one Lloyd step on the card picks the CPU's centers for rows
  that lie near the boundaries between centers (a relative margin of
  1e-4 in the squared distances), with TF32 switched on for the
  process's matmuls: the loop computes its distances in IEEE float32
  anyway, where the same distances in TF32 (a x c^T rounded to ~5e-4)
  flip some of them; a whole ``apply_to`` on tie-free blobs gives the
  CPU's assignments for both metrics;
- t-SNE: 10 iterations of each path from the same seeded draws, card vs
  CPU at 1e-4 of the largest coordinate (learning rate 10, as in the
  parity tests);
- the streaming pipeline's predictions on the card against the CPU
  network on the same weights, 1e-5 of max.
"""

import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.clustering import KMeansClustering
from deeplearning4j_tpu_torch.plot import Tsne

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _near_boundary_blobs(k=6, per=400, d=256, seed=0):
    """Blobs, and half their rows moved to just inside the boundary to a
    neighbouring center: ||x - c_own||^2 is (1 - 1e-4) of ||x - c_other||^2
    (in float64), so a float32 distance keeps the pick and a TF32 one
    need not."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 4.0
    x = np.concatenate([c + rng.randn(per, d) for c in centers])
    own = np.repeat(np.arange(k), per)
    for i in range(0, len(x), 2):
        a, b = centers[own[i]], centers[(own[i] + 1) % k]
        mid, axis = (a + b) / 2.0, (a - b) / np.linalg.norm(a - b)
        off = x[i] - mid
        off -= off.dot(axis) * axis                 # on the bisector
        half = np.linalg.norm(a - b) / 2.0
        # d_own^2 - d_other^2 = -4 t half: a 1e-4 relative margin
        t = 1e-4 * (off.dot(off) + half ** 2) / (4.0 * half)
        x[i] = mid + off + t * axis
    return x.astype(np.float32), centers


def test_assignment_on_the_card_equals_the_cpu_under_tf32(cuda):
    """One Lloyd step from the generating centers: the near-boundary rows
    keep the CPU's picks on the card with TF32 switched on for the
    process, while the same distances in TF32 flip some of them."""
    from deeplearning4j_tpu_torch.clustering import kmeans as K
    x, centers = _near_boundary_blobs()
    pts = torch.as_tensor(x, device=cuda)
    c = torch.as_tensor(centers.astype(np.float32), device=cuda)
    want = K.lloyd(torch.as_tensor(x), c.cpu(), 6, 1, False)[1].numpy()
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        got = K.lloyd(pts, c, 6, 1, False)[1].cpu().numpy()
        tf32 = K._assign(pts, c, False).to(torch.int32).cpu().numpy()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    np.testing.assert_array_equal(got, want)
    assert (tf32 != want).sum() > 0


@pytest.mark.parametrize("metric", ["euclidean", "cosinesimilarity"])
def test_kmeans_on_the_card_equals_the_cpu(cuda, metric):
    rng = np.random.RandomState(4)
    x = np.concatenate([c + rng.randn(300, 64) for c in
                        rng.randn(5, 64) * 4]).astype(np.float32)
    card = KMeansClustering(5, 100, metric, seed=3, n_init=2, device=cuda)
    got = card.apply_to(x)
    want = KMeansClustering(5, 100, metric, seed=3, n_init=2,
                            device="cpu").apply_to(x)
    np.testing.assert_array_equal(got.assignments, want.assignments)
    np.testing.assert_allclose(got.centers, want.centers, rtol=1e-5,
                               atol=1e-5 * np.abs(want.centers).max())
    assert card.host_reads == sum(card.iterations) + 4


@pytest.mark.parametrize("tiled", [False, True], ids=["exact", "tiled"])
def test_tsne_on_the_card_equals_the_cpu(cuda, tiled):
    rng = np.random.RandomState(1)
    x = np.concatenate([c + rng.randn(150, 16) for c in
                        rng.randn(4, 16) * 3]).astype(np.float32)
    kw = dict(perplexity=20.0, max_iter=10, learning_rate=10.0, seed=5)
    if tiled:
        kw.update(tile_threshold=256, block_size=128)
    got = Tsne(device=cuda, **kw).fit(x)
    want = Tsne(device="cpu", **kw).fit(x)
    scale = np.abs(want.coords).max()
    np.testing.assert_allclose(got.coords, want.coords, rtol=0,
                               atol=1e-4 * scale)
    assert got.kl_divergence == pytest.approx(want.kl_divergence, rel=1e-4)


def test_pipeline_predictions_on_the_card_equal_the_cpu(cuda):
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.core import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.streaming import (CsvRecordConverter,
                                                    InMemoryRecordSource,
                                                    StreamingPipeline)
    conf = (NeuralNetConfiguration.builder().seed(3).compute_dtype("float32")
            .list().layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=3))
            .set_input_type(inputs.feed_forward(8)).build())
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    net = MultiLayerNetwork(conf, device=cuda).init()
    net.set_flat_params(cpu.get_flat_params())
    rng = np.random.RandomState(2)
    rows = [",".join(f"{v:.4f}" for v in rng.randn(8)) for _ in range(20)]
    outs = []
    src = InMemoryRecordSource()
    src.offer_all(rows)
    pipe = StreamingPipeline(net, src, CsvRecordConverter(label_index=None),
                             batch_size=8, flush_interval=0.3, device=cuda,
                             on_prediction=lambda x, o: outs.append((x, o)))
    with pipe:
        deadline = time.time() + 30
        while pipe.batches_processed < 3 and time.time() < deadline:
            time.sleep(0.01)
    assert pipe.batches_processed == 3 and not pipe.errors
    for x, out in outs:
        want = cpu.output(x).numpy()
        np.testing.assert_allclose(out, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
