"""LFM2-MoE on the card (marked ``gpu``; every test skips without a CUDA
device, decided inside the fixture).  This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_lfm2_gpu.py

A small network under ``mixed_bf16`` (hidden 128, 4 query and 2 KV heads
of 32, 8 experts of 64, top-2, conv, attention, conv, the first dense)
trains through the epoch cache's captured step: four replayed steps
against four eager per-batch steps over the same batches, K1-K3 named by
the profiler in every replayed step's attention layer (their wrappers
count nothing in a replay), the routing counters counting every replay,
and ``output()`` of the trained network.  The two paths run the same
kernels on the same values except where the eager path's allocator
hands another workspace to cuBLAS, so their params are held at 1e-2 of
each leaf's norm, not bit for bit.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

KW = dict(vocab_size=1024, hidden_size=128,
          layer_types=("conv", "full_attention", "conv"),
          num_dense_layers=1, intermediate_size=256,
          moe_intermediate_size=64, num_experts=8, num_experts_per_tok=2,
          num_attention_heads=4, num_key_value_heads=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_the_captured_lfm2_step_trains_as_the_eager_one(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.lfm2 import lfm2_moe
    from deeplearning4j_tpu_torch.monitor import moe as moe_monitor
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import attention as A

    def build():
        return MultiLayerNetwork(lfm2_moe(**KW), device=cuda).init()
    ids = np.random.RandomState(3).randint(0, 1024, (8, 257))
    ds = DataSet(ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32))
    eager, captured = build(), build()
    assert captured._pol().name == "mixed_bf16"
    eager.fit(ListDataSetIterator(ds, 2), ingest="batch")
    captured.fit(ListDataSetIterator(ds, 2), ingest="cache")
    assert captured._graphs
    A.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        captured.fit(ListDataSetIterator(ds, 2), ingest="cache")
        torch.cuda.synchronize()
    assert set(A.LAUNCHES.values()) == {0}
    eager.fit(ListDataSetIterator(ds, 2), ingest="batch")
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    for kernel in ("flash_fwd_sm90_kernel", "flash_bwd_dkdv_sm90_kernel",
                   "flash_bwd_dq_sm90_kernel"):
        assert sum(kernel in n for n in names) == 4       # 4 steps, 1 layer
    assert any("GroupProblemShape" in n for n in names)
    _, counts = moe_monitor.expert_tokens(captured)
    assert (counts.sum(1) == 8 * 2 * 256 * 2).all()   # 8 steps of 2 x 256
    for (k, p), (_, q) in zip(captured.param_table().items(),
                              eager.param_table().items()):
        gap = np.linalg.norm(p - q) / max(np.linalg.norm(q), 1e-30)
        assert gap < 1e-2, k
    assert abs(captured.score() - eager.score()) < 1e-2 * eager.score()
    out = captured.output(ds.features[:2])
    assert out.shape == (2, 256, 1024)
    torch.testing.assert_close(out.sum(-1), torch.ones(2, 256,
                                                       device=cuda))
