"""The parallel tier across cards (needs two or more CUDA devices; skips
otherwise, here and on a one-card machine): a K=2 NCCL pod, one rank a
card, bitwise equal to the 1-process run of the same mesh, and a
ParallelWrapper over ``cuda:0, cuda:1`` bitwise equal to one card named
twice.  Run alone on a machine with several cards:
``python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_parallel_gpu.py -q``."""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    yield [torch.device("cuda", 0), torch.device("cuda", 1)]
    torch.use_deterministic_algorithms(False)


def test_nccl_pod_of_two_cards_is_bitwise_the_one_process_run(two_cards):
    from deeplearning4j_tpu_torch.parallel.main import run_pod
    multi = run_pod(k=2, data=2, mode="dp", steps=6, device="cuda",
                    timeout=300)
    single = run_pod(k=1, data=2, mode="dp", steps=6, device="cuda",
                     timeout=300)
    assert multi["returncodes"] == [0, 0], multi["stderr_tail"]
    assert single["returncodes"] == [0], single["stderr_tail"]
    assert [r["backend"] for r in multi["reports"]] == ["nccl", "nccl"]
    assert [r["device"] for r in multi["reports"]] == ["cuda:0", "cuda:1"]
    assert multi["scores"] == single["scores"]
    assert multi["param_sha"] == single["param_sha"]
    assert multi["reaped"] and single["reaped"]


def test_wrapper_over_two_cards_is_bitwise_one_card_named_twice(two_cards):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel.main import build_pod_net
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    rng = np.random.RandomState(0)
    batches = [DataSet(rng.randn(16, 4).astype(np.float32),
                       np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)])
               for _ in range(8)]

    def run(devices):
        net = build_pod_net(device="cuda:0")
        ParallelWrapper(net, workers=2, averaging_frequency=2,
                        devices=devices).fit(batches)
        return net.get_flat_params(), net.get_flat_updater_state()

    spread = run(two_cards)
    one = run([two_cards[0]] * 2)
    np.testing.assert_array_equal(spread[0], one[0])
    np.testing.assert_array_equal(spread[1], one[1])
