"""``check_pretrain_gradients`` of the port (``gradientcheck.py``) in
float64 on the CPU: it passes for every AutoEncoder and every VAE
distribution (as the JAX package's check does on the same network), on a
graph vertex, fails on a VAE whose step flips the KL term's sign, and
refuses the RBM (contrastive divergence is the gradient of no loss).
Networks: ``tests/pretrain_pairs.py``.
"""

import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
from deeplearning4j_tpu.gradientcheck import \
    check_pretrain_gradients as jax_check_pretrain
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.gradientcheck import check_pretrain_gradients
from deeplearning4j_tpu_torch.nn.layers import pretrain as ppre
from pretrain_pairs import (AE, DISTS, _data, _ids, _pair, _stack,
                            pretrain_conf)


# ------------------------------------------------ gradient checks (f64)
@pytest.mark.parametrize("case", [("ae", c) for c in AE]
                         + [("vae", d) for d in DISTS], ids=_ids)
def test_check_pretrain_gradients_passes_in_f64(case):
    kind, c = case
    jnet, pnet = _pair(_stack(kind, c))
    x, y = _data()
    assert check_pretrain_gradients(pnet, DataSet(x, y), 0)
    assert jax_check_pretrain(jnet, JDS(x, y), 0)


def test_check_pretrain_gradients_catches_a_wrong_kl_sign_and_refuses_cd():
    _, pnet = _pair(_stack("vae", "gaussian"))
    x, y = _data()
    layer = pnet.layers[0]

    def wrong(params, x_, draws):
        mean, log_sigma2 = layer._posterior(params, x_)
        flipped = (0.5 / x_.shape[0]) * torch.sum(
            1.0 + log_sigma2 - mean * mean - torch.exp(log_sigma2))
        kl = (-0.5 / x_.shape[0]) * torch.sum(
            1.0 + log_sigma2 - mean * mean - torch.exp(log_sigma2))
        return layer.pretrain_loss(params, x_, draws) - kl + flipped

    layer.pretrain_grads = lambda p, x_, d: ppre.autograd_pretrain_grads(
        wrong, p, x_, d)
    assert not check_pretrain_gradients(pnet, DataSet(x, y), 0)
    _, rnet = _pair(_stack("rbm", ("binary", "binary", 1)))
    with pytest.raises(ValueError, match="contrastive divergence"):
        check_pretrain_gradients(rnet, DataSet(x, y), 0)


def test_check_pretrain_gradients_on_a_graph_vertex():
    jnet, pnet = _pair(pretrain_conf(graph=True), graph=True)
    x, y = _data()
    assert check_pretrain_gradients(pnet, DataSet(x, y), "ae")
