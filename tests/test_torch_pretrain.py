"""The pretraining layers of the port (``nn/layers/pretrain.py``:
AutoEncoder, RBM) against the JAX package's, on the CPU.

Each network is built in the JAX package, read by the port from its JSON
(the same bytes back), given the same weights and fed the JAX step's
random draws (``tests/pretrain_pairs.py``).  For every AutoEncoder
(dense, sparse, corrupted, both) and RBM (each unit pair, k = 1 and 2):
the supervised forward, the layer's pretrain score and gradients, three
``pretrain_layer`` steps and one ``fit`` step; then the RBM's free energy
and the network's own draw stream.  The VAE is in
``tests/test_torch_pretrain_vae.py``.

Tolerances: float64 networks 1e-10 (of max|JAX| for params and outputs,
relative for scores), float32 1e-5.  Only SGD is compared in float64 over
several steps: the JAX package keeps Adam's moments in float32 there
(about 1e-9 apart), so Adam is compared on params in float32.  The RBM is
compared in float64, where ``u < p`` cannot flip on a rounding
difference; in its one float32 case a flip would show as an O(1) gap.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.layers import pretrain as ppre
from pretrain_pairs import (CASES, N, TOL, _close, _data, _flat, _ids,
                            _pair, _port_of, _stack, check_layer_case)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != "vae"],
                         ids=_ids)
def test_layer_forward_pretrain_grads_and_steps_match_jax(case):
    check_layer_case(case)


@pytest.mark.parametrize("case", [("ae", "sparse_corrupted"),
                                  ("rbm", ("binary", "binary", 1))],
                         ids=_ids)
def test_float32_adam_pretrain_matches_jax(case):
    kind, c = case
    jnet, pnet = _pair(_stack(kind, c, "float32", "adam", 0.01))
    x, y = _data("float32", binary=kind == "rbm")
    jnet.pretrain_layer(0, JDS(x, y), epochs=2)
    pnet.pretrain_layer(0, DataSet(x, y), epochs=2)
    np.testing.assert_allclose(float(pnet._score), float(jnet._score),
                               rtol=TOL["float32"])
    _close(_flat(pnet), _flat(jnet), TOL["float32"])


def test_rbm_free_energy_and_propagation_match_jax():
    jnet, pnet = _pair(_stack("rbm", ("binary", "binary", 1)))
    x, _ = _data(binary=True)
    jl, pl = jnet.layers[0], pnet.layers[0]
    jp, pp = jnet.params[0], pnet.params[0]
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(float(pl.free_energy(pp, xt)),
                               float(jl.free_energy(jp, x)), rtol=1e-12)
    _close(pl.prop_down(pp, pl.prop_up(pp, xt)),
           jl.prop_down(jp, jl.prop_up(jp, x)), 1e-12)


def test_own_draws_follow_the_seed_and_the_iteration():
    def run(seed):
        conf = _stack("ae", "corrupted")
        conf.conf.seed = seed
        net = _port_of(conf)
        x, y = _data()
        net.pretrain_layer(0, DataSet(x, y), epochs=2)
        return _flat(net)
    assert np.array_equal(run(3), run(3))
    assert not np.array_equal(run(3), run(4))
    assert ppre.pretrain_seed(3, 0) != ppre.pretrain_seed(3, 1)


def test_bad_draws_are_refused():
    net = _port_of(_stack("rbm", ("binary", "binary", 1)))
    x, y = _data(binary=True)
    net.pretrain_draw_source = lambda layer, it, specs: [
        np.zeros((N + 1, 4)), None, None]
    with pytest.raises(ValueError, match="pretrain_draw_source"):
        net.pretrain_layer(0, DataSet(x, y))
