"""The port's ZeRO-1 wrapper (``parallel/zero.py``) against the JAX
package's single-process big-batch ``fit`` on the concatenated batch (not
against the JAX ZeRO wrapper, whose ``tests/test_zero_sharding.py`` cases
are red: ROADMAP C), for every stateful updater, over several steps, with
gradient normalization, l2 before normalization, masks weighted by their
count and frozen layers; plus the sharded n-fold state, the ``mixed_bf16``
fp32 master slice, the synced model state and the refusals.  The port
runs ``devices=["cpu"] * w``.

Tolerances: float64 nets at 1e-10 (sgd, adagrad, rmsprop, adadelta) and
1e-8 (adam, nesterovs: the JAX updater keeps their betas and momentum in
float32); the flat float32 updater-state vectors at 2 ulp (2.5e-7) and
1e-9 absolute; the ``mixed_bf16`` masters against the JAX big-batch masters at 2e-3 (bf16
forwards over 8 rows against one over 32 round differently).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.jax_weights import load_jax_params
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.zero import \
    ZeroShardedParallelWrapper

RTOL = {"sgd": 1e-10, "adagrad": 1e-10, "rmsprop": 1e-10,
        "adadelta": 1e-10, "adam": 1e-8, "nesterovs": 1e-8}
STATE_RTOL = 2.5e-7


def _conf(updater="adam", lr=0.05, l2=0.0, grad_norm=None, seed=77,
          dtype="float64"):
    b = (JConf.builder().seed(seed).updater(updater).learning_rate(lr)
         .activation("tanh").weight_init("xavier").dtype(dtype))
    if l2:
        b = b.l2(l2)
    if grad_norm:
        b = b.gradient_normalization(grad_norm)
    return (b.list()
            .layer(jcore.DenseLayer(n_out=8))
            .layer(jcore.OutputLayer(n_out=3))
            .set_input_type(jin.feed_forward(4))
            .build())


def _pair(jconf):
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    load_jax_params(pnet, np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _batches(n, b=8, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        X = rng.randn(b, 4)
        y = np.eye(3)[(X[:, 0] > 0).astype(int) + (X[:, 1] > 0).astype(int)]
        out.append((X, y))
    return out


def _zero(pnet, w):
    return ZeroShardedParallelWrapper(pnet, workers=w, devices=["cpu"] * w)


def _big(batches):
    return JDS(np.concatenate([x for x, _ in batches]),
               np.concatenate([y for _, y in batches]))


def _close(jnet, pnet, rtol):
    np.testing.assert_allclose(pnet.get_flat_params(),
                               np.asarray(jnet.get_flat_params()),
                               rtol=rtol, atol=rtol)


@pytest.mark.parametrize("updater", ["sgd", "adam", "rmsprop", "nesterovs",
                                     "adagrad", "adadelta"])
def test_zero_matches_jax_single_process_big_batch(updater):
    w = 4
    batches = _batches(w)
    jnet, pnet = _pair(_conf(updater))
    _zero(pnet, w).fit([DataSet(x, y) for x, y in batches])
    jnet.fit(_big(batches))
    _close(jnet, pnet, RTOL[updater])
    assert float(pnet._score) == pytest.approx(float(jnet._score),
                                               rel=RTOL[updater])


def test_zero_multi_step_convergence_matches():
    w = 4
    jnet, pnet = _pair(_conf("adam", l2=1e-3))
    zw = _zero(pnet, w)
    for step in range(5):
        batches = _batches(w, seed=step)
        zw.fit([DataSet(x, y) for x, y in batches])
        jnet.fit(_big(batches))
    _close(jnet, pnet, 1e-8)
    np.testing.assert_allclose(pnet.get_flat_updater_state(),
                               np.asarray(jnet.get_flat_updater_state()),
                               rtol=STATE_RTOL, atol=1e-9)
    assert pnet.iteration == jnet.iteration == 5


@pytest.mark.parametrize("kw", [
    dict(updater="sgd", grad_norm="ClipL2PerLayer"),
    dict(updater="sgd", l2=0.1, grad_norm="RenormalizeL2PerLayer")],
    ids=["gradnorm", "l2_then_gradnorm"])
def test_zero_regularizes_then_normalizes_as_jax(kw):
    w = 2
    batches = _batches(w)
    jnet, pnet = _pair(_conf(**kw))
    _zero(pnet, w).fit([DataSet(x, y) for x, y in batches])
    jnet.fit(_big(batches))
    _close(jnet, pnet, 1e-10)


def test_zero_syncs_model_updater_state():
    """After ZeRO training a plain ``fit`` resumes with the trained adam
    moments, as the JAX big-batch net does."""
    w = 4
    batches = _batches(w)
    jnet, pnet = _pair(_conf("adam"))
    _zero(pnet, w).fit([DataSet(x, y) for x, y in batches])
    jnet.fit(_big(batches))
    np.testing.assert_allclose(pnet.get_flat_updater_state(),
                               np.asarray(jnet.get_flat_updater_state()),
                               rtol=STATE_RTOL, atol=1e-9)
    x, y = _batches(1, b=32, seed=99)[0]
    pnet.fit(DataSet(x, y))
    jnet.fit(JDS(x, y))
    _close(jnet, pnet, 1e-8)


def test_zero_weights_masks_by_count():
    """Masked time series: each shard's masked mean weighs by its mask
    count, so the fold equals one big masked batch."""
    w = 2
    jconf = (JConf.builder().seed(5).updater("sgd").learning_rate(0.1)
             .weight_init("xavier").dtype("float64").list()
             .layer(jrec.GravesLSTM(n_in=3, n_out=6, activation="tanh"))
             .layer(jrec.RnnOutputLayer(n_in=6, n_out=2)).build())
    rng = np.random.RandomState(8)
    raw = []
    for _ in range(w):
        f = rng.randn(4, 5, 3)
        l = np.eye(2)[rng.randint(0, 2, (4, 5))]
        mask = (rng.rand(4, 5) > 0.3).astype(np.float64)
        mask[:, 0] = 1.0
        raw.append((f, l, mask))
    jnet, pnet = _pair(jconf)
    _zero(pnet, w).fit([DataSet(f, l, features_mask=m, labels_mask=m)
                        for f, l, m in raw])
    cat = [np.concatenate([r[i] for r in raw]) for i in range(3)]
    jnet.fit(JDS(cat[0], cat[1], features_mask=cat[2], labels_mask=cat[2]))
    _close(jnet, pnet, 1e-10)


def test_zero_respects_frozen_layers():
    """A frozen layer stays fixed even when l2 would decay it; the head
    moves as the JAX big-batch step moves it."""
    jconf = _conf(updater="adam", lr=0.05, l2=0.01)
    jnet, pnet = _pair(jconf)
    pnet.conf.layers[0].frozen = True
    jnet.conf.layers[0].frozen = True
    rng = np.random.RandomState(0)
    batches = [(rng.randn(8, 4), np.eye(3)[rng.randint(0, 3, 8)])
               for _ in range(4)]
    w0 = pnet.params[0]["W"].clone()
    head0 = pnet.params[1]["W"].clone()
    _zero(pnet, 4).fit([DataSet(x, y) for x, y in batches])
    jnet.fit(_big(batches))
    assert torch.equal(pnet.params[0]["W"], w0)
    assert not torch.allclose(pnet.params[1]["W"], head0)
    _close(jnet, pnet, 1e-8)


def test_zero_state_is_sharded_n_fold():
    w = 4
    _, pnet = _pair(_conf("adam"))
    zw = _zero(pnet, w)
    total = pnet.get_flat_params().size
    assert zw.state_elements_per_replica() == 2 * (-(-total // w))
    assert zw.state_elements_per_replica() < 2 * total / (w - 1)
    assert sorted(zw.state_tree()) == ["m", "v"]
    assert zw.state_tree()["m"].global_shape == (w, -(-total // w))
    # the gauge counts every zero slot's slice (one process holds all)
    assert monitor.gauge("mesh_updater_state_bytes").value(
        axis="zero") == 2 * w * (-(-total // w)) * 8


def test_zero_keeps_the_mixed_bf16_masters_in_the_shard():
    """Under mixed_bf16 the fp32 master slice is part of the sharded
    state: the params are the masters cast to bf16, and the masters track
    the JAX big-batch step's."""
    w = 4
    jconf = _conf("adam", dtype="bfloat16")
    jnet, pnet = _pair(jconf)
    assert pnet._pol().master_weights
    zw = _zero(pnet, w)
    total = pnet.get_flat_params().size
    shard = -(-total // w)
    tree = zw.state_tree()
    assert sorted(tree) == [U.MASTER_KEY, "m", "v"]
    assert tree[U.MASTER_KEY].dtype == torch.float32
    assert zw.state_elements_per_replica() == 3 * shard
    for step in range(2):
        batches = [(np.float32(x), np.float32(y))
                   for x, y in _batches(w, seed=step)]
        zw.fit([DataSet(x, y) for x, y in batches])
        jnet.fit(_big(batches))
    masters = torch.cat([zw._state[z][U.MASTER_KEY] for z in range(w)])
    flat = torch.cat([p.reshape(-1) for layer in pnet.params
                      for _, p in sorted(layer.items())])
    assert torch.equal(masters[:total].to(torch.bfloat16), flat)
    jm = np.concatenate([np.asarray(jnet.updater_state[i][U.MASTER_KEY][k],
                                    np.float32).ravel()
                         for i in range(2)
                         for k in sorted(jnet.updater_state[i][
                             U.MASTER_KEY])])
    np.testing.assert_allclose(masters[:total].numpy(), jm, atol=2e-3)


def test_zero_rejects_per_layer_updater_overrides_and_lars():
    from deeplearning4j_tpu.nn.updaters import UpdaterConfig
    jconf = (JConf.builder().seed(1).updater("sgd").learning_rate(0.1)
             .weight_init("xavier").list()
             .layer(jcore.DenseLayer(n_out=8,
                                     updater=UpdaterConfig(updater="adam")))
             .layer(jcore.OutputLayer(n_out=3))
             .set_input_type(jin.feed_forward(4)).build())
    _, pnet = _pair(jconf)
    with pytest.raises(ValueError, match="ONE updater config"):
        _zero(pnet, 2)
    _, lars = _pair(_conf("lars"))
    with pytest.raises(ValueError, match="lars"):
        _zero(lars, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ZeroShardedParallelWrapper(pnet, workers=2)


def test_zero_pads_an_incomplete_last_group_by_cycling():
    """Three batches over four replicas: the group is padded with the
    first batch again (the JAX package's rule), which weighs it twice in
    the big-batch equivalent."""
    batches = _batches(3)
    jnet, pnet = _pair(_conf("sgd"))
    _zero(pnet, 4).fit([DataSet(x, y) for x, y in batches])
    jnet.fit(_big(batches + batches[:1]))
    _close(jnet, pnet, 1e-10)
