"""The updater's fused Adam step (``ops/adam.py``) on the CPU: the f32
constants the kernel takes against the ones PyTorch multiplies and adds
by, and ``apply_layer_updates``' dispatch (which leaves take the kernel,
in which form, and the ``updater_leaves_total`` counter).  The kernel
itself runs only on the card (``tests/test_torch_updater_gpu.py`` holds
it against the torch ops bit for bit); here ``on_card`` is patched so
that the dispatch takes CPU tensors, and ``master_step`` is a stand-in
that keeps the kernel's contract (the tensors each form writes and
returns) and computes its values with ``compute_update``'s Adam, so
Adam's arithmetic lives in one place."""

import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.monitor import metrics
from deeplearning4j_tpu_torch.nn import step_graph, updaters
from deeplearning4j_tpu_torch.nn.conf import inputs
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.layers.training import \
    CenterLossOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import adam

CONF = updaters.UpdaterConfig(updater="adam", learning_rate=1e-2,
                              adam_mean_decay=0.9, adam_var_decay=0.95)
MIXED = types.SimpleNamespace(updater_dtype=torch.float32,
                              master_weights=True)
#: a bf16 leaf and an f32 one (both get fp32 masters), odd sizes
SHAPES = {"W": ((33, 7), torch.bfloat16), "b": ((7,), torch.float32)}


def make_params(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=gen).to(d)
            for k, (s, d) in SHAPES.items()}


def make_grads(step, g_dtype, seed=0):
    gen = torch.Generator().manual_seed(1000 * seed + step + 1)
    return {k: (torch.randn(s, generator=gen) * 10.0 ** (step - 1)).to(
        g_dtype) for k, (s, _) in SHAPES.items()}


def layer(**kw):
    return DenseLayer(n_in=33, n_out=7, **kw)


def leaves_counted(**labels):
    return metrics.registry().counter(updaters.LEAVES_COUNTER).value(
        **labels)


def same(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


def assert_trees_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k])
        else:
            assert same(got[k], want[k]), k


def cloned(tree):
    return {k: cloned(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def stand_in(conf=CONF):
    """``adam.master_step`` on the CPU for Adam of ``conf``'s decays: the
    tensors it writes and returns in each form (``adam._outputs``), the
    values ``compute_update``'s Adam and the master write give."""
    def master_step(g, w, m, v, storage, alpha, sc, in_place):
        w1, m1, v1, p1, p_out = adam._outputs(w, m, v, storage, in_place)
        u, new = updaters.compute_update(
            conf, {"x": g.float()}, {"m": {"x": m}, "v": {"x": v}}, 0,
            params={"x": w}, scalars={"alpha": alpha})
        nw = w - u["x"]
        for dst, src in ((w1, nw), (m1, new["m"]["x"]),
                         (v1, new["v"]["x"])):
            dst.copy_(src)
        if p_out is not None:
            p_out.copy_(nw.to(p_out.dtype))
        return w1, m1, v1, p1
    return master_step


@pytest.fixture
def card(monkeypatch):
    """The dispatch sees every tensor as on the card, and the stand-in
    runs in the kernel's place."""
    monkeypatch.setattr(adam, "on_card", lambda *tensors: True)
    monkeypatch.setattr(adam, "master_step", stand_in())


def by_ops(monkeypatch, fn, *a, **k):
    """``fn(*a, **k)`` with the dispatch seeing no card: the torch ops."""
    with monkeypatch.context() as mp, torch.no_grad():
        mp.setattr(adam, "on_card", lambda *tensors: False)
        return fn(*a, **k)


@pytest.mark.parametrize("b1, b2", [(0.9, 0.999), (0.9, 0.95), (0.8, 0.99),
                                    (0.5, 0.3)])
def test_the_kernels_constants_are_the_f32_scalars_torch_applies(b1, b2):
    """``adam.scalars`` rounds b1, 1 - b1, b2, 1 - b2 and eps to the f32
    values PyTorch multiplies and adds an f32 tensor by, so each of the
    kernel's correctly rounded f32 operations gives the op's bits."""
    sc = adam.scalars(b1, b2, 1e-8)
    x = torch.randn(4097, generator=torch.Generator().manual_seed(9))
    x = torch.cat([x, x * 1e-30, x * 1e30, x.abs().sqrt()])
    for host, f32 in ((b1, sc.b1), (1 - b1, sc.omb1), (b2, sc.b2),
                      (1 - b2, sc.omb2)):
        assert torch.equal(host * x, torch.tensor(f32) * x), host
    assert torch.equal(x + 1e-8, x + torch.tensor(sc.eps))
    assert all(float(np.float32(c)) == c for c in sc)


@pytest.mark.parametrize("kind", ["plain", "l1_l2", "normalized"])
@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("in_place", [False, True], ids=["out_of_place",
                                                         "in_place"])
def test_adam_with_masters_on_the_card_takes_the_kernel(
        card, monkeypatch, in_place, g_dtype, kind):
    """Adam with fp32 masters on the card runs every leaf through the
    kernel (here its stand-in), bitwise the torch ops over three steps, with
    the layer's regularization and normalization applied first; in place
    it returns the very tensors it was given, written, else new ones and
    leaves its inputs as they were.  Each leaf counts once, as fused in
    the form asked for."""
    kw = {"plain": {}, "l1_l2": {"l1": 1e-3, "l2": 1e-2},
          "normalized": {"gradient_normalization": "clipl2perlayer",
                         "gradient_normalization_threshold": 0.5}}[kind]
    form = "in_place" if in_place else "out_of_place"
    params = make_params(1)
    state = updaters.init_state(CONF, params, MIXED)
    want_p, want_s = cloned(params), cloned(state)
    for step in range(3):
        grads = make_grads(step, g_dtype, 1)
        before = leaves_counted(rule="adam", path="fused", form=form)
        ops_before = leaves_counted(rule="adam", path="ops",
                                    form="out_of_place")
        old_p, old_s = cloned(params), cloned(state)
        want_p, want_s = by_ops(monkeypatch, updaters.apply_layer_updates,
                                CONF, layer(**kw), want_p, want_s, grads,
                                step)
        assert leaves_counted(rule="adam", path="ops",
                              form="out_of_place") == ops_before + 2
        got_p, got_s = updaters.apply_layer_updates(
            CONF, layer(**kw), params, state, grads, step,
            in_place=in_place)
        assert leaves_counted(rule="adam", path="fused",
                              form=form) == before + 2
        assert_trees_equal(got_p, want_p)
        assert_trees_equal(got_s, want_s)
        for k in params:
            for new, old in ((got_p[k], params[k]),
                             (got_s["m"][k], state["m"][k]),
                             (got_s["v"][k], state["v"][k]),
                             (got_s[updaters.MASTER_KEY][k],
                              state[updaters.MASTER_KEY][k])):
                assert (new is old) == in_place
        if not in_place:
            assert_trees_equal(params, old_p)
            assert_trees_equal(state, old_s)
        params, state = got_p, got_s


def test_the_f32_param_of_an_out_of_place_step_is_its_master(card):
    """As ``.to(float32)`` returns the new master itself, the fused step's
    f32 leaf comes back as its master's tensor; a bf16 leaf as its own."""
    params = make_params(2)
    state = updaters.init_state(CONF, params, MIXED)
    p, s = updaters.apply_layer_updates(CONF, layer(), params, state,
                                        make_grads(0, torch.bfloat16, 2), 0)
    assert p["b"] is s[updaters.MASTER_KEY]["b"]
    assert p["W"] is not s[updaters.MASTER_KEY]["W"]
    assert p["W"].dtype == torch.bfloat16


def test_f32_params_without_masters_take_the_kernel(card, monkeypatch):
    """Adam over f32 params with no masters shares the kernel (the param
    is its own master), bitwise the ops."""
    params = {k: v.float() for k, v in make_params(3).items()}
    state = updaters.init_state(CONF, params, None)
    assert updaters.MASTER_KEY not in state
    grads = {k: v.float() for k, v in make_grads(0, torch.float32, 3).items()}
    want = by_ops(monkeypatch, updaters.apply_layer_updates, CONF, layer(),
                  cloned(params), cloned(state), grads, 0)
    before = leaves_counted(rule="adam", path="fused", form="in_place")
    got = updaters.apply_layer_updates(CONF, layer(), params, state, grads,
                                       0, in_place=True)
    assert leaves_counted(rule="adam", path="fused",
                          form="in_place") == before + 2
    assert got[0]["W"] is params["W"]
    assert_trees_equal(got[0], want[0])
    assert_trees_equal(got[1], want[1])


def test_a_leaf_the_kernel_cannot_write_in_place_fails_loudly(monkeypatch):
    """Engagement reads the rule, the device and the dtypes, not the
    layout: a leaf on the card whose moment is not contiguous takes the
    kernel, and the in-place form, which cannot write it, raises."""
    monkeypatch.setattr(adam, "on_card", lambda *tensors: True)
    params = make_params(5)
    state = updaters.init_state(CONF, params, MIXED)
    state["m"]["W"] = torch.zeros(7, 33).t()
    assert not state["m"]["W"].is_contiguous()
    grads = make_grads(0, torch.bfloat16, 5)
    assert updaters._fused_leaves(CONF, grads, state[updaters.MASTER_KEY],
                                  state, params) == ("W", "b")
    with pytest.raises(ValueError, match="contiguous"):
        updaters.apply_layer_updates(CONF, layer(), params, state, grads, 0,
                                     in_place=True)


def _spy(monkeypatch):
    seen = []
    real = adam.master_step

    def spy(g, *a, **k):
        seen.append(tuple(g.shape))
        return real(g, *a, **k)
    monkeypatch.setattr(adam, "master_step", spy)
    return seen


@pytest.mark.parametrize("case", ["nesterovs", "cpu", "frozen", "direct"])
def test_what_does_not_take_the_kernel(monkeypatch, case):
    """Nesterov, tensors on the CPU, a frozen layer and a
    ``direct_update_params`` leaf (CenterLoss's centers) go around the
    kernel; the counter names the ops for every updater leaf (none for a
    frozen layer, which updates nothing)."""
    if case != "cpu":
        monkeypatch.setattr(adam, "on_card", lambda *tensors: True)
    monkeypatch.setattr(adam, "master_step", stand_in())
    seen = _spy(monkeypatch)
    conf, lay = CONF, layer()
    params = make_params(4)
    if case == "nesterovs":
        conf = updaters.UpdaterConfig(updater="nesterovs", learning_rate=0.1)
    elif case == "frozen":
        lay = layer(frozen=True)
    elif case == "direct":
        lay = CenterLossOutputLayer(n_in=33, n_out=7, alpha=0.3)
        params["cL"] = torch.randn(7, 33).to(torch.bfloat16)
    rule = conf.updater.lower()
    upd = updaters.updatable_params(lay, params)
    state = updaters.init_state(conf, upd, MIXED)
    grads = {k: torch.randn(p.shape).to(torch.bfloat16)
             for k, p in params.items()}
    fused = leaves_counted(rule=rule, path="fused", form="out_of_place")
    ops = leaves_counted(rule=rule, path="ops", form="out_of_place")
    new_p, _ = updaters.apply_layer_updates(conf, lay, params, state, grads,
                                            0)
    fused = leaves_counted(rule=rule, path="fused",
                           form="out_of_place") - fused
    ops = leaves_counted(rule=rule, path="ops", form="out_of_place") - ops
    if case == "direct":
        # W and b through the kernel; the centers by p -= g, uncounted
        assert sorted(seen) == [(7,), (33, 7)]
        assert (fused, ops) == (2, 0)
        want = (params["cL"].float() - grads["cL"].float()).to(torch.bfloat16)
        assert same(new_p["cL"], want)
    else:
        assert seen == []
        assert (fused, ops) == ((0, 0) if case == "frozen" else (0, 2))


def _dense_net():
    return MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(7).updater("adam")
        .learning_rate(1e-2).activation("tanh").list()
        .layer(DenseLayer(n_out=16)).layer(OutputLayer(n_out=3))
        .set_input_type(inputs.feed_forward(9)).build(),
        device="cpu").init()


def _data():
    rng = np.random.RandomState(5)
    return DataSet(rng.randn(24, 9).astype(np.float32),
                   np.eye(3, dtype=np.float32)[rng.randint(0, 3, 24)])


def test_a_mixed_bf16_fit_is_the_same_through_the_kernel(monkeypatch):
    """A mixed_bf16 network fit batch by batch (eager, out of place)
    through the kernel's dispatch ends bitwise where the torch ops end;
    its four leaves count as fused, out of place, each step."""
    monkeypatch.setenv("DL4J_TPU_PRECISION", "mixed_bf16")
    ops_net, fused_net = _dense_net(), _dense_net()
    assert ops_net._pol().name == "mixed_bf16"
    ops_net.fit(ListDataSetIterator(_data(), 8), ingest="batch")
    monkeypatch.setattr(adam, "on_card", lambda *tensors: True)
    monkeypatch.setattr(adam, "master_step",
                        stand_in(fused_net._updater_conf(0)))
    before = leaves_counted(rule="adam", path="fused", form="out_of_place")
    fused_net.fit(ListDataSetIterator(_data(), 8), ingest="batch")
    assert leaves_counted(rule="adam", path="fused",
                          form="out_of_place") == before + 3 * 4
    np.testing.assert_array_equal(fused_net.get_flat_params(),
                                  ops_net.get_flat_params())
    np.testing.assert_array_equal(fused_net.get_flat_updater_state(),
                                  ops_net.get_flat_updater_state())


def test_the_captured_steps_sink_finds_the_kernels_leaves_in_place(
        monkeypatch):
    """``_updated`` with the captured step's sink (``_commit``, whose
    ``in_place`` asks for the kernel's in-place form) writes each fused
    leaf into the network's own tensors, which ``_commit`` then leaves alone; the trees
    equal an out-of-place step's bit for bit."""
    monkeypatch.setenv("DL4J_TPU_PRECISION", "mixed_bf16")
    net = _dense_net()
    monkeypatch.setattr(adam, "on_card", lambda *tensors: True)
    monkeypatch.setattr(adam, "master_step", stand_in(net._updater_conf(0)))
    gen = torch.Generator().manual_seed(8)
    flat = [torch.randn(p.shape, generator=gen).to(p.dtype)
            for _, tree in net._items(net.params) for p in tree.values()]
    want_p, want_u = by_ops(monkeypatch, net._updated,
                            cloned_tree(net.params),
                            cloned_tree(net.updater_state), flat, 0)
    copies = []
    real = torch._foreach_copy_
    monkeypatch.setattr(torch, "_foreach_copy_",
                        lambda dst, src: (copies.append(len(dst)),
                                          real(dst, src)))
    before = [p for _, tree in net._items(net.params) for p in tree.values()]
    got_p, got_u = net._updated(net.params, net.updater_state, flat, 0,
                                sink=step_graph._commit)
    assert copies == []
    after = [p for _, tree in net._items(got_p) for p in tree.values()]
    assert all(a is b for a, b in zip(after, before))
    for (_, g), (_, w) in zip(net._items(got_p), net._items(want_p)):
        assert_trees_equal(g, w)
    for (_, g), (_, w) in zip(net._items(got_u), net._items(want_u)):
        assert_trees_equal(g, w)


def cloned_tree(tree):
    if isinstance(tree, dict):
        return {k: cloned_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cloned_tree(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree
