"""The updater's fused Adam kernel on the card (marked ``gpu``; every test
skips without a CUDA device, decided inside the fixture).  This file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_updater_gpu.py

``adam_master_step_kernel`` (``ops/csrc/adam_update.cu``) against the
torch ops it replaces (``updaters.apply_layer_updates`` with the dispatch
seeing no card), bit for bit on the card: three steps in a row, in both
forms, bf16 and f32 gradients, bf16 and f32 params beside fp32 masters,
sizes 1, 7, 4097 and 2^20 + 3, views off 16 bytes (the scalar path),
alpha as a host float and as a captured graph's f64 table entry.  Then a
small LFM2 trained through the epoch cache's captured step: the profiler
names the kernel once an Adam leaf in every replayed step, the counter
reads every leaf fused and in place at the capture, the params stay within
1e-2 of each leaf's norm of eager steps (cuBLAS's workspaces keep the two
paths from being bitwise, as ``tests/test_torch_lfm2_gpu.py`` says), and a
warm-up step leaves the static trees bitwise as they were.
"""

import types

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

MIXED = types.SimpleNamespace(updater_dtype=torch.float32,
                              master_weights=True)
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


def _conf():
    from deeplearning4j_tpu_torch.nn import updaters
    return updaters.UpdaterConfig(updater="adam", learning_rate=1e-2,
                                  adam_mean_decay=0.9, adam_var_decay=0.95)


def _layer():
    from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer
    return DenseLayer(n_in=1, n_out=1)


def _offset(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a contiguous view one element into a buffer:
    its pointer is off 16 bytes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _leaves(n, g_dtype, device, unaligned):
    """A bf16 and an f32 param of ``n`` values, their Adam state with fp32
    masters, and three steps of gradients growing 10x a step."""
    from deeplearning4j_tpu_torch.nn import updaters
    gen = torch.Generator(device=device).manual_seed(n)
    params = {"p16": torch.randn(n, generator=gen, device=device).to(
        torch.bfloat16),
        "p32": torch.randn(n, generator=gen, device=device)}
    state = updaters.init_state(_conf(), params, MIXED)
    grads = [{k: (torch.randn(n, generator=gen, device=device)
                  * 10.0 ** (s - 1)).to(g_dtype) for k in params}
             for s in range(3)]
    if unaligned:
        params = {k: _offset(v) for k, v in params.items()}
        state = {name: {k: _offset(v) for k, v in tree.items()}
                 for name, tree in state.items()}
        grads = [{k: _offset(v) for k, v in g.items()} for g in grads]
    return params, state, grads


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _assert_bitwise(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_bitwise(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k


def _by_ops(monkeypatch, *a, **k):
    from deeplearning4j_tpu_torch.nn import updaters
    from deeplearning4j_tpu_torch.ops import adam
    with monkeypatch.context() as mp, torch.no_grad():
        mp.setattr(adam, "on_card", lambda *tensors: False)
        return updaters.apply_layer_updates(*a, **k)


@pytest.mark.parametrize("unaligned", [False, True],
                         ids=["aligned", "off16"])
@pytest.mark.parametrize("n", [1, 7, 4097, 2 ** 20 + 3])
@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32],
                         ids=["g_bf16", "g_f32"])
@pytest.mark.parametrize("in_place", [False, True],
                         ids=["out_of_place", "in_place"])
def test_the_kernel_is_the_torch_ops_bit_for_bit(cuda, monkeypatch,
                                                 in_place, g_dtype, n,
                                                 unaligned):
    from deeplearning4j_tpu_torch.nn import updaters
    from deeplearning4j_tpu_torch.ops import adam
    params, state, grads = _leaves(n, g_dtype, cuda, unaligned)
    if unaligned:
        assert all(t.data_ptr() % 16 for t in params.values())
    want_p, want_s = _clone(params), _clone(state)
    adam.reset_launches()
    for step in range(3):
        want_p, want_s = _by_ops(monkeypatch, _conf(), _layer(), want_p,
                                 want_s, grads[step], step)
        with torch.no_grad():
            got_p, got_s = updaters.apply_layer_updates(
                _conf(), _layer(), params, state, grads[step], step,
                in_place=in_place)
        torch.cuda.synchronize()
        assert (got_p["p16"] is params["p16"]) == in_place
        _assert_bitwise(got_p, want_p)
        _assert_bitwise(got_s, want_s)
        params, state = got_p, got_s
    assert adam.LAUNCHES["adam_master_step"] == 3 * 2


def test_a_leaf_off_the_kernels_layout_takes_it_or_fails_loudly(
        cuda, monkeypatch):
    """A leaf whose master and moments are transposed views takes the
    kernel all the same: out of place it reads contiguous copies, bitwise
    the torch ops; in place, which cannot write such a view, it raises."""
    from deeplearning4j_tpu_torch.nn import updaters
    from deeplearning4j_tpu_torch.ops import adam
    gen = torch.Generator(device=cuda).manual_seed(11)
    params = {"w": torch.randn(33, 65, generator=gen, device=cuda).to(
        torch.bfloat16)}
    state = updaters.init_state(_conf(), params, MIXED)
    state = {name: {"w": tree["w"].t().contiguous().t()}
             for name, tree in state.items()}
    assert not state["m"]["w"].is_contiguous()
    grads = {"w": torch.randn(33, 65, generator=gen, device=cuda).to(
        torch.bfloat16)}
    want = _by_ops(monkeypatch, _conf(), _layer(), _clone(params),
                   _clone(state), grads, 0)
    adam.reset_launches()
    with torch.no_grad():
        got = updaters.apply_layer_updates(_conf(), _layer(), params, state,
                                           grads, 0)
        torch.cuda.synchronize()
        assert adam.LAUNCHES["adam_master_step"] == 1
        _assert_bitwise(got[0], want[0])
        _assert_bitwise(got[1], want[1])
        with pytest.raises(ValueError, match="contiguous"):
            updaters.apply_layer_updates(_conf(), _layer(), params, state,
                                         grads, 0, in_place=True)


def test_a_captured_kernel_reads_alpha_from_the_step_table(cuda,
                                                           monkeypatch):
    """In a CUDA graph, alpha is the step table's f64 entry the graph
    selects by a device counter: three replays, in place, equal three
    eager torch-op steps with host alphas."""
    from deeplearning4j_tpu_torch.nn import updaters
    conf = _conf()
    params, state, grads = _leaves(4097, torch.bfloat16, cuda, False)
    want_p, want_s = _clone(params), _clone(state)
    for step in range(3):
        want_p, want_s = _by_ops(monkeypatch, conf, _layer(), want_p,
                                 want_s, grads[step], step)
    table = torch.tensor([updaters.step_scalars(conf, s)["alpha"]
                          for s in range(3)], dtype=torch.float64,
                         device=cuda)
    ctr = torch.zeros(1, dtype=torch.long, device=cuda)
    g = _clone(grads[0])
    with torch.no_grad():       # the library loads outside the capture
        updaters.apply_layer_updates(conf, _layer(), _clone(params),
                                     _clone(state), g, 0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        alpha = table.index_select(0, ctr).reshape(())
        updaters.apply_layer_updates(conf, _layer(), params, state, g, 0,
                                     scalars={"alpha": alpha},
                                     in_place=True)
        ctr.add_(1)
    for step in range(3):
        for k in g:
            g[k].copy_(grads[step][k])
        graph.replay()
    torch.cuda.synchronize()
    _assert_bitwise(params, want_p)
    _assert_bitwise(state, want_s)


def test_the_captured_lfm2_step_takes_the_kernel_in_place(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.lfm2 import lfm2_moe
    from deeplearning4j_tpu_torch.monitor import metrics
    from deeplearning4j_tpu_torch.nn import step_graph, updaters
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import adam

    def build():
        return MultiLayerNetwork(lfm2_moe(**KW), device=cuda).init()

    def counted():
        c = metrics.registry().counter(updaters.LEAVES_COUNTER)
        return {(path, form): c.value(rule="adam", path=path, form=form)
                for path in ("fused", "ops")
                for form in ("in_place", "out_of_place")}

    def delta(a, b):
        return {k: b[k] - a[k] for k in a if b[k] != a[k]}

    ids = np.random.RandomState(3).randint(0, 1024, (8, 257))
    ds = DataSet(ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32))
    eager, captured = build(), build()
    assert captured._pol().name == "mixed_bf16"
    leaves = sum(len(updaters.updatable_params(layer, captured.params[key]))
                 for key, layer in captured._slots())
    c0 = counted()
    eager.fit(ListDataSetIterator(ds, 2), ingest="batch")
    c1 = counted()
    assert delta(c0, c1) == {("fused", "out_of_place"): 4 * leaves}, (
        leaves, delta(c0, c1))
    captured.fit(ListDataSetIterator(ds, 2), ingest="cache")
    c2 = counted()
    # two warm-up steps out of place, the capture in place
    assert delta(c1, c2) == {("fused", "out_of_place"): 2 * leaves,
                             ("fused", "in_place"): leaves}, (
        leaves, delta(c1, c2))
    adam.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        captured.fit(ListDataSetIterator(ds, 2), ingest="cache")
        torch.cuda.synchronize()
    assert adam.LAUNCHES["adam_master_step"] == 0, adam.LAUNCHES
    assert delta(c2, counted()) == {}                # replays count nothing
    eager.fit(ListDataSetIterator(ds, 2), ingest="batch")
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    fused = sum("adam_master_step_kernel" in n for n in names)
    assert fused == 4 * leaves, (fused, leaves)      # 4 steps
    for (k, p), (_, q) in zip(captured.param_table().items(),
                              eager.param_table().items()):
        gap = np.linalg.norm(p - q) / max(np.linalg.norm(q), 1e-30)
        assert gap < 1e-2, (k, gap)
    (step,) = captured._graphs.values()
    st = captured._static
    before = _clone({"p": dict(enumerate(
        p for _, t in captured._items(st.params) for p in t.values())),
        "u": dict(enumerate(
            u for _, t in captured._items(st.updater_state)
            for tree in t.values() for u in tree.values()))})
    step._compute(step_graph._discard)          # a warm-up step
    torch.cuda.synchronize()
    after = {"p": dict(enumerate(
        p for _, t in captured._items(st.params) for p in t.values())),
        "u": dict(enumerate(
            u for _, t in captured._items(st.updater_state)
            for tree in t.values() for u in tree.values()))}
    _assert_bitwise(after, before)
