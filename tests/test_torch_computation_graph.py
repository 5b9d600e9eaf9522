"""The port's ComputationGraph (``nn/conf/computation_graph.py``,
``nn/computation_graph.py``) against the JAX package's: every vertex's
forward and gradient (ties of ``max`` included), the topological order
and its errors, identical ``to_json`` text, shape inference with the
auto-inserted preprocessors, a linear graph equal to the
MultiLayerNetwork, multi-input multi-output fit steps with masks, L-BFGS,
listeners, ``evaluate``, ``score_examples``, truncated BPTT,
``rnn_time_step``, ``decode_step``, graph sessions and engine
``predict``, ``check_gradients_graph`` and ``clone``.  Each pair of
networks loads the same weights (JAX ``get_flat_params`` into the port).

Tolerances: float64 networks at 1e-12 of max|JAX| for outputs, scores
and SGD steps (updates at a learning rate exact in float32: the JAX
package keeps the updater's hyperparameters in float32, so an adam or
nesterovs step in float64 differs by the rounding of its betas, ~1e-8
relative); float32 networks at 1e-5 (f32 sums in another order);
vertex gradients in float64 at 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.gradientcheck import \
    check_gradients_graph as jax_check_graph
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.conf import computation_graph as jcg
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import pretrain as jpretrain
from deeplearning4j_tpu.nn.layers import convolution as jconvl
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.optimize.listeners.listeners import \
    CollectScoresIterationListener as JaxCollect
from deeplearning4j_tpu.serving.sessions import SessionCache as JaxSessions
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.gradientcheck import check_gradients_graph
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import computation_graph as cg
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.jax_weights import load_jax_params
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners.listeners import \
    CollectScoresIterationListener
from deeplearning4j_tpu_torch.serving import InferenceEngine, SessionCache

F64 = 1e-12
F32 = 1e-5
B, T = 4, 5


def _close(got, want, tol):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(initial=0.0),
                                              1e-30))


def _port_conf(jconf):
    return ComputationGraphConfiguration.from_json(jconf.to_json())


def _pair(jconf):
    jnet = JaxCG(jconf).init()
    pnet = ComputationGraph(_port_conf(jconf), device="cpu").init()
    load_jax_params(pnet, np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _builder(dtype="float64", updater="sgd", lr=0.0625, seed=3, l2=1e-3):
    return (JaxConf.builder().seed(seed).dtype(dtype).updater(updater)
            .learning_rate(lr).activation("tanh").weight_init("xavier")
            .l2(l2).graph_builder())


def _all_vertex_conf(dtype="float64", updater="sgd", lr=0.0625):
    """Two inputs (a masked sequence and a vector), two outputs (listed
    in the other order than their insertion), every vertex type, an
    auto-inserted cnn_to_ff preprocessor."""
    g = (_builder(dtype, updater, lr).add_inputs("seq", "vec")
         .add_layer("lstm", jrec.GravesLSTM(n_out=6), "seq")
         .add_vertex("last", jcg.LastTimeStepVertex(mask_input="seq"),
                     "lstm")
         .add_layer("dv", jcore.DenseLayer(n_out=6), "vec"))
    for op in ("add", "subtract", "product", "average", "max"):
        g.add_vertex(op, jcg.ElementWiseVertex(op=op), "last", "dv")
    return (g.add_vertex("merge", jcg.MergeVertex(), "add", "subtract",
                         "product", "average", "max")
            .add_vertex("subset", jcg.SubsetVertex(from_index=2,
                                                   to_index=13), "merge")
            .add_vertex("scale", jcg.ScaleVertex(scale_factor=0.5),
                        "subset")
            .add_vertex("shift", jcg.ShiftVertex(shift_factor=0.1), "scale")
            .add_vertex("l2n", jcg.L2NormalizeVertex(), "shift")
            .add_vertex("stack", jcg.StackVertex(), "l2n", "shift")
            .add_layer("shared", jcore.DenseLayer(n_out=5), "stack")
            .add_vertex("u0", jcg.UnstackVertex(from_index=0, stack_size=2),
                        "shared")
            .add_vertex("u1", jcg.UnstackVertex(from_index=1, stack_size=2),
                        "shared")
            .add_vertex("l2", jcg.L2Vertex(), "u0", "u1")
            .add_vertex("img", jcg.PreprocessorVertex(
                preprocessor=jpp.FeedForwardToCnnPreProcessor(2, 2, 3)),
                "shift")
            .add_layer("flat", jcore.DenseLayer(n_out=4), "img")
            .add_vertex("head_in", jcg.MergeVertex(), "l2", "u1", "flat")
            .add_layer("ffout", jcore.OutputLayer(n_out=2), "head_in")
            .add_vertex("dup", jcg.DuplicateToTimeSeriesVertex(
                reference_input="seq"), "flat")
            .add_vertex("seqm", jcg.MergeVertex(), "lstm", "dup")
            .add_layer("rnnout", jrec.RnnOutputLayer(n_out=3), "seqm")
            .set_outputs("rnnout", "ffout")
            .set_input_types(jin.recurrent(3, T), jin.feed_forward(4))
            .build())


def _all_vertex_data(dtype=np.float64, seed=0, batch=B):
    rng = np.random.RandomState(seed)
    x1 = rng.randn(batch, T, 3).astype(dtype)
    x2 = rng.randn(batch, 4).astype(dtype)
    lengths = (np.arange(batch) % T) + 1
    lengths[0] = T
    fm = (np.arange(T)[None] < lengths[:, None]).astype(dtype)
    y1 = np.eye(3, dtype=dtype)[rng.randint(0, 3, (batch, T))]
    y2 = np.eye(2, dtype=dtype)[rng.randint(0, 2, batch)]
    return ((x1, x2), (y1, y2), (fm, None), (fm, None))


def _mds(pkg, data):
    feats, labels, fms, lms = data
    cls = JaxMDS if pkg == "jax" else MultiDataSet
    return cls(list(feats), list(labels), list(fms), list(lms))


# ------------------------------------------------------------- vertices
def _vertex_cases():
    rng = np.random.RandomState(1)
    a, b, c = rng.randn(3, 4, 6)
    seq = rng.randn(4, T, 6)
    fm = (np.arange(T)[None] < np.array([5, 2, 4, 1])[:, None]).astype(
        np.float64)
    tied = a.copy()
    tied[:, ::2] = b[:, ::2]           # half the elements tie exactly
    return {
        "merge": (lambda m: m.MergeVertex(), (a, b, c), None),
        "add": (lambda m: m.ElementWiseVertex(op="add"), (a, b, c), None),
        "subtract": (lambda m: m.ElementWiseVertex(op="subtract"), (a, b),
                     None),
        "product": (lambda m: m.ElementWiseVertex(op="product"), (a, b, c),
                    None),
        "average": (lambda m: m.ElementWiseVertex(op="average"), (a, b, c),
                    None),
        "max": (lambda m: m.ElementWiseVertex(op="max"), (a, b, c), None),
        "max_tied": (lambda m: m.ElementWiseVertex(op="max"), (tied, b),
                     None),
        "max_three_tied": (lambda m: m.ElementWiseVertex(op="max"),
                           (b, b.copy(), b.copy()), None),
        "subset": (lambda m: m.SubsetVertex(from_index=1, to_index=4), (a,),
                   None),
        "stack": (lambda m: m.StackVertex(), (a, b), None),
        "unstack": (lambda m: m.UnstackVertex(from_index=1, stack_size=2),
                    (a,), None),
        "scale": (lambda m: m.ScaleVertex(scale_factor=-1.5), (a,), None),
        "shift": (lambda m: m.ShiftVertex(shift_factor=0.3), (a,), None),
        "preprocessor": (lambda m: m.PreprocessorVertex(
            preprocessor=(jpp if m is jcg else pp)
            .FeedForwardToCnnPreProcessor(1, 2, 3)), (a,), None),
        "l2": (lambda m: m.L2Vertex(), (a, b), None),
        "l2_normalize": (lambda m: m.L2NormalizeVertex(), (seq,), None),
        "last_time_step": (lambda m: m.LastTimeStepVertex(mask_input="in"),
                           (seq,), {"in": fm}),
        "last_time_step_unmasked": (
            lambda m: m.LastTimeStepVertex(mask_input="in"), (seq,), None),
    }


VERTEX_CASES = _vertex_cases()


@pytest.mark.parametrize("case", list(VERTEX_CASES))
def test_vertex_forward_and_gradient_match_jax(case):
    make, xs, masks = VERTEX_CASES[case]
    jv, pv = make(jcg), make(cg)
    jout = jv.apply(*[jnp.asarray(x) for x in xs], masks=None if masks is None
                    else {k: jnp.asarray(v) for k, v in masks.items()})
    cot = np.random.RandomState(2).randn(*jout.shape)

    def jloss(*args):
        return jnp.sum(jv.apply(*args, masks=None if masks is None else {
            k: jnp.asarray(v) for k, v in masks.items()}) * cot)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x) for x in xs])
    leaves = [torch.tensor(x, requires_grad=True) for x in xs]
    pout = pv.apply(*leaves, masks=None if masks is None else {
        k: torch.as_tensor(v) for k, v in masks.items()})
    _close(pout, jout, F64)
    (pout * torch.as_tensor(cot)).sum().backward()
    for leaf, g in zip(leaves, jgrads):
        _close(leaf.grad, g, F64)


def test_elementwise_max_splits_tied_gradients_in_half():
    """jnp.maximum gives each of two tied inputs half the cotangent;
    torch.maximum does the same, so the vertex matches JAX at ties."""
    x = np.array([[1.0, 2.0, 3.0]])
    y = np.array([[1.0, 0.0, 3.0]])
    leaves = [torch.tensor(v, requires_grad=True) for v in (x, y)]
    cg.ElementWiseVertex(op="max").apply(*leaves).sum().backward()
    assert leaves[0].grad.tolist() == [[0.5, 1.0, 0.5]]
    assert leaves[1].grad.tolist() == [[0.5, 0.0, 0.5]]
    jg = jax.grad(lambda a, b: jnp.sum(jcg.ElementWiseVertex(op="max")
                                       .apply(a, b)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    assert np.asarray(jg[0]).tolist() == [[0.5, 1.0, 0.5]]


def test_duplicate_to_time_series_takes_the_reference_length():
    x = torch.arange(6.0).reshape(2, 3)
    out = cg.DuplicateToTimeSeriesVertex(reference_input="s").apply(
        x, timesteps=4)
    assert tuple(out.shape) == (2, 4, 3)
    assert torch.equal(out[:, 2], x)
    with pytest.raises(ValueError, match="timestep count"):
        cg.DuplicateToTimeSeriesVertex().apply(x)


@pytest.mark.parametrize("bad", ["subtract_three", "unknown_op"])
def test_elementwise_errors_match_jax(bad):
    op = "subtract" if bad == "subtract_three" else "pow"
    xs = [np.ones((2, 2))] * 3
    with pytest.raises(ValueError) as jerr:
        jcg.ElementWiseVertex(op=op).apply(*[jnp.asarray(x) for x in xs])
    with pytest.raises(ValueError) as perr:
        cg.ElementWiseVertex(op=op).apply(*[torch.as_tensor(x)
                                            for x in xs])
    assert str(perr.value) == str(jerr.value)


# ------------------------------------------------- order, errors, JSON
def _diamond():
    """Insertion order that is not topological, with ties to break."""
    return (_builder().add_inputs("in")
            .add_layer("out", jcore.OutputLayer(n_out=3), "join")
            .add_vertex("join", jcg.MergeVertex(), "right", "left", "mid")
            .add_layer("right", jcore.DenseLayer(n_out=2), "in")
            .add_layer("left", jcore.DenseLayer(n_out=3), "mid")
            .add_layer("mid", jcore.DenseLayer(n_out=4), "in")
            .set_outputs("out").set_input_types(jin.feed_forward(5))
            .build())


def test_topological_order_equals_jax():
    jconf = _diamond()
    pconf = _port_conf(jconf)
    assert pconf.topological_order() == jconf.topological_order() == [
        "right", "mid", "left", "join", "out"]
    jnet, pnet = _pair(jconf)
    assert pnet._layer_names() == ["right", "mid", "left", "out"]
    np.testing.assert_array_equal(pnet.get_flat_params(),
                                  np.asarray(jnet.get_flat_params()))
    x = np.random.RandomState(0).randn(3, 5)
    _close(pnet.output(x), jnet.output(x), F64)


@pytest.mark.parametrize("kind", ["cycle", "unknown"])
def test_cycle_and_unknown_input_raise_as_in_jax(kind):
    def build(m, b):
        b = b.add_inputs("in")
        if kind == "cycle":
            b.add_layer("a", m.DenseLayer(n_in=4, n_out=4), "in", "b")
            b.add_layer("b", m.DenseLayer(n_in=4, n_out=4), "a")
            b.add_layer("out", m.OutputLayer(n_in=4, n_out=3), "b")
        else:
            b.add_layer("a", m.DenseLayer(n_in=4, n_out=4), "nonexistent")
            b.add_layer("out", m.OutputLayer(n_in=4, n_out=3), "a")
        return b.set_outputs("out").build()

    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import core
    match = "cycle involving" if kind == "cycle" else "unknown input"
    with pytest.raises(ValueError, match=match) as jerr:
        build(jcore, _builder())
    with pytest.raises(ValueError, match=match) as perr:
        build(core, NeuralNetConfiguration.builder().graph_builder())
    assert str(perr.value) == str(jerr.value)


def test_builder_errors():
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import core
    with pytest.raises(ValueError, match="addInputs"):
        NeuralNetConfiguration.builder().graph_builder().build()
    with pytest.raises(ValueError, match="setOutputs"):
        NeuralNetConfiguration.builder().graph_builder().add_inputs(
            "in").build()
    with pytest.raises(ValueError, match="is not a vertex"):
        (NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
         .add_layer("d", core.DenseLayer(n_in=2, n_out=2), "in")
         .set_outputs("nope").build())
    with pytest.raises(ValueError, match="n_out must be positive"):
        (NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
         .add_layer("d", core.DenseLayer(n_out=0), "in")
         .set_outputs("d").set_input_types(
             __import__("deeplearning4j_tpu_torch.nn.conf.inputs",
                        fromlist=["x"]).feed_forward(3)).build())


def test_to_json_is_identical_text_for_resnet50_and_the_all_vertex_graph():
    from deeplearning4j_tpu.models.resnet import resnet50 as jax_resnet50
    from deeplearning4j_tpu_torch.models.resnet import resnet50
    assert resnet50().to_json() == jax_resnet50().to_json()
    jconf = _all_vertex_conf()
    pconf = _port_conf(jconf)
    assert pconf.to_json() == jconf.to_json()
    assert pconf.topological_order() == jconf.topological_order()
    assert pconf.to_json(indent=None) == jconf.to_json(indent=None)


def test_shape_inference_sets_n_in_and_inserts_preprocessors():
    jconf = _all_vertex_conf()
    pconf = _port_conf(jconf)
    for name, v in pconf.vertices.items():
        jv = jconf.vertices[name]
        if isinstance(v, cg.LayerVertex):
            assert v.layer.n_in == jv.layer.n_in, name
            assert type(v.preprocessor).__name__ == \
                type(jv.preprocessor).__name__, name
    assert isinstance(pconf.vertices["flat"].preprocessor,
                      pp.CnnToFeedForwardPreProcessor)
    assert pconf.vertices["flat"].layer.n_in == 12
    assert pconf.vertices["rnnout"].layer.n_in == 10
    # the port's own builder infers the same
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import core
    own = (NeuralNetConfiguration.builder().graph_builder()
           .add_inputs("img").add_layer("d", core.DenseLayer(n_out=10), "img")
           .add_layer("out", core.OutputLayer(n_out=3), "d")
           .set_outputs("out")
           .set_input_types(inputs.convolutional(4, 4, 2)).build())
    assert own.vertices["d"].layer.n_in == 32
    assert isinstance(own.vertices["d"].preprocessor,
                      pp.CnnToFeedForwardPreProcessor)
    assert own._inferred_types["out"].size == 3


# ------------------------------------------------------------- training
def test_linear_graph_equals_the_multilayer_network():
    jconf = (_builder().add_inputs("in")
             .add_layer("dense", jcore.DenseLayer(n_in=4, n_out=6), "in")
             .add_layer("out", jcore.OutputLayer(n_in=6, n_out=3), "dense")
             .set_outputs("out").build())
    mconf = (JaxConf.builder().seed(3).dtype("float64").updater("sgd")
             .learning_rate(0.0625).activation("tanh").weight_init("xavier")
             .l2(1e-3).list()
             .layer(jcore.DenseLayer(n_in=4, n_out=6))
             .layer(jcore.OutputLayer(n_in=6, n_out=3)).build())
    jnet, graph = _pair(jconf)
    mln = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        mconf.to_json()), device="cpu").init()
    mln.set_flat_params(graph.get_flat_params())
    rng = np.random.RandomState(0)
    x, y = rng.randn(6, 4), np.eye(3)[rng.randint(0, 3, 6)]
    _close(graph.output(x), mln.output(x), F64)
    for _ in range(2):
        graph.fit(DataSet(x, y))
        mln.fit(DataSet(x, y))
        jnet.fit(JaxDataSet(x, y))
    _close(graph.get_flat_params(), mln.get_flat_params(), F64)
    _close(graph.get_flat_params(), jnet.get_flat_params(), F64)
    assert graph.score() == pytest.approx(float(jnet.score()), rel=F64)


@pytest.mark.parametrize("dtype,updater,tol", [
    ("float64", "sgd", F64), ("float32", "nesterovs", F32),
    ("float32", "adam", F32)])
def test_multi_input_multi_output_fit_with_masks_matches_jax(dtype, updater,
                                                             tol):
    jconf = _all_vertex_conf(dtype, updater, 0.0625)
    jnet, pnet = _pair(jconf)
    data = _all_vertex_data(np.dtype(dtype).type)
    feats, _, fms, _ = data
    jouts = jnet.output(*feats, features_masks=list(fms))
    pouts = pnet.output(*feats, features_masks=list(fms))
    assert isinstance(pouts, list) and len(pouts) == 2
    assert tuple(pouts[0].shape) == (B, T, 3)     # network_outputs order
    for got, want in zip(pouts, jouts):
        _close(got, want, tol)
    for _ in range(3):
        jnet.fit(_mds("jax", data))
        pnet.fit(_mds("port", data))
        assert pnet.score() == pytest.approx(float(jnet.score()), rel=tol)
    assert pnet.iteration == jnet.iteration == 3
    _close(pnet.get_flat_params(), jnet.get_flat_params(), tol)
    _close(pnet.get_flat_updater_state(), jnet.get_flat_updater_state(),
           tol)
    assert pnet.score(_mds("port", data)) == pytest.approx(
        float(jnet.score(_mds("jax", data))), rel=tol)


def test_flat_updater_state_crosses_in_topological_order():
    jconf = _all_vertex_conf("float32", "nesterovs")
    jnet, pnet = _pair(jconf)
    data = _all_vertex_data(np.float32)
    jnet.fit(_mds("jax", data))
    ustate = np.asarray(jnet.get_flat_updater_state())
    pnet.set_flat_updater_state(ustate)
    np.testing.assert_array_equal(pnet.get_flat_updater_state(), ustate)
    assert ustate.size == pnet.num_params()
    # one velocity per param, in the topological order of the vertices
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    table = pnet.param_table()
    assert list(table) == [f"{n}_{p}" for n in pnet._layer_names()
                           for p in pnet.vertices[n].layer.param_order()]
    jtable = jnet.param_table()
    assert list(table) == list(jtable)
    for key in table:
        np.testing.assert_array_equal(table[key], np.asarray(jtable[key]))


def test_bn_graph_state_follows_jax_and_fit_orders_it_by_name():
    """Batch-norm running statistics per vertex; a fit step stores the
    state dict with sorted keys, as the JAX package's jitted step does."""
    jconf = (_builder("float32", "nesterovs", 0.0625).add_inputs("img")
             .add_layer("zconv", jconvl.ConvolutionLayer(
                 n_out=3, kernel_size=(3, 3), convolution_mode="same"),
                 "img")
             .add_layer("zbn", jnorm.BatchNormalization(), "zconv")
             .add_layer("mid", jcore.DenseLayer(n_out=4), "zbn")
             .add_layer("abn", jnorm.BatchNormalization(), "mid")
             .add_layer("out", jcore.OutputLayer(n_out=2), "abn")
             .set_outputs("out").set_input_types(jin.convolutional(5, 5, 2))
             .build())
    jnet, pnet = _pair(jconf)
    assert list(pnet.net_state) == list(jnet.net_state) == [
        "zconv", "zbn", "mid", "abn", "out"]
    rng = np.random.RandomState(4)
    x = rng.randn(6, 5, 5, 2).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 6)]
    for _ in range(2):
        jnet.fit(JaxDataSet(x, y))
        pnet.fit(DataSet(x, y))
    assert list(pnet.net_state) == list(jnet.net_state) == sorted(
        pnet.net_state)
    for name in ("zbn", "abn"):
        for key in ("mean", "var"):
            _close(pnet.net_state[name][key], jnet.net_state[name][key], F32)
    _close(pnet.output(x), jnet.output(x), F32)


def test_lbfgs_on_a_graph_matches_jax():
    jconf = (JaxConf.builder().seed(2).dtype("float64").updater("sgd")
             .optimization_algo("lbfgs").activation("tanh")
             .weight_init("xavier").graph_builder()
             .add_inputs("a", "b")
             .add_layer("zd", jcore.DenseLayer(n_out=5), "a")
             .add_layer("ad", jcore.DenseLayer(n_out=3), "b")
             .add_vertex("m", jcg.MergeVertex(), "zd", "ad")
             .add_layer("out", jcore.OutputLayer(n_out=3), "m")
             .set_outputs("out")
             .set_input_types(jin.feed_forward(4), jin.feed_forward(2))
             .build())
    jnet, pnet = _pair(jconf)
    rng = np.random.RandomState(5)
    feats = [rng.randn(10, 4), rng.randn(10, 2)]
    labels = [np.eye(3)[rng.randint(0, 3, 10)]]
    for _ in range(4):
        jnet.fit(JaxMDS(feats, labels))
        pnet.fit(MultiDataSet(feats, labels))
    _close(pnet.get_flat_params(), jnet.get_flat_params(), 1e-9)
    assert pnet.score() == pytest.approx(float(jnet.score()), rel=1e-9)
    assert pnet._solver.iterations == 4


def test_listeners_see_the_same_scores_as_jax():
    jconf = _all_vertex_conf()
    jnet, pnet = _pair(jconf)
    jl, pl = JaxCollect(), CollectScoresIterationListener()
    jnet.set_listeners(jl)
    pnet.set_listeners(pl)
    data = _all_vertex_data()
    jnet.fit([_mds("jax", data)] * 3, ingest="batch")
    pnet.fit([_mds("port", data)] * 3)
    assert [i for i, _ in pl.scores] == [i for i, _ in jl.scores] == \
        [1, 2, 3]
    np.testing.assert_allclose([s for _, s in pl.scores],
                               [float(s) for _, s in jl.scores], rtol=F64)


def _classifier_conf():
    return (_builder().add_inputs("x")
            .add_layer("h", jcore.DenseLayer(n_out=8), "x")
            .add_layer("out", jcore.OutputLayer(n_out=3), "h")
            .set_outputs("out").set_input_types(jin.feed_forward(4))
            .build())


def test_evaluate_gives_the_jax_confusion_matrix():
    jnet, pnet = _pair(_classifier_conf())
    rng = np.random.RandomState(6)
    batches = [(rng.randn(16, 4), np.eye(3)[rng.randint(0, 3, 16)])
               for _ in range(3)]
    jev = jnet.evaluate([JaxDataSet(x, y) for x, y in batches])
    pev = pnet.evaluate([DataSet(x, y) for x, y in batches])
    np.testing.assert_array_equal(pev.confusion.matrix,
                                  np.asarray(jev.confusion.matrix))
    assert pev.accuracy() == pytest.approx(jev.accuracy())
    assert pnet.predict(batches[0][0]).tolist() == \
        np.asarray(jnet.predict(batches[0][0])).tolist()
    reg = pnet.evaluate_regression([MultiDataSet([x], [y])
                                    for x, y in batches])
    jreg = jnet.evaluate_regression([JaxMDS([x], [y]) for x, y in batches])
    np.testing.assert_allclose(reg.mean_squared_error(0),
                               jreg.mean_squared_error(0), rtol=F64)
    with pytest.raises(ValueError, match="single-output"):
        _pair(_all_vertex_conf())[1].evaluate([])


def test_score_examples_sums_the_outputs_like_jax():
    jnet, pnet = _pair(_all_vertex_conf())
    data = _all_vertex_data()
    for reg in (True, False):
        _close(pnet.score_examples(_mds("port", data), reg),
               jnet.score_examples(_mds("jax", data), reg), F64)
    both = pnet.score_examples([_mds("port", data)] * 2)
    assert tuple(both.shape) == (2 * B,)


# ----------------------------------------------------------------- time
def _seq_conf(tbptt=None, back=None, dtype="float64"):
    b = (_builder(dtype).add_inputs("seq")
         .add_layer("lstm1", jrec.GravesLSTM(n_in=3, n_out=4), "seq")
         .add_layer("lstm2", jrec.GravesLSTM(n_in=4, n_out=4), "lstm1")
         .add_layer("rnnout", jrec.RnnOutputLayer(n_in=4, n_out=3), "lstm2")
         .set_outputs("rnnout"))
    if tbptt:
        b = b.backprop_type("tbptt").t_bptt_forward_length(tbptt)
        if back:
            b = b.t_bptt_backward_length(back)
    return b.build()


def _seq_data(n=4, t=11, masked=False, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, t, 3)
    y = np.eye(3)[rng.randint(0, 3, (n, t))]
    m = None
    if masked:
        m = (np.arange(t)[None] < np.array([t, 7, 3, 9])[:n, None]).astype(
            np.float64)
    return x, y, m


@pytest.mark.parametrize("fwd,back,masked", [
    (4, None, False), (6, 3, False), (4, 4, True), (5, 2, True)])
def test_graph_tbptt_matches_jax(fwd, back, masked):
    jnet, pnet = _pair(_seq_conf(fwd, back))
    x, y, m = _seq_data(masked=masked)
    ms = None if m is None else [m]
    for _ in range(2):
        jnet.fit(JaxMDS([x], [y], ms, ms))
        pnet.fit(MultiDataSet([x], [y], ms, ms))
    windows = -(-11 // fwd)
    assert pnet.iteration == jnet.iteration == 2 * windows
    _close(pnet.get_flat_params(), jnet.get_flat_params(), F64)
    assert pnet.score() == pytest.approx(float(jnet.score()), rel=F64)


def test_graph_tbptt_errors():
    _, pnet = _pair(_seq_conf(4, 6))
    x, y, _ = _seq_data()
    with pytest.raises(ValueError, match="not meaningful"):
        pnet.fit(MultiDataSet([x], [y]))
    _, pnet = _pair(_seq_conf(4))
    with pytest.raises(ValueError, match="per-timestep labels"):
        pnet.fit(MultiDataSet([x], [np.eye(3)[[0, 1, 2, 0]]]))


def test_rnn_time_step_chunked_equals_full_sequence_and_jax():
    jnet, pnet = _pair(_seq_conf())
    x, _, _ = _seq_data(t=6)
    full = pnet.output(x)
    _close(full, jnet.output(x), F64)
    stepped = torch.stack([pnet.rnn_time_step(x[:, t]) for t in range(6)],
                          dim=1)
    _close(stepped, full, F64)
    pnet.rnn_clear_previous_state()
    a = pnet.rnn_time_step(x[:, :2])
    b = pnet.rnn_time_step(x[:, 2:])
    _close(torch.cat([a, b], dim=1), full, F64)
    jnet.rnn_time_step(x[:, :2])
    _close(b, jnet.rnn_time_step(x[:, 2:]), F64)
    state = pnet.rnn_get_previous_state("lstm1")
    _close(state[0], jnet.rnn_get_previous_state("lstm1")[0], F64)
    assert set(pnet._rnn_carries) == {"lstm1", "lstm2", "rnnout"}
    with pytest.raises(KeyError):
        pnet.rnn_set_previous_state("nope", state)
    with pytest.raises(ValueError, match="batch size"):
        pnet.rnn_time_step(x[:1, 0])
    pnet.rnn_set_previous_state("lstm1", state)


def _decode_conf(cache_len=16):
    return (JaxConf.builder().seed(11).dtype("float64").graph_builder()
            .add_inputs("in")
            .add_layer("attn", jatt.CausalSelfAttention(
                n_in=8, n_out=16, n_heads=4, cache_len=cache_len), "in")
            .add_layer("out", jrec.RnnOutputLayer(
                n_in=16, n_out=4, activation="softmax", loss="mcxent"),
                "attn")
            .set_outputs("out").build())


def test_graph_decode_step_matches_output_and_jax():
    jnet, pnet = _pair(_decode_conf())
    assert pnet.has_kv_ring() and pnet.max_cache_len() == 16
    x = np.random.RandomState(5).randn(2, 10, 8)
    full = pnet.output(x)
    _close(full, jnet.output(x), F64)
    carries, jcarries, steps = None, None, []
    for t in range(10):
        outs, carries = pnet.decode_step(carries, x[:, t:t + 1])
        jouts, jcarries = jnet.decode_step(jcarries, x[:, t:t + 1])
        _close(outs[0], jouts[0], F64)
        steps.append(outs[0][:, 0])
    _close(torch.stack(steps, 1), full, F64)
    # the ring hop: a carry grown to a larger capacity gives the same step
    small = pnet._init_carries(2, cache_len=4)
    _, small = pnet.decode_step(small, x[:, :3])
    grown = pnet.grow_decode_carries(small, 16)
    outs, _ = pnet.decode_step(grown, x[:, 3:4])
    _close(outs[0][:, 0], full[:, 3], F64)
    with pytest.raises(ValueError, match="expects"):
        pnet.decode_step(None, x[:, 0])


def _graph_sessions_model():
    return (JaxConf.builder().seed(11).dtype("float64").graph_builder()
            .add_inputs("in", "aux")
            .add_layer("lstm", jrec.GravesLSTM(n_in=3, n_out=8), "in")
            .add_vertex("m", jcg.MergeVertex(), "lstm", "aux")
            .add_layer("out", jrec.RnnOutputLayer(
                n_in=10, n_out=2, activation="softmax", loss="mcxent"), "m")
            .add_layer("out2", jrec.RnnOutputLayer(
                n_in=8, n_out=3, activation="identity", loss="mse"), "lstm")
            .set_outputs("out", "out2").build())


def test_graph_sessions_match_jax_with_the_same_paths_and_bytes():
    jnet, pnet = _pair(_graph_sessions_model())
    cache, jcache = SessionCache(pnet, name="g"), JaxSessions(jnet,
                                                              name="jg")
    rng = np.random.RandomState(2)
    xs, aux = rng.randn(2, 5, 3), rng.randn(2, 5, 2)
    full = pnet.output(xs, aux)
    for t in range(5):
        got = cache.step("s", [xs[:, t], aux[:, t]])
        want = jcache.step("s", [xs[:, t], aux[:, t]])
        assert isinstance(got, list) and len(got) == 2
        for g, w, f in zip(got, want, full):
            _close(g, w, F64)
            _close(g, f[:, t].numpy(), F64)
    assert cache.state_bytes() == jcache.state_bytes()
    from deeplearning4j_tpu.serving import sessions as jsess
    from deeplearning4j_tpu_torch.serving import sessions as psess
    carries = cache.get_carries("s")
    paths = [p for p, _ in psess._leaves_with_path(carries)]
    jpaths = [jax.tree_util.keystr(kp) for kp, _ in
              jax.tree_util.tree_flatten_with_path(
                  jcache.get_carries("s"))[0]]
    assert paths == jpaths == ["['lstm'][0]", "['lstm'][1]"]
    with pytest.raises(psess.SessionStateError) as perr:
        cache.step("s", [xs[:1, 0], aux[:1, 0]])
    with pytest.raises(jsess.SessionStateError) as jerr:
        jcache.step("s", [xs[:1, 0], aux[:1, 0]])
    assert perr.value.leaf_path == jerr.value.leaf_path == "['lstm'][0]"


def test_graph_decode_session_matches_output():
    _, pnet = _pair(_decode_conf(cache_len=32))
    cache = SessionCache(pnet, name="dec-graph")
    x = np.random.RandomState(5).randn(2, 12, 8)
    full = pnet.output(x).numpy()
    stepped = np.stack([cache.step("s", x[:, t]) for t in range(12)],
                       axis=1)
    _close(stepped, full, F64)
    assert cache.session_capacity("s") == 16


def test_engine_serves_a_multi_input_graph_like_jax():
    from deeplearning4j_tpu.serving.engine import \
        InferenceEngine as JaxEngine
    jnet, pnet = _pair(_all_vertex_conf())
    data = _all_vertex_data(batch=3)
    (x1, x2), _, _, _ = data
    with InferenceEngine(pnet, max_batch_size=4, max_latency_ms=1.0,
                         name="cg-engine") as eng, \
            JaxEngine(jnet, max_batch_size=4, max_latency_ms=1.0,
                      name="cg-jax") as jeng:
        assert eng.warmup(((T, 3), (4,))) == len(eng._policy.batch_buckets)
        got = eng.predict([x1, x2], timeout=60)
        want = jeng.predict([x1, x2], timeout=60)
        assert isinstance(got, list) and len(got) == 2
        for g, w, o in zip(got, want, pnet.output(x1, x2)):
            _close(g, w, F64)
            _close(g, o, F64)
        with pytest.raises(ValueError, match="expects 2 inputs"):
            eng.predict(x1, timeout=60)
        with pytest.raises(ValueError, match="disagree"):
            eng.predict([x1, x2[:2]], timeout=60)


def test_engine_serves_a_single_input_graph_with_time_buckets():
    _, pnet = _pair(_decode_conf(cache_len=32))
    with InferenceEngine(pnet, max_batch_size=4, timestep_buckets=(8, 16),
                         max_latency_ms=1.0, name="cg-seq") as eng:
        rng = np.random.RandomState(7)
        for t in (3, 8, 13):
            x = rng.randn(2, t, 8)
            got = eng.predict(x, timeout=60)
            assert got.shape == (2, t, 4)
            _close(got, pnet.output(x), F64)
        assert eng.warmup_decode((8,)) > 0
        assert eng.warmup_decode((8,)) == 0
        out = eng.predict_session("s", rng.randn(1, 8))
        assert out.shape == (1, 4)


# ------------------------------------------------------------- checks
@pytest.mark.parametrize("which", ["all_vertex", "bn", "tied_max"])
def test_check_gradients_graph_passes_in_f64(which):
    if which == "all_vertex":
        jconf = _all_vertex_conf()
        data = _all_vertex_data(batch=3)
        pdata, jdata = _mds("port", data), _mds("jax", data)
    else:
        b = _builder().add_inputs("in")
        if which == "bn":
            b = (b.add_layer("d", jcore.DenseLayer(n_out=4), "in")
                 .add_layer("bn", jnorm.BatchNormalization(), "d")
                 .add_layer("d2", jcore.DenseLayer(n_out=4), "in")
                 .add_vertex("join", jcg.ElementWiseVertex(op="add"), "bn",
                             "d2"))
        else:
            b = (b.add_layer("d", jcore.DenseLayer(n_out=4,
                                                   activation="relu"), "in")
                 .add_layer("d2", jcore.DenseLayer(n_out=4,
                                                   activation="sigmoid"),
                            "in")
                 .add_vertex("join", jcg.ElementWiseVertex(op="max"), "d",
                             "d2"))
        jconf = (b.add_layer("out", jcore.OutputLayer(n_out=3), "join")
                 .set_outputs("out").set_input_types(jin.feed_forward(4))
                 .build())
        rng = np.random.RandomState(8)
        x, y = rng.randn(6, 4), np.eye(3)[rng.randint(0, 3, 6)]
        pdata, jdata = DataSet(x, y), JaxDataSet(x, y)
    jnet, pnet = _pair(jconf)
    assert check_gradients_graph(pnet, pdata)
    assert jax_check_graph(jnet, jdata)


def test_check_gradients_graph_refuses_float32_and_catches_a_bad_grad():
    _, pnet = _pair(_all_vertex_conf("float32"))
    with pytest.raises(ValueError, match="float64"):
        check_gradients_graph(pnet, _mds("port", _all_vertex_data()))
    _, pnet = _pair(_classifier_conf())
    rng = np.random.RandomState(9)
    ds = DataSet(rng.randn(5, 4), np.eye(3)[rng.randint(0, 3, 5)])
    real = pnet._reg_score
    pnet._reg_score = lambda p: real(p) + 1e-3 * (
        p["h"]["W"].detach() ** 2).sum()      # a loss term autograd misses
    assert not check_gradients_graph(pnet, ds)


def test_clone_copies_the_training_state():
    jconf = _all_vertex_conf("float32", "nesterovs")
    _, pnet = _pair(jconf)
    data = _all_vertex_data(np.float32)
    pnet.fit(_mds("port", data))
    other = pnet.clone()
    assert isinstance(other, ComputationGraph) and other is not pnet
    assert other.iteration == pnet.iteration == 1
    np.testing.assert_array_equal(other.get_flat_params(),
                                  pnet.get_flat_params())
    np.testing.assert_array_equal(other.get_flat_updater_state(),
                                  pnet.get_flat_updater_state())
    other.fit(_mds("port", data))
    pnet.fit(_mds("port", data))
    np.testing.assert_array_equal(other.get_flat_params(),
                                  pnet.get_flat_params())
    other.fit(_mds("port", data))
    assert not np.array_equal(other.get_flat_params(),
                              pnet.get_flat_params())


def test_unported_routes_raise_naming_their_item(tmp_path):
    """No route is left unported: ``pretrain`` and ``pretrain_layer`` run
    and match the JAX package (an AutoEncoder vertex, f64, 1e-10), and the
    fused runtime's routes (every ``ingest`` value, ``fit_scan``,
    ``checkpoint=``) run."""
    rng = np.random.RandomState(0)
    x, y = rng.randn(4, 4), np.eye(3)[rng.randint(0, 3, 4)]
    ds = DataSet(x, y)
    jpre_net, ppre_net = _pair(
        _builder().add_inputs("x")
        .add_layer("h", jpretrain.AutoEncoder(
            n_out=8, corruption_level=0.0, activation="sigmoid",
            loss="mse"), "x")
        .add_layer("out", jcore.OutputLayer(n_out=3), "h")
        .set_outputs("out").set_input_types(jin.feed_forward(4)).build())
    for net, data in ((jpre_net, JaxDataSet(x, y)), (ppre_net, ds)):
        net.pretrain(data, epochs=2)
        net.pretrain_layer("h", data)
        net.pretrain_layer("out", data)     # not pretrainable: skipped
    assert ppre_net.iteration == jpre_net.iteration == 3
    assert ppre_net._pretrain_done and jpre_net._pretrain_done
    want = np.asarray(jpre_net.get_flat_params())
    np.testing.assert_allclose(ppre_net.get_flat_params(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    _, pnet = _pair(_classifier_conf())
    with pytest.raises(ValueError, match="unknown ingest"):
        pnet.fit(ds, ingest="stream")
    pnet.fit(ds, ingest="cache")
    pnet.fit(ds, ingest="window")
    pnet.fit(ds, checkpoint=str(tmp_path))
    assert pnet.fit_scan([ds, ds]).shape == (2,)
    pnet.fit(ds, ingest="batch")
    pnet.fit([ds, ds], ingest="auto")
    assert pnet.iteration == 8


def test_a_graph_runs_on_the_card_unless_the_cpu_is_asked_for(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph(_port_conf(_classifier_conf()))
    assert ComputationGraph(_port_conf(_classifier_conf()),
                            device="cpu").device.type == "cpu"
