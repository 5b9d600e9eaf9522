"""The port's ParallelWrapper (``parallel/parallel_wrapper.py``) against
the JAX package's on the same weights (``nn/jax_weights.py``) and the same
batches, for every case of ``tests/test_parallel.py``, plus a tBPTT LSTM
net (the ``lstm_rmsprop_tbptt`` golden's size), the health vector after
one worker's NaN, the example ``examples/parallel_training.py`` through
the port, and the refusals.  The JAX wrapper runs on its 8 virtual CPU
devices, the port on ``devices=["cpu"] * w``.

Tolerances: float64 nets with sgd at 1e-10; float64 adam, rmsprop and
nesterovs at 1e-8 (the JAX updater keeps the betas and the momentum in
float32, so its f64 steps differ from the port's by ~1e-9); float32
nets at rtol 2e-5; the flat updater-state vectors, float32 in both
packages, at 2 ulp (2.5e-7) and 1e-9 absolute.  The port against itself
(prefetch, stragglers, workers=1 against ``fit``) is bitwise.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.monitor import health as jhealth
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf.computation_graph import \
    MergeVertex as JMerge
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel.parallel_wrapper import \
    ParallelWrapper as JPW
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.monitor import health as phealth
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.jax_weights import load_jax_params
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
    ParallelWrapper

SGD_RTOL = 1e-10
F64_RTOL = 1e-8
F32_RTOL = 2e-5
#: the flat updater-state vector is float32 in both packages: 2 ulp
STATE_RTOL = 2.5e-7


def _conf(updater="sgd", lr=0.1, seed=12345, dtype="float64"):
    return (JConf.builder().seed(seed).dtype(dtype).updater(updater)
            .learning_rate(lr).activation("tanh").weight_init("xavier")
            .list()
            .layer(jcore.DenseLayer(n_in=4, n_out=8))
            .layer(jcore.OutputLayer(n_in=8, n_out=3)).build())


def _pair(jconf):
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    load_jax_params(pnet, np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _batches(n_batches, b=8, seed=0, n_in=4, n_classes=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, n_in), np.eye(n_classes)[rng.randint(
        0, n_classes, b)]) for _ in range(n_batches)]


def _jds(batches):
    return [JDS(x, y) for x, y in batches]


def _pds(batches):
    return [DataSet(x, y) for x, y in batches]


def _cpu(w):
    return ["cpu"] * w


def _close(jnet, pnet, rtol, what="params"):
    """Params within ``rtol`` (relative, and absolute for the values near
    0); the float32 updater-state vectors within 2 ulp."""
    if what == "params":
        a, b = np.asarray(jnet.get_flat_params()), pnet.get_flat_params()
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol)
    else:
        a = np.asarray(jnet.get_flat_updater_state())
        b = pnet.get_flat_updater_state()
        np.testing.assert_allclose(b, a, rtol=STATE_RTOL, atol=1e-9)


def test_avgfreq1_sgd_equals_large_batch_step_and_jax():
    """w workers x 1 SGD step + averaging == one step on the concatenated
    batch, and == the JAX wrapper."""
    w = 4
    batches = _batches(w)
    jnet, pnet = _pair(_conf())
    _, ref = _pair(_conf())
    JPW(jnet, workers=w, averaging_frequency=1).fit(_jds(batches))
    ParallelWrapper(pnet, workers=w, averaging_frequency=1,
                    devices=_cpu(w)).fit(_pds(batches))
    _close(jnet, pnet, SGD_RTOL)
    ref.fit(DataSet(np.concatenate([x for x, _ in batches]),
                    np.concatenate([y for _, y in batches])))
    np.testing.assert_allclose(pnet.get_flat_params(),
                               ref.get_flat_params(), rtol=1e-12)
    assert pnet.iteration == jnet.iteration == 1
    assert float(pnet._score) == pytest.approx(float(jnet._score),
                                               rel=SGD_RTOL)


def test_avgfreq_k_matches_manual_local_sgd_and_jax():
    """averaging_frequency=2: workers step independently twice, then
    params AND updater state are averaged; simulated with clones."""
    w, k = 2, 2
    batches = _batches(w * k, seed=3)
    jnet, pnet = _pair(_conf(updater="nesterovs", lr=0.05))
    manual = [pnet.clone() for _ in range(w)]
    JPW(jnet, workers=w, averaging_frequency=k).fit(_jds(batches))
    ParallelWrapper(pnet, workers=w, averaging_frequency=k,
                    devices=_cpu(w)).fit(_pds(batches))
    _close(jnet, pnet, F64_RTOL)
    _close(jnet, pnet, F64_RTOL, what="ustate")
    for i, m in enumerate(manual):
        for j in range(k):
            x, y = batches[j * w + i]
            m.fit(DataSet(x, y))
    np.testing.assert_allclose(
        pnet.get_flat_params(),
        np.mean([m.get_flat_params() for m in manual], axis=0), rtol=1e-12)
    np.testing.assert_allclose(
        pnet.get_flat_updater_state(),
        np.mean([m.get_flat_updater_state() for m in manual], axis=0),
        rtol=1e-6)


def test_average_updaters_false_keeps_local_updater_state():
    w = 2
    batches = _batches(w * 2, seed=5)
    out = {}
    for flag in (True, False):
        jnet, pnet = _pair(_conf(updater="adam", lr=0.01))
        JPW(jnet, workers=w, averaging_frequency=2,
            average_updaters=flag).fit(_jds(batches))
        pw = ParallelWrapper(pnet, workers=w, averaging_frequency=2,
                             average_updaters=flag, devices=_cpu(w))
        pw.fit(_pds(batches))
        _close(jnet, pnet, F64_RTOL)
        _close(jnet, pnet, F64_RTOL, what="ustate")
        out[flag] = (pnet.get_flat_updater_state(), pw)
    assert not np.allclose(out[True][0], out[False][0])
    # without averaging, each worker keeps its own state across rounds
    kept = out[False][1]._worker_ustate
    assert not torch.equal(kept[0][0]["m"]["W"], kept[1][0]["m"]["W"])


def test_iteration_count_advances_by_avg_freq():
    jnet, pnet = _pair(_conf())
    JPW(jnet, workers=2, averaging_frequency=3).fit(_jds(_batches(6)))
    ParallelWrapper(pnet, workers=2, averaging_frequency=3,
                    devices=_cpu(2)).fit(_pds(_batches(6)))
    assert pnet.iteration == jnet.iteration == 3
    _close(jnet, pnet, SGD_RTOL)


def test_parallel_wrapper_with_computation_graph():
    gconf = (JConf.builder().seed(99).dtype("float64")
             .updater("sgd").learning_rate(0.1).activation("tanh")
             .weight_init("xavier").graph_builder()
             .add_inputs("a", "b")
             .add_vertex("merge", JMerge(), "a", "b")
             .add_layer("h", jcore.DenseLayer(n_in=4, n_out=6), "merge")
             .add_layer("out", jcore.OutputLayer(n_in=6, n_out=2), "h")
             .set_outputs("out").build())
    rng = np.random.RandomState(1)
    raw = [([rng.randn(8, 2), rng.randn(8, 2)],
            [np.eye(2)[rng.randint(0, 2, 8)]]) for _ in range(4)]
    jcg = JCG(gconf).init()
    pcg = ComputationGraph(ComputationGraphConfiguration.from_json(
        gconf.to_json()), device="cpu").init()
    load_jax_params(pcg, np.asarray(jcg.get_flat_params()))
    ref = ComputationGraph(ComputationGraphConfiguration.from_json(
        gconf.to_json()), device="cpu").init()
    load_jax_params(ref, np.asarray(jcg.get_flat_params()))
    JPW(jcg, workers=4).fit([JMDS(features=f, labels=l) for f, l in raw])
    ParallelWrapper(pcg, workers=4, devices=_cpu(4)).fit(
        [MultiDataSet(f, l) for f, l in raw])
    _close(jcg, pcg, SGD_RTOL)
    ref.fit(MultiDataSet(
        [np.concatenate([f[i] for f, _ in raw]) for i in range(2)],
        [np.concatenate([l[0] for _, l in raw])]))
    np.testing.assert_allclose(pcg.get_flat_params(),
                               ref.get_flat_params(), rtol=1e-12)


def _rconf():
    return (JConf.builder().seed(7).dtype("float64").updater("sgd")
            .learning_rate(0.1).activation("tanh").weight_init("xavier")
            .list()
            .layer(jrec.GravesLSTM(n_in=3, n_out=5))
            .layer(jrec.RnnOutputLayer(n_in=5, n_out=2)).build())


def _masked_batches(w, seed=11):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(w):
        f = rng.randn(4, 6, 3)
        l = np.eye(2)[rng.randint(0, 2, (4, 6))]
        mask = (rng.rand(4, 6) > 0.3).astype(np.float64)
        mask[:, 0] = 1.0
        out.append((f, l, mask))
    return out


def test_masks_thread_through_parallel_fit():
    w = 2
    raw = _masked_batches(w)
    jnet, pnet = _pair(_rconf())
    JPW(jnet, workers=w).fit([JDS(f, l, features_mask=m) for f, l, m in raw])
    ParallelWrapper(pnet, workers=w, devices=_cpu(w)).fit(
        [DataSet(f, l, features_mask=m) for f, l, m in raw])
    _close(jnet, pnet, SGD_RTOL)
    base = np.asarray(JNet(_rconf()).init().get_flat_params())
    avg = []
    for f, l, m in raw:
        one = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            _rconf().to_json()), device="cpu").init()
        load_jax_params(one, base)
        one.fit(DataSet(f, l, features_mask=m))
        avg.append(one.get_flat_params())
    np.testing.assert_allclose(pnet.get_flat_params(),
                               np.mean(avg, axis=0), rtol=1e-12)
    unmasked = []
    for f, l, m in raw:
        one = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            _rconf().to_json()), device="cpu").init()
        load_jax_params(one, base)
        one.fit(DataSet(f, l))
        unmasked.append(one.get_flat_params())
    assert not np.allclose(pnet.get_flat_params(),
                           np.mean(unmasked, axis=0))


def test_mixed_mask_presence_raises():
    raw = _batches(2)
    batches = _pds(raw)
    batches[0] = DataSet(raw[0][0], raw[0][1], features_mask=np.ones((8, 1)))
    _, pnet = _pair(_conf())
    with pytest.raises(ValueError, match="[Mm]ixed mask"):
        ParallelWrapper(pnet, workers=2, devices=_cpu(2)).fit(batches)


def test_tbptt_lstm_net_runs_its_windows_per_worker():
    """A tBPTT LSTM net at the ``lstm_rmsprop_tbptt`` golden's size
    (GravesLSTM 5 -> 8, RnnOutputLayer 8 -> 5, rmsprop, windows of 4 over
    T=6): each worker runs the port's own ``_tbptt_window_loss`` window
    by window, as the JAX wrapper runs its windowed program."""
    jconf = (JConf.builder().seed(71).dtype("float64").updater("rmsprop")
             .learning_rate(0.05).weight_init("xavier").list()
             .layer(jrec.GravesLSTM(n_in=5, n_out=8, activation="tanh"))
             .layer(jrec.RnnOutputLayer(n_in=8, n_out=5))
             .backprop_type("tbptt").t_bptt_forward_length(4).build())
    rng = np.random.RandomState(4)
    raw = [(rng.randn(2, 6, 5), np.eye(5)[rng.randint(0, 5, (2, 6))])
           for _ in range(4)]
    jnet, pnet = _pair(jconf)
    JPW(jnet, workers=2, averaging_frequency=2).fit(_jds(raw))
    ParallelWrapper(pnet, workers=2, averaging_frequency=2,
                    devices=_cpu(2)).fit(_pds(raw))
    _close(jnet, pnet, F64_RTOL)
    _close(jnet, pnet, F64_RTOL, what="ustate")
    assert pnet.iteration == jnet.iteration == 2
    # one worker's windows == the network's own tBPTT fit on its batches
    one = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    load_jax_params(one, np.asarray(JNet(jconf).init().get_flat_params()))
    solo = ParallelWrapper(one.clone(), workers=1, averaging_frequency=2,
                           devices=_cpu(1))
    solo.fit(_pds(raw[:2]))
    for x, y in raw[:2]:
        one.fit(DataSet(x, y))
    np.testing.assert_array_equal(solo.model.get_flat_params(),
                                  one.get_flat_params())


@pytest.fixture
def health_on():
    jhealth.enable("warn")
    phealth.enable("warn")
    yield
    jhealth.disable()
    phealth.disable()


def test_health_vector_after_one_workers_nan_matches_jax(health_on):
    """One worker's NaN batch poisons the averaged health stack (loss and
    the flag column), in both packages alike."""
    raw = _batches(4, seed=8)
    raw[1] = (np.full_like(raw[1][0], np.nan), raw[1][1])
    jnet, pnet = _pair(_conf(dtype="float32"))
    JPW(jnet, workers=2, averaging_frequency=2).fit(
        [JDS(np.float32(x), np.float32(y)) for x, y in raw])
    ParallelWrapper(pnet, workers=2, averaging_frequency=2,
                    devices=_cpu(2)).fit(
        [DataSet(np.float32(x), np.float32(y)) for x, y in raw])
    js = np.asarray(jhealth.last_stack_for(jnet))
    ps = np.asarray(phealth.last_stack_for(pnet))
    assert js.shape == ps.shape == (2, 2 + 3 * 2)
    assert np.isnan(ps[:, 0]).all() and np.isnan(js[:, 0]).all()
    np.testing.assert_array_equal(np.isfinite(ps), np.isfinite(js))
    np.testing.assert_allclose(ps, js, rtol=F32_RTOL, atol=1e-6,
                               equal_nan=True)
    assert phealth.state() == jhealth.state()


def test_parallel_fit_serialize_resume_chain(tmp_path):
    from deeplearning4j_tpu_torch.utils.model_serializer import (
        restore_multi_layer_network, write_model)
    jnet, pnet = _pair(_conf(updater="adam", lr=0.01))
    batches = _batches(8)
    JPW(jnet, workers=4, averaging_frequency=2).fit(_jds(batches))
    ParallelWrapper(pnet, workers=4, averaging_frequency=2,
                    devices=_cpu(4)).fit(_pds(batches))
    _close(jnet, pnet, F64_RTOL)
    assert pnet.iteration == jnet.iteration == 2
    p = str(tmp_path / "pw.zip")
    write_model(pnet, p)
    again = restore_multi_layer_network(p, device="cpu")
    assert again.iteration == pnet.iteration
    np.testing.assert_array_equal(again.get_flat_updater_state(),
                                  pnet.get_flat_updater_state())
    x, y = batches[0]
    for _ in range(2):
        pnet.fit(DataSet(x, y))
        again.fit(DataSet(x, y))
        jnet.fit(JDS(x, y))
    np.testing.assert_allclose(again.get_flat_params(),
                               pnet.get_flat_params(), atol=1e-6)
    _close(jnet, pnet, F64_RTOL)


def test_tail_stragglers_left_unfitted_not_double_counted():
    w = 4
    batches = _batches(w + 2, seed=3)
    jnet, tail = _pair(_conf())
    _, full = _pair(_conf())
    jpw = JPW(jnet, workers=w)
    jpw.fit(_jds(batches))
    pw = ParallelWrapper(tail, workers=w, devices=_cpu(w))
    pw.fit(_pds(batches))
    assert pw.skipped_tail_batches == jpw.skipped_tail_batches == 2
    pw_full = ParallelWrapper(full, workers=w, devices=_cpu(w))
    pw_full.fit(_pds(batches[:w]))
    assert pw_full.skipped_tail_batches == 0
    np.testing.assert_array_equal(tail.get_flat_params(),
                                  full.get_flat_params())
    assert tail.iteration == full.iteration == jnet.iteration
    _close(jnet, tail, SGD_RTOL)


def test_prefetch_buffer_matches_unprefetched():
    from deeplearning4j_tpu_torch import monitor
    batches = _batches(16, seed=9)

    def run(prefetch):
        _, net = _pair(_conf())
        pw = (ParallelWrapper.Builder(net).workers(4).averaging_frequency(1)
              .prefetch_buffer(prefetch).devices(_cpu(4)).build())
        pw.fit(_pds(batches))
        return net.get_flat_params()

    np.testing.assert_array_equal(run(0), run(2))
    depth = monitor.snapshot().get("parallel_prefetch_depth", {})
    assert depth.get("values"), "prefetch path must feed the depth gauge"


def test_workers_1_is_bitwise_the_per_batch_fit():
    _, a = _pair(_conf(updater="adam", lr=0.01, dtype="float32"))
    b = a.clone()
    batches = [(np.float32(x), np.float32(y)) for x, y in _batches(3)]
    ParallelWrapper(a, workers=1, devices=_cpu(1)).fit(_pds(batches))
    for x, y in batches:
        b.fit(DataSet(x, y))
    np.testing.assert_array_equal(a.get_flat_params(), b.get_flat_params())
    np.testing.assert_array_equal(a.get_flat_updater_state(),
                                  b.get_flat_updater_state())
    assert a.iteration == b.iteration == 3
    assert float(a._score) == float(b._score)


def test_refusals_and_the_card_default():
    _, pnet = _pair(_conf())
    with pytest.raises(ValueError, match="workers >"):
        ParallelWrapper(pnet, workers=4, devices=_cpu(2))
    meta = ["meta"] * 2
    with pytest.raises(ValueError):
        ParallelWrapper(pnet, workers=2, devices=meta)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ParallelWrapper(pnet, workers=2)
    with pytest.warns(UserWarning, match="trained NOTHING"):
        ParallelWrapper(pnet, workers=2, averaging_frequency=2,
                        devices=_cpu(2)).fit(_pds(_batches(3)))


def test_parallel_training_example_flow_through_the_port():
    """``examples/parallel_training.py`` with the port's modules (4
    workers on the CPU, averaging frequency 2, adam; 20 rounds): the
    score reported after averaging falls."""
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.core import (DenseLayer,
                                                         OutputLayer)
    workers = 4
    conf = (NeuralNetConfiguration.builder()
            .seed(3).updater("adam").learning_rate(0.01)
            .activation("tanh").weight_init("xavier").list()
            .layer(DenseLayer(n_out=24))
            .layer(OutputLayer(n_out=3))
            .set_input_type(inputs.feed_forward(8))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.RandomState(0)
    w_true = rng.randn(8, 3)
    pw = (ParallelWrapper.Builder(net).workers(workers)
          .averaging_frequency(2).report_score_after_averaging(True)
          .devices(_cpu(workers)).build())

    def batches(n):
        x = rng.randn(n * 2 * workers * 32, 8).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[np.argmax(x @ w_true, 1)]
        return [DataSet(x[i * 32:(i + 1) * 32], y[i * 32:(i + 1) * 32])
                for i in range(n * 2 * workers)]

    s0 = None
    for _ in range(20):
        pw.fit(batches(1))
        if s0 is None:
            s0 = pw.last_score
    assert pw.last_score < s0
    assert net.iteration == 40


def test_parallel_wrapper_cli_fits_a_model_zip(tmp_path, monkeypatch):
    """``python -m deeplearning4j_tpu_torch.parallel.main --model-path
    ... --iterator-factory module:callable`` (the reference's
    ParallelWrapperMain): the CLI loads the zip, fits it through the
    wrapper on the devices named and saves it; the result equals the
    wrapper driven by hand from the same zip, bitwise."""
    from deeplearning4j_tpu_torch.parallel import main as pmain
    from deeplearning4j_tpu_torch.utils.model_serializer import (
        restore_multi_layer_network, write_model)
    _, net = _pair(_conf(updater="adam", lr=0.01))
    src = str(tmp_path / "in.zip")
    write_model(net, src)
    (tmp_path / "pw_factory.py").write_text(
        "import numpy as np\n"
        "from deeplearning4j_tpu_torch.datasets import DataSet\n"
        "def make():\n"
        "    rng = np.random.RandomState(0)\n"
        "    return [DataSet(rng.randn(8, 4), np.eye(3)[rng.randint(0, 3, 8)])"
        " for _ in range(8)]\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    out = str(tmp_path / "out.zip")
    pmain.main(["--model-path", src, "--iterator-factory",
                "pw_factory:make", "--workers", "2", "--devices",
                "cpu,cpu", "--device", "cpu", "--averaging-frequency", "2",
                "--epochs", "2", "--model-output-path", out])
    got = restore_multi_layer_network(out, device="cpu")
    import pw_factory
    net = restore_multi_layer_network(src, device="cpu")
    ParallelWrapper(net, workers=2, averaging_frequency=2,
                    devices=_cpu(2)).fit(pw_factory.make(), epochs=2)
    assert got.iteration == net.iteration == 8
    # the zip holds float32 params
    np.testing.assert_array_equal(got.get_flat_params(),
                                  net.get_flat_params().astype(np.float32))


def test_u8_wire_staging_equals_float_staging(monkeypatch):
    """Batches that carry a uint8 wire twin (the procedural MNIST) cross
    to the workers as 1 byte a pixel and are decoded by
    ``ingest.device_decode``: bitwise the float32 path
    (``DL4J_TPU_WIRE_UINT8=0``), and the staged bytes (features and
    labels) drop ~4x."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.core import (DenseLayer,
                                                         OutputLayer)

    def run(wire: str):
        monkeypatch.setenv("DL4J_TPU_WIRE_UINT8", wire)
        conf = (NeuralNetConfiguration.builder().seed(4).updater("adam")
                .learning_rate(0.01).activation("relu").list()
                .layer(DenseLayer(n_out=16)).layer(OutputLayer(n_out=10))
                .set_input_type(inputs.feed_forward(784)).build())
        net = MultiLayerNetwork(conf, device="cpu").init()
        ParallelWrapper(net, workers=2, averaging_frequency=2,
                        devices=_cpu(2), prefetch_size=0).fit(
            MnistDataSetIterator(8, 64, shuffle=False))
        staged = monitor.gauge("ingest_staged_bytes").value(path="parallel")
        return net.get_flat_params(), staged

    (wired, u8_bytes), (plain, f32_bytes) = run("1"), run("0")
    np.testing.assert_array_equal(wired, plain)
    assert f32_bytes > 3.5 * u8_bytes
