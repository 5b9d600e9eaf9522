"""The recurrent slice of the port (``nn/layers/recurrent.py``, truncated
BPTT in ``nn/multilayer.py``) against the JAX package, case by case after
``tests/test_recurrent.py``: ``lstm_scan`` forward and gradients,
GravesLSTM, bidirectional and stacked networks (output, score, one fit
step), ``rnn_time_step``, tBPTT with and without a truncated backward,
masked global pooling over LSTM output, the configuration JSON and the
float64 gradient checks.

Every network is built in the JAX package, read by the port from its JSON
and given the JAX network's weights; inputs come from a numpy seed.
Tolerances: float64 1e-10, float32 1e-5, of max|JAX| for tensors and
relative for scores (sums in another order).  The JAX package computes the
learning rate in float32 even for a float64 network, so float64 updates
run SGD at a rate exact in float32 (0.0625); RmsProp is held in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import pooling as jpool
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.nn import activations as act
from deeplearning4j_tpu_torch.nn.conf import inputs
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import recurrent as rec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = {"float64": 1e-10, "float32": 1e-5}
N_IN, N_CLS = 3, 3
LR = {"float64": ("sgd", 0.0625), "float32": ("rmsprop", 0.05)}


def _close(got, want, tol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(initial=0.0),
                                              1e-30))


def _seq(n=4, t=6, seed=0, mask=False, dtype="float64"):
    """Inputs, one-hot labels and, with ``mask``, right-padded ragged
    masks (lengths 2..t), as ``tests/test_recurrent.py`` draws them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, t, N_IN).astype(dtype)
    y = np.eye(N_CLS, dtype=dtype)[rng.randint(0, N_CLS, (n, t))]
    fm = None
    if mask:
        lengths = rng.randint(2, t + 1, n)
        fm = (np.arange(t)[None, :] < lengths[:, None]).astype(dtype)
    return x, y, fm


def _conf(layers, dtype="float64", t=6, tbptt=None, back=None,
          updater=None):
    name, lr = updater or LR[dtype]
    lb = (JaxConf.builder().seed(12345).dtype(dtype).updater(name)
          .learning_rate(lr).activation("tanh").weight_init("xavier")
          .list())
    for layer in layers:
        lb.layer(layer)
    lb.set_input_type(jin.recurrent(N_IN, t))
    if tbptt:
        lb.backprop_type("tbptt")
        lb.t_bptt_forward_length(tbptt)
        lb.t_bptt_backward_length(back or tbptt)
    return lb.build()


def _pair(conf):
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def _out(n=N_CLS, **kw):
    return jrec.RnnOutputLayer(n_out=n, activation="softmax",
                               loss="mcxent", **kw)


def _stacks():
    return {
        "lstm": [jrec.GravesLSTM(n_out=4), _out()],
        "bidirectional": [jrec.GravesBidirectionalLSTM(n_out=4), _out()],
        "stacked": [jrec.GravesLSTM(n_out=4), jrec.GravesLSTM(n_out=3),
                    _out()],
    }


def _fit_both(jnet, pnet, x, y, fm=None):
    jnet.fit(JaxDataSet(x, y, features_mask=fm, labels_mask=fm))
    pnet.fit(DataSet(x, y, features_mask=fm, labels_mask=fm))


def _hold_nets(jnet, pnet, tol):
    np.testing.assert_allclose(pnet.score(), float(jnet.score()), rtol=tol)
    _close(pnet.get_flat_params(), jnet.get_flat_params(), tol)
    _close(pnet.get_flat_updater_state(), jnet.get_flat_updater_state(),
           tol)
    assert pnet.iteration == jnet.iteration


# ---------------------------------------------------------------- lstm_scan
def _scan_inputs(dtype, seed=1, b=3, t=7, n_in=5, H=4):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(n_in, 4 * H) * 0.4, rng.randn(H, 4 * H + 3) * 0.4,
              rng.randn(4 * H) * 0.2, rng.randn(b, t, n_in),
              rng.randn(b, H) * 0.5, rng.randn(b, H) * 0.5]
    mask = (rng.rand(b, t) > 0.3).astype(dtype)
    return [a.astype(dtype) for a in arrays], mask


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_forward_and_gradients_match_jax(dtype, masked, reverse):
    """Outputs, the final (h, c) and the gradients of a loss that reads
    all three with respect to W, RW, b, x and the carry in."""
    arrays, mask = _scan_inputs(dtype)
    m = mask if masked else None

    def jax_loss(W, RW, b, x, h, c):
        out, (hf, cf) = jrec.lstm_scan(
            W, RW, b, x, (h, c), afn=jact.get("tanh"),
            gate_fn=jact.get("sigmoid"),
            mask=None if m is None else jnp.asarray(m), reverse=reverse)
        return jnp.sum(out ** 2) + jnp.sum(hf * 0.3) + jnp.sum(cf ** 3), \
            (out, hf, cf)

    jargs = [jnp.asarray(a) for a in arrays]
    (_, (jout, jh, jc)), jgrads = jax.value_and_grad(
        jax_loss, argnums=tuple(range(6)), has_aux=True)(*jargs)

    targs = [torch.tensor(a, requires_grad=True) for a in arrays]
    W, RW, b, x, h, c = targs
    out, (hf, cf) = rec.lstm_scan(
        W, RW, b, x, (h, c), afn=act.get("tanh"), gate_fn=act.get("sigmoid"),
        mask=None if m is None else torch.tensor(m), reverse=reverse)
    loss = (out ** 2).sum() + (hf * 0.3).sum() + (cf ** 3).sum()
    grads = torch.autograd.grad(loss, targs)
    tol = TOL[dtype]
    for got, want in zip((out, hf, cf) + grads,
                         (jout, jh, jc) + tuple(jgrads)):
        assert got.dtype == getattr(torch, dtype)
        _close(got, want, tol)
    if masked:   # masked steps emit exact zeros
        assert np.all(out.detach().numpy()[mask == 0] == 0.0)


def test_lstm_scan_promotes_a_bf16_carry_once():
    """bf16 inputs and carry with f32 weights: the projection and the carry
    are promoted to f32 (the result type of x @ W and RW), as in the JAX
    package, and the outputs agree at the f32 tolerance."""
    arrays, _ = _scan_inputs("float32", seed=4)
    W, RW, b, x, h, c = arrays
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    hb, cb = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                         .astype(jnp.float32)) for a in (h, c))
    jout, (jh, jc) = jrec.lstm_scan(
        jnp.asarray(W), jnp.asarray(RW), jnp.asarray(b),
        jnp.asarray(xb).astype(jnp.bfloat16),
        (jnp.asarray(hb).astype(jnp.bfloat16),
         jnp.asarray(cb).astype(jnp.bfloat16)),
        afn=jact.get("tanh"), gate_fn=jact.get("sigmoid"))
    bf = torch.bfloat16
    out, (ph, pc) = rec.lstm_scan(
        torch.tensor(W), torch.tensor(RW), torch.tensor(b),
        torch.tensor(xb).to(bf),
        (torch.tensor(hb).to(bf), torch.tensor(cb).to(bf)),
        afn=act.get("tanh"), gate_fn=act.get("sigmoid"))
    assert jout.dtype == jnp.float32
    assert out.dtype == ph.dtype == pc.dtype == torch.float32
    for got, want in ((out, jout), (ph, jh), (pc, jc)):
        _close(got, want, TOL["float32"])


# ------------------------------------------------------ networks vs JAX
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", list(_stacks()))
def test_network_output_score_and_fit_step_match_jax(kind, masked, dtype):
    jnet, pnet = _pair(_conf(_stacks()[kind], dtype))
    x, y, fm = _seq(mask=masked, dtype=dtype)
    tol = TOL[dtype]
    _close(pnet.output(x, features_mask=fm),
           jnet.output(x, features_mask=fm), tol)
    np.testing.assert_allclose(
        pnet.score(DataSet(x, y, features_mask=fm, labels_mask=fm)),
        float(jnet.score(JaxDataSet(x, y, features_mask=fm,
                                    labels_mask=fm))), rtol=tol)
    _fit_both(jnet, pnet, x, y, fm)
    _hold_nets(jnet, pnet, tol)
    _close(pnet.output(x, features_mask=fm),
           jnet.output(x, features_mask=fm), tol)


def test_masked_steps_emit_zeros_from_the_lstm():
    jnet, pnet = _pair(_conf([jrec.GravesLSTM(n_out=5), _out()]))
    x, _, fm = _seq(mask=True)
    acts = pnet._forward(pnet.params, pnet.net_state, torch.tensor(x),
                         train=False, rng=None, mask=torch.tensor(fm),
                         to_layer=0)[0]
    jacts = jnet._forward(jnet.params, jnet.net_state, jnp.asarray(x),
                          train=False, rng=None, mask=jnp.asarray(fm),
                          to_layer=0)[0]
    assert np.all(acts.numpy()[fm == 0] == 0.0)
    _close(acts, jacts, TOL["float64"])


def test_bidirectional_differs_from_unidirectional():
    x, _, _ = _seq()
    uni = _pair(_conf([jrec.GravesLSTM(n_out=4), _out()]))[1]
    bi = _pair(_conf([jrec.GravesBidirectionalLSTM(n_out=4), _out()]))[1]
    assert not np.allclose(uni.output(x).numpy(), bi.output(x).numpy())


def test_bidirectional_ragged_masks_in_both_directions():
    """Right-padded ragged rows: the reversed scan starts in the padding
    with its zero carry passed through, so each row equals that row alone,
    truncated to its length, and the JAX package's."""
    jnet, pnet = _pair(_conf([jrec.GravesBidirectionalLSTM(n_out=4),
                              _out()], t=7))
    x, _, _ = _seq(n=3, t=7, seed=5)
    lengths = (7, 3, 5)                     # one full row, two padded
    fm = (np.arange(7)[None, :] < np.array(lengths)[:, None]).astype(
        np.float64)
    got = pnet.output(x, features_mask=fm).numpy()
    _close(got, jnet.output(x, features_mask=fm), TOL["float64"])
    for i, t in enumerate(lengths):
        alone = pnet.output(x[i:i + 1, :t]).numpy()
        _close(got[i:i + 1, :t], alone, TOL["float64"])


# ----------------------------------------------------------- rnn_time_step
def test_rnn_time_step_single_steps_match_output_and_jax():
    jnet, pnet = _pair(_conf(_stacks()["stacked"]))
    x, _, _ = _seq()
    full = pnet.output(x).numpy()
    steps = []
    for t in range(x.shape[1]):
        got = pnet.rnn_time_step(x[:, t])
        _close(got, jnet.rnn_time_step(x[:, t]), TOL["float64"])
        steps.append(got.numpy())
    _close(np.stack(steps, 1), full, TOL["float64"])
    for got, want in zip(pnet.rnn_get_previous_state(0),
                         jnet.rnn_get_previous_state(0)):
        _close(got, want, TOL["float64"])


def test_rnn_time_step_chunked_matches_output():
    _, pnet = _pair(_conf([jrec.GravesLSTM(n_out=4), _out()]))
    x, _, _ = _seq()
    full = pnet.output(x).numpy()
    a = pnet.rnn_time_step(x[:, :2]).numpy()
    b = pnet.rnn_time_step(x[:, 2:]).numpy()
    _close(np.concatenate([a, b], 1), full, TOL["float64"])


def test_rnn_clear_previous_state_resets():
    _, pnet = _pair(_conf([jrec.GravesLSTM(n_out=4), _out()]))
    x, _, _ = _seq()
    first = pnet.rnn_time_step(x[:, 0]).numpy()
    assert not np.allclose(first, pnet.rnn_time_step(x[:, 0]).numpy())
    pnet.rnn_clear_previous_state()
    np.testing.assert_array_equal(first, pnet.rnn_time_step(x[:, 0]))


def test_bidirectional_refuses_carried_state():
    jnet, pnet = _pair(_conf(_stacks()["bidirectional"]))
    x, _, _ = _seq()
    for net in (jnet, pnet):
        with pytest.raises(ValueError, match="full sequence"):
            net.rnn_time_step(x[:, 0])


# ------------------------------------------------------------------ tBPTT
def test_tbptt_window_covering_the_sequence_equals_standard_backprop():
    x, y, _ = _seq()
    layers = lambda: [jrec.GravesLSTM(n_out=4), _out()]
    _, a = _pair(_conf(layers(), tbptt=6))
    _, b = _pair(_conf(layers()))
    b.set_flat_params(a.get_flat_params())
    a.fit(DataSet(x, y))
    b.fit(DataSet(x, y))
    _close(a.get_flat_params(), b.get_flat_params(), TOL["float64"])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fwd,back", [(4, 4), (4, 3), (5, 2)])
def test_tbptt_windows_match_jax(fwd, back, masked, dtype):
    """Two stacked LSTMs over T=11 (a ragged last window), back <= fwd
    (adv = window - back > 0 for all but the equal case), two fits: the
    carries cross windows and are zeroed at the next minibatch; one
    iteration per window, the score the last window's."""
    jnet, pnet = _pair(_conf(_stacks()["stacked"], dtype, t=11, tbptt=fwd,
                             back=back))
    x, y, fm = _seq(n=5, t=11, seed=2, mask=masked, dtype=dtype)
    for _ in range(2):
        _fit_both(jnet, pnet, x, y, fm)
    _hold_nets(jnet, pnet, TOL[dtype])
    assert pnet.iteration == 2 * -(-11 // fwd)


def test_tbptt_back_shorter_exact_truncation_semantics():
    """With back < fwd, labels of the leading steps still train the output
    layer but never reach the LSTM; params after the step equal the JAX
    package's."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6, 3)
    y = np.eye(3)[rng.randint(0, 3, (4, 6))]
    y2 = y.copy()
    y2[:, :3] = np.eye(3)[rng.randint(0, 3, (4, 3))]   # leading only

    def one_step(labels):
        jnet, pnet = _pair(_conf([jrec.GravesLSTM(n_out=4), _out()],
                                 tbptt=6, back=3))
        _fit_both(jnet, pnet, x, labels)
        _close(pnet.get_flat_params(), jnet.get_flat_params(),
               TOL["float64"])
        return pnet

    a, b = one_step(y), one_step(y2)
    for k in a.params[0]:
        torch.testing.assert_close(a.params[0][k], b.params[0][k], rtol=0,
                                   atol=1e-12)
    assert not torch.allclose(a.params[1]["W"], b.params[1]["W"])


def test_tbptt_training_decreases_score():
    rng = np.random.RandomState(7)
    x = rng.randn(16, 12, 3)
    cls = (np.cumsum(x.sum(-1), axis=1) > 0).astype(int)
    ds = DataSet(x, np.eye(3)[cls + 1])
    _, net = _pair(_conf([jrec.GravesLSTM(n_out=8), _out()], t=12,
                         tbptt=4, updater=("sgd", 0.1)))
    net.fit(ds)
    s0 = net.score(ds)
    net.fit(ds, epochs=30)
    assert net.score(ds) < s0 * 0.7
    assert net.iteration == 31 * 3    # 12 steps / window 4, per fit


def test_tbptt_back_longer_than_fwd_raises():
    x, y, _ = _seq()
    jnet, pnet = _pair(_conf([jrec.GravesLSTM(n_out=4), _out()], tbptt=4,
                             back=6))
    with pytest.raises(ValueError, match="not meaningful"):
        pnet.fit(DataSet(x, y))
    with pytest.raises(ValueError):
        jnet.fit(JaxDataSet(x, y))


def test_tbptt_refuses_a_bidirectional_net():
    x, y, _ = _seq()
    jnet, pnet = _pair(_conf(_stacks()["bidirectional"], tbptt=3))
    for net, ds in ((pnet, DataSet(x, y)), (jnet, JaxDataSet(x, y))):
        with pytest.raises(ValueError, match="truncated BPTT"):
            net.fit(ds)


def test_tbptt_refuses_sequence_level_labels():
    layers = [jrec.GravesLSTM(n_out=4),
              jpool.GlobalPoolingLayer(pooling_type="avg"),
              jcore.OutputLayer(n_out=N_CLS)]
    jnet, pnet = _pair(_conf(layers, tbptt=3))
    x, _, _ = _seq()
    y = np.eye(N_CLS)[[0, 1, 2, 0]]
    for net, ds in ((pnet, DataSet(x, y)), (jnet, JaxDataSet(x, y))):
        with pytest.raises(ValueError, match="per-timestep labels"):
            net.fit(ds)


@pytest.mark.parametrize("bad", [{"tbptt": -1}, {"tbptt": 4, "back": -2}])
def test_tbptt_lengths_are_validated(bad):
    layers = [jrec.GravesLSTM(n_out=4), _out()]
    with pytest.raises(ValueError, match="tbptt"):
        _conf(layers, tbptt=bad["tbptt"], back=bad.get("back"))
    b = (NeuralNetConfiguration.builder().list()
         .layer(rec.GravesLSTM(n_out=4)).layer(rec.RnnOutputLayer(n_out=3))
         .set_input_type(inputs.recurrent(3, 6)).backprop_type("tbptt")
         .t_bptt_forward_length(bad["tbptt"]))
    if "back" in bad:
        b.t_bptt_backward_length(bad["back"])
    with pytest.raises(ValueError, match="tbptt"):
        b.build()


# --------------------------------------------- masked global pooling
@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
def test_masked_global_pooling_over_lstm_equals_the_truncated_sequence(kind):
    """LSTM -> masked GlobalPooling -> OutputLayer: a padded, masked
    sequence gives what its unpadded prefix gives, in both packages."""
    layers = [jrec.GravesLSTM(n_out=5),
              jpool.GlobalPoolingLayer(pooling_type=kind),
              jcore.OutputLayer(n_out=N_CLS)]
    jnet, pnet = _pair(_conf(layers, t=7))
    rng = np.random.RandomState(0)
    x_real = rng.randn(3, 4, N_IN)
    x_pad = np.concatenate([x_real, 99.0 * np.ones((3, 3, N_IN))], axis=1)
    mask = np.zeros((3, 7))
    mask[:, :4] = 1.0
    got = pnet.output(x_pad, features_mask=mask).numpy()
    _close(got, pnet.output(x_real).numpy(), TOL["float64"])
    _close(got, jnet.output(x_pad, features_mask=mask), TOL["float64"])


# ------------------------------------------------------------------ config
def test_configuration_json_is_the_jax_packages():
    """The port's builder writes the JAX package's JSON field for field,
    forget_gate_bias_init, gate_activation_fn and the tBPTT fields
    included, and each package reads the other's."""
    jconf = (JaxConf.builder().seed(7).updater("rmsprop").learning_rate(0.05)
             .list()
             .layer(jrec.GravesLSTM(n_out=8, activation="tanh",
                                    forget_gate_bias_init=0.5,
                                    gate_activation_fn="hardsigmoid"))
             .layer(jrec.GravesBidirectionalLSTM(n_out=6, activation="tanh"))
             .layer(_out(5))
             .set_input_type(jin.recurrent(5, 9))
             .backprop_type("tbptt").t_bptt_forward_length(4)
             .t_bptt_backward_length(3).build())
    pconf = (NeuralNetConfiguration.builder().seed(7).updater("rmsprop")
             .learning_rate(0.05).list()
             .layer(rec.GravesLSTM(n_out=8, activation="tanh",
                                   forget_gate_bias_init=0.5,
                                   gate_activation_fn="hardsigmoid"))
             .layer(rec.GravesBidirectionalLSTM(n_out=6, activation="tanh"))
             .layer(rec.RnnOutputLayer(n_out=5, activation="softmax",
                                       loss="mcxent"))
             .set_input_type(inputs.recurrent(5, 9))
             .backprop_type("tbptt").t_bptt_forward_length(4)
             .t_bptt_backward_length(3).build())
    assert pconf.to_json() == jconf.to_json()
    back = MultiLayerConfiguration.from_json(jconf.to_json())
    assert isinstance(back.layers[1], rec.GravesBidirectionalLSTM)
    assert back.layers[1].n_in == 8 and back.tbptt_back_length == 3
    assert back.to_json() == jconf.to_json()
    net = MultiLayerNetwork(back, device="cpu").init()
    H = 8
    assert net.params[0]["RW"].shape == (H, 4 * H + 3)
    torch.testing.assert_close(
        net.params[0]["b"], torch.tensor([0.0] * H + [0.5] * H
                                         + [0.0] * 2 * H))
    assert list(net.params[1]) == ["WF", "RWF", "bF", "WB", "RWB", "bB"]


# ------------------------------------------------------- gradient checks
def _mse_data():
    x, _, _ = _seq()
    return DataSet(x, np.random.RandomState(1).randn(4, 6, N_CLS))


_CHECKS = {
    "lstm": ([jrec.GravesLSTM(n_out=4), _out()], False),
    "lstm_masked": ([jrec.GravesLSTM(n_out=4), _out()], True),
    "bidirectional": ([jrec.GravesBidirectionalLSTM(n_out=4), _out()],
                      False),
    "bidirectional_masked": ([jrec.GravesBidirectionalLSTM(n_out=4),
                              _out()], True),
    "stacked": ([jrec.GravesLSTM(n_out=4), jrec.GravesLSTM(n_out=3),
                 _out()], False),
    "mse": ([jrec.GravesLSTM(n_out=4),
             jrec.RnnOutputLayer(n_out=N_CLS, activation="identity",
                                 loss="mse")], False),
}


@pytest.mark.parametrize("case", list(_CHECKS))
def test_check_gradients_float64(case):
    layers, masked = _CHECKS[case]
    _, pnet = _pair(_conf(layers))
    if case == "mse":
        ds = _mse_data()
    else:
        x, y, fm = _seq(mask=masked)
        ds = DataSet(x, y, features_mask=fm, labels_mask=fm)
    assert check_gradients(pnet, ds)
