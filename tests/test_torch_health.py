"""The port's training health layer (``monitor/health.py``) against the JAX
package's: the packed ``[loss, flag, grad_l2*, param_l2*, update_ratio*]``
vectors from the same params and grads, the stacks a health-enabled fit
records, the ``skip_update`` guard leaving params and updater state
bit-identical on every fit path of both containers, ``abort`` naming the
JAX package's step and layer, and a disabled layer staying inert.

Tolerances: the vectors are f32 sums of squares over the same values in
another order (1e-6 relative); a fit's stacks follow the fit's own
parity (1e-4 relative, after up to 4 steps).

C5 (ROADMAP): before this layer the port had no guard, so with
``DL4J_TPU_HEALTH=1`` and ``DL4J_TPU_HEALTH_POLICY=skip_update`` a
non-finite per-batch step overwrote the params with NaN where the JAX
package's ``_train_step_h`` leaves them bit-identical.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JaxList
from deeplearning4j_tpu.monitor import health as jhealth
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    ExistingDataSetIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.monitor import health

from test_torch_ingest import _arrays, _pair

import torch


@pytest.fixture(autouse=True)
def _isolated_health():
    monitor.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    jmonitor.reset()


def _nan(n=32, poison=None):
    """``_arrays(n)`` with every feature NaN, or only row ``poison``'s."""
    x, y = _arrays(n=n)
    if poison is None:
        x[:] = np.nan
    else:
        x[poison, 2] = np.nan
    return x, y


def _state(net):
    return net.get_flat_params(), net.get_flat_updater_state()


# --------------------------------------------------------- the vectors
def _trees(seed, poison=False):
    """Per-layer params, grads and new params of a 3-layer network whose
    middle layer has no params."""
    rng = np.random.RandomState(seed)
    shapes = [{"W": (6, 10), "b": (10,)}, {}, {"W": (10, 3), "b": (3,)}]
    params = [{k: rng.randn(*s).astype(np.float32) for k, s in l.items()}
              for l in shapes]
    grads = [{k: rng.randn(*s).astype(np.float32) * 3 for k, s in
              l.items()} for l in shapes]
    if poison:
        grads[2]["b"][1] = np.inf
    new = [{k: v - 0.1 * grads[i][k] for k, v in l.items()}
           for i, l in enumerate(params)]
    return params, grads, new


@pytest.mark.parametrize("case", ["finite", "inf_grad", "nan_loss",
                                  "explode"])
def test_layer_stats_equal_the_jax_vectors(case):
    params, grads, new = _trees(1, poison=case == "inf_grad")
    loss = np.float32(np.nan if case == "nan_loss" else 0.75)
    limit = 5.0 if case == "explode" else health.DEFAULT_GRAD_NORM_LIMIT
    health.enable("warn", grad_norm_limit=limit)
    jhealth.enable("warn", grad_norm_limit=limit)

    def flat(trees):
        return [torch.from_numpy(v) for l in trees for v in l.values()]

    counts = [len(l) for l in params]
    got, bad = health.layer_stats(flat(params), flat(new), flat(grads),
                                  torch.tensor(loss), counts,
                                  health._layer_matrix(counts, "cpu"))
    jt = [{k: jnp.asarray(v) for k, v in l.items()} for l in params]
    want, jbad = jhealth.layer_stats(
        jt, [{k: jnp.asarray(v) for k, v in l.items()} for l in new],
        [{k: jnp.asarray(v) for k, v in l.items()} for l in grads],
        jnp.asarray(loss))
    assert got.shape == (2 + 3 * 3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert bool(bad) == bool(jbad) == (case != "finite")


def test_a_fit_records_the_jax_stacks():
    """Health on, the cache path, 2 epochs of 4 steps: the port's stack of
    its last dispatch equals the JAX package's, step for step."""
    health.enable("warn")
    jhealth.enable("warn")
    x, y = _arrays(n=64)
    jnet, pnet = _pair()
    jnet.fit(JaxList(JaxDataSet(x, y), 16), epochs=2, ingest="cache")
    pnet.fit(ListDataSetIterator(DataSet(x, y), 16), epochs=2,
             ingest="cache")
    got = health.last_stack_for(pnet)
    want = jhealth.last_stack_for(jnet)
    assert got.shape == want.shape == (8, 2 + 3 * 2)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert health.state() == "ok"
    snap = health.last_for(pnet)
    assert snap["steps"] == 8 and snap["flagged_steps"] == 0
    assert set(snap["layers"]) == {"0", "1"}
    text = monitor.registry().prometheus_text()
    for name in (health.LOSS, health.GRAD_L2, health.PARAM_L2,
                 health.UPDATE_RATIO, health.LAST_DISPATCH_TS):
        assert name in text


# ----------------------------------------------------- skip_update guard
def _fit(net, path, x, y):
    if path == "batch":
        net.fit(ListDataSetIterator(DataSet(x, y), 16), ingest="batch")
    elif path == "cache":
        net.fit(ListDataSetIterator(DataSet(x, y), 16), ingest="cache")
    elif path == "window":
        net.fit(ExistingDataSetIterator(list(ListDataSetIterator(
            DataSet(x, y), 16))), ingest="window", window=2)
    else:
        net.fit_scan([DataSet(x[i:i + 16], y[i:i + 16])
                      for i in range(0, len(x), 16)])


@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("path", ["batch", "cache", "window", "fit_scan"])
def test_skip_update_leaves_the_state_bit_identical(container, path):
    health.enable("skip_update")
    net = _pair(container)[1]
    before = _state(net)
    _fit(net, path, *_nan())
    for got, want in zip(_state(net), before):
        np.testing.assert_array_equal(got, want)
    assert monitor.counter(health.SKIPPED_TOTAL).value() == 2
    assert health.state() == "diverged"
    assert net.iteration == 2


@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("path", ["batch", "cache"])
def test_abort_names_the_jax_step_and_layer(container, path):
    """A NaN in the third batch: both packages abort at step 2, at the
    loss."""
    health.enable("abort")
    jhealth.enable("abort")
    x, y = _nan(n=64, poison=40)
    jnet, pnet = _pair(container)
    with pytest.raises(health.TrainingDivergedError) as got:
        _fit(pnet, path, x, y)
    with pytest.raises(jhealth.TrainingDivergedError) as want:
        jnet.fit(JaxList(JaxDataSet(x, y), 16), ingest=path)
    assert (got.value.step, got.value.layer) == \
        (want.value.step, want.value.layer) == (2, "loss")
    assert health.state() == "diverged"


def test_the_grad_norm_limit_aborts_like_jax():
    health.enable("abort", grad_norm_limit=1e-6)
    jhealth.enable("abort", grad_norm_limit=1e-6)
    x, y = _arrays(n=32)
    jnet, pnet = _pair()
    with pytest.raises(health.TrainingDivergedError) as got:
        pnet.fit(ListDataSetIterator(DataSet(x, y), 16))
    with pytest.raises(jhealth.TrainingDivergedError) as want:
        jnet.fit(JaxList(JaxDataSet(x, y), 16))
    assert (got.value.step, got.value.layer) == \
        (want.value.step, want.value.layer)
    assert "limit" in str(got.value)


def test_warn_completes_publishes_and_stays_diverged():
    health.enable("warn")
    net = _pair()[1]
    net.fit(ListDataSetIterator(DataSet(*_nan()), 16))   # one dispatch
    assert health.state() == "diverged"
    assert monitor.counter(health.NONFINITE_TOTAL).value() == 2
    assert "train_health_state 1" in monitor.registry().prometheus_text()
    assert health.snapshot()["last_dispatch"]["diverged_at"]["step"] == 0
    assert np.isnan(net.get_flat_params()).any()      # warn does not guard
    clean = _pair()[1]
    clean.fit(ListDataSetIterator(DataSet(*_arrays(n=32)), 16))
    assert health.state() == "diverged"
    health.reset()
    assert health.state() == "ok"


def test_a_disabled_guard_is_inert():
    net = _pair()[1]
    net.fit(ListDataSetIterator(DataSet(*_nan()), 16), ingest="cache")
    assert health.state() == "ok"
    assert health.last_stack_for(net) is None
    assert "train_health_loss" not in monitor.registry().prometheus_text()
    assert health.last_dispatch_timestamp() is not None
    assert np.isnan(net.get_flat_params()).any()


@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("path", ["batch", "cache", "window", "fit_scan"])
def test_a_step_computes_health_only_when_asked(container, path,
                                                monkeypatch):
    """With the layer off and policy ``warn`` (the default) no step
    computes the vector or the guard; enabled, every step does."""
    calls = []
    real = health.layer_stats

    def spy(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(health, "layer_stats", spy)
    health.disable()
    net = _pair(container)[1]
    _fit(net, path, *_arrays(n=32))
    assert calls == [] and health.last_stack_for(net) is None
    health.enable("warn")
    _fit(net, path, *_arrays(n=32))
    assert len(calls) == 2
    assert health.last_stack_for(net).shape[0] in (1, 2)


def test_env_skip_update_guards_with_the_layer_off(monkeypatch):
    """``DL4J_TPU_HEALTH_POLICY=skip_update`` with ``DL4J_TPU_HEALTH=0``:
    the JAX package's step still selects the old params on a flagged
    step (its guard reads the policy only), and so does the port's; no
    stats are published."""
    monkeypatch.setenv("DL4J_TPU_HEALTH", "0")
    monkeypatch.setenv("DL4J_TPU_HEALTH_POLICY", "skip_update")
    health.reset()
    jhealth.reset()
    assert not health.enabled() and health.in_step()
    jnet, pnet = _pair()
    x, y = _nan(n=16)
    before = pnet.get_flat_params()
    pnet.fit(DataSet(x, y))
    jnet.fit(JaxDataSet(x, y), ingest="batch")
    np.testing.assert_array_equal(pnet.get_flat_params(), before)
    np.testing.assert_array_equal(np.asarray(jnet.get_flat_params()),
                                  before)
    assert health.last_stack_for(pnet) is None


def test_c5_env_skip_update_guards_the_per_batch_step(monkeypatch):
    """C5: ``DL4J_TPU_HEALTH=1`` with ``skip_update`` through the
    environment: a non-finite per-batch step leaves the params
    bit-identical, in the port as in the JAX package."""
    monkeypatch.setenv("DL4J_TPU_HEALTH", "1")
    monkeypatch.setenv("DL4J_TPU_HEALTH_POLICY", "skip_update")
    health.reset()
    jhealth.reset()
    assert health.config().policy == "skip_update" and health.enabled()
    jnet, pnet = _pair()
    x, y = _nan(n=16)
    before = pnet.get_flat_params()
    pnet.fit(DataSet(x, y))
    jnet.fit(JaxDataSet(x, y), ingest="batch")
    np.testing.assert_array_equal(pnet.get_flat_params(), before)
    np.testing.assert_array_equal(np.asarray(jnet.get_flat_params()),
                                  before)


def test_config_reads_the_environment(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_HEALTH", "on")
    monkeypatch.setenv("DL4J_TPU_HEALTH_POLICY", "ABORT")
    monkeypatch.setenv("DL4J_TPU_GRAD_NORM_LIMIT", "12.5")
    cfg = health.config()
    assert (cfg.enabled, cfg.policy, cfg.grad_norm_limit) == \
        (True, "abort", 12.5)
    health.disable()
    assert not health.enabled()
    with pytest.raises(ValueError, match="unknown guard policy"):
        health.enable("ignore")


def test_param_listener_prints_the_jax_health_columns(tmp_path):
    """With health on, ``ParamAndGradientIterationListener`` appends the
    per-step ``grad_l2_step`` and ``update_ratio_step`` of each param's
    layer, as the JAX package's does; the same rows to 1e-5."""
    from deeplearning4j_tpu.optimize.listeners.listeners import \
        ParamAndGradientIterationListener as JaxPGIL
    from deeplearning4j_tpu_torch.optimize.listeners.listeners import \
        ParamAndGradientIterationListener
    health.enable("warn")
    jhealth.enable("warn")
    x, y = _arrays(n=32)
    jnet, pnet = _pair(updater="sgd")
    paths = {k: str(tmp_path / f"{k}.tsv") for k in ("port", "jax")}
    pnet.set_listeners(ParamAndGradientIterationListener(
        2, output_to_console=False, file_path=paths["port"]))
    jnet.set_listeners(JaxPGIL(2, output_to_console=False,
                               file_path=paths["jax"]))
    pnet.fit(ListDataSetIterator(DataSet(x, y), 16), ingest="batch")
    jnet.fit(JaxList(JaxDataSet(x, y), 16), ingest="batch")
    rows = {k: [ln.split("\t") for ln in open(p).read().splitlines()]
            for k, p in paths.items()}
    assert rows["port"][0] == rows["jax"][0]
    assert rows["port"][0][-2:] == ["grad_l2_step", "update_ratio_step"]
    assert len(rows["port"]) == len(rows["jax"]) == 5
    for got, want in zip(rows["port"][1:], rows["jax"][1:]):
        assert got[:2] == want[:2]
        np.testing.assert_allclose([float(v) for v in got[2:]],
                                   [float(v) for v in want[2:]],
                                   rtol=1e-5, atol=1e-7)


# --------------------------------- the phase attribution and the gauges
def test_phase_functions_and_prometheus_text_match_jax():
    """The same observations in both registries give the same
    phase_breakdown (whole and as a delta against a snapshot) and the
    same exposition lines; a port fit records its data/step/listener
    phases and the precision gauges."""
    jmonitor.reset()
    monitor.reset()
    for mod in (jmonitor, monitor):
        mod.observe_phase("data", 0.002)
        mod.observe_phase("step", 0.010, path="batch")
    jsnap, psnap = jmonitor.snapshot(), monitor.snapshot()
    for mod in (jmonitor, monitor):
        mod.observe_phase("step", 0.004, path="batch")
        mod.observe_phase("listener", 0.001)
    assert monitor.phase_breakdown() == jmonitor.phase_breakdown()
    assert monitor.phase_breakdown(psnap) == jmonitor.phase_breakdown(jsnap)
    assert monitor.phase_breakdown(psnap)["steps"] == 1

    def phase_lines(text):
        # the help strings differ: the port's step is not a jitted one
        return [ln for ln in text.splitlines()
                if "phase_" in ln and not ln.startswith("# HELP")]

    assert phase_lines(monitor.prometheus_text()) == \
        phase_lines(jmonitor.prometheus_text())
    monitor.reset()
    x, y = _arrays()
    _, pnet = _pair()
    from deeplearning4j_tpu_torch.optimize.listeners.listeners import \
        CollectScoresIterationListener
    pnet.set_listeners(CollectScoresIterationListener())
    for i in range(3):
        pnet.fit(DataSet(x[16 * i:16 * i + 16], y[16 * i:16 * i + 16]))
    got = monitor.phase_breakdown()
    assert got["steps"] == 3 and got["step_ms"] > 0 and got["data_ms"] > 0
    assert got["listener_ms"] > 0
    assert monitor.gauge("precision_param_bits").value() == 32
    assert monitor.gauge("precision_master_weights").value() == 0
    monitor.reset()
    jmonitor.reset()


@pytest.mark.parametrize("mode", ["fp32", "mixed_bf16"])
def test_precision_gauges_match_jax(mode, monkeypatch):
    from deeplearning4j_tpu.nn import precision as jprecision
    from deeplearning4j_tpu_torch.nn import precision
    monkeypatch.setenv("DL4J_TPU_PRECISION", mode)
    jmonitor.reset()
    monitor.reset()
    jprecision.publish(jprecision.resolve_policy(None))
    precision.publish(precision.resolve_policy(None,
                                               torch.device("cpu")))
    for name in ("precision_param_bits", "precision_compute_bits",
                 "precision_master_weights"):
        assert monitor.gauge(name).value() == jmonitor.gauge(name).value()
    monitor.reset()
    jmonitor.reset()
