"""The reference against the program at a small size on the CPU, the
fp8 control coming out as not correct, and runs driven with the timed
path broken underneath coming out as not correct."""

import copy
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import inputs, program, run
from perfbench.traffic import serve_open_loop as S
from perfbench.traffic import train_fit as T

CPU = torch.device("cpu")


def small(name, size, lr=None):
    """The configuration at ``size`` x ``size`` pixels and 10 classes
    (every width kept), optionally at another learning rate."""
    cfg = copy.deepcopy(run.read_json(run.HERE / "configs" / f"{name}.json"))
    cfg.update(height=size, width=size, n_classes=10)
    cfg["program"]["kwargs"].update(height=size, width=size, n_classes=10)
    if lr is not None:
        cfg["learning_rate"] = lr
        if "learning_rate" in cfg["program"]["kwargs"]:
            cfg["program"]["kwargs"]["learning_rate"] = lr
        else:
            cfg["program"]["updater_overrides"]["learning_rate"] = lr
    model = run.load_module(run.HERE / "reference" / f"{cfg['reference']}.py",
                            f"perfbench.reference.{cfg['reference']}")
    return model, cfg


CASES = {"resnet50": (64, 8, 1e-5), "vgg16": (32, 4, None)}


def readings(name, seed=3, quant=None):
    size, batch, lr = CASES[name]
    model, cfg = small(name, size, lr)
    u8 = inputs.make_images(3 * batch, cfg, seed, "images", CPU)
    y = inputs.make_labels(3 * batch, 10, seed, "labels", CPU)
    want = T.reference_steps(model, cfg, u8, y, batch, seed, CPU)
    if quant:
        got = T.reference_steps(model, cfg, u8, y, batch, seed, CPU, quant)
    else:
        net = program.build(cfg, CPU)
        program.load(net, inputs.make_weights(model.leaves(cfg), seed, CPU,
                                              cfg["precision"]),
                     inputs.make_state(model.state_leaves(cfg), CPU,
                                       cfg["precision"]))
        got = T.checked_steps(net, model, cfg, u8, y, batch, seed, CPU,
                              "cache")
    return T.compare(got, want)[0]


def one_pass_variance(x, gamma, beta, mean, var, train, eps, decay,
                      quant=None):
    """Batch norm with the program's one-pass variance, E[x^2] - E[x]^2,
    and its folded scale and shift."""
    shape = (1, -1, 1, 1)
    m, v, new = mean, var, (mean, var)
    if train:
        m = x.mean((0, 2, 3))
        v = torch.clamp_min(x.square().mean((0, 2, 3)) - m.square(), 0.0)
        new = (decay * mean + (1 - decay) * m.detach(),
               decay * var + (1 - decay) * v.detach())
    inv = torch.rsqrt(v + eps)
    scale, shift = gamma * inv, beta - m * gamma * inv
    return x * scale.reshape(shape) + shift.reshape(shape), new


@pytest.mark.parametrize("name,bn,tol", [
    # the two-pass variance of the reference against the program's
    # one-pass one: at 64x64 and 8 images the batch norms of the last
    # stage see 32 values each, and the formulas part in the fourth digit
    ("resnet50", None, (1e-3, 1e-2, 5e-2)),
    ("resnet50", one_pass_variance, (1e-4, 1e-4, 1e-2)),
    ("vgg16", None, (1e-4, 1e-3, 1e-3))])
def test_reference_follows_the_program(monkeypatch, name, bn, tol):
    """Forward (the first step's score), the first update (the gradient
    norms) and the three steps' change, all in float32."""
    if bn is not None:
        from perfbench.reference import ops
        monkeypatch.setattr(ops, "batch_norm", bn)
    gaps = readings(name)
    assert gaps["loss_gap"] < tol[0]
    assert gaps["grad_gap"] < tol[1]
    assert gaps["change_gap"] < tol[2]


@pytest.mark.parametrize("name", sorted(CASES))
def test_fp8_control_is_far_off(name):
    sound, low = readings(name), readings(name, quant="fp8")
    assert max(low[k] / max(sound[k], 1e-12) for k in low) > 10.0


def train_ctx(name, seed=7):
    size, batch, lr = CASES[name]
    model, cfg = small(name, size, lr)
    return SimpleNamespace(
        cfg=cfg, model=model, seed=seed, seconds=0.0, trace=False,
        device=CPU, t0=time.perf_counter(), summarize=None,
        traffic={"driver": "train_fit", "metric": "train_samples_per_s",
                 "examples": 3 * batch,
                 "batch": batch, "ingest": "cache"})


def left_unchanged(monkeypatch):
    from deeplearning4j_tpu_torch.nn import updaters
    monkeypatch.setattr(updaters, "apply_layer_updates",
                        lambda conf, layer, params, state, *a, **k:
                        (dict(params), state))


def half_batch(monkeypatch):
    from deeplearning4j_tpu_torch.nn.multilayer import _Network
    real = _Network._gather_step

    def step(self, params, ustate, nstate, fs, ls, wires, idx, *a, **k):
        return real(self, params, ustate, nstate, fs, ls, wires,
                    idx[:len(idx) // 2], *a, **k)
    monkeypatch.setattr(_Network, "_gather_step", step)


#: what these runs are held to: the VGG-16 cell's limits
LIMITS = run.read_json(run.HERE / "limits" / "vgg16.train.cache-b256.json")


@pytest.mark.parametrize("fault", [None, left_unchanged, half_batch],
                         ids=["sound", "state-unchanged", "half-batch"])
def test_train_run_sees_the_fault(monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    out = T.run(train_ctx("vgg16"))
    assert run.judge(out["checks"], LIMITS) is (fault is None), out["checks"]


def altered_answer(monkeypatch):
    """One row of every batch comes back altered where it is produced."""
    from deeplearning4j_tpu_torch.nn.native_runtime import NativeModelRunner
    real = NativeModelRunner.output

    def output(self, *xs):
        out = real(self, *xs)
        out = out.clone() if isinstance(out, torch.Tensor) else out.copy()
        out[0] = out[0].flip(-1) if isinstance(out, torch.Tensor) \
            else out[0][::-1].copy()
        return out
    monkeypatch.setattr(NativeModelRunner, "output", output)


@pytest.mark.parametrize("fault", [None, altered_answer],
                         ids=["sound", "answer-altered"])
def test_serve_run_sees_the_fault(monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    model, cfg = small("resnet50", 32)
    traffic = run.read_json(run.HERE / "traffic" / "serve.native-open.json")
    traffic.update(rate_images_per_s=60.0, pool_images=64,
                   calibration_images=16, check_rows=10 ** 6)
    traffic["engine"] = dict(traffic["engine"], max_batch_size=32)
    ctx = SimpleNamespace(cfg=cfg, traffic=traffic, model=model, seed=9,
                          seconds=2.0, trace=False, device=CPU,
                          t0=time.perf_counter(), summarize=None)
    out = S.run(ctx)
    limits = run.read_json(run.HERE / "limits"
                           / "resnet50.serve.native-open.json")
    assert out["failed"] == 0
    assert run.judge(out["checks"], limits) is (fault is None), out["checks"]
