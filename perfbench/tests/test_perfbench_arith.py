"""The yardstick's arithmetic: FLOP counts from the reference's shapes,
the open-loop schedule, and the reduction of a device trace."""

import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import run, trace
from perfbench.traffic import serve_open_loop as S


def model_and_cfg(name):
    cfg = run.read_json(run.HERE / "configs" / f"{name}.json")
    return run.load_module(run.HERE / "reference" / f"{cfg['reference']}.py",
                           f"perfbench.reference.{cfg['reference']}"), cfg


@pytest.mark.parametrize("name,gmac,params", [
    # He et al. Table 1: 3.8e9 multiply-adds (v1, the stride on the first
    # 1x1; the 4.09e9 often quoted is v1.5's, with the stride on the 3x3)
    ("resnet50", 3.858, 25_557_032),
    ("vgg16", 15.470, 138_357_544)])
def test_forward_flops_and_params(name, gmac, params):
    model, cfg = model_and_cfg(name)
    assert model.forward_flops(cfg) / 2e9 == pytest.approx(gmac, abs=1e-3)
    assert sum(int(np.prod(s)) for _, s, _ in model.leaves(cfg)) == params
    assert cfg["params"] == params


TRAFFIC = run.read_json(run.HERE / "traffic" / "serve.native-open.json")


#: a mix of request sizes, as a later cell may send
MIXED = dict(TRAFFIC, sizes=[1, 2, 4, 8, 16, 32],
             weights=[0.30, 0.20, 0.20, 0.15, 0.10, 0.05])
del MIXED["block_requests"]


def gaps_of(due, seconds):   # the last gap runs to the window's end
    return np.append(np.diff(due), seconds - due[-1])


@pytest.mark.parametrize("traffic", [TRAFFIC, MIXED],
                         ids=["cell", "mixed-sizes"])
def test_schedule_same_sizes_and_gaps_for_every_seed(traffic):
    a = S.schedule(traffic, 1, 20.0)
    b = S.schedule(traffic, 2 ** 31 + 7, 20.0)
    assert sorted(a[1]) == sorted(b[1])
    assert not np.array_equal(a[0], b[0])
    if len(traffic["sizes"]) > 1:
        assert not np.array_equal(a[1], b[1])
    assert np.allclose(sorted(gaps_of(a[0], 20.0)),
                       sorted(gaps_of(b[0], 20.0)), rtol=1e-9, atol=1e-12)
    for due, ks, offs in (a, b):
        assert due[0] == 0 and np.all(np.diff(due) >= 0)
        assert due[-1] < 20.0
        assert np.all(offs + ks <= traffic["pool_images"])
    mean_k = float(np.mean(a[1]))
    rate = len(a[0]) * mean_k / 20.0
    assert rate == pytest.approx(traffic["rate_images_per_s"], rel=0.02)


def test_single_image_arrivals_are_poisson():
    """One image a request (MLPerf's Server scenario): the gaps are those
    of a Poisson stream, exponential with a coefficient of variation of
    about 1, not a fixed beat."""
    due, ks, _ = S.schedule(TRAFFIC, 5, 20.0)
    g = gaps_of(due, 20.0)
    assert set(ks.tolist()) == {1}
    assert g.std() / g.mean() == pytest.approx(1.0, abs=0.1)
    assert len(due) >= TRAFFIC["block_requests"]


class SlowEngine:
    """Serves one request at a time, each taking ``service`` seconds, and
    stalls once, for ``stall`` seconds, at its 20th request."""

    def __init__(self, ctx, weights, state, service=0.002, stall=0.3):
        self.service, self.stall = service, stall
        self.queue = []
        self.cv = threading.Condition()
        self.alive = True
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()
        self.classes = ctx.cfg["n_classes"]

    def _loop(self):
        served = 0
        while True:
            with self.cv:
                while not self.queue and self.alive:
                    self.cv.wait()
                if not self.alive:
                    return
                fut, x = self.queue.pop(0)
            served += 1
            time.sleep(self.service + (self.stall if served == 20 else 0))
            fut.set_result(np.full((len(x), self.classes),
                                   1.0 / self.classes, np.float32))

    def submit(self, x):
        fut = Future()
        with self.cv:
            self.queue.append((fut, x))
            self.cv.notify()
        return fut

    def stop(self):
        with self.cv:
            self.alive = False
            self.cv.notify()
        self.thread.join(5)


def test_latency_is_timed_from_the_due_time(monkeypatch):
    """A stall in the window delays the requests behind it: timed from
    when each was due, the requests that arrived during the stall read
    most of it."""
    model, cfg = model_and_cfg("resnet50")
    cfg = dict(cfg, height=8, width=8, n_classes=4)
    traffic = dict(TRAFFIC, rate_images_per_s=200.0, pool_images=64,
                   calibration_images=2, check_rows=8, sizes=[1],
                   warm_seconds=0.0,
                   weights=[1.0])
    got = {}
    monkeypatch.setattr(S, "check_answers",
                        lambda *a, **k: {"logit_gap": 0.0})
    monkeypatch.setattr(S, "calibrated_state", lambda ctx, w: {})
    ctx = SimpleNamespace(cfg=cfg, traffic=traffic, seed=5, seconds=1.0,
                          trace=False, device=torch.device("cpu"),
                          t0=time.perf_counter(), model=model)
    out = S.run(ctx, engine_cls=lambda c, w, s: got.setdefault(
        "e", SlowEngine(c, w, s)))
    assert out["failed"] == 0 and out["attempted"] == 200
    # a fifth of a second's arrivals wait behind the 0.3 s stall
    assert out["e2e"]["serve_p95_ms"] > 50.0


class RefusingEngine(SlowEngine):
    """A SlowEngine that refuses its 7th request."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.sent = 0

    def submit(self, x):
        self.sent += 1
        if self.sent == 7:
            raise RuntimeError("queue full")
        return super().submit(x)


def test_the_window_keeps_only_the_answers_it_may_sample():
    """The window holds no request's future: it keeps every request's
    answer time and the answers of the check's candidates alone; a
    refused request is missing and never sampled."""
    ctx = SimpleNamespace(cfg={"n_classes": 4})
    server = RefusingEngine(ctx, None, None, service=0.0005, stall=0.0)
    traffic = dict(TRAFFIC, rate_images_per_s=400.0, pool_images=16)
    due, ks, offs = S.schedule(traffic, 3, 0.5)
    pool = np.zeros((16, 2), np.float32)
    keep = S.candidates(ks, 3, 8)
    try:
        w = S.drive(server, pool, due, ks, offs, 0.5, keep=keep)
    finally:
        server.stop()
    answered = np.isfinite(w["done"])
    assert w["failed"] == 1 and answered.sum() == len(due) - 1
    assert set(w["answers"]) == {i for i in keep if answered[i]}
    picks = S.sample(ks, 3, 8, answered)
    assert len(picks) == 8 and set(picks) <= set(w["answers"])


def test_trace_reduction_and_readers():
    classes = trace.kernel_classes()
    dev = [("sm90_xmma_fprop_implicit_gemm_bf16", 0, 100),
           ("sm90_xmma_gemm_bf16bf16_bf16f32", 50, 150),   # overlaps
           ("vectorized_elementwise_kernel", 300, 400),
           ("Memcpy HtoD (Pinned -> Device)", 400, 450),
           ("batch_norm_collect_statistics", 1000, 1100)]
    host = [("aten::add_", 100, 600), ("cudaGraphLaunch", 150, 250),
            ("fit/epoch", 0, 2000)]
    t = trace.summarize(dev, host, 0.002, classes)
    assert t["busy_s"] == pytest.approx(400e-6)
    assert t["by_class"]["conv"] == pytest.approx(100e-6)
    assert t["by_class"]["gemm"] == pytest.approx(100e-6)
    assert t["by_class"]["other"] == pytest.approx(200e-6)
    assert t["htod_s"] == pytest.approx(50e-6)
    assert t["idle_gaps"][0] == ["fit/epoch", pytest.approx(550e-6)]
    assert t["idle_gaps"][1] == ["cudaGraphLaunch", pytest.approx(150e-6)]
    out = {"trace": t, "peak_flops": 1e9,
           "readings": {"samples": 4, "steps": 2, "window_s": 0.002,
                        "step_flops_per_sample": 1e5}}

    def read(name):
        return run.load_module(run.HERE / "metrics" / f"{name}.py",
                               name).read(out)

    assert read("device_idle.train") == pytest.approx(80.0)
    assert read("other_kernel_ms.train") == pytest.approx(0.1)
    assert read("htod_ms.stream") == pytest.approx(0.025)
    # 4e5 FLOP over 200 us of convolution and GEMM at 1e9 FLOP/s
    assert read("gemm_conv_roofline.train") == pytest.approx(200.0)
    assert read("mfu.train") == pytest.approx(20.0)


def test_batch_fill_reader():
    reader = run.load_module(run.HERE / "metrics" / "batch_fill.serve.py",
                             "bf")
    out = {"trace": {}, "readings": {"batch_rows": [3, 128, 100],
                                     "max_batch_size": 128}}
    assert reader.read(out) == pytest.approx(100 * 231 / (4 + 128 + 128))
