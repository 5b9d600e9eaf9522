"""The language-model cell (``traffic/train_lm.py``) driven whole on the
CPU at a small size, with the timed path sound and broken underneath,
and the two kernel classes it adds read against the kernels of the cells
that were there before."""

import copy
import json
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import run, trace
from perfbench.traffic import train_lm as T

CPU = torch.device("cpu")
WORKLOAD = "lfm2-8b-a1b.train.tokens-b2-t4096"
#: every width cut to a CPU test's size; the layer pattern and the rules
#: (dense layers first, GQA, top-k of sigmoid scores with a bias) kept
SMALL = dict(vocab_size=512, hidden_size=64,
             layer_types=["conv", "conv", "full_attention", "conv"],
             num_dense_layers=2, intermediate_size=96,
             moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2,
             num_attention_heads=4, num_key_value_heads=2)
LIMITS = run.read_json(run.HERE / "limits" / f"{WORKLOAD}.json")


def ctx(seed=2 ** 33 + 7):
    bench = run.read_json(run.ROOT / "BENCHMARK.json")
    c = run.cell(bench, WORKLOAD)
    cfg = copy.deepcopy(c.cfg)
    cfg.update(SMALL)
    cfg["program"]["kwargs"].update(SMALL)
    traffic = dict(c.traffic, examples=6, seq_len=32)
    model = run.load_module(run.HERE / "reference" / "lfm2.py",
                            "perfbench.reference.lfm2")
    return SimpleNamespace(cfg=cfg, traffic=traffic, model=model, seed=seed,
                           seconds=0.0, trace=False, device=CPU,
                           t0=time.perf_counter(), summarize=None)


def ignore_bias(monkeypatch):
    """The program chooses its experts without ``expert_bias``."""
    from deeplearning4j_tpu_torch.ops import moe
    real = moe.route
    monkeypatch.setattr(moe, "route", lambda x, w, b, *a, **k:
                        real(x, w, torch.zeros_like(b), *a, **k))


def left_unchanged(monkeypatch):
    from deeplearning4j_tpu_torch.nn import updaters
    monkeypatch.setattr(updaters, "apply_layer_updates",
                        lambda conf, layer, params, state, *a, **k:
                        (dict(params), state))


@pytest.mark.parametrize("fault", [None, ignore_bias, left_unchanged],
                         ids=["sound", "bias-ignored", "state-unchanged"])
def test_lm_run_sees_the_fault(monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    out = T.run(ctx())
    assert out["failed"] == 0 and out["attempted"] == 3
    assert run.judge(out["checks"], LIMITS) is (fault is None), out["checks"]
    if fault is None:
        assert out["checks"]["route_agree"] == 1.0


class _NoProfiler:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


def test_lm_run_reads_the_counters_when_traced():
    """A traced run reads the experts' load over the traced call: tokens
    x top-k routed in all, the most-loaded expert over the even share."""
    c = ctx()
    c.trace, c.profiler = True, _NoProfiler
    c.summarize = lambda prof, w: None
    r = T.run(c)["readings"]
    layers = len(SMALL["layer_types"]) - SMALL["num_dense_layers"]
    assert r["expert_tokens_traced_total"] == layers * 6 * 32 * 2
    assert r["expert_load_max"] >= 1.0


def ledger_kernel_names():
    """The top kernels of every cell the ledger has traced."""
    names = set()
    with open(run.ROOT / "PERF_LEDGER.jsonl") as f:
        for line in f:
            rows = [json.loads(line)]
            while rows:
                x = rows.pop()
                if isinstance(x, dict):
                    b = x.get("breakdown")
                    if isinstance(b, dict):
                        names.update(n for n, _ in b.get("device_ops", []))
                    rows.extend(v for k, v in x.items() if k != "breakdown")
                elif isinstance(x, list):
                    rows.extend(x)
    return sorted(names)


def test_new_kernel_classes_leave_the_old_cells_alone():
    """Every kernel the earlier cells' traces name falls in the class it
    fell in without ``flash.txt`` and ``experts.txt``."""
    names = ledger_kernel_names()
    assert names
    now = trace.kernel_classes()
    before = {k: v for k, v in now.items() if k not in ("flash", "experts")}
    assert set(now) - set(before) == {"flash", "experts"}
    for n in names:
        assert trace.classify(n, now) == trace.classify(n, before), n


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::flash_fwd_sm90_kernel<64, 1>(CUtensorMap_"
     "st)", "flash"),
    ("void (anonymous namespace)::flash_bwd_dkdv_sm90_kernel<64>(CUtensorMa"
     "p_st)", "flash"),
    ("void (anonymous namespace)::flash_bwd_dq_sm90_kernel<64>(CUtensorMap_"
     "st)", "flash"),
    ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9"
     "xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShapeIN4cute5tuple",
     "experts"),
    ("void at::cuda::detail::prepare_grouped_gemm_data<cutlass::bfloat16_t>",
     "experts"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "gemm")])
def test_the_lm_cells_kernels_take_their_classes(name, cls):
    """Names as the H100's trace gives them (K1-K3, the grouped GEMMs of
    ``torch.nn.functional.grouped_mm``, a cuBLAS GEMM)."""
    assert trace.classify(name, trace.kernel_classes()) == cls
