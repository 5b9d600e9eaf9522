"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases (each raises on failure; the exit code is non-zero on any):

1. device: a CUDA card must be present; prints its name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit`` gives them;
2. build: compiles every kernel source of the port with nvcc;
3. kernels: at the full width of the attention model (batch 2, T=8192,
   4 heads, d_head 64, causal), each kernel (K1 forward in both modes, K2
   dK/dV, K3 dQ) is held against its plain PyTorch version on the same
   inputs, in bfloat16 and float32, then timed with CUDA events against
   its plain version and against the PyTorch library call that computes
   the same function (``scaled_dot_product_attention``, a yardstick the
   port never calls);
4. reference: a small network trains 2 steps on the card (kernels) and on
   the CPU (plain versions) from the same weights, in fp32; scores and
   params must agree;
5. training: the full-width network (CausalSelfAttention(n_out=256,
   n_heads=4, cache_len=8192) -> RnnOutputLayer(n_out=32, softmax,
   mcxent), n_in=64, adam, the card's default mixed_bf16 policy) takes
   3 fit steps; the score must be finite and every kernel's
   launch count must rise by exactly one per step;
6. inference: ``output()`` of the trained net must be finite
   probabilities of the right shape.

Prints a JSON line of the reference, training and inference results, one
``{"kernels": [...]}`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# full width of the repo's attention model
BATCH, SEQ, HEADS, D_HEAD = 2, 8192, 4, 64
N_IN, HIDDEN, N_OUT = 64, 256, 32
STEPS = 3

# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel vs plain.  An f32 result must agree to 1e-4 of max|plain|: both
# sides accumulate in f32 from the same inputs, in another order.  A bf16
# output is checked element by element: both sides round nearly the same
# f32 value to bf16, so they differ by at most one bf16 ulp, which is
# within 2^-7 of the value (atol 1e-5 covers the f32 noise near zero).
F32_RTOL = 1e-4
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
REF_RTOL = 1e-4     # card vs CPU reference network, fp32


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(what: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Hold a kernel's result against its plain version; raises when they
    disagree.  Returns max|err| and max|err| / max|plain|."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{what}: non-finite values")
    scale = want.abs().max().item()
    if scale == 0.0:
        raise RuntimeError(f"{what}: the plain result is all zeros, the "
                           "comparison would prove nothing")
    diff = (got - want).abs()
    err = diff.max().item()
    if bf16:
        bad = int((diff > BF16_ATOL + BF16_RTOL * want.abs()).sum().item())
        ok, tol = bad == 0, f"rtol {BF16_RTOL:g}, atol {BF16_ATOL:g}, " \
                            f"element-wise; {bad} elements outside"
    else:
        ok, tol = err <= F32_RTOL * scale, f"{F32_RTOL:g} of max|plain|"
    log(f"[kernels] {what}: max_abs_err={err:.3e} rel={err / scale:.3e} "
        f"({tol})")
    if not ok:
        raise RuntimeError(f"{what} disagrees with its plain version ({tol})")
    return {"max_abs_err": err, "rel": err / scale}


# ------------------------------------------------------------- bounds
def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(products: int, q: torch.Tensor, inputs, outputs) -> tuple:
    """Least time for ``products`` (T x T x d, causal half) matrix products
    on bf16 ``q``'s shape at the bf16 peak, or for the bytes of ``inputs``
    read once and ``outputs`` written once: the larger, and which of the
    two it is."""
    assert q.dtype == torch.bfloat16
    b, t, h, d = q.shape
    flops = products * 2.0 * d * (t * (t + 1) // 2) * b * h
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (nbytes(*inputs) + nbytes(*outputs)) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------- phases
def phase_kernels(A, seed: int):
    """Each kernel against its plain version (bf16 and f32), then timed
    in bf16, the dtype the training path gives it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (BATCH, SEQ, HEADS, D_HEAD)
    scale = 1.0 / D_HEAD ** 0.5
    checks = {"flash_fwd": [], "flash_bwd_dkdv": [], "flash_bwd_dq": []}
    inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                      .to(dtype) for _ in range(4))
        out, lse = A.flash_forward(q, k, v, causal=True, sm_scale=scale,
                                   with_lse=True)
        plain_out, plain_lse = A.flash_forward_plain(q, k, v, True, scale,
                                                     True)
        out_n = A.flash_forward(q, k, v, causal=True, sm_scale=scale,
                                with_lse=False)
        Drow = (g.float() * out.float()).sum(-1).contiguous()
        dk, dv = A.flash_dkdv(q, k, v, g, lse, Drow, causal=True,
                              sm_scale=scale)
        dq = A.flash_dq(q, k, v, g, lse, Drow, causal=True, sm_scale=scale)
        torch.cuda.synchronize()
        pdk, pdv = A.flash_dkdv_plain(q, k, v, g, lse, Drow, True, scale)
        pdq = A.flash_dq_plain(q, k, v, g, lse, Drow, True, scale)
        items = {
            "flash_fwd": [("out", out, plain_out),
                          ("out_normalized", out_n, plain_out),
                          ("lse", lse, plain_lse)],
            "flash_bwd_dkdv": [("dk", dk, pdk), ("dv", dv, pdv)],
            "flash_bwd_dq": [("dq", dq, pdq)],
        }
        dname = str(dtype).replace("torch.", "")
        for name, results in items.items():
            for result, got, want in results:
                checks[name].append(
                    {"result": result, "inputs": dname,
                     **compare(f"{name} {result} ({dname} inputs)", got,
                               want)})
        inputs[dtype] = (q, k, v, g, out, lse, Drow)
        del dk, dv, dq, pdk, pdv, pdq, plain_out, plain_lse, out_n

    q, k, v, g, out, lse, Drow = inputs[torch.bfloat16]
    del inputs[torch.float32]
    torch.cuda.empty_cache()
    A.reset_launches()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        return sdpa(qt, kt, vt, is_causal=True, scale=scale)

    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    sdpa_out = sdpa(qr, kr, vr, is_causal=True, scale=scale)
    gt = g.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qr, kr, vr), gt,
                                   retain_graph=True)

    t = {
        "flash_fwd": time_ms(lambda: A.flash_forward(
            q, k, v, causal=True, sm_scale=scale, with_lse=True)),
        "flash_fwd_normalized": time_ms(lambda: A.flash_forward(
            q, k, v, causal=True, sm_scale=scale, with_lse=False)),
        "flash_bwd_dkdv": time_ms(lambda: A.flash_dkdv(
            q, k, v, g, lse, Drow, causal=True, sm_scale=scale)),
        "flash_bwd_dq": time_ms(lambda: A.flash_dq(
            q, k, v, g, lse, Drow, causal=True, sm_scale=scale)),
    }
    plain = {
        "flash_fwd": time_ms(lambda: A.flash_forward_plain(
            q, k, v, True, scale, True), iters=3, warmup=1),
        "flash_bwd_dkdv": time_ms(lambda: A.flash_dkdv_plain(
            q, k, v, g, lse, Drow, True, scale), iters=3, warmup=1),
        "flash_bwd_dq": time_ms(lambda: A.flash_dq_plain(
            q, k, v, g, lse, Drow, True, scale), iters=3, warmup=1),
    }
    lib_fwd, lib_bwd = time_ms(sdpa_fwd), time_ms(sdpa_bwd)
    A.reset_launches()
    f32_grad = torch.empty(q.shape, dtype=torch.float32, device="meta")
    bwd_in = (q, k, v, g, lse, Drow)
    bounds = {
        # q, k, v in; out + lse out; two products (S = QK^T, PV)
        "flash_fwd": bound_ms(2, q, (q, k, v), (out, lse)),
        # q, k, v, dO, L, D in; dk, dv out (f32); four (S, dP, dV, dK)
        "flash_bwd_dkdv": bound_ms(4, q, bwd_in, (f32_grad, f32_grad)),
        # same in; dq out (f32); three (S, dP, dQ)
        "flash_bwd_dq": bound_ms(3, q, bwd_in, (f32_grad,)),
    }
    library = {"flash_fwd": lib_fwd, "flash_bwd_dkdv": lib_bwd,
               "flash_bwd_dq": lib_bwd}
    timing = {name: {"ms": t[name], "plain_ms": plain[name],
                     "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1],
                     "library_ms": library[name],
                     "max_abs_err": max(c["max_abs_err"]
                                        for c in checks[name]),
                     "checks": checks[name]}
              for name in bounds}
    timing["flash_fwd"]["ms_normalized"] = t["flash_fwd_normalized"]
    log(f"[kernels] library yardsticks: sdpa fwd {lib_fwd:.4f} ms, sdpa "
        f"bwd (dq, dk, dv together) {lib_bwd:.4f} ms")
    return timing


def build_net(N, A, *, seed, n_in, hidden, heads, n_out, cache_len,
              compute_dtype=None, device=None):
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        CausalSelfAttention
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    b = N.NeuralNetConfiguration.builder().seed(seed).updater("adam") \
        .learning_rate(1e-3)
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    conf = (b.list()
            .layer(CausalSelfAttention(n_out=hidden, n_heads=heads,
                                       cache_len=cache_len))
            .layer(RnnOutputLayer(n_out=n_out, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(inputs.recurrent(n_in, cache_len))
            .build())
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(conf, device=device).init()


def make_batch(seed: int, batch: int, t: int, n_in: int, n_out: int):
    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, t, n_in).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.randint(0, n_out, (batch, t))]
    return DataSet(x, y)


def phase_reference(N, A, seed: int) -> dict:
    """2 fp32 fit steps of a small net on the card (kernels) and on the
    CPU (plain versions) from the same weights: the card must agree."""
    kw = dict(seed=seed, n_in=16, hidden=64, heads=2, n_out=8,
              cache_len=200, compute_dtype="float32")
    card = build_net(N, A, **kw)
    cpu = build_net(N, A, device="cpu", **kw)
    cpu.set_flat_params(card.get_flat_params())
    ds = make_batch(seed + 1, 2, 200, 16, 8)
    A.reset_launches()
    worst = 0.0
    for step in range(2):
        card.fit(ds)
        cpu.fit(ds)
        a, b = card.score(), cpu.score()
        pa, pb = card.get_flat_params(), cpu.get_flat_params()
        p_rel = float(np.abs(pa - pb).max() / np.abs(pb).max())
        s_rel = abs(a - b) / abs(b)
        log(f"[reference] step {step}: score card={a:.7f} cpu={b:.7f} "
            f"rel={s_rel:.2e}; params rel={p_rel:.2e} (tol {REF_RTOL:g})")
        if not (s_rel <= REF_RTOL and p_rel <= REF_RTOL):
            raise RuntimeError("card and CPU reference disagree")
        worst = max(worst, s_rel, p_rel)
    if A.LAUNCHES["flash_fwd"] != 2 or A.LAUNCHES["flash_bwd_dq"] != 2:
        raise RuntimeError(f"reference net did not run on the kernels: "
                           f"{A.LAUNCHES}")
    return {"steps": 2, "max_rel": worst}


def phase_training(N, A, seed: int):
    net = build_net(N, A, seed=seed, n_in=N_IN, hidden=HIDDEN, heads=HEADS,
                    n_out=N_OUT, cache_len=SEQ)
    pol = net._pol()
    if pol.name != "mixed_bf16":
        raise RuntimeError(f"the card's default policy is {pol.name}")
    ds = make_batch(seed, BATCH, SEQ, N_IN, N_OUT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()            # counts of the main path's run only
    scores, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        s = net.score()           # a host read: waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        scores.append(s)
    launches = dict(A.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"[training] scores {scores}; step ms {step_ms}; launches "
        f"{launches}; peak memory {peak / 2**30:.3f} GiB")
    if not all(np.isfinite(scores)):
        raise RuntimeError(f"non-finite training score: {scores}")
    for name, n in launches.items():
        if n != STEPS:
            raise RuntimeError(f"{name} launched {n} times in {STEPS} "
                               "steps, expected one per step")
    return net, ds, {"scores": scores, "step_ms": step_ms,
                     "peak_mem_bytes": peak, "launches": launches}


def phase_inference(net, ds) -> dict:
    t0 = time.perf_counter()
    out = net.output(ds.features)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if tuple(out.shape) != (BATCH, SEQ, N_OUT):
        raise RuntimeError(f"output shape {tuple(out.shape)}")
    if out.dtype != torch.float32 or not torch.isfinite(out).all():
        raise RuntimeError("output is not finite fp32")
    row_err = (out.sum(-1) - 1).abs().max().item()
    if row_err > 1e-4:
        raise RuntimeError(f"softmax rows do not sum to 1: {row_err}")
    log(f"[inference] output {tuple(out.shape)} in {ms:.1f} ms, row-sum "
        f"err {row_err:.2e}")
    return {"output_ms": ms, "row_sum_err": row_err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the card only")
        return 2
    card = card_line()
    log(f"[device] {card}")

    from deeplearning4j_tpu_torch.nn.conf import \
        neural_net_configuration as N
    from deeplearning4j_tpu_torch.ops import attention as A
    from deeplearning4j_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    for source in kernel_build.SOURCES:
        kernel_build.build(source)
    build_s = time.perf_counter() - t0
    log(f"[build] {len(kernel_build.SOURCES)} source(s) in {build_s:.1f} s")

    timing = phase_kernels(A, args.seed)
    reference = phase_reference(N, A, args.seed)
    net, ds, training = phase_training(N, A, args.seed)
    inference = phase_inference(net, ds)

    sources = {"flash_fwd": "deeplearning4j_tpu/ops/attention.py:222",
               "flash_bwd_dkdv": "deeplearning4j_tpu/ops/attention.py:479",
               "flash_bwd_dq": "deeplearning4j_tpu/ops/attention.py:502"}
    kernels = [dict(name=name, route="cuda",
                    source="deeplearning4j_tpu_torch/ops/csrc/"
                           "flash_attention.cu",
                    replaces=sources[name],
                    launches=training["launches"][name],
                    **{k: v for k, v in timing[name].items()})
               for name in sources]
    print(json.dumps({"build_s": build_s, "reference": reference,
                      "training": training,
                      "inference": inference}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
