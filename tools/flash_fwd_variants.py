"""Where K1/K4's time goes on the card: the Hopper forward body against
variants of itself, built from patched copies of the port's CUDA sources.

    python3 tools/flash_fwd_variants.py

Needs a CUDA card (Hopper) and nvcc; builds every variant in parallel into
the git-ignored ``build/variants/``, then times K1 (causal, with the
logsumexp) and K4 (partials, non-causal) at B=2, T=8192, H=4, d=64 in bf16
with CUDA events (mean of 20 launches after 3 warm-ups), each variant twice,
in turns (the list, then the list reversed), beside
``scaled_dot_product_attention`` on the same inputs.  Prints one JSON line a
variant, the card's name and power limit, and a last JSON line with all of
them.  The variants (only ``hopper`` and ``mma_sync`` compute the right
result):

- ``hopper``: the sources as they are (flash_fwd_sm90_kernel);
- ``mma_sync``: the Hopper route switched off, so the bf16 calls take the
  mma.sync body (fwd_tc) the port had before;
- ``no_softmax``: the softmax replaced by the scale alone: the products,
  the TMA pipeline and the epilogue, the floor under the softmax;
- ``branch_per_score``: the ``alive`` guard as a conditional around each
  score's exp, which the compiler turns into a branch a score;
- ``no_turns``: the consumers' named-barrier turns removed;
- ``three_consumers``: three consumer warpgroups at the d <= 64 bucket
  (BQ = 192, 160 registers a thread);
- ``bk64`` and ``bk64_three_consumers``: 64-key tiles (S 32 registers,
  P 16), with two or three consumers.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deeplearning4j_tpu_torch.ops import attention as A  # noqa: E402
from deeplearning4j_tpu_torch.ops import kernel_build  # noqa: E402

OUT = ROOT / "build" / "variants"
SHAPE = (2, 8192, 4, 64)
SCALE = 0.125


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"patch does not apply: {old[:60]!r}")
    return text.replace(old, new)


def _no_softmax(t: str) -> str:
    start = t.index("  if (edge) {\n#pragma unroll\n"
                    "    for (int j = 0; j < SM90_BK / 8; ++j)")
    end = t.index("// P (in s) packed to bf16 pairs")
    return (t[:start] + "#pragma unroll\n"
            "  for (int i = 0; i < SM90_BK / 2; ++i) { s[i] = s[i] * scale; "
            "l[0] += s[i]; }\n  corr[0] = corr[1] = 1.f;\n"
            "  m[0] = m[1] = 0.f;\n}\n\n" + t[end:])


def _branch_per_score(t: str) -> str:
    return _sub(t, "      s[4 * j + e] = expf(s[4 * j + e] - m_exp[hf]);",
                "      s[4 * j + e] = m_exp[hf] == m[hf]\n"
                "                         ? expf(s[4 * j + e] - m[hf]) : 0.f;")


def _no_turns(t: str) -> str:
    for old, new in (
            ("    if (last) bar_arrive(BAR_TURN, 256);\n", ""),
            ("    bar_sync(my_turn, 256);\n    mbar_wait(k_full, 0);",
             "    mbar_wait(k_full, 0);"),
            ("    if (!last || nk > 1) bar_arrive(next_turn, 256);\n", ""),
            ("      bar_sync(my_turn, 256);\n", ""),
            ("      if (!last || kt + 1 < nk) bar_arrive(next_turn, 256);\n",
             "")):
        t = _sub(t, old, new)
    return t


def _three_consumers(t: str) -> str:
    t = _sub(t, "static constexpr int NC = 2;",
             "static constexpr int NC = DM <= 64 ? 3 : 2;")
    return _sub(t, "PRODUCER_REGS = 40, CONSUMER_REGS = 232;",
                "PRODUCER_REGS = NC == 3 ? 24 : 40,\n"
                "                       CONSUMER_REGS = NC == 3 ? 160 : 232;")


def _bk64(t: str) -> str:
    return _sub(t, "constexpr int SM90_BK = 128;", "constexpr int SM90_BK = 64;")


# variant: (file patched, patch)
VARIANTS = {
    "hopper": (None, None),
    "mma_sync": ("flash_attention.cu", lambda t: _sub(
        t, "  if (sm90_route(g, bf16_in, {q, k, v})) return FWD_SM90;\n",
        "")),
    "no_softmax": ("flash_fwd_sm90.cuh", _no_softmax),
    "branch_per_score": ("flash_fwd_sm90.cuh", _branch_per_score),
    "no_turns": ("flash_fwd_sm90.cuh", _no_turns),
    "three_consumers": ("flash_fwd_sm90.cuh", _three_consumers),
    "bk64": ("flash_fwd_sm90.cuh", _bk64),
    "bk64_three_consumers": ("flash_fwd_sm90.cuh",
                             lambda t: _three_consumers(_bk64(t))),
}


def build_all(variants: dict = VARIANTS, out: Path = OUT) -> dict:
    """Each variant's library (``variants``: name -> (file patched, patch)),
    compiled in parallel under ``out``; raises on a failure."""
    nvcc = kernel_build.nvcc_path()
    procs = {}
    for name, (target, patch) in variants.items():
        src = out / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(kernel_build.CSRC, src)
        if patch is not None:
            path = src / target
            path.write_text(patch(path.read_text()))
        procs[name] = subprocess.Popen(
            [nvcc, *kernel_build.NVCC_FLAGS, "-o", str(src / "lib.so"),
             str(src / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = out / name / "lib.so"
    return libs


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out, acc = torch.empty_like(q), torch.empty(SHAPE, device="cuda")
    lse, m, l = (torch.empty(SHAPE[:3], device="cuda") for _ in range(3))
    geo = A._geometry(q, k)
    P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.dl4j_flash_fwd.argtypes = [P] * 5 + [I] * 5 + [L] * 6 + \
            [F, I, I, I, P]
        lib.dl4j_flash_fwd_partials.argtypes = [P] * 6 + [I] * 5 + \
            [L] * 6 + [F, I, I, P]

        def k1(lib=lib):
            rc = lib.dl4j_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *geo, SCALE, 1, 1, 1,
                torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc

        def k4(lib=lib):
            rc = lib.dl4j_flash_fwd_partials(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
                m.data_ptr(), l.data_ptr(), *geo, SCALE, 0, 1,
                torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc
        calls[name] = (k1, k4)
    times = {name: {"k1_causal_lse_ms": [], "k4_full_ms": []}
             for name in VARIANTS}
    order = list(VARIANTS)
    for names in (order, order[::-1]):
        for name in names:
            k1, k4 = calls[name]
            times[name]["k1_causal_lse_ms"].append(time_ms(k1))
            times[name]["k4_full_ms"].append(time_ms(k4))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times["sdpa"] = {
        "k1_causal_lse_ms": [time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                                  scale=SCALE))],
        "k4_full_ms": [time_ms(lambda: sdpa(qt, kt, vt, is_causal=False,
                                            scale=SCALE))]}
    for name, t in times.items():
        print(json.dumps({"variant": name, **t}))
    print(card)
    print(json.dumps({"card": card, "shape": list(SHAPE), "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
