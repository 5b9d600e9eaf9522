"""Where K2/K3's time goes on the card: the Hopper backward bodies against
variants of themselves, built from patched copies of the port's CUDA
sources.

    python3 tools/flash_bwd_variants.py

Needs a CUDA card (Hopper) and nvcc; builds every variant in parallel into
the git-ignored ``build/variants/bwd/``, then times K2 (dK/dV) and K3 (dQ)
at B=2, T=8192, H=4, d=64 in bf16, causal and not (the ring's full step),
with CUDA events (mean of 20 launches after 3 warm-ups), each variant
twice, in turns (the list, then the list reversed), beside the backward of
``scaled_dot_product_attention`` (dq, dk and dv in one call) on the same
inputs.  Prints one JSON line a variant, the card's name and power limit,
and a last JSON line with all of them.  The variants (only ``hopper`` and
``mma_sync`` compute the right result):

- ``hopper``: the sources as they are (flash_bwd_dkdv_sm90_kernel,
  flash_bwd_dq_sm90_kernel);
- ``mma_sync``: the Hopper route switched off, so the bf16 calls take the
  mma.sync bodies (dkdv_tc, dq_tc) the port had before;
- ``no_elementwise``: P and dS replaced by one product each: the products,
  the TMA pipeline and the epilogue, the floor under the elementwise math;
- ``branch_per_score``: the exp under a condition on each score (the
  ``keep ? expf(x) : 0`` form), which the compiler turns into a branch a
  score;
- ``dq_bk64``: K3 on 64-key tiles at d <= 64, each tile's elementwise
  math overlapping the previous tile's dQ product (the 128-key tiles
  cannot overlap it without spilling);
- ``rows_sync``: K2's producer copies each q-tile's L and D by plain loads
  and stores, so their latency holds it up every tile, instead of by
  cp.async that arrive on the stage's barrier;
- ``kv_smem``: K2's score products read K and V from shared memory (both
  operands there) instead of from registers.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deeplearning4j_tpu_torch.ops import attention as A  # noqa: E402
from tools.flash_fwd_variants import (_sub, build_all, card_line,  # noqa: E402
                                      time_ms)

OUT = ROOT / "build" / "variants" / "bwd"
SHAPE = (2, 8192, 4, 64)
SCALE = 0.125
_HEADER = "flash_bwd_sm90.cuh"


def _body(t: str, start: str, end: str, body: str) -> str:
    """``t`` with the text between ``start`` and ``end`` replaced."""
    i = t.index(start) + len(start)
    return t[:i] + body + t[t.index(end, i):]


def _no_elementwise(t: str) -> str:
    t = _body(t, "const Geom& g,\n                                            "
              "float scale, int causal) {\n",
              "}\n\n// K3's elementwise core",
              "#pragma unroll\n  for (int i = 0; i < BQ / 2; ++i) {\n"
              "    s[i] = s[i] * scale;\n    dp[i] = dp[i] * scale;\n  }\n")
    return _body(t, "const Geom& g, float scale,\n"
                 "                                          int causal) {\n",
                 "}\n\n// f32 rows of a",
                 "#pragma unroll\n  for (int i = 0; i < BK / 2; ++i) {\n"
                 "    s[i] = s[i] * scale;\n    dp[i] = dp[i] * scale;\n"
                 "  }\n")


def _branch_per_score(t: str) -> str:
    t = _sub(t, "      const float p = expf(s[4 * j + e]);",
             "      const float p = s[4 * j + e] > NEG_INF\n"
             "                          ? expf(s[4 * j + e]) : 0.f;")
    return _sub(t, "    const float p = expf(s[i]);",
                "    const float p = s[i] > NEG_INF ? expf(s[i]) : 0.f;")


def _dq_bk64(t: str) -> str:
    return _sub(t, "constexpr int SM90_DQ_BK_D64 = 128;",
                "constexpr int SM90_DQ_BK_D64 = 64;")


def _rows_sync(t: str) -> str:
    t = _sub(t, """          const long long ri = row_index(g, b, in ? t : 0, h);
          cp_async4(Ls + r, L + ri, in ? 4 : 0);
          cp_async4(Ls + BQ + r, Drow + ri, in ? 4 : 0);
        }
        asm volatile(
            "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n" ::"r"(
                full + 8 * st)
            : "memory");
""", """          Ls[r] = in ? L[row_index(g, b, t, h)] : 0.f;
          Ls[BQ + r] = in ? Drow[row_index(g, b, t, h)] : 0.f;
        }
        mbar_arrive(full + 8 * st);
""")
    return t


# variant: (file patched, patch)
VARIANTS = {
    "hopper": (None, None),
    "mma_sync": ("flash_attention.cu", lambda t: _sub(
        t, "  if (sm90_route(a.g, tc, {a.q, a.k, a.v, a.dout})) "
           "return BWD_SM90;\n", "")),
    "no_elementwise": (_HEADER, _no_elementwise),
    "branch_per_score": (_HEADER, _branch_per_score),
    "dq_bk64": (_HEADER, _dq_bk64),
    "rows_sync": (_HEADER, _rows_sync),
    "kv_smem": (_HEADER, lambda t: _sub(
        t, "static constexpr bool KV_REGS = DM <= 64;",
        "static constexpr bool KV_REGS = false;")),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    libs = build_all(VARIANTS, OUT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(SHAPE, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    inputs = {}
    for causal in (True, False):
        out, lse = A.flash_forward(q, k, v, causal=causal, sm_scale=SCALE,
                                   with_lse=True)
        inputs[causal] = (lse, (g.float() * out.float()).sum(-1).contiguous())
    dk, dv, dq = (torch.empty(SHAPE, device="cuda") for _ in range(3))
    geo = A._geometry(q, k)
    P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
    geom = [I] * 5 + [L] * 6
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.dl4j_flash_bwd_dkdv.argtypes = [P] * 8 + geom + [F, I, I, I, P]
        lib.dl4j_flash_bwd_dq.argtypes = [P] * 7 + geom + [F, I, I, I, P]

        def k2(causal, lib=lib):
            lse, D = inputs[causal]
            rc = lib.dl4j_flash_bwd_dkdv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), D.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *geo, SCALE, int(causal), 1, 0,
                torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc

        def k3(causal, lib=lib):
            lse, D = inputs[causal]
            rc = lib.dl4j_flash_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), D.data_ptr(), dq.data_ptr(), *geo, SCALE,
                int(causal), 1, 0, torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc
        calls[name] = (k2, k3)
    keys = ("k2_causal_ms", "k3_causal_ms", "k2_full_ms", "k3_full_ms")
    times = {name: {key: [] for key in keys} for name in VARIANTS}
    order = list(VARIANTS)
    for names in (order, order[::-1]):
        for name in names:
            k2, k3 = calls[name]
            for key, fn, causal in zip(keys, (k2, k3, k2, k3),
                                       (True, True, False, False)):
                times[name][key].append(time_ms(lambda: fn(causal)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times["sdpa"] = {}
    for causal, key in ((True, "bwd_causal_ms"), (False, "bwd_full_ms")):
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        o = sdpa(qt, kt, vt, is_causal=causal, scale=SCALE)
        gt = g.transpose(1, 2)
        times["sdpa"][key] = [time_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), gt, retain_graph=True))]
    for name, t in times.items():
        print(json.dumps({"variant": name, **t}))
    print(card)
    print(json.dumps({"card": card, "shape": list(SHAPE), "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
