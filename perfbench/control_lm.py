"""The readings the language-model cell's limits are set from, on the
card, at the cell's own sizes: for each seed the float32 reference's
three steps, and held to it by the run's own comparison
(``traffic/train_lm.py`` ``compare``) the controls that must come out as
not correct: the reference computed in fp8 (every product's operands,
results and gradients rounded to e4m3, ``reference/ops.py`` ``q``), and
the fault that chooses the experts without ``expert_bias`` (the
reference in the program's place).  ``bf16`` adds the reference in the
program's precision, a witness of what rounding alone gives.  The
program's own readings come from the cell's runs.  A step that returns
its state unchanged reads 1 on ``change_gap`` and needs no run.

    python3 perfbench/control_lm.py --seeds 1,2,3 \
        [--what fp8,ignore_bias,bf16] [--out FILE]
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

from perfbench import run  # noqa: E402
from perfbench.traffic import train_lm as T  # noqa: E402

WORKLOAD = "lfm2-8b-a1b.train.tokens-b2-t4096"


def held_to(got: dict, want: dict, batch: int, device) -> dict:
    """``got``'s numbers against ``want`` (both host tensors by leaf, as
    ``train_lm.reference_side`` returns them, over ``batch`` sequences a
    step)."""
    norms = {}
    for what in ("grads", "changes"):
        n = T.LeafNorms(got[what])
        for k, w in want[what].items():
            n(k, w.to(device))
        norms[what] = n
    out = T.compare(got, {"losses": want["losses"], **norms})
    layers = len(got["choices"]) // batch
    out["route_agree"] = T.route_agree(
        [torch.cat([got["choices"][s * layers + i].cpu()
                    for s in range(batch)]) for i in range(layers)],
        want["choices"], batch)
    return out


def readings(c, seed: int, what, device) -> dict:
    cfg, traffic, model = c.cfg, c.traffic, c.model
    n, batch, t = (int(traffic["examples"]), int(traffic["batch"]),
                   int(traffic["seq_len"]))
    ids = T.make_tokens(n, t + 1, cfg["vocab_size"], float(traffic["zipf_s"]),
                        seed, device)
    x, y = ids[:, :-1].copy(), ids[:, 1:].copy()
    want = T.reference_side(model, cfg, x, y, batch, seed, device)
    out = {"reference_losses": want["losses"]}
    for w in what:
        t0 = time.perf_counter()
        got = T.reference_side(
            model, cfg, x, y, batch, seed, device,
            quant=w if w in ("fp8", "bf16") else None,
            ignore_bias=w == "ignore_bias")
        out[w] = held_to(got, want, batch, device)
        out[w]["losses"] = got["losses"]
        out[w]["seconds"] = time.perf_counter() - t0
        del got
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="fp8,ignore_bias")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    run.set_cache_dirs()
    bench = run.read_json(run.ROOT / "BENCHMARK.json")
    cell = run.cell(bench, WORKLOAD)
    cell.model = run.load_module(
        run.HERE / "reference" / f"{cell.cfg['reference']}.py",
        f"perfbench.reference.{cell.cfg['reference']}")
    device = run.device_or_exit(1)
    what = [w for w in args.what.split(",") if w]
    results = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        results[seed] = r = readings(cell, seed, what, device)
        line = {w: {k: r[w][k] for k in
                    ("grad_gap", "change_gap", "head_grad_err", "loss_gap",
                     "route_agree", "grad_err", "change_err")}
                for w in what}
        print(json.dumps({"seed": seed, **line}), flush=True)
        if args.out:
            Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
