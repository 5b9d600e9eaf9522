"""The readings the correctness limits are set from, for one cell, in
one process on the card: the program's numbers and the control's over
many seeds, at the cell's own sizes.

Training cells: for each seed, the program's three checked steps (as a
run makes them), the float32 reference's, the control's (the reference
computing every convolution and dense product from fp8 operands), and a
planted fault's (the reference in the program's place, taking the mean
over half of each batch).  Each is held to the float32 reference by the
run's own comparison.  A step that returns its state unchanged reads 1
on the change and needs no run.

Serving cells: for each seed, the served sample's rows under the fp8
control against the float32 reference (the program's own numbers come
from the cell's runs).

``bf16`` adds the reference computed in bf16 (every layer's operands,
results and gradients rounded to it): the program's precision, a witness
of what rounding alone gives.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        [--what program,control,half] [--out FILE]
"""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from perfbench import inputs, program, run  # noqa: E402


def train_readings(ctx, what):
    import torch
    from perfbench.traffic import train_fit as T
    cfg, traffic, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    model = ctx.model
    n, batch = int(traffic["examples"]), int(traffic["batch"])
    u8 = inputs.make_images(n, cfg, seed, "images", dev)[:3 * batch]
    labels = inputs.make_labels(n, cfg["n_classes"], seed, "labels",
                                dev)[:3 * batch]
    out = {}
    want = T.reference_steps(model, cfg, u8, labels, batch, seed, dev)
    out["reference_losses"] = want["losses"]
    if "program" in what:
        net = program.build(cfg, dev)
        program.load(net, inputs.make_weights(model.leaves(cfg), seed, dev,
                                              cfg["precision"]),
                     inputs.make_state(model.state_leaves(cfg), dev,
                                       cfg["precision"]))
        got = T.checked_steps(net, model, cfg, u8, labels, batch, seed,
                              dev, traffic["ingest"])
        del net
        torch.cuda.empty_cache()
        out["program"], out["left_out"] = T.compare(got, want)
        out["worst_leaves"] = worst_leaves(got, want)
        out["program_losses"] = got["losses"]
    if "control" in what:
        ctrl = T.reference_steps(model, cfg, u8, labels, batch, seed, dev,
                                 quant="fp8")
        out["control"] = T.compare(ctrl, want)[0]
    if "bf16" in what:
        twin = T.reference_steps(model, cfg, u8, labels, batch, seed, dev,
                                 quant="bf16")
        out["bf16"] = T.compare(twin, want)[0]
        out["bf16_worst_leaves"] = worst_leaves(twin, want)
    if "half" in what:
        half = T.reference_steps(model, cfg, half_rows(u8, batch),
                                 half_rows(labels, batch), batch // 2,
                                 seed, dev)
        out["half"] = T.compare(half, want)[0]
    return out


def worst_leaves(got, want, n: int = 6):
    """The leaves whose norms part most, with both sides' norms."""
    from perfbench.traffic.train_fit import _norm
    out = {}
    for what in ("grads", "changes"):
        a = {k: _norm(v) for k, v in got[what].items()}
        b = {k: _norm(v) for k, v in want[what].items()}
        rows = sorted(((abs(a[k] - b[k]) / max(b[k], 1e-30), k, a[k], b[k])
                       for k in b), reverse=True)
        out[what] = rows[:n]
    return out


def half_rows(a, batch: int):
    """The first half of each of the three batches, back to back."""
    import numpy as np
    h = batch // 2
    return np.concatenate([a[i * batch:i * batch + h] for i in range(3)])


def serve_readings(ctx, what):
    import numpy as np
    import torch
    from perfbench.reference import ops, train as ref_train
    from perfbench.traffic import serve_open_loop as S
    cfg, traffic, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    model = ctx.model
    pool = inputs.decode(inputs.make_images(
        traffic["pool_images"], cfg, seed, "pool", dev), dev).cpu().numpy()
    due, ks, offs = S.schedule(traffic, seed, ctx.seconds)
    picks = S.sample(ks, seed, traffic["check_rows"], [True] * len(ks))
    ops.strict_fp32()
    P = inputs.make_weights(model.leaves(cfg), seed, dev, cfg["precision"])
    St = S.calibrated_state(ctx, P)
    out = {"rows": int(sum(ks[picks])), "largest": int(max(ks[picks]))}
    for fmt, name in (("fp8", "control"), ("bf16", "bf16")):
        if name not in what:
            continue
        x = torch.from_numpy(np.concatenate(
            [pool[offs[i]:offs[i] + ks[i]] for i in picks])).to(dev)
        ref = ref_train.logits(model, cfg, P, St, x)
        low = ref_train.logits(model, cfg, P, St, x, fmt)
        got = torch.softmax(low.double(), -1).cpu().numpy()
        out[name] = S.summarize_rows(S.row_gaps(got, ref))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="program,control,bf16,half")
    p.add_argument("--seconds", type=float)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    run.set_cache_dirs()
    bench = run.read_json(run.ROOT / "BENCHMARK.json")
    c = run.cell(bench, args.workload)
    model = run.load_module(HERE / "reference" / f"{c.cfg['reference']}.py",
                            f"perfbench.reference.{c.cfg['reference']}")
    dev = torch.device("cuda:0")
    what = args.what.split(",")
    sink = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        ctx = SimpleNamespace(cfg=c.cfg, traffic=c.traffic, seed=seed,
                              seconds=args.seconds or bench["run_seconds"],
                              device=dev, model=model, trace=False)
        reader = (train_readings if c.traffic["driver"] == "train_fit"
                  else serve_readings)
        rec = {"workload": args.workload, "seed": seed,
               **reader(ctx, what), "s": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        if sink:
            sink.write(json.dumps(rec) + "\n")
            sink.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
