"""Find a serving cell's knee: one engine, windows of open-loop traffic at
rising offered rates, each reported by its p95, the images per second
answered inside the window, the requests failed and those still
unanswered at the close (a growing backlog).

    python3 perfbench/sweep.py --workload <name> --seed <n> \
        --rates 500,1000,2000 [--seconds 10]

The knee is the highest rate whose p95 stays under the limit with no
backlog; the cell's traffic file takes about four fifths of it.
"""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from perfbench import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    import numpy as np
    import torch
    from perfbench.traffic import serve_open_loop as S
    run.set_cache_dirs()
    c = run.cell(run.read_json(run.ROOT / "BENCHMARK.json"), args.workload)
    model = run.load_module(HERE / "reference" / f"{c.cfg['reference']}.py",
                            f"perfbench.reference.{c.cfg['reference']}")
    ctx = SimpleNamespace(cfg=c.cfg, traffic=c.traffic, seed=args.seed,
                          device=torch.device("cuda:0"), model=model)
    t0 = time.perf_counter()
    server, pool = S.prepare(ctx)
    S.settle_heap()
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    for rate in [float(r) for r in args.rates.split(",")]:
        traffic = dict(c.traffic, rate_images_per_s=rate)
        due, ks, offs = S.schedule(traffic, args.seed, args.seconds)
        w = S.drive(server, pool, due, ks, offs, args.seconds)
        backlog = int(np.sum(w["done"] > w["t_close"]))
        print(json.dumps({
            "rate_images_per_s": rate, "requests": len(due),
            "p95_ms": w["p95_ms"],
            "p50_ms": S.percentile(w["lat_ms"], 50),
            "p99_ms": S.percentile(w["lat_ms"], 99),
            "images_per_s": w["images_per_s"], "failed": w["failed"],
            "unanswered_at_close": backlog,
            "generator_late_ms": w["late_ms"]}), flush=True)
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
