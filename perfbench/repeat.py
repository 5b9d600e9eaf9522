"""Run cells of the benchmark several times, each run a fresh process as
the check makes them, and summarize: per metric the median and the
spread (first to third quartile, ``statistics.quantiles(values, n=4)``,
over the median), and every compared number's largest reading.

    python3 perfbench/repeat.py --workload <name> [--workload ...] \
        --seeds 11,12,13 [--seconds S] [--trace 0|1] [--out FILE]

Each run's result line and its standard error's last lines go to
``--out`` (JSON lines) as well.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    for workload in args.workload:
        lines = []
        for seed in seeds:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(HERE / "run.py"), "--workload",
                 workload, "--seed", str(seed), "--seconds", str(seconds),
                 "--trace", str(args.trace)],
                capture_output=True, text=True)
            wall = time.perf_counter() - t0
            out = proc.stdout.strip().splitlines()
            try:
                line = json.loads(out[-1]) if out else None
            except json.JSONDecodeError:
                line = None
            rec = {"workload": workload, "seed": seed, "rc": proc.returncode,
                   "wall_s": wall, "line": line,
                   "stderr_tail": proc.stderr[-3000:]}
            if sink:
                sink.write(json.dumps(rec) + "\n")
                sink.flush()
            brief = (json.dumps({k: v for k, v in line.items()
                                 if k != "breakdown"})
                     if line else proc.stderr[-2000:])
            print(f"[{workload} seed {seed} rc {proc.returncode} "
                  f"{wall:.1f} s] {brief}", flush=True)
            if line:
                lines.append(line)
        names = sorted({m for l in lines for m in l["metrics"]})
        for m in names:
            vals = [l["metrics"][m]["value"] for l in lines
                    if m in l["metrics"]]
            print(f"  {workload} {m}: median {statistics.median(vals)!r} "
                  f"spread {spread(vals)!r} values {vals}", flush=True)
        for k in sorted({k for l in lines for k in l.get("checks", {})}):
            vals = [l["checks"][k]["value"] for l in lines]
            print(f"  {workload} check {k}: max {max(vals)!r} "
                  f"values {vals}", flush=True)
        print(f"  {workload} correct: "
              f"{[l['correct'] for l in lines]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
