"""Compare ``chip_smoke.py`` of two checkouts on one card: the whole script
in the order A, B, B, A, then phase 9's LeNet-5 step of each with and
without ``CUBLAS_WORKSPACE_CONFIG``, one process a run, rounds interleaved.

    python3 tools/smoke_ab.py A_DIR B_DIR

Each directory is a tree that holds ``chip_smoke.py`` and the port (a
``git archive`` of a commit).  Needs a CUDA card.  For each whole run it
prints the exit code, the wall seconds and the ``[build]`` and ``phase N
in`` lines, and writes the run's output to ``chiprun_out/ab<i>_<name>.out``
and ``.err``; for each LeNet run the median, p10 and p90 of the step's ms
(``chip_smoke.phase_lenet``: a ``fit`` and its score read, host clock;
``LENET_STEPS`` steps, ``LENET_ROUNDS`` rounds).
The card's name and power limit are printed first and last.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
ENV = "CUBLAS_WORKSPACE_CONFIG"
LENET_ROUNDS, LENET_STEPS = 3, 300
LENET = """
import os, sys
import numpy as np
sys.path.insert(0, os.getcwd())
import chip_smoke as C
C.LENET_STEPS = {steps}
ms = np.array(C.phase_lenet(0)["step_ms"][1:])
print("LENET median %.4f p10 %.4f p90 %.4f" % (
    np.median(ms), np.percentile(ms, 10), np.percentile(ms, 90)))
"""


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip()


def smoke(i: int, tree: str) -> None:
    name = os.path.basename(os.path.normpath(tree))
    stem = os.path.join(OUT, f"ab{i}_{name}")
    t0 = time.perf_counter()
    with open(stem + ".out", "w") as out, open(stem + ".err", "w") as err:
        rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                            stdout=out, stderr=err, timeout=1250).returncode
    seconds = time.perf_counter() - t0
    print(f"run {i} {name} rc={rc} seconds={seconds!r}", flush=True)
    for path in (stem + ".err", stem + ".out"):
        for line in open(path):
            if re.match(r"\[build\]|\[\w+\] phase \d+ in", line):
                print("  " + line.rstrip()[:160], flush=True)


def lenet(tree: str, env_set: bool) -> None:
    env = dict(os.environ)
    env.pop(ENV, None)
    if env_set:
        env[ENV] = ":4096:8"
    code = LENET.format(steps=LENET_STEPS)
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=300)
    found = [l for l in out.stdout.splitlines() if l.startswith("LENET")]
    result = found[-1] if found else f"failed: {out.stderr[-300:]}"
    name = os.path.basename(os.path.normpath(tree))
    print(f"{name} {ENV}={'set' if env_set else 'unset'} {result}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    args = ap.parse_args(argv)
    os.makedirs(OUT, exist_ok=True)
    print(card(), flush=True)
    for i, tree in enumerate((args.a, args.b, args.b, args.a), 1):
        smoke(i, tree)
    runs = [(args.a, False), (args.b, False), (args.b, True), (args.a, True)]
    for r in range(LENET_ROUNDS):
        for tree, env_set in (runs if r % 2 == 0 else runs[::-1]):
            lenet(tree, env_set)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
