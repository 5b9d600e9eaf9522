"""Run ``chip_smoke.py``'s phase 19 (the serving fleet) several times on
one card, seeds 0, 1, ..., and print each run's failover record.

    python3 tools/fleet_repeat.py [--runs 3]

Run from the root of the repo (it imports ``chip_smoke``).  Needs a CUDA
card.  Prints the card's name and power limit first, then one ``REP``
line a run: OK with the seconds and the failover's request count,
non-200s, transport errors and respawn seconds, or FAIL with the error.
Exits 1 if any run failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from deeplearning4j_tpu_torch.ops import attention as A
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    failed = 0
    keys = ("requests", "non_200", "transport_errors", "respawn_s",
            "home_again", "code_after")
    for i in range(args.runs):
        t0 = time.time()
        try:
            fo = C.phase_fleet(A, i)["failover"]
            print("REP", i, "OK", round(time.time() - t0, 1),
                  json.dumps({k: fo[k] for k in keys}), flush=True)
        except Exception as e:      # record the run, go on to the next
            failed += 1
            print("REP", i, "FAIL", round(time.time() - t0, 1),
                  repr(e)[:1500], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
