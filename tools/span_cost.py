"""Host microseconds a ``monitor.span`` costs, with the profiler off and
on, and a ``record_span`` beside them.

    python3 tools/span_cost.py [--spans N] [--repeats R]

Each figure is the median over ``R`` repeats of ``N`` empty spans on a
fresh tracer; "on" runs under ``perfbench/trace.py``'s ``Profiler``,
started on the same thread.  Prints one JSON line, with the device's
name (or ``cpu``) beside the numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def per_span_us(fn, n: int, repeats: int) -> float:
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(n)
        out.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--spans", type=int, default=20000)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    import torch
    from deeplearning4j_tpu_torch.monitor import tracing
    from perfbench.trace import Profiler

    def spans(n):
        tr = tracing.Tracer(capacity=4096)
        for _ in range(n):
            with tr.span("cost/span", rows=1):
                pass

    def records(n):
        tr = tracing.Tracer(capacity=4096)
        for _ in range(n):
            tr.record_span("cost/record", trace_id=1, ts=0.0, dur_ms=1.0,
                           rows=1)

    spans(1000)
    off = per_span_us(spans, args.spans, args.repeats)
    rec = per_span_us(records, args.spans, args.repeats)
    with Profiler():
        spans(1000)
        on = per_span_us(spans, args.spans, args.repeats)
    dev = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
           else "cpu")
    print(json.dumps({"device": dev, "spans": args.spans,
                      "repeats": args.repeats, "span_off_us": off,
                      "span_on_us": on, "record_span_us": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
