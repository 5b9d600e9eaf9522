"""95th percentile of the engine's ``serve/queue_wait`` spans of the
requests sent while the profiler ran."""

import math


def read(out):
    waits = sorted(out["readings"].get("queue_wait_ms") or [])
    if out["trace"] is None or not waits:
        return None
    return float(waits[max(0, math.ceil(0.95 * len(waits)) - 1)])
