"""Useful rows over bucket rows of the engine's batches (``serve/batch``
spans of the batches opened while the profiler ran), in %.  A batch of n rows
runs in the smallest power of two at or above n, or at the largest
batch."""


def read(out):
    r = out["readings"]
    rows = [n for n in r.get("batch_rows") or [] if n > 0]
    if out["trace"] is None or not rows:
        return None
    top = r["max_batch_size"]
    padded = sum(min(1 << (n - 1).bit_length(), top) for n in rows)
    return 100.0 * sum(rows) / padded
