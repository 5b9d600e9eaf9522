"""Per-layer readers of the program's own spans: the finished spans in
the tracer's ring of ``deeplearning4j_tpu_torch.monitor``, read after
the run.  Each reader takes a run's outcome (and, for a test, the
spans) and returns the metric, or None where the run has nothing to
read: a program that records no such span yields None, not 0."""


def ring():
    """The program's finished spans, oldest first."""
    from deeplearning4j_tpu_torch import monitor
    return monitor.tracer().events()


def fit_child_ms(out, name: str, events=None):
    """Milliseconds a step of the ``name`` spans that are children of the
    newest ``fit/epoch`` span (the traced ``fit`` call's), over the
    traced call's steps."""
    steps = out["readings"].get("steps")
    if out["trace"] is None or not steps:
        return None
    events = ring() if events is None else events
    epochs = [e for e in events if e["name"] == "fit/epoch"]
    if not epochs:
        return None
    top = epochs[-1]["id"]
    kids = [e["dur_ms"] for e in events
            if e["name"] == name and e["parent"] == top]
    if not kids:
        return None
    return sum(kids) / steps


def worker_host_ms(out, events=None):
    """Milliseconds a batch of the serving worker's host work,
    ``serve/assemble`` plus ``serve/resolve``, over the batches that ran
    within the traced window's length before the start of the newest
    ``serve/request`` span: ``serve/assemble`` starts and
    ``serve/resolve`` ends in that stretch.  A batch still running when
    the last request is sent is left out: the profiler's stop follows that
    send and holds the worker up (1.5–2.3 s on an H100 host)."""
    t = out["trace"]
    if t is None:
        return None
    events = ring() if events is None else events
    starts = [e["ts"] for e in events if e["name"] == "serve/request"]
    if not starts:
        return None
    end = max(starts)
    first = end - t["window_s"]
    per = {}
    for e in events:
        if e["name"] in ("serve/assemble", "serve/resolve"):
            per.setdefault(e["parent"], {})[e["name"]] = e
    whole = [a["dur_ms"] + r["dur_ms"] for a, r in (
        (v.get("serve/assemble"), v.get("serve/resolve"))
        for v in per.values())
        if a is not None and r is not None and first <= a["ts"]
        and r["ts"] + r["dur_ms"] / 1e3 <= end]
    if not whole:
        return None
    return sum(whole) / len(whole)
