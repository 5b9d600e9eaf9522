"""The port's tracing (``monitor/tracing.py``) and histogram exemplars
against the JAX package's: the same spans give the same JSONL and Chrome
structure (ids, timestamps, durations and threads aside), ``traceparent``
parses the same, attached contexts parent spans the same way, a full ring
counts its drops, and the serving engine's batch spans have the JAX
engine's parent/link shape.
"""

import json
import threading

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.monitor import metrics as jmetrics
from deeplearning4j_tpu.monitor import tracing as jtracing
from deeplearning4j_tpu.serving import InferenceEngine as JaxEngine
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import metrics, tracing
from deeplearning4j_tpu_torch.serving import InferenceEngine
from serving_pairs import dense_conf, pair

IDS = ("ts", "dur", "tid", "pid")


@pytest.fixture(autouse=True)
def _isolated():
    monitor.reset()
    jmonitor.reset()
    yield
    monitor.reset()
    jmonitor.reset()


def _record(mod, tracer):
    root = mod.TraceContext(0x1234, 0x99)
    token = tracer.attach(root)
    with tracer.span("fit/epoch", epoch=3) as outer:
        with tracer.span("fit/step", links=[outer], step=1):
            pass
        tracer.record_span("serve/queue_wait", trace_id=0xabc, ts=1.5,
                           dur_ms=2.25, parent_id=outer, rows=4)
    tracer.detach(token)
    with tracer.span("fresh"):
        pass
    return tracer


def _shape(events):
    """Chrome events with every id replaced by its first-seen index (ids
    are per process), timings and threads dropped."""
    seen = {}

    def rid(v):
        return None if v is None else seen.setdefault(v, len(seen))

    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in IDS}
        args = dict(e.pop("args"))
        args["span_id"] = rid(args["span_id"])
        args["parent"] = rid(args["parent"])
        if args.get("links"):
            args["links"] = [rid(v) for v in args["links"]]
        if e["name"] == "fresh":
            args.pop("trace_id")             # a fresh random trace
        out.append(dict(e, args=args))
    return out


def test_same_spans_give_the_same_chrome_structure():
    got = _record(tracing, tracing.Tracer())
    want = _record(jtracing, jtracing.Tracer())
    assert _shape(got.chrome_events()) == _shape(want.chrome_events())
    assert [json.loads(l)["name"] for l in got.to_jsonl().splitlines()] \
        == [json.loads(l)["name"] for l in want.to_jsonl().splitlines()]
    assert _shape(json.loads(got.to_chrome_json(name="fit"))) == \
        _shape(json.loads(want.to_chrome_json(name="fit")))
    trace = f"{0x1234:032x}"
    assert len(got.events(trace_id=trace)) == len(
        want.events(trace_id=trace)) == 2
    assert got.events(limit=1)[0]["name"] == "fresh"
    assert got.active_spans() == []


@pytest.mark.parametrize("header", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "01-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00-extra",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "00-xyz-b7ad6b7169203331-01", "", None, "garbage"])
def test_traceparent_parses_like_jax(header):
    got = tracing.parse_traceparent(header)
    want = jtracing.parse_traceparent(header)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id, got.flags) == \
            (want.trace_id, want.span_id, want.flags)
        assert got.traceparent() == want.traceparent()
        assert got.child(5).traceparent() == want.child(5).traceparent()


def test_span_ids_are_pid_salted_and_a_full_ring_counts_drops():
    tr = tracing.Tracer(capacity=3)
    ids = [tr.next_span_id() for _ in range(3)]
    assert ids == sorted(ids) and len(set(i >> 40 for i in ids)) == 1
    for i in range(5):
        tr.record_span("s", trace_id=1, ts=0.0, dur_ms=1.0, n=i)
    assert tr.dropped_count() == 2
    assert [e["attrs"]["n"] for e in tr.events()] == [2, 3, 4]
    tr.clear()
    assert tr.dropped_count() == 0 and tr.events() == []


def test_histograms_pin_the_ambient_trace_as_exemplar():
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    ctx = tracing.TraceContext(0xfeed, 7)
    token = tracing.attach(ctx)
    try:
        reg.histogram("lat_ms", "h").observe(3.0, model="m")
    finally:
        tracing.detach(token)
    jreg.histogram("lat_ms", "h").observe(3.0, exemplar=f"{0xfeed:032x}",
                                          model="m")
    reg.histogram("lat_ms").observe(700.0, exemplar="", model="m")
    jreg.histogram("lat_ms").observe(700.0, exemplar="", model="m")
    got = reg.snapshot()["lat_ms"]["values"]['{model="m"}']
    want = jreg.snapshot()["lat_ms"]["values"]['{model="m"}']
    assert list(got["exemplars"]) == list(want["exemplars"]) == ["5"]
    assert got["exemplars"]["5"][0]["trace_id"] == f"{0xfeed:032x}"

    def lines(text):
        return [l.rsplit(" ", 1)[0] for l in text.splitlines()
                if "trace_id" in l]

    assert lines(reg.prometheus_text()) == lines(jreg.prometheus_text())


def _batch_spans(engine_cls, net, name):
    """Three concurrent requests under one attached context, coalesced
    into batches; returns the engine's serve/* spans."""
    mod = monitor if engine_cls is InferenceEngine else jmonitor
    mod.tracer().clear()
    x = np.random.RandomState(0).randn(1, 4).astype(np.float32)
    ctx = mod.TraceContext(0x5eed, 0x77)
    with engine_cls(net, max_batch_size=4, max_latency_ms=200.0,
                    name=name) as eng:
        eng.warmup((4,))
        gate = threading.Barrier(3)

        def call():
            token = mod.attach(ctx)
            try:
                gate.wait(10)
                eng.predict(x, timeout=60.0)
            finally:
                mod.detach(token)

        threads = [threading.Thread(target=call) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    return mod.tracer().events(name="serve/")


def _span_shape(events):
    reqs = [e for e in events if e["name"] == "serve/request"]
    batches = [e for e in events if e["name"] == "serve/batch"]
    req_ids = {e["id"] for e in reqs}
    segs = sorted(e["name"] for e in events
                  if e["parent"] in req_ids)
    linked = sorted(l for b in batches for l in b.get("links", []))
    return {
        "requests": len(reqs),
        "request_parents": sorted({e["parent"] for e in reqs}),
        "request_trace": sorted({e["trace"] for e in reqs}),
        "segments": segs,
        "links_cover_requests": linked == sorted(req_ids),
        "batch_rows": sum(b["attrs"]["rows"] for b in batches),
        "request_attrs": sorted(sorted(e["attrs"]) for e in reqs),
    }


def test_engine_batch_spans_have_the_jax_shape():
    """The requests, their parents and traces, the batches' links and
    rows are the JAX engine's.  Per request the port keeps
    ``serve/request`` and its ``serve/queue_wait`` segment; the JAX
    engine's per-request ``serve/batch_assembly`` and ``serve/dispatch``
    segments, which repeat the batch's interval, give way to the worker's
    live ``serve/assemble``, ``serve/forward`` and ``serve/resolve``, one
    each per batch, children of its ``serve/batch`` span."""
    jnet, pnet = pair(dense_conf(seed=4))
    events = _batch_spans(InferenceEngine, pnet, "spans")
    got = _span_shape(events)
    want = _span_shape(_batch_spans(JaxEngine, jnet, "spans"))
    assert want.pop("segments") == sorted(
        ["serve/queue_wait", "serve/batch_assembly", "serve/dispatch"] * 3)
    assert got.pop("segments") == ["serve/queue_wait"] * 3
    assert got == want
    assert got["requests"] == 3 and got["request_parents"] == [0x77]
    assert got["links_cover_requests"]
    batches = [e for e in events if e["name"] == "serve/batch"]
    work = [e for e in events if e["name"] in (
        "serve/assemble", "serve/forward", "serve/resolve")]
    assert batches and len(work) == 3 * len(batches)
    for b in batches:
        kids = [e for e in work if e["parent"] == b["id"]]
        assert sorted(e["name"] for e in kids) == [
            "serve/assemble", "serve/forward", "serve/resolve"]
        assert {e["trace"] for e in kids} == {b["trace"]}
        (assemble,) = [e for e in kids if e["name"] == "serve/assemble"]
        assert assemble["attrs"]["rows"] == b["attrs"]["rows"]
    # the request latency histogram carries the request's trace
    lat = monitor.snapshot()["serving_request_latency_ms"]["values"]
    exemplars = [x["trace_id"] for st in lat.values()
                 for xs in st.get("exemplars", {}).values() for x in xs]
    assert f"{0x5eed:032x}" in exemplars
