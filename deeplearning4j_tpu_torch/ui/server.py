"""UIServer: training dashboard over a stats storage, and the HTTP front
door of serving (port of ``deeplearning4j_tpu/ui/server.py``: the same
routes, status codes, headers and body keys).

Equivalent of the reference's
``deeplearning4j-ui-parent/deeplearning4j-play/src/main/java/org/
deeplearning4j/ui/play/PlayUIServer.java`` (implements ``ui/api/
UIServer.java``: ``getInstance().attach(statsStorage)``) and the train
dashboard module ``module/train/TrainModule.java`` (overview / model /
system tabs), plus the remote-stats receiver path
(``module/remote/`` + core ``api/storage/impl/RemoteUIStatsStorageRouter``:
remote processes POST stats to a central UI).

The Play framework + JS asset pipeline is replaced by a stdlib
``ThreadingHTTPServer`` serving one self-contained HTML page (inline SVG
charts, no external assets) and JSON data endpoints the page polls:

    GET  /train/sessions            -> list of session ids
    GET  /train/overview/data?sid=  -> score/throughput/lr/memory series
    GET  /train/model/data?sid=     -> per-param magnitudes/ratios/histograms
    POST /remote                    -> Persistable JSON (remote router)

Runtime-telemetry export (the ``monitor`` package's process globals):

    GET  /metrics  -> Prometheus text exposition (counters/gauges/summaries)
    GET  /trace    -> Chrome trace events, one JSON object per line (wrap
                      the lines in [...] for Perfetto / chrome://tracing);
                      the X-Trace-Dropped response header counts spans the
                      ring buffer evicted unexported (truncated timeline)
    GET  /alerts   -> alert-engine state: per-rule config, ok/pending/
                      firing, last reason/value, flight-bundle path
    GET  /healthz  -> liveness probe for scrapers, enriched with backend
                      (``"cuda"`` when torch sees a card, else
                      ``"cpu"``), device count, last dispatch time, and
                      the ok/diverged training-health state
    GET  /health   -> full training-health snapshot (guard config +
                      last-dispatch per-layer grad/param/update stats)

Model serving (the ``serving`` package's multi-tenant engine):

    POST /predict  -> JSON in/out inference against an attached
                      :class:`~deeplearning4j_tpu_torch.serving.
                      InferenceEngine` (``attach_inference``) or
                      :class:`~deeplearning4j_tpu_torch.serving.
                      ModelRegistry`
                      (``attach_registry``).  Body:
                      ``{"features": [[...], ...]}`` for single-input
                      models or ``{"inputs": [[[...]], ...]}`` for
                      multi-input graphs; optional ``"model"`` (registry
                      routing, 404 for unknown names), ``"session"``
                      (device-resident RNN session id — one timestep
                      dispatch per call), ``"engine"`` (attached-engine
                      name), ``"timeout"`` (seconds) and ``"tenant"``
                      (fair-admission tenant id; absent/unknown ids
                      normalize to the public tenant).
    GET  /models   -> registry hosting view: per-model residency,
                      bytes, quantization, queue depth, SLO.
    GET  /tenants  -> per-tenant SLO scoreboard: windowed p50/p99 vs
                      target, shed rate, error-budget burn rate, and
                      cross-tenant unfairness evidence per engine.

    Overload responses are distinct and actionable: 429 when the
    bounded queue rejects (with a ``Retry-After`` header derived from
    the live queue drain rate), 503 with the violated SLO and observed
    p99 when admission control sheds, 400 on malformed shapes, 503
    when no engine is attached.

Fleet and deployment control plane:

    GET  /fleet         -> the attached ``FleetRouter``'s status (POST
                           /predict then routes through the fleet)
    GET  /deploy        -> every attached rollout controller's status
    POST /deploy/<model> -> push / promote / rollback / step (a corrupt
                           snapshot answers 400, misuse 409)

Unknown routes return 404 with a JSON error body.  The engines behind
``/predict`` are called from the server's request threads; each engine
queues its device work on its device's default stream.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

from .. import monitor as _monitor
from .storage import (InMemoryStatsStorage, Persistable, StatsStorage,
                      StatsStorageRouter)
from .stats_listener import TYPE_ID


class _HTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog of 1024 (the kernel
    caps it at ``net.core.somaxconn``).  socketserver's default of 5 let
    only 6 connections wait while the accept loop was busy, and a burst
    of clients past that saw connection resets: a FleetRouter's front
    door under open-loop load dropped requests unanswered (ROADMAP C10;
    the JAX server keeps the default)."""

    request_queue_size = 1024


_PAGE = """<!DOCTYPE html>
<html><head><title>DL4J Training UI</title>
<style>
body { font-family: sans-serif; margin: 1.5em; background: #fafafa; }
h1 { font-size: 1.3em; } h2 { font-size: 1.05em; margin-top: 1.2em; }
.chart { background: #fff; border: 1px solid #ddd; margin-bottom: 1em; }
table { border-collapse: collapse; background: #fff; }
td, th { border: 1px solid #ddd; padding: 4px 10px; font-size: 0.85em; }
#meta { color: #666; font-size: 0.85em; }
</style></head>
<body>
<h1>DL4J Training Dashboard</h1>
<div id="meta"></div>
<h2>Score vs iteration</h2>
<svg id="score" class="chart" width="640" height="240"></svg>
<h2>Update:param mean-magnitude ratio (log10)</h2>
<svg id="ratios" class="chart" width="640" height="240"></svg>
<h2>Throughput + memory</h2>
<table id="sys"></table>
<h2>Model</h2>
<table id="model"></table>
<h2>System: memory (MB) vs iteration</h2>
<svg id="memchart" class="chart" width="640" height="200"></svg>
<h2>System: hardware</h2>
<table id="hw"></table>
<script>
function esc(v) {                       // stats values may come from the
  const d = document.createElement('div');  // unauthenticated /remote POST
  d.textContent = String(v);                // path - never innerHTML them raw
  return d.innerHTML;
}
function line(svg, series, labels) {
  svg.innerHTML = '';
  const W = svg.width.baseVal.value, H = svg.height.baseVal.value;
  let xs = [], ys = [];
  series.forEach(s => s.pts.forEach(p => { xs.push(p[0]); ys.push(p[1]); }));
  if (!xs.length) return;
  const x0 = Math.min(...xs), x1 = Math.max(...xs, x0 + 1);
  const y0 = Math.min(...ys), y1 = Math.max(...ys, y0 + 1e-9);
  const X = v => 40 + (W - 50) * (v - x0) / (x1 - x0);
  const Y = v => H - 20 - (H - 30) * (v - y0) / (y1 - y0);
  const colors = ['#1976d2','#d32f2f','#388e3c','#f57c00','#7b1fa2',
                  '#0097a7','#5d4037','#455a64'];
  series.forEach((s, i) => {
    const d = s.pts.map((p, j) => (j ? 'L' : 'M') + X(p[0]) + ',' + Y(p[1]))
                   .join(' ');
    const path = document.createElementNS('http://www.w3.org/2000/svg',
                                          'path');
    path.setAttribute('d', d); path.setAttribute('fill', 'none');
    path.setAttribute('stroke', colors[i % colors.length]);
    svg.appendChild(path);
  });
  [[x0, y0], [x1, y1]].forEach((p, i) => {
    const t = document.createElementNS('http://www.w3.org/2000/svg','text');
    t.setAttribute('x', i ? W - 90 : 2); t.setAttribute('y', H - 4);
    t.setAttribute('font-size', '10');
    t.textContent = i ? 'iter ' + p[0] : (y0.toPrecision(3) + ' .. '
                                          + y1.toPrecision(3));
    svg.appendChild(t);
  });
}
async function refresh() {
  const sids = await (await fetch('train/sessions')).json();
  if (!sids.length) return;
  const sid = sids[sids.length - 1];
  const ov = await (await fetch('train/overview/data?sid=' + sid)).json();
  document.getElementById('meta').textContent =
    'session ' + sid + ' | ' + JSON.stringify(ov.static || {});
  line(document.getElementById('score'),
       [{pts: ov.score_vs_iter || []}]);
  const md = await (await fetch('train/model/data?sid=' + sid)).json();
  const rs = Object.entries(md.ratio_series || {}).map(
    ([k, v]) => ({pts: v.map(p => [p[0], Math.log10(p[1] + 1e-12)])}));
  line(document.getElementById('ratios'), rs);
  document.getElementById('sys').innerHTML =
    '<tr><th>samples/sec</th><th>batches/sec</th><th>rss MB</th></tr>' +
    '<tr><td>' + (ov.samples_per_sec || '-') + '</td><td>' +
    (ov.batches_per_sec || '-') + '</td><td>' +
    (ov.memory_rss_mb || '-') + '</td></tr>';
  document.getElementById('model').innerHTML =
    '<tr><th>param</th><th>mean |w|</th><th>mean |dw|</th><th>ratio</th>'
    + '</tr>' + Object.entries(md.params || {}).map(([k, v]) =>
      '<tr><td>' + esc(k) + '</td><td>' + v.mean_mag.toPrecision(4)
      + '</td><td>' + (v.update_mag || 0).toPrecision(4) + '</td><td>'
      + (v.ratio || 0).toPrecision(4) + '</td></tr>').join('');
  const sd = await (await fetch('train/system/data?sid=' + sid)).json();
  const wk = Object.entries(sd.workers || {});
  line(document.getElementById('memchart'),
       wk.map(([w, d]) => ({pts: d.memory_vs_iter || []})));
  const hwKeys = ['hostname','os','python','torch_version','backend',
                  'device_count','device_kind'];
  document.getElementById('hw').innerHTML =
    '<tr><th>worker</th>' + hwKeys.map(k => '<th>' + k + '</th>').join('')
    + '</tr>' + wk.map(([w, d]) => '<tr><td>' + esc(w) + '</td>'
      + hwKeys.map(k => '<td>' + esc((d.hardware || {})[k] ?? '-')
      + '</td>').join('') + '</tr>').join('');
}
refresh(); setInterval(refresh, 2000);
</script></body></html>
"""

_TSNE_PAGE = """<!DOCTYPE html>
<html><head><title>DL4J t-SNE</title>
<style>
body { font-family: sans-serif; margin: 1.5em; background: #fafafa; }
h1 { font-size: 1.3em; }
.chart { background: #fff; border: 1px solid #ddd; }
</style></head>
<body>
<h1>t-SNE embedding</h1>
<svg id="tsne" class="chart" width="720" height="560"></svg>
<script>
async function refresh() {
  const d = await (await fetch('tsne/data')).json();
  const svg = document.getElementById('tsne');
  svg.innerHTML = '';
  const pts = d.coords || [];
  if (!pts.length) return;
  const W = svg.width.baseVal.value, H = svg.height.baseVal.value;
  // reduce, not Math.min(...xs): spread throws past ~65k args
  const xs = pts.map(p => p[0]), ys = pts.map(p => p[1]);
  const x0 = xs.reduce((a, b) => Math.min(a, b), Infinity);
  const x1 = Math.max(xs.reduce((a, b) => Math.max(a, b), -Infinity),
                      x0 + 1e-9);
  const y0 = ys.reduce((a, b) => Math.min(a, b), Infinity);
  const y1 = Math.max(ys.reduce((a, b) => Math.max(a, b), -Infinity),
                      y0 + 1e-9);
  const X = v => 15 + (W - 30) * (v - x0) / (x1 - x0);
  const Y = v => H - 15 - (H - 30) * (v - y0) / (y1 - y0);
  pts.forEach((p, i) => {
    const c = document.createElementNS('http://www.w3.org/2000/svg',
                                       'circle');
    c.setAttribute('cx', X(p[0])); c.setAttribute('cy', Y(p[1]));
    c.setAttribute('r', 2.5); c.setAttribute('fill', '#1976d2');
    svg.appendChild(c);
    const label = (d.labels || [])[i];
    if (label !== undefined && label !== null) {
      const t = document.createElementNS('http://www.w3.org/2000/svg',
                                         'text');
      t.setAttribute('x', X(p[0]) + 4); t.setAttribute('y', Y(p[1]) - 3);
      t.setAttribute('font-size', '9');
      t.textContent = label;
      svg.appendChild(t);
    }
  });
}
refresh(); setInterval(refresh, 5000);
</script></body></html>
"""


_FLOW_PAGE = """<!DOCTYPE html>
<html><head><title>DL4J Network Flow</title>
<style>
body { font-family: sans-serif; margin: 1.5em; background: #fafafa; }
h1 { font-size: 1.3em; }
.chart { background: #fff; border: 1px solid #ddd; }
</style></head>
<body>
<h1>Network topology</h1>
<svg id="flow" class="chart" width="860" height="600"></svg>
<script>
async function refresh() {
  const sids = await (await fetch('/train/sessions')).json();
  if (!sids.length) return;
  const d = await (await fetch('/flow/data?sid='
                               + sids[sids.length - 1])).json();
  const svg = document.getElementById('flow');
  svg.innerHTML = '';
  const rows = {};
  (d.nodes || []).forEach(n => (rows[n.depth] = rows[n.depth] || []).push(n));
  const W = svg.width.baseVal.value, BH = 34, BW = 150;
  const depths = Object.keys(rows).map(Number).sort((a, b) => a - b);
  svg.setAttribute('height', Math.max(200, depths.length * 70 + 40));
  const pos = {};
  depths.forEach((dep, r) => {
    const row = rows[dep];
    row.forEach((n, i) => {
      const x = (W - row.length * (BW + 20)) / 2 + i * (BW + 20) + 10;
      const y = 20 + r * 70;
      pos[n.name] = [x + BW / 2, y, y + BH];
      const g = document.createElementNS('http://www.w3.org/2000/svg','g');
      const rect = document.createElementNS(
        'http://www.w3.org/2000/svg','rect');
      rect.setAttribute('x', x); rect.setAttribute('y', y);
      rect.setAttribute('width', BW); rect.setAttribute('height', BH);
      rect.setAttribute('rx', 5);
      rect.setAttribute('fill', n.kind === 'input' ? '#e3f2fd' : '#fff');
      rect.setAttribute('stroke', '#1976d2');
      g.appendChild(rect);
      const t = document.createElementNS('http://www.w3.org/2000/svg','text');
      t.setAttribute('x', x + BW / 2); t.setAttribute('y', y + 14);
      t.setAttribute('text-anchor', 'middle');
      t.setAttribute('font-size', '11');
      t.textContent = n.name;                       // textContent: safe
      g.appendChild(t);
      const t2 = document.createElementNS(
        'http://www.w3.org/2000/svg','text');
      t2.setAttribute('x', x + BW / 2); t2.setAttribute('y', y + 28);
      t2.setAttribute('text-anchor', 'middle');
      t2.setAttribute('font-size', '10'); t2.setAttribute('fill', '#666');
      t2.textContent = n.detail || '';
      g.appendChild(t2);
      svg.appendChild(g);
    });
  });
  (d.edges || []).forEach(([a, b]) => {
    if (!pos[a] || !pos[b]) return;
    const ln = document.createElementNS('http://www.w3.org/2000/svg','line');
    ln.setAttribute('x1', pos[a][0]); ln.setAttribute('y1', pos[a][2]);
    ln.setAttribute('x2', pos[b][0]); ln.setAttribute('y2', pos[b][1]);
    ln.setAttribute('stroke', '#999');
    svg.appendChild(ln);
  });
}
refresh(); setInterval(refresh, 5000);
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    server_version = "DL4JTPUUI/1.0"

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json",
              headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        trace_header = getattr(self, "_trace_header", None)
        if trace_header:
            self.send_header("traceparent", trace_header)
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj) -> None:
        self._send(200, json.dumps(obj).encode())

    def log_message(self, fmt, *args):  # quiet
        pass

    # ---- GET routes ------------------------------------------------------
    def do_GET(self):
        ui: "UIServer" = self.server.ui            # type: ignore
        url = urlparse(self.path)
        q = parse_qs(url.query)
        sid = q.get("sid", [None])[0]
        path = url.path.rstrip("/") or "/"
        if path in ("/", "/train", "/train/overview"):
            self._send(200, _PAGE.encode(), "text/html")
        elif path == "/train/sessions":
            self._json(ui.list_sessions())
        elif path == "/train/overview/data":
            self._json(ui.overview_data(sid))
        elif path == "/train/model/data":
            self._json(ui.model_data(sid))
        elif path == "/train/system/data":
            self._json(ui.system_data(sid))
        elif path == "/flow":
            self._send(200, _FLOW_PAGE.encode(), "text/html")
        elif path == "/flow/data":
            self._json(ui.flow_data(sid))
        elif path == "/tsne":
            self._send(200, _TSNE_PAGE.encode(), "text/html")
        elif path == "/tsne/data":
            self._json(ui.tsne_data())
        elif path == "/metrics":
            # scrape self-telemetry: the cost of observability is itself
            # observable (a slow/huge exposition shows on the NEXT scrape)
            t0 = time.perf_counter()
            body = _monitor.prometheus_text().encode()
            _monitor.histogram(
                "metrics_exposition_seconds",
                "wall time to render the /metrics exposition").observe(
                    time.perf_counter() - t0)
            _monitor.gauge(
                "metrics_exposition_bytes",
                "size of the last rendered /metrics body").set(len(body))
            self._send(200, body,
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/trace":
            trace_id = q.get("trace_id", [None])[0]
            name = q.get("name", [None])[0]
            try:
                limit = (int(q["limit"][0]) if "limit" in q else None)
            except ValueError:
                self._send(400, json.dumps(
                    {"error": "limit must be an integer"}).encode())
                return
            dropped = {"X-Trace-Dropped":
                       _monitor.tracer().dropped_count()}
            if q.get("format", [None])[0] == "chrome":
                self._send(200, _monitor.trace_chrome_json(
                    trace_id=trace_id, name=name, limit=limit).encode(),
                    "application/json", headers=dropped)
            else:
                self._send(200, _monitor.trace_jsonl(
                    trace_id=trace_id, name=name, limit=limit).encode(),
                    "application/x-ndjson", headers=dropped)
        elif path == "/alerts":
            self._json(ui.alerts_data())
        elif path == "/healthz":
            self._json(ui.healthz_data())
        elif path == "/health":
            self._json(ui.health_data())
        elif path == "/models":
            self._json(ui.models_data())
        elif path == "/deploy":
            self._json(ui.deploy_data())
        elif path == "/fleet":
            self._json(ui.fleet_data())
        elif path == "/tenants":
            self._json(ui.tenants_data())
        else:
            self._send(404, json.dumps(
                {"error": "not found", "path": path}).encode())

    # ---- POST /predict (multi-tenant dynamic-batching inference) ---------
    def _predict(self, ui: "UIServer") -> None:
        """Trace-context shell around the predict route: adopt the
        client's W3C ``traceparent`` (or mint a fresh trace), wrap the
        handling in an ``http/predict`` server span so the engine's
        request span parents under it, and echo the server context back
        as a ``traceparent`` response header on every outcome."""
        ctx = _monitor.parse_traceparent(self.headers.get("traceparent"))
        with _monitor.tracer().span("http/predict", ctx=ctx,
                                    path="/predict"):
            current = _monitor.current_context()
            self._trace_header = (current.traceparent()
                                  if current is not None else None)
            try:
                self._predict_inner(ui)
            finally:
                self._trace_header = None

    def _predict_inner(self, ui: "UIServer") -> None:
        import numpy as _np
        from ..serving.engine import QueueFull, ServingError, SloShed
        from ..serving.registry import UnknownModel
        from ..serving.sessions import SessionError
        length = int(self.headers.get("Content-Length", "0"))
        try:
            payload = json.loads(self.rfile.read(length).decode())
        except Exception as e:
            self._send(400, json.dumps({"error": repr(e)}).encode())
            return
        fleet = ui.get_fleet()
        if fleet is not None:
            # front-door mode: the fleet router owns placement —
            # session affinity, failover, and backpressure statuses
            # all come back from the chosen worker verbatim
            code, body, headers = fleet.handle_predict(payload)
            self._send(code, json.dumps(body).encode(),
                       headers=headers or None)
            return
        registry = ui.get_registry()
        model = payload.get("model")
        session = payload.get("session")
        # tenant rides the payload end to end (absent/unknown ids
        # normalize to the public tenant at the engine's edge)
        tenant = payload.get("tenant")
        try:
            if "inputs" in payload:
                feats = tuple(_np.asarray(a) for a in payload["inputs"])
            elif "features" in payload:
                feats = _np.asarray(payload["features"])
            else:
                raise ValueError("body needs 'features' or 'inputs'")
            timeout = payload.get("timeout")
            timeout = float(timeout) if timeout else None
            # non-blocking submits: the bounded queue is the buffer, so
            # saturation answers 429 + Retry-After instead of holding
            # the connection open
            if registry is not None and model is not None:
                out = registry.predict(model, feats, session=session,
                                       timeout=timeout, block=False,
                                       tenant=tenant)
            else:
                engine = ui.get_inference(payload.get("engine"))
                if engine is None and registry is not None:
                    raise ValueError(
                        "a registry is attached: select with 'model' "
                        f"(one of {registry.names()})")
                if engine is None:
                    self._send(503, json.dumps(
                        {"error": "no inference engine attached",
                         "engine": payload.get("engine")}).encode())
                    return
                if session is not None:
                    out = engine.predict_session(session, feats,
                                                 tenant=tenant)
                else:
                    out = engine.predict(feats, timeout=timeout,
                                         block=False, tenant=tenant)
        except UnknownModel as e:
            self._send(404, json.dumps(
                {"error": f"unknown model {model!r}",
                 "models": registry.names()}).encode())
            return
        except SloShed as e:
            # shed != full: report the SLO that triggered it so clients
            # can distinguish "overloaded" from "misconfigured"
            self._send(503, json.dumps(
                {"error": str(e), "shed": True,
                 "tenant": e.tenant,
                 "slo_p99_ms": e.slo_p99_ms,
                 "observed_p99_ms": e.observed_p99_ms}).encode(),
                headers={"Retry-After": "1"})
            return
        except QueueFull as e:
            self._send(429, json.dumps(
                {"error": str(e),
                 "retry_after_s": e.retry_after_s}).encode(),
                headers={"Retry-After": int(round(e.retry_after_s))})
            return
        except (ValueError, TypeError, SessionError) as e:
            self._send(400, json.dumps({"error": str(e)}).encode())
            return
        except ServingError as e:
            self._send(503, json.dumps({"error": str(e)}).encode())
            return
        except Exception as e:
            # any other fault answers 500 where the JAX server drops the
            # connection: behind a FleetRouter a dropped connection reads
            # as a dead worker, and the request would fail over onto (and
            # mark down) every worker in turn
            self._send(500, json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode())
            return
        if isinstance(out, (list, tuple)):
            body = {"outputs": [_np.asarray(o).tolist() for o in out]}
        else:
            body = {"output": _np.asarray(out).tolist()}
        self._json(body)

    # ---- POST /deploy/{model} (rollout control plane) --------------------
    def _deploy_post(self, ui: "UIServer", model: str) -> None:
        """``{"action": "push"|"promote"|"rollback"|"step",
        "version": N?}``.  Corrupt snapshots 400 (manifest SHA
        mismatch, no swap happens); control-plane misuse 409; an
        unattached model 404.  Every success echoes the controller's
        full status."""
        from ..deploy.rollout import RolloutError
        from ..deploy.store import WeightStoreCorruptError
        ctl = ui.get_deployment(model)
        if ctl is None:
            self._send(404, json.dumps(
                {"error": f"no deployment attached for model {model!r}",
                 "deployments": sorted(ui.deployments())}).encode())
            return
        length = int(self.headers.get("Content-Length", "0"))
        try:
            payload = json.loads(self.rfile.read(length).decode()) \
                if length else {}
            action = payload.get("action", "push")
            version = payload.get("version")
            version = int(version) if version is not None else None
            if action == "push":
                result = {"pushed": ctl.push(version)}
            elif action == "promote":
                result = {"promoted": ctl.promote()}
            elif action == "rollback":
                result = {"rolled_back": ctl.rollback(
                    reason=str(payload.get("reason", "http")))}
            elif action == "step":
                result = {"action": ctl.step()}
            else:
                raise ValueError(
                    f"unknown action {action!r}; expected push/promote/"
                    "rollback/step")
        except WeightStoreCorruptError as e:
            self._send(400, json.dumps(
                {"error": str(e), "corrupt": True}).encode())
            return
        except RolloutError as e:
            self._send(409, json.dumps({"error": str(e)}).encode())
            return
        except KeyError as e:
            self._send(404, json.dumps({"error": str(e)}).encode())
            return
        except (ValueError, TypeError) as e:
            self._send(400, json.dumps({"error": str(e)}).encode())
            return
        result["status"] = ctl.status()
        self._json(result)

    # ---- POST /remote (RemoteUIStatsStorageRouter receiver) + /tsne ------
    def do_POST(self):
        ui: "UIServer" = self.server.ui            # type: ignore
        path = urlparse(self.path).path.rstrip("/")
        if path == "/predict":
            self._predict(ui)
            return
        if path.startswith("/deploy/"):
            self._deploy_post(ui, path[len("/deploy/"):])
            return
        if path not in ("/remote", "/tsne/upload"):
            # Route before touching the body: unknown paths must 404 even
            # with an empty/non-JSON body.
            self._send(404, json.dumps(
                {"error": "not found", "path": path}).encode())
            return
        length = int(self.headers.get("Content-Length", "0"))
        try:
            payload = json.loads(self.rfile.read(length).decode())
            if path == "/remote":
                record = Persistable(**payload["record"])
                if payload.get("kind") == "static":
                    ui.storage.put_static_info(record)
                else:
                    ui.storage.put_update(record)
            else:
                ui.set_tsne_data(payload.get("coords", []),
                                 payload.get("labels"))
        except Exception as e:
            self._send(400, json.dumps({"error": repr(e)}).encode())
            return
        self._json({"status": "ok"})


class UIServer:
    """Reference ``UIServer.getInstance().attach(statsStorage)`` analogue.

    ``start()`` binds a background HTTP server (port 0 = ephemeral);
    ``attach`` points it at a storage to visualize (also the sink for
    POSTed remote stats)."""

    def __init__(self, storage: Optional[StatsStorage] = None,
                 port: int = 9000):
        self.storage = storage or InMemoryStatsStorage()
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._tsne: dict = {"coords": [], "labels": None}
        self._engines: dict = {}
        self._registry = None
        self._deployments: dict = {}
        self._fleet = None

    def attach(self, storage: StatsStorage) -> "UIServer":
        self.storage = storage
        return self

    # ---- serving (POST /predict) -----------------------------------------
    def attach_inference(self, engine, name: Optional[str] = None
                         ) -> "UIServer":
        """Register a :class:`~deeplearning4j_tpu_torch.serving.
        InferenceEngine`
        behind ``POST /predict``.  The first attached engine is the
        default; requests may select others by ``{"engine": name}``."""
        self._engines[name or getattr(engine, "name", "default")] = engine
        return self

    def detach_inference(self, name: str) -> "UIServer":
        self._engines.pop(name, None)
        return self

    def get_inference(self, name: Optional[str] = None):
        if name is not None:
            return self._engines.get(name)
        if self._engines:
            return next(iter(self._engines.values()))
        return None

    def attach_registry(self, registry) -> "UIServer":
        """Serve a :class:`~deeplearning4j_tpu_torch.serving.
        ModelRegistry`
        behind ``POST /predict`` (requests route by ``{"model": name}``,
        sessions by ``{"session": id}``) and ``GET /models``."""
        self._registry = registry
        return self

    def detach_registry(self) -> "UIServer":
        self._registry = None
        return self

    def get_registry(self):
        return self._registry

    # ---- fleet front door (POST /predict routed, GET /fleet) -------------
    def attach_fleet(self, router) -> "UIServer":
        """Make this server the fleet's front door: ``POST /predict``
        consistent-hash-routes through the attached
        :class:`~deeplearning4j_tpu_torch.serving.fleet.FleetRouter`
        (taking
        precedence over any local registry/engine), and ``GET /fleet``
        reports membership, health, and scale events."""
        self._fleet = router
        return self

    def detach_fleet(self) -> "UIServer":
        self._fleet = None
        return self

    def get_fleet(self):
        return self._fleet

    def fleet_data(self) -> dict:
        """``GET /fleet`` body (a stub when no router is attached)."""
        if self._fleet is None:
            return {"attached": False, "workers": []}
        data = self._fleet.status()
        data["attached"] = True
        return data

    # ---- tenant SLO scoreboard (GET /tenants) ----------------------------
    def _tenant_engines(self) -> dict:
        """Every engine this server fronts (standalone attachments plus
        the registry's, no paging side effects)."""
        engines = dict(self._engines)
        if self._registry is not None:
            for name in self._registry.names():
                try:
                    engines.setdefault(name, self._registry.get(name))
                except Exception:
                    pass
        return engines

    def tenants_data(self) -> dict:
        """``GET /tenants`` body: the per-tenant SLO scoreboard.

        Per tenant (merged worst-case across every fronted engine):
        windowed p50/p99 against the tenant's SLO target, admission
        decision counts and shed rate, the unloaded-baseline inflation,
        and the lifetime error-budget burn rate computed from the
        ``serving_tenant_latency_ms`` bucket ladder (bad = observations
        over the tenant's SLO, objective 99%).  ``engines`` carries each
        admission controller's raw snapshot including the cross-tenant
        unfairness evidence the alert rule thresholds on."""
        import re as _re
        from ..monitor.alerts import _bad_good
        from ..serving.admission import DEFAULT_TENANT
        objective = 0.99
        tenants: dict = {}
        engines: dict = {}

        def merge(tenant: str, row: dict) -> None:
            agg = tenants.setdefault(tenant, {
                "slo_p99_ms": None, "window_p50_ms": None,
                "window_p99_ms": None, "baseline_p99_ms": None,
                "inflation_x": None, "slo_ok": True,
                "window_admitted": 0, "window_shed": 0,
                "shed_rate": 0.0, "burn_rate": None,
                "requests": 0.0, "admitted": 0.0, "shed": 0.0,
            })
            if row.get("slo_p99_ms") is not None:
                agg["slo_p99_ms"] = (
                    row["slo_p99_ms"] if agg["slo_p99_ms"] is None
                    else min(agg["slo_p99_ms"], row["slo_p99_ms"]))
            for key in ("window_p50_ms", "window_p99_ms",
                        "inflation_x"):
                if row.get(key) is not None:
                    agg[key] = (row[key] if agg[key] is None
                                else max(agg[key], row[key]))
            if row.get("baseline_p99_ms") is not None:
                agg["baseline_p99_ms"] = (
                    row["baseline_p99_ms"]
                    if agg["baseline_p99_ms"] is None
                    else min(agg["baseline_p99_ms"],
                             row["baseline_p99_ms"]))
            agg["slo_ok"] = agg["slo_ok"] and row.get("slo_ok", True)
            agg["window_admitted"] += row.get("window_admitted", 0)
            agg["window_shed"] += row.get("window_shed", 0)
            decided = agg["window_admitted"] + agg["window_shed"]
            agg["shed_rate"] = (round(agg["window_shed"] / decided, 4)
                                if decided else 0.0)

        sources = list(self._tenant_engines().items())
        fleet = self.get_fleet()
        if fleet is not None and getattr(fleet, "_admission",
                                         None) is not None:
            sources.append(("fleet-router", fleet))
        for name, eng in sources:
            adm = getattr(eng, "_admission", None)
            if adm is None:
                continue
            rows = adm.tenant_snapshot()
            engines[name] = {
                "slo_p99_ms": adm.slo_p99_ms,
                "fair": adm.fair, "enforce": adm.enforce,
                "window_p99_ms": adm.window_p99(),
                "unfairness": adm.unfairness(),
                "tenants": rows,
            }
            for tenant, row in rows.items():
                merge(tenant, row)

        # lifetime counters + bucket-ladder burn per tenant label
        snap = _monitor.snapshot()

        def label_tenant(key: str):
            m = _re.search(r'tenant="([^"]*)"', key)
            return m.group(1) if m else None

        for metric, field in (("serving_tenant_requests_total",
                               "requests"),
                              ("serving_tenant_admitted_total",
                               "admitted"),
                              ("serving_tenant_shed_total", "shed")):
            for key, val in snap.get(metric, {}).get("values",
                                                     {}).items():
                tenant = label_tenant(key)
                if tenant is None:
                    continue
                if tenant not in tenants:
                    merge(tenant, {})
                tenants[tenant][field] += float(val)
        for key, val in snap.get("serving_tenant_latency_ms",
                                 {}).get("values", {}).items():
            tenant = label_tenant(key)
            if tenant is None:
                continue
            if tenant not in tenants:
                merge(tenant, {})
            agg = tenants[tenant]
            slo = agg.get("slo_p99_ms") or 50.0
            total, bad = _bad_good(val, slo)
            if total:
                burn = (bad / total) / (1.0 - objective)
                agg["burn_rate"] = round(
                    burn if agg["burn_rate"] is None
                    else max(agg["burn_rate"], burn), 3)
                stats = val if isinstance(val, dict) else {}
                for src, dst in (("p50", "lifetime_p50_ms"),
                                 ("p99", "lifetime_p99_ms")):
                    if stats.get(src) is not None:
                        agg[dst] = (
                            round(stats[src], 3)
                            if agg.get(dst) is None
                            else round(max(agg[dst], stats[src]), 3))
        return {"default_tenant": DEFAULT_TENANT,
                "objective": objective,
                "tenants": tenants, "engines": engines}

    # ---- deployment control plane (POST /deploy/{model}) -----------------
    def attach_deployment(self, controller) -> "UIServer":
        """Expose a :class:`~deeplearning4j_tpu_torch.deploy.
        RolloutController`
        behind ``POST /deploy/{model}`` (push / promote / rollback /
        step) and ``GET /deploy`` (per-model rollout status)."""
        self._deployments[controller.model] = controller
        return self

    def detach_deployment(self, name: str) -> "UIServer":
        self._deployments.pop(name, None)
        return self

    def get_deployment(self, name: str):
        return self._deployments.get(name)

    def deployments(self):
        return list(self._deployments)

    def deploy_data(self) -> dict:
        """``GET /deploy`` body: every attached controller's status."""
        return {name: ctl.status()
                for name, ctl in self._deployments.items()}

    def models_data(self) -> dict:
        """``GET /models`` body: the registry hosting view plus any
        standalone attached engines."""
        data = (self._registry.stats() if self._registry is not None
                else {"hbm_budget_bytes": None, "resident_bytes": 0,
                      "models": {}})
        if self._engines:
            data["engines"] = {name: eng.stats()
                               for name, eng in self._engines.items()}
        return data

    # ---- health endpoints ------------------------------------------------
    def healthz_data(self) -> dict:
        """``GET /healthz`` body: still a liveness probe (200 whenever
        the server answers), enriched with the runtime identity scrapers
        want on the same poll — backend (``"cuda"`` or ``"cpu"``, where
        the JAX package names its jax platform), device count (torch's
        CUDA devices, or 1 for the CPU), last train-dispatch timestamp,
        and the divergence state."""
        import torch

        from .. import monitor as _mon
        if torch.cuda.is_available():
            backend, device_count = "cuda", torch.cuda.device_count()
        else:
            backend, device_count = "cpu", 1
        checkpoint = None
        try:
            from ..resilience import checkpoint as _ckpt
            checkpoint = _ckpt.status()
        except Exception:
            pass
        return {
            "status": "ok",
            "backend": backend,
            "device_count": device_count,
            "last_dispatch_timestamp":
                _mon.health.last_dispatch_timestamp(),
            "health": _mon.health.state(),
            "checkpoint": checkpoint,
        }

    def health_data(self) -> dict:
        """``GET /health`` body: the full training-health snapshot —
        guard config, ok/diverged state, and the last dispatch's
        per-layer grad/param/update statistics."""
        from .. import monitor as _mon
        return _mon.health.snapshot()

    def alerts_data(self) -> dict:
        """``GET /alerts`` body: the alert engine's status (a stub with
        ``running: false`` when no engine has been created — reading
        the endpoint must not conjure a watcher)."""
        from .. import monitor as _mon
        return _mon.alert_status()

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "UIServer":
        self._httpd = _HTTPServer(("127.0.0.1", self.port), _Handler)
        self._httpd.ui = self                       # type: ignore
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/train/overview"

    # ---- t-SNE module (reference ui-parent tsne module) ------------------
    def set_tsne_data(self, coords, labels=None) -> "UIServer":
        """Publish 2-D embedding coordinates (e.g. ``plot.tsne.Tsne``'s
        ``get_coordinates()``) for the ``/tsne`` page."""
        import numpy as _np
        coords = _np.asarray(coords, float)
        if coords.size == 0:
            coords = coords.reshape(0, 2)       # [] clears the plot
        if coords.ndim != 2 or coords.shape[1] < 2:
            raise ValueError(f"coords must be (n, 2+), got {coords.shape}")
        self._tsne = {
            "coords": coords[:, :2].tolist(),
            "labels": None if labels is None else [str(l) for l in labels],
        }
        return self

    def tsne_data(self) -> dict:
        return self._tsne

    # ---- data assembly (TrainModule.java role) ---------------------------
    def list_sessions(self) -> List[str]:
        return self.storage.list_session_ids()

    def _updates(self, sid: Optional[str]) -> List[Persistable]:
        if sid is None:
            return []
        out: List[Persistable] = []
        for wid in self.storage.list_worker_ids(sid, TYPE_ID):
            out.extend(self.storage.get_all_updates(sid, TYPE_ID, wid))
        out.sort(key=lambda r: r.timestamp)
        return out

    def overview_data(self, sid: Optional[str]) -> dict:
        updates = self._updates(sid)
        data = {
            "score_vs_iter": [[u.data["iteration"], u.data["score"]]
                              for u in updates],
        }
        if updates:
            last = updates[-1].data
            for k in ("samples_per_sec", "batches_per_sec", "memory_rss_mb",
                      "learning_rates", "iteration", "epoch"):
                if k in last:
                    data[k] = last[k]
        if sid is not None:
            for wid in self.storage.list_worker_ids(sid, TYPE_ID):
                static = self.storage.get_static_info(sid, TYPE_ID, wid)
                if static:
                    data["static"] = {
                        k: static.data.get(k)
                        for k in ("backend", "device_kind", "model_class",
                                  "num_params", "hostname")}
                    break
        return data

    def flow_data(self, sid: Optional[str]) -> dict:
        """Network-topology graph for the flow page (reference
        ``module/flow/FlowListenerModule.java`` — renders the model
        structure).  Nodes/edges come from the ``model_config_json``
        the StatsListener posts in its static-info record."""
        conf = None
        if sid is not None:
            for wid in self.storage.list_worker_ids(sid, TYPE_ID):
                static = self.storage.get_static_info(sid, TYPE_ID, wid)
                if static and static.data.get("model_config_json"):
                    try:
                        conf = json.loads(static.data["model_config_json"])
                    except (TypeError, ValueError):
                        conf = None
                    break
        if not isinstance(conf, dict):
            return {"nodes": [], "edges": []}

        def layer_detail(layer: dict) -> str:
            if not isinstance(layer, dict):
                return ""
            n_in, n_out = layer.get("n_in"), layer.get("n_out")
            kind = layer.get("type", "?")
            return f"{kind} {n_in or '?'}->{n_out or '?'}"

        nodes, edges = [], []
        # the config arrives via the unauthenticated /remote path, so a
        # malformed document must yield an empty graph, not a crashed
        # handler thread
        try:
            if conf.get("type") == "computation_graph_conf":
                net_inputs = [n for n in conf.get("network_inputs") or []
                              if isinstance(n, str)]
                for name in net_inputs:
                    nodes.append({"name": name, "kind": "input",
                                  "depth": 0, "detail": "input"})
                raw = conf.get("vertices")
                vertices = {k: v for k, v in raw.items()
                            if isinstance(v, dict)} \
                    if isinstance(raw, dict) else {}
                depth_of = {n: 0 for n in net_inputs}

                def depth(name, seen=()):
                    if name in depth_of:
                        return depth_of[name]
                    if name in seen or name not in vertices:
                        return 0
                    ins = vertices[name].get("inputs") or []
                    d = 1 + max((depth(i, seen + (name,)) for i in ins),
                                default=0)
                    depth_of[name] = d
                    return d

                for name, v in vertices.items():
                    layer = v.get("layer")
                    detail = (layer_detail(layer) if layer
                              else str(v.get("type", "vertex")))
                    nodes.append({"name": name, "kind": "vertex",
                                  "depth": depth(name), "detail": detail})
                    for src in v.get("inputs") or []:
                        edges.append([src, name])
            else:
                layers = [l for l in conf.get("layers") or []]
                nodes.append({"name": "input", "kind": "input", "depth": 0,
                              "detail": "input"})
                prev = "input"
                for i, layer in enumerate(layers):
                    name = f"{i}_{layer.get('type', 'layer')}" \
                        if isinstance(layer, dict) else str(i)
                    nodes.append({"name": name, "kind": "layer",
                                  "depth": i + 1,
                                  "detail": layer_detail(layer)})
                    edges.append([prev, name])
                    prev = name
        except Exception:
            return {"nodes": [], "edges": []}
        return {"nodes": nodes, "edges": edges}

    def system_data(self, sid: Optional[str]) -> dict:
        """System tab (reference ``TrainModule`` system tab: per-worker
        memory-utilization chart + hardware info table)."""
        workers: dict = {}
        if sid is not None:
            for wid in self.storage.list_worker_ids(sid, TYPE_ID):
                ups = self.storage.get_all_updates(sid, TYPE_ID, wid)
                ups.sort(key=lambda r: r.timestamp)
                info = {}
                static = self.storage.get_static_info(sid, TYPE_ID, wid)
                if static:
                    info = {k: static.data.get(k)
                            for k in ("hostname", "os", "python",
                                      "torch_version", "backend",
                                      "device_count", "device_kind")}
                workers[wid] = {
                    "hardware": info,
                    "memory_vs_iter": [
                        [u.data["iteration"], u.data["memory_rss_mb"]]
                        for u in ups
                        if "memory_rss_mb" in u.data and "iteration" in u.data],
                }
        return {"workers": workers}

    def model_data(self, sid: Optional[str]) -> dict:
        updates = self._updates(sid)
        ratio_series: dict = {}
        params: dict = {}
        for u in updates:
            it = u.data["iteration"]
            for name, r in u.data.get("update_param_ratios", {}).items():
                ratio_series.setdefault(name, []).append([it, r])
        if updates:
            last = updates[-1].data
            for name, mag in last.get("param_mean_magnitudes", {}).items():
                params[name] = {
                    "mean_mag": mag,
                    "update_mag": last.get("update_mean_magnitudes",
                                           {}).get(name),
                    "ratio": last.get("update_param_ratios", {}).get(name),
                    "histogram": last.get("param_histograms", {}).get(name),
                }
        return {"ratio_series": ratio_series, "params": params}


class RemoteStatsStorageRouter(StatsStorageRouter):
    """POST stats to a remote UIServer (reference core
    ``api/storage/impl/RemoteUIStatsStorageRouter.java`` — the path Spark
    executors use to feed a central dashboard).

    Like the reference, posting is asynchronous with bounded retries: a
    dashboard outage must never crash the training loop.  Records are
    queued and shipped by a daemon thread; after ``max_retries`` failed
    attempts a record is dropped with a warning (reference
    ``RemoteUIStatsStorageRouter`` retry/shutdown semantics)."""

    def __init__(self, url: str, timeout: float = 5.0,
                 max_retries: int = 3, retry_backoff: float = 0.5,
                 queue_size: int = 1000):
        import logging
        import queue
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self._log = logging.getLogger("deeplearning4j_tpu_torch")
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    def _drain(self) -> None:
        import time as _time
        while True:
            kind, record = self._queue.get()
            for attempt in range(self.max_retries):
                try:
                    self._post(kind, record)
                    break
                except Exception as e:
                    if attempt == self.max_retries - 1:
                        self._log.warning(
                            "RemoteStatsStorageRouter: dropping %s record "
                            "after %d attempts (%r)", kind,
                            self.max_retries, e)
                    else:
                        _time.sleep(self.retry_backoff * (2 ** attempt))
            self._queue.task_done()

    def _enqueue(self, kind: str, record: Persistable) -> None:
        try:
            self._queue.put_nowait((kind, record))
        except Exception:
            self._log.warning(
                "RemoteStatsStorageRouter: queue full, dropping %s record",
                kind)

    def flush(self, timeout: float = 10.0) -> None:
        """Block until queued records are shipped (tests / orderly exit)."""
        import time as _time
        deadline = _time.time() + timeout
        while not self._queue.empty() and _time.time() < deadline:
            _time.sleep(0.01)
        self._queue.join()

    def _post(self, kind: str, record: Persistable) -> None:
        body = json.dumps({
            "kind": kind,
            "record": {
                "session_id": record.session_id,
                "type_id": record.type_id,
                "worker_id": record.worker_id,
                "timestamp": record.timestamp,
                "data": record.data,
            },
        }).encode()
        req = urllib.request.Request(
            self.url + "/remote", data=body,
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=self.timeout).read()

    def put_static_info(self, record: Persistable) -> None:
        self._enqueue("static", record)

    def put_update(self, record: Persistable) -> None:
        self._enqueue("update", record)
