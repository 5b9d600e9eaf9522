"""Horizontal serving fleet: a consistent-hash router over K worker
processes (port of ``deeplearning4j_tpu/serving/fleet.py``).

One engine process with LRU weight paging (``registry.py``) is a
single box; this module is the N-box story — the reference stack's
cluster-serving layer rebuilt on our own wire:

- **Router** (:class:`FleetRouter`): the front door.  Consistent-hashes
  session ids onto worker processes (*affinity, not broadcast* — the
  one-dispatch RNN/session contract holds because one session's device
  carries live on exactly one worker), health-checks workers via
  ``GET /healthz``, routes around dead ones immediately (the hash
  ring's successor walk IS the failover path, so a SIGKILLed worker
  costs retries, never 5xx), and respawns them in the background.
- **Workers** (:func:`fleet_worker_main`): one ``InferenceEngine`` +
  ``ModelRegistry`` + ``UIServer`` per process, spawned as a fresh
  interpreter running ``python -m deeplearning4j_tpu_torch.parallel.main
  --fleet-worker --device cuda`` (never a fork of a process that holds
  a CUDA context).  Each worker holds its own CUDA context on the card;
  without MPS the card time-slices between them, so K workers buy K
  GILs on a host-bound serving path, not overlapping kernels.  Every
  worker warms itself from the versioned weight store — the store is
  the fleet's single source of truth for weights — and attaches the
  build cache (:mod:`.compile_cache`) FIRST, so a respawn loads what an
  earlier worker built instead of building it again.
- **Elasticity**: the router publishes ``fleet_router_p99_ms`` and
  ``fleet_queue_depth`` each health tick and evaluates the
  ``fleet_scale_*`` AlertEngine rules (:func:`monitor.alerts.
  fleet_rules`) against them; a firing scale-out rule adds a worker,
  a firing scale-in rule drains and stops one (never below
  ``min_workers``).
- **Tenant watch**: the router runs an observe-only (``enforce=False``)
  :class:`~.admission.SloAdmissionController` — per-request it accounts
  the tenant's router-observed latency and the worker's admit/shed
  verdict, each health tick it publishes the per-tenant scoreboard
  gauges (``serving_tenant_p99_ms{engine="fleet-router"}`` etc.) and
  evaluates its private rules, so the cross-tenant ``tenant_unfairness``
  alert fires at the fleet front door without double-shedding in front
  of the workers' own enforcing controllers.
- **Route fractions**: sessionless traffic is split by per-worker
  weights (deficit round-robin — deterministic, exact), which is the
  canary generalized to processes: ``set_route_fraction("w2", 0.05)``
  sends 5% of stateless traffic to a worker serving a candidate
  version.  Session traffic stays hash-pinned (a canary must not break
  affinity).

Membership semantics: the ring holds one node per worker *rank*
(``w0``, ``w1``, ...), and a respawned worker keeps its rank, so a
session remaps to the successor while its worker is down and returns
home afterwards — membership churn moves ~1/K of keys, never all of
them.  Device-side RNN carries do not migrate: a remapped session
resumes (fresh carry) on the survivor; availability and affinity are
the contract, not state migration.

Locking discipline (lint rule R3): the router snapshots membership
under ``serving.fleet.router`` and performs ALL blocking work —
forwarding, health probes, spawning, draining — outside it.

Differences from the JAX package: workers take ``--device`` (default
``cuda``; with no card a worker fails to start, there is no CPU
fallback) and name it in their ready line (``WorkerHandle.ready``;
``GET /fleet`` keeps the JAX package's body keys); the spawn
environment pins no JAX platform; beside ``sanitize_end_warmup()`` (the
port's dispatch sanitizer, armed by ``DL4J_TPU_SANITIZE=1``) a worker
reports ``serving_bucket_compiles_total`` at the end of its warmup, which
must not move afterwards; a worker calls ``InferenceEngine.end_warmup``
after its warm session step and first reply; it prints an exit line with
its hand-kernel launches (``WorkerHandle.exit_report``,
``FleetRouter.exit_reports``).
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import monitor as _monitor
from ..device import DeviceLike
from ..monitor.locks import make_lock
from . import compile_cache
from .admission import SloAdmissionController, publish_tenant_telemetry

ENV_SPAWN_TIMEOUT = "DL4J_TPU_FLEET_SPAWN_TIMEOUT_S"
#: default fleet width when ``FleetRouter`` is built without ``k``
ENV_WORKERS = "DL4J_TPU_FLEET_WORKERS"

_READY_KEY = "fleet_worker_ready"
#: key of the line a worker prints as it exits cleanly: the hand-kernel
#: launches it made (``ops.attention.LAUNCHES``)
_EXIT_KEY = "fleet_worker_exit"


class FleetError(RuntimeError):
    """Fleet control-plane failure (spawn timeout, no live workers at
    startup)."""


# --------------------------------------------------------------- hash ring
class HashRing:
    """Consistent-hash ring with virtual nodes.

    ``lookup`` walks the ring clockwise from the key's position and
    returns the first node that survives the ``skip`` predicate — the
    successor walk doubles as deterministic failover ordering, so "the
    worker is down" and "the worker was scaled away" remap a key the
    same way."""

    def __init__(self, vnodes: int = 64):
        self._vnodes = max(1, int(vnodes))
        self._keys: List[int] = []        # sorted vnode positions
        self._ring: Dict[int, str] = {}   # position -> node
        self._nodes: set = set()

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.sha256(key.encode()).digest()[:8], "big")

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for r in range(self._vnodes):
            pos = self._hash(f"{node}#{r}")
            if pos in self._ring:         # astronomically unlikely
                continue
            bisect.insort(self._keys, pos)
            self._ring[pos] = node

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._keys = [p for p in self._keys if self._ring[p] != node]
        self._ring = {p: n for p, n in self._ring.items() if n != node}

    def nodes(self) -> frozenset:
        return frozenset(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def preference(self, key: str) -> List[str]:
        """Every node, in this key's failover order (owner first)."""
        if not self._keys:
            return []
        out: List[str] = []
        start = bisect.bisect(self._keys, self._hash(key))
        n = len(self._keys)
        for i in range(n):
            node = self._ring[self._keys[(start + i) % n]]
            if node not in out:
                out.append(node)
                if len(out) == len(self._nodes):
                    break
        return out

    def lookup(self, key: str, skip=()) -> Optional[str]:
        for node in self.preference(key):
            if node not in skip:
                return node
        return None


# ------------------------------------------------------------ worker model
#: worker model specs, by name.  ``lstm`` is the fleet default: a
#: 2-layer recurrent stack whose 12-executable bucket ladder makes the
#: executable cache's cold/warm gap measurable; ``mlp`` is the fast
#: spec for tests.
FLEET_SPECS: Dict[str, Dict[str, Any]] = {
    "lstm": dict(kind="lstm", n_in=32, n_out=16, hidden=256, layers=2,
                 max_batch=8, timestep_buckets=(8, 16, 32)),
    "lstm-small": dict(kind="lstm", n_in=16, n_out=8, hidden=32,
                       layers=1, max_batch=4, timestep_buckets=(4, 8)),
    "mlp": dict(kind="mlp", n_in=64, n_out=10, hidden=64, layers=2,
                max_batch=16, timestep_buckets=None),
}


def build_fleet_conf(spec: str = "lstm", seed: int = 11):
    """(NeuralNetConfiguration, engine kwargs, warmup shape) for a
    named fleet spec — one deterministic recipe shared by every worker
    and by the bench's baseline, so all processes agree on the model
    signature (and therefore on the executable-cache namespace)."""
    from ..nn.conf import inputs as _inputs
    from ..nn.conf.neural_net_configuration import NeuralNetConfiguration
    from ..nn.layers.core import DenseLayer, OutputLayer
    from ..nn.layers.recurrent import GravesLSTM, RnnOutputLayer

    s = FLEET_SPECS[spec]
    b = NeuralNetConfiguration.builder().seed(seed).list()
    if s["kind"] == "lstm":
        for _ in range(s["layers"]):
            b = b.layer(GravesLSTM(n_out=s["hidden"]))
        b = b.layer(RnnOutputLayer(n_out=s["n_out"],
                                   activation="softmax", loss="mcxent"))
        conf = b.set_input_type(_inputs.recurrent(
            s["n_in"], max(s["timestep_buckets"]))).build()
        # one example is (T, n_in): axis 0 is time, replaced per
        # ladder entry by InferenceEngine.warmup
        warmup_shape = (max(s["timestep_buckets"]), s["n_in"])
    else:
        for _ in range(s["layers"]):
            b = b.layer(DenseLayer(n_out=s["hidden"]))
        b = b.layer(OutputLayer(n_out=s["n_out"]))
        conf = b.set_input_type(_inputs.feed_forward(s["n_in"])).build()
        warmup_shape = (s["n_in"],)
    engine_kwargs = dict(max_batch_size=s["max_batch"],
                         timestep_buckets=s["timestep_buckets"])
    return conf, engine_kwargs, warmup_shape


# ---------------------------------------------------------- worker process
#: the directory that holds the package, put first on a worker's path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn_worker(rank: int, *, model: str = "lstm",
                 store_dir: Optional[str] = None,
                 cache_root: Optional[str] = None,
                 slo_p99_ms: Optional[float] = None,
                 seed: int = 11, port: int = 0,
                 device: DeviceLike = "cuda") -> subprocess.Popen:
    """Start one fleet worker: a fresh interpreter (``Popen``, the module
    entrypoint; the package's directory first on its path) serving on
    ``device``.  The worker prints ONE ready line (JSON,
    ``fleet_worker_ready: true``) on stdout and then serves until its
    stdin closes — the router holds the write end, so a dead router
    reaps its whole fleet."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.main",
           "--fleet-worker", "--rank", str(rank), "--port", str(port),
           "--model", model, "--seed", str(seed),
           "--device", str(device),
           "--spawn-ts", repr(time.time())]
    if store_dir:
        cmd += ["--store-dir", store_dir]
    if cache_root:
        cmd += ["--cache-root", cache_root]
    if slo_p99_ms:
        cmd += ["--slo-p99-ms", str(slo_p99_ms)]
    return subprocess.Popen(cmd, env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def wait_ready(proc: subprocess.Popen,
               timeout: Optional[float] = None) -> dict:
    """Block until ``proc`` prints its ready line; returns the parsed
    dict.  Raises :class:`FleetError` on exit/timeout (with the
    worker's stderr tail — the only way spawn failures are
    debuggable)."""
    if timeout is None:
        try:
            timeout = float(os.environ.get(ENV_SPAWN_TIMEOUT, "180"))
        except ValueError:
            timeout = 180.0
    import select
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            break
        rlist, _, _ = select.select([proc.stdout], [], [],
                                    min(0.5, timeout))
        if not rlist:
            continue
        line = proc.stdout.readline()
        if not line:
            break
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if doc.get(_READY_KEY):
            return doc
    tail = ""
    try:
        proc.kill()
        _, err = proc.communicate(timeout=5)
        tail = "\n".join((err or "").splitlines()[-15:])
    except Exception:
        pass
    raise FleetError(
        f"fleet worker pid={proc.pid} did not become ready within "
        f"{timeout:.0f}s (rc={proc.returncode}); stderr tail:\n{tail}")


class WorkerHandle:
    """Router-side view of one worker process."""

    def __init__(self, rank: int, proc: subprocess.Popen, ready: dict):
        self.rank = int(rank)
        self.name = f"w{rank}"
        self.proc = proc
        self.ready = dict(ready)
        self.port = int(ready["port"])
        self.url = f"http://127.0.0.1:{self.port}"
        self.healthy = True
        self.route_fraction = 1.0
        self.served = 0          # sessionless requests (DRR accounting)
        self.fail_streak = 0
        self.generation = 0
        self.started_at = time.monotonic()
        self.log_tail: deque = deque(maxlen=40)
        self.exit_report: Optional[dict] = None   # the worker's exit line
        self._drain_threads: List[threading.Thread] = []

    def start_drains(self) -> None:
        """Drain the worker's pipes into a bounded tail so they can
        never fill and stall the child."""
        for stream in (self.proc.stdout, self.proc.stderr):
            if stream is None:
                continue
            t = threading.Thread(target=self._drain, args=(stream,),
                                 daemon=True)
            t.start()
            self._drain_threads.append(t)

    def _drain(self, stream) -> None:
        try:
            for line in stream:
                line = line.rstrip()
                self.log_tail.append(line)
                if line.startswith("{") and _EXIT_KEY in line:
                    try:
                        self.exit_report = json.loads(line)
                    except ValueError:
                        pass
        except Exception:
            pass

    def alive(self) -> bool:
        return self.proc.poll() is None

    def terminate(self, grace_s: float = 5.0) -> Optional[dict]:
        """Close the worker's stdin, SIGTERM it, kill it after
        ``grace_s``; returns its exit line (``None`` when it printed
        none: killed, or never drained)."""
        try:
            if self.proc.stdin:
                self.proc.stdin.close()
        except Exception:
            pass
        try:
            self.proc.terminate()
            self.proc.wait(timeout=grace_s)
        except Exception:
            try:
                self.proc.kill()
                self.proc.wait(timeout=grace_s)
            except Exception:
                pass
        for t in self._drain_threads:
            t.join(timeout=2.0)
        return self.exit_report

    def view(self) -> dict:
        return {
            "name": self.name, "rank": self.rank, "pid": self.proc.pid,
            "port": self.port, "healthy": self.healthy,
            "generation": self.generation,
            "route_fraction": self.route_fraction,
            "served_sessionless": self.served,
            "uptime_s": round(time.monotonic() - self.started_at, 1),
            "warmup_s": self.ready.get("warmup_s"),
            "cache_dir": self.ready.get("cache_dir"),
        }


# ----------------------------------------------------------------- router
class FleetRouter:
    """The fleet front door: spawn K workers, hash sessions onto them,
    keep them alive, scale them.  Plug into HTTP with
    ``UIServer().attach_fleet(router)`` (``POST /predict`` forwards,
    ``GET /fleet`` reports) or :meth:`serve`."""

    def __init__(self, k: Optional[int] = None, *, model: str = "lstm",
                 store_dir: Optional[str] = None,
                 cache_root: Optional[str] = None,
                 slo_p99_ms: Optional[float] = None,
                 min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 elastic: bool = False,
                 queue_high: float = 32.0,
                 health_interval_s: float = 1.0,
                 scale_cooldown_s: float = 5.0,
                 request_timeout_s: float = 30.0,
                 spawn_timeout_s: Optional[float] = None,
                 seed: int = 11, vnodes: int = 64,
                 tenants: Optional[Dict[str, dict]] = None,
                 device: DeviceLike = "cuda"):
        if k is None:
            k = int(os.environ.get(ENV_WORKERS, "2"))
        if k < 1:
            raise ValueError("fleet needs at least one worker")
        self.model = str(model)
        self._k0 = int(k)
        self.store_dir = store_dir
        self.cache_root = cache_root
        self.slo_p99_ms = slo_p99_ms
        self.min_workers = max(1, int(min_workers))
        self.max_workers = int(max_workers) if max_workers else max(
            int(k) + 2, int(k))
        self.elastic = bool(elastic)
        self.queue_high = float(queue_high)
        self.health_interval_s = max(0.05, float(health_interval_s))
        self.scale_cooldown_s = float(scale_cooldown_s)
        self.request_timeout_s = float(request_timeout_s)
        self.spawn_timeout_s = spawn_timeout_s
        self.seed = int(seed)
        self.device = str(device)
        self._lock = make_lock("serving.fleet.router")
        self._ring = HashRing(vnodes=vnodes)
        self._workers: Dict[str, WorkerHandle] = {}
        self._running = False
        self._health_thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._last_scale = 0.0
        self._scale_events: List[dict] = []
        self._latency_window: deque = deque(maxlen=512)
        # the router's own alert engine, never the process-global one:
        # scale triggers must not leak into the deploy gate of a
        # co-resident trainer
        from ..monitor.alerts import AlertEngine, fleet_rules
        self._alerts = AlertEngine(
            rules=fleet_rules(slo_p99_ms=slo_p99_ms or 100.0,
                              queue_high=self.queue_high),
            interval_s=self.health_interval_s)
        # observe-only tenant watcher: the router never sheds (its
        # workers' enforcing controllers do); it accounts per-tenant
        # latency and worker admit/shed outcomes so the fleet-level
        # cross-tenant unfairness alert has evidence to fire on
        self._admission = SloAdmissionController(
            slo_p99_ms or 100.0, fair=True, enforce=False,
            tenants=tenants)
        #: the exit lines of the workers this router has stopped (a
        #: worker that died or was killed leaves none)
        self.exit_reports: List[dict] = []

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetRouter":
        if self._running:
            return self
        procs = [self._spawn(rank) for rank in range(self._k0)]
        handles = []
        failures = []
        for rank, proc in enumerate(procs):
            try:
                ready = wait_ready(proc, self.spawn_timeout_s)
                handles.append(WorkerHandle(rank, proc, ready))
            except FleetError as e:
                failures.append(str(e))
        if not handles:
            raise FleetError("no fleet worker became ready:\n" +
                             "\n".join(failures))
        with self._lock:
            for h in handles:
                h.start_drains()
                self._workers[h.name] = h
                self._ring.add(h.name)
            self._running = True
        self._publish_gauges()
        self._stop_evt.clear()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="fleet-health", daemon=True)
        self._health_thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=10.0)
            self._health_thread = None
        with self._lock:
            handles = list(self._workers.values())
            self._workers.clear()
            for h in handles:
                self._ring.remove(h.name)
            self._running = False
        for h in handles:
            self._retire(h)

    def _retire(self, h: WorkerHandle, grace_s: float = 5.0) -> None:
        report = h.terminate(grace_s=grace_s)
        if report is not None:
            self.exit_reports.append(report)

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def serve(self, port: int = 0):
        """Convenience: a started ``UIServer`` with this router
        attached (the caller owns both lifecycles)."""
        from ..ui.server import UIServer
        ui = UIServer(port=port)
        ui.attach_fleet(self)
        return ui.start()

    # ------------------------------------------------------------- spawning
    def _spawn(self, rank: int) -> subprocess.Popen:
        return spawn_worker(rank, model=self.model,
                            store_dir=self.store_dir,
                            cache_root=self.cache_root,
                            slo_p99_ms=self.slo_p99_ms,
                            seed=self.seed, device=self.device)

    def _respawn(self, name: str) -> bool:
        """Replace a dead worker in place (same rank — its ring slots,
        and therefore its sessions, come back to it).  Runs on the
        health thread; routing continues on survivors meanwhile."""
        with self._lock:
            old = self._workers.get(name)
        if old is None:
            return False
        self._retire(old, grace_s=1.0)
        _monitor.counter(
            "fleet_respawns_total",
            "dead fleet workers replaced by the router").inc(
            worker=name)
        _monitor.record_incident("fleet_worker_respawn", {
            "worker": name, "rank": old.rank,
            "generation": old.generation + 1})
        try:
            proc = self._spawn(old.rank)
            ready = wait_ready(proc, self.spawn_timeout_s)
        except FleetError:
            with self._lock:
                if self._workers.get(name) is old:
                    old.healthy = False
            return False
        fresh = WorkerHandle(old.rank, proc, ready)
        fresh.generation = old.generation + 1
        fresh.route_fraction = old.route_fraction
        fresh.start_drains()
        with self._lock:
            self._workers[name] = fresh
            self._ring.add(name)       # no-op if still a member
        return True

    # -------------------------------------------------------------- routing
    def pick(self, session: Optional[str] = None,
             tried: Sequence[str] = ()) -> Optional[WorkerHandle]:
        """The worker that should serve this request: the hash ring's
        first healthy candidate for ``session``; deficit-weighted
        round-robin over route fractions for sessionless traffic."""
        tried = set(tried)
        with self._lock:
            if session is not None:
                for name in self._ring.preference(str(session)):
                    h = self._workers.get(name)
                    if h is not None and h.healthy \
                            and name not in tried:
                        return h
                return None
            ranked = [h for name, h in sorted(self._workers.items())
                      if h.healthy and name not in tried
                      and name in self._ring.nodes()]
            weighted = [h for h in ranked if h.route_fraction > 0.0]
            pool = weighted or ranked
            if not pool:
                return None
            best = min(pool, key=lambda h:
                       (h.served / max(h.route_fraction, 1e-9), h.rank))
            best.served += 1
            return best

    def handle_predict(self, payload: dict
                       ) -> Tuple[int, dict, Dict[str, str]]:
        """Route one ``POST /predict`` body through the fleet:
        ``(status, body, extra headers)``.  Worker HTTP statuses pass
        through untouched (a worker's 429/503 is real backpressure);
        *transport* failures — the worker died mid-request — retry on
        the key's next ring candidate, which is how a SIGKILL costs
        zero 5xx."""
        session = payload.get("session")
        key = str(session) if session is not None else None
        tenant = self._admission.normalize(payload.get("tenant"))
        t0 = time.perf_counter()
        tried: List[str] = []
        with self._lock:
            attempts = max(1, len(self._workers))
        for _ in range(attempts):
            worker = self.pick(key, tried)
            if worker is None:
                break
            code, body, headers = self._forward(worker, payload)
            if code is None:             # transport failure: fail over
                tried.append(worker.name)
                self._note_down(worker)
                _monitor.counter(
                    "fleet_retries_total",
                    "requests retried on a ring successor after a "
                    "worker transport failure").inc(worker=worker.name)
                continue
            latency_ms = (time.perf_counter() - t0) * 1e3
            self._latency_window.append(latency_ms)
            # account the worker's verdict at the fleet grain: a 503
            # with shed=True is the worker's controller shedding this
            # tenant; a 200 feeds the tenant's router-observed latency
            # window (429s and other statuses are neither evidence)
            shed = (code == 503 and isinstance(body, dict)
                    and bool(body.get("shed")))
            if shed or code == 200:
                self._admission.account(tenant, shed)
            if code == 200:
                self._admission.observe(latency_ms, tenant=tenant)
            _monitor.counter(
                "fleet_requests_total",
                "requests routed through the fleet front door, by "
                "worker and class").inc(
                worker=worker.name,
                kind="session" if key is not None else "stateless")
            _monitor.histogram(
                "fleet_request_latency_ms",
                "router-observed request latency through the fleet"
            ).observe(latency_ms)
            return code, body, headers
        return 503, {"error": "no healthy fleet workers",
                     "tried": tried}, {"Retry-After": "1"}

    def _forward(self, worker: WorkerHandle, payload: dict
                 ) -> Tuple[Optional[int], Optional[dict],
                            Dict[str, str]]:
        """One worker hop.  ``(None, None, {})`` = transport failure
        (connect/read error — the worker is gone or going); an HTTP
        error status is a *response* and passes through."""
        data = json.dumps(payload).encode()
        req = urllib.request.Request(
            worker.url + "/predict", data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.request_timeout_s) as resp:
                return resp.status, json.loads(resp.read().decode()), {}
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read().decode())
            except Exception:
                body = {"error": f"worker {worker.name} answered "
                                 f"{e.code}"}
            headers = {}
            retry = e.headers.get("Retry-After")
            if retry:
                headers["Retry-After"] = retry
            return e.code, body, headers
        except Exception:
            return None, None, {}

    def _note_down(self, worker: WorkerHandle) -> None:
        with self._lock:
            current = self._workers.get(worker.name)
            if current is worker:
                worker.healthy = False
        self._publish_gauges()

    # ---------------------------------------------------- canary fractions
    def set_route_fraction(self, worker: str, fraction: float) -> None:
        """Weight ``worker``'s share of *sessionless* traffic (the
        per-process canary knob; sessions stay hash-pinned).  Weights
        are relative: ``{w0: 1.0, w1: 0.05}`` sends ~5/105 of
        stateless traffic to ``w1``."""
        fraction = max(0.0, float(fraction))
        with self._lock:
            h = self._workers.get(str(worker))
            if h is None:
                raise KeyError(f"unknown fleet worker {worker!r}; "
                               f"have {sorted(self._workers)}")
            h.route_fraction = fraction
            for other in self._workers.values():
                other.served = 0      # restart DRR accounting cleanly
        _monitor.gauge(
            "fleet_route_fraction",
            "per-worker sessionless route weight").set(
            fraction, worker=str(worker))

    # ------------------------------------------------------------- health
    def _health_loop(self) -> None:
        while not self._stop_evt.wait(self.health_interval_s):
            try:
                self._health_tick()
            except Exception:
                pass

    def _health_tick(self) -> None:
        with self._lock:
            handles = list(self._workers.values())
        dead: List[str] = []
        queue_depth = 0.0
        for h in handles:
            if not h.alive():
                dead.append(h.name)
                continue
            ok, depth = self._probe(h)
            if ok:
                h.healthy = True
                h.fail_streak = 0
                queue_depth += depth
            else:
                h.fail_streak += 1
                if h.fail_streak >= 3:
                    dead.append(h.name)
                elif h.fail_streak >= 2:
                    h.healthy = False
        for name in dead:
            self._respawn(name)
        self._publish_gauges(queue_depth=queue_depth)
        try:
            publish_tenant_telemetry(self._admission, "fleet-router")
        except Exception:
            pass
        # evaluated every tick — not just when elastic — so the
        # cross-tenant unfairness rule watches any fleet; the scale
        # rules only *act* when elasticity is on
        self._alerts.evaluate_once()
        if self.elastic:
            self._elastic_tick()

    def _probe(self, h: WorkerHandle) -> Tuple[bool, float]:
        """One ``/healthz`` liveness + queue-depth probe."""
        try:
            with urllib.request.urlopen(
                    h.url + "/healthz",
                    timeout=min(2.0, self.request_timeout_s)) as resp:
                if resp.status != 200:
                    return False, 0.0
                json.loads(resp.read().decode())
        except Exception:
            return False, 0.0
        depth = 0.0
        try:
            with urllib.request.urlopen(
                    h.url + "/models",
                    timeout=min(2.0, self.request_timeout_s)) as resp:
                doc = json.loads(resp.read().decode())
            for eng in (doc.get("engines") or {}).values():
                depth += float(eng.get("queue_depth", 0))
        except Exception:
            pass
        return True, depth

    def window_p99_ms(self) -> Optional[float]:
        window = list(self._latency_window)
        if len(window) < 5:
            return None
        window.sort()
        return window[min(len(window) - 1, int(0.99 * len(window)))]

    def _publish_gauges(self, queue_depth: Optional[float] = None
                        ) -> None:
        with self._lock:
            handles = list(self._workers.values())
        _monitor.gauge("fleet_workers",
                       "worker processes in the fleet").set(
            float(len(handles)))
        healthy = 0
        for h in handles:
            healthy += 1 if h.healthy else 0
            _monitor.gauge(
                "fleet_worker_healthy",
                "1 = the worker answers /healthz, 0 = routed around"
            ).set(1.0 if h.healthy else 0.0, worker=h.name)
        _monitor.gauge("fleet_workers_healthy",
                       "workers currently answering /healthz").set(
            float(healthy))
        if queue_depth is not None:
            _monitor.gauge(
                "fleet_queue_depth",
                "summed serving queue depth across fleet workers").set(
                queue_depth)
        p99 = self.window_p99_ms()
        if p99 is not None:
            _monitor.gauge(
                "fleet_router_p99_ms",
                "router-observed p99 latency over the recent window"
            ).set(p99)

    # ------------------------------------------------------------- elastic
    def _elastic_tick(self) -> None:
        firing = set(self._alerts.firing())
        now = time.monotonic()
        if now - self._last_scale < self.scale_cooldown_s:
            return
        out = any(name.startswith("fleet_scale_out") for name in firing)
        down = "fleet_scale_in" in firing
        with self._lock:
            n = len(self._workers)
        if out and n < self.max_workers:
            self.scale_out()
        elif down and not out and n > self.min_workers:
            self.scale_in()

    def scale_out(self) -> Optional[str]:
        """Add one worker (blocking until it is ready and ringed)."""
        with self._lock:
            if len(self._workers) >= self.max_workers:
                return None
            rank = 1 + max((h.rank for h in self._workers.values()),
                           default=-1)
        try:
            proc = self._spawn(rank)
            ready = wait_ready(proc, self.spawn_timeout_s)
        except FleetError:
            return None
        h = WorkerHandle(rank, proc, ready)
        h.start_drains()
        with self._lock:
            self._workers[h.name] = h
            self._ring.add(h.name)
        self._record_scale("out", h.name)
        return h.name

    def scale_in(self) -> Optional[str]:
        """Drain and stop the youngest worker (never below
        ``min_workers``): pull it from the ring first so new traffic
        remaps, give in-flight work a grace period, then terminate."""
        with self._lock:
            if len(self._workers) <= self.min_workers:
                return None
            victim = max(self._workers.values(), key=lambda h: h.rank)
            self._ring.remove(victim.name)
        time.sleep(min(1.0, self.health_interval_s))   # drain window
        with self._lock:
            self._workers.pop(victim.name, None)
        self._retire(victim)
        self._record_scale("in", victim.name)
        return victim.name

    def _record_scale(self, direction: str, worker: str) -> None:
        self._last_scale = time.monotonic()
        self._scale_events.append({"direction": direction,
                                   "worker": worker,
                                   "wall_time": time.time()})
        _monitor.counter(
            "fleet_scale_events_total",
            "elastic scale decisions taken by the router").inc(
            direction=direction)
        _monitor.record_incident(f"fleet_scale_{direction}",
                                 {"worker": worker})
        self._publish_gauges()

    # -------------------------------------------------------------- status
    def status(self) -> dict:
        """The ``GET /fleet`` body."""
        with self._lock:
            handles = sorted(self._workers.values(),
                             key=lambda h: h.rank)
            ring_nodes = sorted(self._ring.nodes())
        return {
            "running": self._running,
            "model": self.model,
            "workers": [h.view() for h in handles],
            "healthy": sum(1 for h in handles if h.healthy),
            "ring": ring_nodes,
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "elastic": self.elastic,
            "scale_events": list(self._scale_events),
            "window_p99_ms": self.window_p99_ms(),
            "tenants": self._admission.tenant_snapshot(),
            "unfairness": self._admission.unfairness(),
            "store_dir": self.store_dir,
            "compile_cache": compile_cache.stats(
                self.cache_root) if self.cache_root else None,
        }


# -------------------------------------------------------- worker main
def _bucket_compiles() -> float:
    """This process's ``serving_bucket_compiles_total``, all engines."""
    snap = _monitor.snapshot().get("serving_bucket_compiles_total", {})
    return float(sum(snap.get("values", {}).values()))


def _device_name(device) -> str:
    """``"cuda:0 NVIDIA H100 80GB HBM3"`` for a card, ``"cpu"``."""
    import torch
    if device.type != "cuda":
        return str(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return f"cuda:{index} {torch.cuda.get_device_name(index)}"


def fleet_worker_main(argv: Optional[Sequence[str]] = None) -> int:
    """One fleet worker process: enable the build cache, build the spec
    model on ``--device``, warm from the versioned weight store, make the
    bucket ladder, warm one session step, serve HTTP, print the ready
    line, park until the router's stdin pipe closes.

    Invoked as ``python -m deeplearning4j_tpu_torch.parallel.main
    --fleet-worker`` (the launcher owns the ``-m`` entrypoint; this
    function owns everything after the flag)."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(prog="fleet-worker")
    ap.add_argument("--fleet-worker", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--model", default="lstm",
                    choices=sorted(FLEET_SPECS))
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--spawn-ts", type=float, default=None)
    ap.add_argument("--store-dir", default=None)
    ap.add_argument("--cache-root", default=None)
    ap.add_argument("--slo-p99-ms", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from ..device import resolve_device

    t_main = time.perf_counter()
    device = resolve_device(args.device)
    conf, engine_kwargs, warmup_shape = build_fleet_conf(
        args.model, seed=args.seed)
    from .bucketing import BucketPolicy
    policy = BucketPolicy(engine_kwargs["max_batch_size"],
                          engine_kwargs["timestep_buckets"])
    # cache FIRST: every build from here on reads and writes the
    # namespace
    sig = compile_cache.signature(conf, policy, device)
    cache_dir = compile_cache.enable(args.cache_root, sig)
    cache_before = compile_cache.stats(cache_dir)

    from ..nn.multilayer import MultiLayerNetwork
    from .engine import InferenceEngine
    from .registry import ModelRegistry

    model = MultiLayerNetwork(conf, device=device).init()
    t_model = time.perf_counter()
    engine = InferenceEngine(
        model, max_latency_ms=2.0, name=f"fleet-w{args.rank}",
        slo_p99_ms=args.slo_p99_ms, **engine_kwargs).start()

    store_version = None
    if args.store_dir:
        from ..deploy.store import VersionedWeightStore
        store = VersionedWeightStore(args.store_dir)
        store_version = engine.warm_from_store(store)

    t0 = time.perf_counter()
    n_buckets = engine.warmup(warmup_shape)
    warmup_s = time.perf_counter() - t0

    spec = FLEET_SPECS[args.model]
    session_warmup_s = None
    if spec["kind"] == "lstm":
        # the session step is not part of the bucket ladder; run it once
        # here so that the first session request meets a warm path
        t0 = time.perf_counter()
        engine.predict_session(
            "_warmup", np.zeros((1, spec["n_in"]), dtype=np.float32))
        session_warmup_s = round(time.perf_counter() - t0, 3)

    # first in-process reply: proves the dispatch path end to end
    # before the router sees this worker
    if spec["kind"] == "lstm":
        example = np.zeros(
            (1, min(spec["timestep_buckets"]), spec["n_in"]),
            dtype=np.float32)
    else:
        example = np.zeros((1, spec["n_in"]), dtype=np.float32)
    t0 = time.perf_counter()
    engine.predict(example, timeout=30.0)
    first_reply_s = time.perf_counter() - t0

    # after warmup no bucket callable may be made: serving traffic must
    # leave serving_bucket_compiles_total where it is now
    bucket_compiles = _bucket_compiles()
    # the warm session step and the first reply are not serving latencies
    engine.end_warmup()
    # after warmup, any further build is a contract violation the
    # sanitizer (when armed via DL4J_TPU_SANITIZE=1) will record
    _monitor.sanitize_end_warmup()

    registry = ModelRegistry()
    registry.register("fleet", engine, pinned=True, start=False)

    from ..ui.server import UIServer
    ui = UIServer(port=args.port)
    ui.attach_registry(registry)
    ui.attach_inference(engine)
    ui.start()

    # from the ready line on, SIGTERM ends the worker through its exit
    # line: a router may terminate it as soon as it has read the line
    stop_evt = threading.Event()

    def _term(signum, frame):
        stop_evt.set()

    signal.signal(signal.SIGTERM, _term)

    now = time.perf_counter()
    ready = {
        _READY_KEY: True,
        "rank": args.rank,
        "pid": os.getpid(),
        "port": ui.port,
        "model": args.model,
        "device": _device_name(device),
        "signature": sig,
        "cache_dir": cache_dir,
        "cache_entries_before": cache_before["entries"],
        "store_version": store_version,
        "boot_s": round(time.time() - args.spawn_ts, 3)
        if args.spawn_ts else None,
        "model_build_s": round(t_model - t_main, 3),
        "warmup_s": round(warmup_s, 3),
        "warmup_buckets": n_buckets,
        "session_warmup_s": session_warmup_s,
        "first_reply_s": round(first_reply_s, 3),
        "serve_ready_s": round(now - t_main, 3),
        "bucket_compiles_after_warmup": bucket_compiles,
    }
    print(json.dumps(ready), flush=True)

    def _watch_stdin():
        try:
            sys.stdin.buffer.read()
        except Exception:
            pass
        stop_evt.set()

    threading.Thread(target=_watch_stdin, daemon=True).start()
    stop_evt.wait()
    try:
        ui.stop()
        engine.stop(timeout=5.0)
    except Exception:
        pass
    from ..ops.attention import LAUNCHES
    try:
        print(json.dumps({_EXIT_KEY: True, "rank": args.rank,
                          "pid": os.getpid(),
                          "launches": dict(LAUNCHES)}), flush=True)
    except (BrokenPipeError, ValueError):
        pass        # the router is gone: nobody reads the report
    return 0
