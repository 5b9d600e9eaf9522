"""The pod runtime: one ``("data", "zero", "pipe")`` mesh of slots for
every parallel tier (port of ``deeplearning4j_tpu/parallel/mesh.py``).

A *slot* is one (process, device) pair: a data-parallel replica, a ZeRO
shard or a pipeline stage.  The slots of the mesh are numbered row-major
over ``(data, zero, pipe)``, as the JAX package lays its devices out, and
each process owns a contiguous block of them.

- **One process** (:meth:`MeshRuntime.local`): the slots are a list of
  devices, which may name one device more than once (no copy is made
  between a device and itself).  That is how one card runs four replicas
  (``["cuda:0"] * 4``) and how the CPU tests run theirs
  (``["cpu"] * 4``), as the JAX tests run on 8 virtual CPU devices.  The
  devices default to every visible card.
- **A pod** (``coordinator`` or the env contract): one process per rank
  over ``torch.distributed``, each owning ``cuda:<local rank>`` (or the
  CPU when asked) and ``slots / processes`` slots on it.  The backend
  follows the device: NCCL for ``cuda``, gloo for ``cpu``; there is no
  switch and no fallback.  NCCL needs one card a rank, so a pod with more
  ranks on one machine than the machine has cards raises before init.

Bootstrap (the JAX package's env/flag contract): flags take precedence
over ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``;
:func:`ensure_distributed` is idempotent and refuses a second call with a
different topology.  ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` (torchrun's
names) say which card a rank owns; without them a pod whose coordinator
is a loopback address has every rank on this machine, and a rank of a
remote coordinator's pod raises unless it names its card.

**Reductions.** Every mean over slots is :meth:`MeshRuntime.mean_over`:
the sum in slot order, then divided by the slot count, as ``lax.pmean``
does (psum / n).  The collective each case uses:

- one process: a left-to-right sum on the group's first slot's device,
  each operand moved there with ``.to``, the result copied back to every
  slot with ``.to`` — no collective;
- a group of exactly two slots on two processes (one slot each):
  ``all_reduce(SUM)``, one addition, which is commutative, so the bits
  are those of one process;
- every other group across processes: ``all_gather`` of each process's
  slot buffers, then the same left-to-right sum on every process (a ring
  all-reduce over more than two ranks adds in another order and would
  break the bits).

So a pod gives the same bits as one process holding the same slots.
Trees are flattened into one buffer per dtype before a collective.

Gauges (``monitor/metrics.py``): ``mesh_process_count``,
``mesh_axis_size{axis}``, ``mesh_updater_state_bytes{axis}`` (the
per-process resident updater state, the quantity the zero axis shrinks)
and ``mesh_collective_seconds{axis,op}``
(:meth:`MeshRuntime.measure_collectives`).
"""

from __future__ import annotations

import datetime
import errno
import ipaddress
import os
import socket
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import monitor as _monitor
from ..device import DeviceLike, resolve_device

AXES = ("data", "zero", "pipe")

#: env contract (the JAX package's names)
ENV_COORDINATOR = "COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "NUM_PROCESSES"
ENV_PROCESS_ID = "PROCESS_ID"
#: torchrun's names for a rank's place on its machine
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"
#: seconds a collective may wait for a peer before the group fails
DIST_TIMEOUT_S = 120.0

STATE_BYTES_GAUGE = "mesh_updater_state_bytes"
COLLECTIVE_HIST = "mesh_collective_seconds"
_HELP = {
    STATE_BYTES_GAUGE: "per-process addressable updater-state bytes by "
                       "sharding axis",
    COLLECTIVE_HIST: "measured cross-device collective latency by mesh "
                     "axis and op",
}

# what this process bootstrapped with, so that a second subsystem cannot
# re-initialize with a conflicting topology; and the device its process
# group runs on
_initialized: Optional[Dict[str, object]] = None
_group_device: Optional[torch.device] = None


def resolve_topology(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     env: Optional[Dict[str, str]] = None
                     ) -> Optional[Dict[str, object]]:
    """The topology from explicit flags and the env, flags first.
    ``None`` when no coordinator is configured anywhere (one process),
    else ``{"coordinator", "num_processes", "process_id"}``."""
    env = os.environ if env is None else env
    coord = coordinator or env.get(ENV_COORDINATOR) or None
    if coord is None:
        return None
    n = num_processes if num_processes is not None else \
        int(env.get(ENV_NUM_PROCESSES, "1"))
    pid = process_id if process_id is not None else \
        int(env.get(ENV_PROCESS_ID, "0"))
    if n < 1:
        raise ValueError(f"num_processes must be >= 1, got {n}")
    if not 0 <= pid < n:
        raise ValueError(f"process_id {pid} out of range [0, {n})")
    return {"coordinator": coord, "num_processes": n, "process_id": pid}


def _is_loopback(host: str) -> bool:
    if host in ("localhost", ""):
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def local_placement(topo: Dict[str, object],
                    env: Optional[Dict[str, str]] = None
                    ) -> Optional[Tuple[int, int]]:
    """``(local rank, ranks on this machine)`` of a topology:
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` when set, else every rank on this
    machine when the coordinator is a loopback address, else ``(0, 1)``
    for a single process.  ``None`` when nothing tells: several ranks
    behind a remote coordinator without ``LOCAL_RANK``."""
    env = os.environ if env is None else env
    if env.get(ENV_LOCAL_RANK) not in (None, ""):
        rank = int(env[ENV_LOCAL_RANK])
        return rank, int(env.get(ENV_LOCAL_WORLD_SIZE, str(rank + 1)))
    host = str(topo["coordinator"]).rsplit(":", 1)[0]
    if _is_loopback(host):
        return int(topo["process_id"]), int(topo["num_processes"])
    if int(topo["num_processes"]) == 1:
        return 0, 1
    return None


def process_device(device: DeviceLike, topo: Dict[str, object]
                   ) -> torch.device:
    """The device a pod rank owns: ``cuda`` (the default) is
    ``cuda:<local rank>``; ``cpu`` only when asked.  Raises when a rank
    of a remote coordinator's pod cannot tell its local rank."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        placement = local_placement(topo)
        if placement is None:
            raise RuntimeError(
                f"rank {topo['process_id']} of a {topo['num_processes']}-"
                f"process pod behind {topo['coordinator']} cannot tell "
                f"which card is its own: set {ENV_LOCAL_RANK} and "
                f"{ENV_LOCAL_WORLD_SIZE}, or name the card (cuda:<i>)")
        dev = torch.device("cuda", placement[0])
    return resolve_device(dev)


def ensure_distributed(coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       device: DeviceLike = None,
                       group_of_one: bool = False) -> bool:
    """Join this process's ``torch.distributed`` group exactly once, from
    flags (first) or the env contract.

    Returns True when running multi-process, False when no coordinator is
    configured or the topology has one process.  One process records the
    topology without a group, as in the JAX package, unless
    ``group_of_one``: then it forms a group of one rank, so that its
    collectives run through the backend as a pod's do.  Raises
    ``RuntimeError`` when a previous call recorded a DIFFERENT topology,
    and when a NCCL pod has more ranks on this machine than cards."""
    global _initialized, _group_device
    topo = resolve_topology(coordinator, num_processes, process_id)
    if topo is None:
        return False
    if _initialized is not None:
        if _initialized != topo:
            raise RuntimeError(
                f"torch.distributed already initialized with "
                f"{_initialized}; refusing conflicting topology {topo}")
        return topo["num_processes"] > 1
    if topo["num_processes"] == 1 and not group_of_one:
        _initialized = topo
        return False
    dev = process_device(device, topo)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        # an explicit cuda:<i> behind a remote coordinator has no known
        # count of ranks on this machine: its caller placed it
        placement = local_placement(topo)
        local_world = 1 if placement is None else placement[1]
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise RuntimeError(
                f"a NCCL pod of {local_world} ranks on this machine needs "
                f"{local_world} cards, one card a rank; this machine has "
                f"{cards} (NCCL refuses two ranks on one card)")
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=DIST_TIMEOUT_S)
    dist.init_process_group(
        backend, init_method=f"tcp://{topo['coordinator']}",
        world_size=int(topo["num_processes"]),
        rank=int(topo["process_id"]), timeout=timeout)
    _initialized = topo
    _group_device = dev
    return topo["num_processes"] > 1


def initialized_topology() -> Optional[Dict[str, object]]:
    """The topology this process bootstrapped with (None before any
    :func:`ensure_distributed`)."""
    return None if _initialized is None else dict(_initialized)


def _reset_bootstrap_for_tests() -> None:
    """Forget the recorded topology and leave the process group."""
    global _initialized, _group_device
    _initialized = None
    _group_device = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def default_devices() -> List[torch.device]:
    """Every visible card (raises when there is none: the CPU only when
    asked)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _slot_device(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# --------------------------------------------------------- port helpers

def pick_coordinator_port(host: str = "127.0.0.1") -> int:
    """One candidate coordinator port from the OS.  The bind is released
    before returning, so the port can be stolen: wrap launches in
    :func:`retry_on_port_clash`."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


#: substrings that identify a coordinator bind failure in a worker's
#: output (torch's TCP store prints EADDRINUSE and "Address already in
#: use"; the rest are the JAX package's spellings)
PORT_CLASH_MARKERS = ("EADDRINUSE", "Address already in use",
                      "address already in use", "Failed to bind",
                      "errno 98", "Errno 98", os.strerror(errno.EADDRINUSE))


def is_port_clash(text: str) -> bool:
    """Does this (worker) output say the coordinator port was taken?"""
    return any(m in text for m in PORT_CLASH_MARKERS)


def retry_on_port_clash(launch, attempts: int = 4):
    """Call ``launch(port)`` with a fresh candidate port per attempt;
    ``launch`` returns ``(ok, result)``, ``ok=False`` meaning the
    coordinator failed to bind.  Raises ``RuntimeError`` after
    ``attempts`` clashes."""
    last = None
    for _ in range(max(1, attempts)):
        port = pick_coordinator_port()
        ok, result = launch(port)
        if ok:
            return result
        last = result
    raise RuntimeError(
        f"coordinator port clashed {attempts} times; last result: "
        f"{str(last)[-500:]}")


# ------------------------------------------------------------ trees

class Sharded:
    """A leaf of a global array of which this process holds pieces:
    ``global_shape``, ``dtype`` and ``pieces``, a list of ``(windows,
    tensor)`` with one ``(start, stop)`` window per axis.  Per-slot state
    (a ParallelWrapper's per-worker updater state, a ZeRO shard) takes
    this form for the state gauge and the pod checkpoints, where the JAX
    package has a sharded ``jax.Array``."""

    def __init__(self, global_shape, dtype: torch.dtype, pieces):
        self.global_shape = tuple(int(d) for d in global_shape)
        self.dtype = dtype
        self.pieces = list(pieces)

    def distinct_pieces(self):
        """The pieces with their windows deduplicated (replicas count
        once)."""
        seen, out = set(), []
        for windows, t in self.pieces:
            key = tuple(tuple(w) for w in windows)
            if key not in seen:
                seen.add(key)
                out.append((key, t))
        return out


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` order: dict keys sorted at every
    level, lists and tuples in order, None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in
                tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_unflatten(template, leaves) -> Any:
    """``template``'s structure with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {key: build(t[key]) for key in sorted(t)}
            return {key: out[key] for key in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(item) for item in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_to(tree, device: torch.device):
    """Every tensor leaf moved to ``device`` with ``.to`` (no copy when it
    is there already); other leaves pass through."""
    return tree_unflatten(tree, [
        x.to(device) if isinstance(x, torch.Tensor) else x
        for x in tree_leaves(tree)])


# ------------------------------------------------------------- runtime

class MeshRuntime:
    """One mesh with axes ``("data", "zero", "pipe")`` over slots, handed
    to every parallel wrapper.

    ``data``/``zero``/``pipe`` are the axis degrees; ``data=None`` infers
    the largest degree that fits the slots given the other two.  With
    ``devices`` the runtime is one process's (see :meth:`local`); without,
    ``coordinator``/``num_processes``/``process_id`` (or the env
    contract) join a pod first, each process owning ``device`` (default
    ``cuda:<local rank>``), and with no pod the slots default to every
    visible card."""

    def __init__(self, data: Optional[int] = None, zero: int = 1,
                 pipe: int = 1, devices: Optional[Sequence] = None,
                 coordinator: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 device: DeviceLike = None, group_of_one: bool = False):
        if devices is None:
            ensure_distributed(coordinator, num_processes, process_id,
                               device=device, group_of_one=group_of_one)
        zero = int(zero)
        pipe = int(pipe)
        if zero < 1 or pipe < 1:
            raise ValueError(f"axis degrees must be >= 1 "
                             f"(zero={zero}, pipe={pipe})")
        self._group = (devices is None and dist.is_available()
                       and dist.is_initialized())
        if self._group:
            count, index = dist.get_world_size(), dist.get_rank()
            if data is None:
                data = count // (zero * pipe)
            if int(data) < 1:
                raise ValueError(
                    f"mesh needs data >= 1: {count} process(es) cannot "
                    f"fit zero={zero} x pipe={pipe}")
            n = int(data) * zero * pipe
            if n % count:
                raise ValueError(
                    f"mesh {data}x{zero}x{pipe} = {n} slots do not divide "
                    f"over {count} processes")
            per = n // count
            local = [_group_device] * per
            self._process = (index, count)
            self._first = index * per
        else:
            if devices is None:
                devices = default_devices()
            local = [_slot_device(d) for d in devices]
            if data is None:
                data = len(local) // (zero * pipe)
            if int(data) < 1:
                raise ValueError(
                    f"mesh needs data >= 1: {len(local)} device(s) cannot "
                    f"fit zero={zero} x pipe={pipe}")
            n = int(data) * zero * pipe
            if n > len(local):
                raise ValueError(
                    f"mesh {data}x{zero}x{pipe} = {n} devices > "
                    f"{len(local)} available")
            local = local[:n]
            self._process = (0, 1)
            self._first = 0
        self.data_degree = int(data)
        self.zero_degree = zero
        self.pipe_degree = pipe
        self.slot_count = n
        #: this process's slot devices, in slot order
        self.devices: List[torch.device] = local
        _monitor.gauge("mesh_process_count",
                       "processes participating in the pod mesh").set(
            self.process_count)
        for axis, degree in zip(AXES, (self.data_degree, zero, pipe)):
            _monitor.gauge("mesh_axis_size",
                           "global mesh axis degree").set(degree, axis=axis)

    # ---- single-process factory -----------------------------------------
    @classmethod
    def local(cls, data: Optional[int] = 1, zero: int = 1, pipe: int = 1,
              devices: Optional[Sequence] = None) -> "MeshRuntime":
        """A runtime over this process's own devices (default: every
        visible card) with NO distributed bootstrap."""
        if devices is None:
            devices = default_devices()
        return cls(data=data, zero=zero, pipe=pipe, devices=devices)

    # ---- topology -------------------------------------------------------
    @property
    def dp_degree(self) -> int:
        """Data-parallel replicas: the flattened data x zero extent."""
        return self.data_degree * self.zero_degree

    @property
    def process_index(self) -> int:
        return self._process[0]

    @property
    def process_count(self) -> int:
        return self._process[1]

    @property
    def is_multiprocess(self) -> bool:
        return self.process_count > 1

    @property
    def local_slots(self) -> List[int]:
        """Global indices of this process's slots, in order."""
        return list(range(self._first, self._first + len(self.devices)))

    def coords(self, slot: int) -> Tuple[int, int, int]:
        """``(data, zero, pipe)`` coordinates of a global slot."""
        p = slot % self.pipe_degree
        z = (slot // self.pipe_degree) % self.zero_degree
        d = slot // (self.pipe_degree * self.zero_degree)
        return d, z, p

    def topology(self) -> Dict[str, int]:
        """The shape stamp pod checkpoints carry."""
        return {"data": self.data_degree, "zero": self.zero_degree,
                "pipe": self.pipe_degree,
                "num_processes": self.process_count}

    def describe(self) -> str:
        return (f"mesh[data={self.data_degree},zero={self.zero_degree},"
                f"pipe={self.pipe_degree}]@{self.process_count}proc")

    def group_of(self, slot: int, axes: Sequence[str]) -> List[int]:
        """The slots that share ``slot``'s coordinates on every axis not in
        ``axes``, in slot order."""
        keep = [i for i, a in enumerate(AXES) if a not in axes]
        mine = self.coords(slot)
        return [s for s in range(self.slot_count)
                if all(self.coords(s)[i] == mine[i] for i in keep)]

    # ---- the exchange ---------------------------------------------------
    def _exchange(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every slot's tensor (global slot order) from this process's
        ``values`` (one a local slot, equal shapes and dtypes): the list
        itself in one process, an ``all_gather`` over the group in a pod
        (onto this process's device; the bytes travel as uint8, which
        both NCCL and gloo move whatever the dtype)."""
        if not self._group:
            return list(values)
        mine = torch.stack(values)
        raw = mine.reshape(mine.shape[0], -1).contiguous().view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(self.process_count)]
        dist.all_gather(parts, raw)
        rows = torch.cat(parts).view(mine.dtype).reshape(
            (-1,) + tuple(mine.shape[1:]))
        return list(rows.unbind(0))

    def _reduce(self, values: List[torch.Tensor], axes: Sequence[str],
                mean: bool) -> List[torch.Tensor]:
        n = len(self.group_of(self._first, axes))
        if (self._group and self.process_count == 2
                and len(self.devices) == 1 and n == 2
                and values[0].dtype in (torch.float32, torch.float64)):
            out = values[0].clone()
            dist.all_reduce(out, op=dist.ReduceOp.SUM)
            return [out / n if mean else out]
        every = self._exchange(values)
        out, done = [], {}
        for i, slot in enumerate(self.local_slots):
            group = tuple(self.group_of(slot, axes))
            if group not in done:
                first = group[0] - self._first
                home = (self.devices[first] if 0 <= first < len(self.devices)
                        else self.devices[i])
                acc = every[group[0]].to(home)
                for s in group[1:]:
                    acc = acc + every[s].to(home)
                done[group] = acc / n if mean else acc
            out.append(done[group].to(self.devices[i]))
        return out

    def sum_over(self, values: List[torch.Tensor],
                 axes: Sequence[str] = ("data", "zero")
                 ) -> List[torch.Tensor]:
        """For each local slot, the sum over its group along ``axes`` of
        the slots' ``values``, in slot order, on that slot's device."""
        return self._reduce(values, axes, mean=False)

    def mean_over(self, values: List[torch.Tensor],
                  axes: Sequence[str] = ("data", "zero")
                  ) -> List[torch.Tensor]:
        """:meth:`sum_over` divided by the group's size (psum / n), once a
        group, then copied to its slots."""
        return self._reduce(values, axes, mean=True)

    def gather_over(self, values: List[torch.Tensor],
                    axes: Sequence[str]) -> List[List[torch.Tensor]]:
        """For each local slot, its group's ``values`` along ``axes`` in
        slot order, each on that slot's device (the all-gather)."""
        every = self._exchange(values)
        return [[every[s].to(dev) for s in self.group_of(slot, axes)]
                for slot, dev in zip(self.local_slots, self.devices)]

    def mean_trees(self, trees: List[Any],
                   axes: Sequence[str] = ("data", "zero")) -> List[Any]:
        """:meth:`mean_over` of whole trees, one a local slot (same
        structure): floating leaves flattened into one buffer per dtype,
        one reduction each; other leaves stay each slot's own."""
        leaves = [tree_leaves(t) for t in trees]
        out = [list(ls) for ls in leaves]
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for j, leaf in enumerate(leaves[0]):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                by_dtype.setdefault(leaf.dtype, []).append(j)
        for idx in by_dtype.values():
            flats = [torch.cat([ls[j].reshape(-1) for j in idx])
                     for ls in leaves]
            means = self.mean_over(flats, axes)
            for i, m in enumerate(means):
                offset = 0
                for j in idx:
                    shape = leaves[i][j].shape
                    size = leaves[i][j].numel()
                    out[i][j] = m[offset:offset + size].reshape(shape)
                    offset += size
        return [tree_unflatten(t, o) for t, o in zip(trees, out)]

    # ---- per-slot state -------------------------------------------------
    def stack_slots(self, per_slot: List[Any]) -> Any:
        """Per-local-slot trees (same structure) as one tree of
        :class:`Sharded` leaves of global shape ``(slots, ...)``, this
        process holding its slots' rows (the JAX package's stacked
        per-worker state, sharded over the worker axis)."""
        leaves = [tree_leaves(t) for t in per_slot]

        def one(j):
            leaf = leaves[0][j]
            pieces = []
            for slot, ls in zip(self.local_slots, leaves):
                t = ls[j]
                pieces.append((((slot, slot + 1),)
                               + tuple((0, d) for d in t.shape), t[None]))
            return Sharded((self.slot_count,) + tuple(leaf.shape),
                           leaf.dtype, pieces)

        return tree_unflatten(per_slot[0],
                              [one(j) for j in range(len(leaves[0]))])

    def unstack_slots(self, stacked: Any, template: Any) -> List[Any]:
        """The inverse of :meth:`stack_slots` from whole host arrays: each
        local slot's row, as ``template``'s leaves' dtypes on that slot's
        device."""
        leaves = tree_leaves(stacked)
        kinds = tree_leaves(template)
        out = []
        for slot, dev in zip(self.local_slots, self.devices):
            out.append(tree_unflatten(template, [
                torch.as_tensor(full[slot]).to(device=dev, dtype=k.dtype)
                for full, k in zip(leaves, kinds)]))
        return out

    def addressable_state_bytes(self, tree) -> int:
        """Bytes of ``tree`` resident in THIS process: a tensor counts its
        bytes, a :class:`Sharded` leaf its distinct pieces' (replicas
        count once)."""
        total = 0
        for leaf in tree_leaves(tree):
            if isinstance(leaf, Sharded):
                total += sum(t.numel() * t.element_size()
                             for _, t in leaf.distinct_pieces())
            elif isinstance(leaf, torch.Tensor):
                total += leaf.numel() * leaf.element_size()
            else:
                total += getattr(leaf, "nbytes", 0)
        return total

    def publish_state_bytes(self, tree, axis: str) -> int:
        """Gauge ``mesh_updater_state_bytes{axis=...}`` with this
        process's resident bytes of ``tree``."""
        nbytes = self.addressable_state_bytes(tree)
        _monitor.gauge(STATE_BYTES_GAUGE,
                       _HELP[STATE_BYTES_GAUGE]).set(nbytes, axis=axis)
        return nbytes

    # ---- collectives ----------------------------------------------------
    def barrier(self, name: str = "mesh_barrier") -> None:
        """Block until every process reaches this point (no-op without a
        process group)."""
        if not self._group:
            return
        if self.devices[0].type == "cuda":
            dist.barrier(device_ids=[self.devices[0].index])
        else:
            dist.barrier()

    def _sync(self) -> None:
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def measure_collectives(self, size: int = 1 << 14,
                            repeats: int = 3) -> Dict[str, float]:
        """Wall time of the all-reduce (:meth:`sum_over`) and the
        all-gather (:meth:`gather_over`) of ``size`` float32 values a slot
        over each axis of degree > 1, the card synchronized around the
        clock; publishes ``mesh_collective_seconds{axis,op}``.  Returns
        ``{"{axis}/{op}": seconds}``, best of ``repeats`` after one
        untimed call."""
        out: Dict[str, float] = {}
        hist = _monitor.histogram(COLLECTIVE_HIST, _HELP[COLLECTIVE_HIST])
        for axis, degree in zip(AXES, (self.data_degree, self.zero_degree,
                                       self.pipe_degree)):
            if degree <= 1:
                continue
            values = [torch.arange(size, dtype=torch.float32, device=dev)
                      + slot * size
                      for slot, dev in zip(self.local_slots, self.devices)]
            for op, fn in (("all_reduce",
                            lambda a=axis: self.sum_over(values, (a,))),
                           ("all_gather",
                            lambda a=axis: self.gather_over(values, (a,)))):
                fn()
                self._sync()
                best = float("inf")
                for _ in range(max(1, repeats)):
                    self._sync()
                    t0 = time.perf_counter()
                    fn()
                    self._sync()
                    best = min(best, time.perf_counter() - t0)
                hist.observe(best, axis=axis, op=op)
                out[f"{axis}/{op}"] = best
        return out


def worker_generator(seed: int, iteration: int, slot: int,
                     device: torch.device) -> torch.Generator:
    """The dropout generator of one replica's step: seeded by (the
    network's seed, the iteration, the slot).  The JAX package folds the
    same three into its threefry key; torch cannot reproduce that stream,
    so draws differ between the packages (a deliberate difference)."""
    state = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(iteration), int(slot)])
    value = int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(value)
