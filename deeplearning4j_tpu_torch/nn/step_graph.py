"""One CUDA graph per train step on the epoch-cache path: the port's
analogue of the JAX package's one ``lax.scan`` dispatch per fused epoch.

``CapturedGatherStep`` captures the network's gather step (gather a
minibatch from the resident dataset, decode the wire, forward, autograd
backward, the DL4J-order update, the health vector and guard) once per
(network, dataset, batch rows) and replays it once a step, with no host
sync between replays.  Everything the step reads or writes lives in
static buffers:

- the params, updater state (fp32 masters included) and layer state are
  static trees: the network's own tensors, adopted when the first step
  is captured (a model whose trees fill most of the card has no room for
  a copy); ``load`` copies in any leaf the caller replaced between fits,
  the graph writes each step's result back with ``copy_``, and the
  network's trees point at the static ones between and after dispatches
  (``bind``), so the next cache fit writes the tensors a caller holds in
  place, as an optimizer's step does.  The update writes each layer's
  params and updater state back as soon as that layer's are made
  (``_Network._updated``'s sink; the layer state after the step), so the
  step holds one layer's new trees beside the static ones, not a second
  copy of them all: what lets a model of billions of parameters train
  with Adam and fp32 masters on one card.  Adam's fused kernel
  (``ops/adam.py``) writes straight into the static tensors, so its
  leaves are not copied back at all.  The health guard, which picks
  between old and new trees, keeps the whole new trees until the end
  (its step updates out of place);
- the step counter ``ctr`` is a device scalar the graph increments; it
  selects the step's row of example indices (``rows``, filled on the
  device from the epoch permutation) and of iteration scalars (``table``:
  the learning rate, momentum and Adam step that the host's
  ``updaters.step_scalars`` computes for each iteration, filled once per
  fit from a device table), and the slot of the step's score and health
  vector in ``scores``/``health``, which the host reads once per dispatch;
- dropout draws from the network's device generator, registered with the
  graph (``CUDAGraph.register_generator_state``), so each replay advances
  it exactly as an eager step would;
- the health configuration (``monitor.health.config_key``) is fixed at
  capture: it decides whether the step computes the health vector and
  the guard, and the guard's policy and grad norm limit, so it is part
  of the capture key and a change of it captures anew.

Capture is decided by a stated static rule, never by catching an error:
the cache path captures whenever the network lives on a CUDA device (the
cache path itself requires no solver, no tBPTT and ``num_iterations ==
1``, over a resident dataset).  A capture or replay that fails raises.
The eager loop over the same step (``_Network._gather_step``) runs for
CPU tensors and is the reference the captured path is held to on the
card.

Kernel launch counts: the wrappers count their calls, the warm-up steps'
and the capture's included; a replay runs no wrapper and counts nothing.
What a replay launches is read from the profiler's kernel names.
"""

from __future__ import annotations

import gc
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..monitor import jit_watch as _jit_watch

#: warm-up steps on a side stream before a capture (autograd and the
#: library handles initialise there, outside the graph)
WARMUP_STEPS = 2


def _matched(dst, src) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Leaves of ``dst`` and the leaves of ``src`` at the same keys."""
    if isinstance(dst, dict):
        pairs = [_matched(dst[k], src[k]) for k in dst]
    elif isinstance(dst, (list, tuple)):
        pairs = [_matched(d, s) for d, s in zip(dst, src)]
    elif isinstance(dst, torch.Tensor):
        return [dst], [src]
    else:
        return [], []
    return ([t for d, _ in pairs for t in d],
            [t for _, s in pairs for t in s])


def _copy_into(dst, src) -> None:
    d, s = _matched(dst, src)
    pairs = [(a, b) for a, b in zip(d, s) if a is not b]
    if pairs:
        torch._foreach_copy_([a for a, _ in pairs], [b for _, b in pairs])


class StaticTrees:
    """The static params, updater state and layer state of one network's
    captured steps (shared by its full-batch and tail graphs): the
    network's tensors at the first capture, in new containers."""

    def __init__(self, net):
        self.params = _shallow(net.params)
        self.updater_state = _shallow(net.updater_state)
        self.net_state = _shallow(net.net_state)

    def load(self, net) -> None:
        """Copy in the network's current values where it holds other
        tensors than the static ones (device to device)."""
        _copy_into(self.params, net.params)
        _copy_into(self.updater_state, net.updater_state)
        _copy_into(self.net_state, net.net_state)

    def bind(self, net) -> None:
        """Point the network's trees at the static ones."""
        net.params = _shallow(self.params)
        net.updater_state = _shallow(self.updater_state)
        net.net_state = _shallow(self.net_state)


def _shallow(tree):
    """New containers around the same tensors (so a caller that replaces
    a dict entry does not write into the static tree)."""
    if isinstance(tree, dict):
        return {k: _shallow(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shallow(v) for v in tree]
    return tree


def gather_step_name(net) -> str:
    """The compile watch's name of a network's gather step (the JAX
    package's ``watched_jit`` name)."""
    return ("cg" if type(net).__name__ == "ComputationGraph"
            else "mln") + ".gather_train_step"


def _commit(old_p, old_u, new_p, new_u):
    """A layer's new trees written into the static ones (the sink of the
    captured step).  ``in_place``: the updater may write them there itself
    (``_Network._updated``), and the tensors it hands back are then the
    static ones, which ``_copy_into`` skips."""
    _copy_into(old_p, new_p)
    _copy_into(old_u, new_u)
    return old_p, old_u


_commit.in_place = True


def _discard(old_p, old_u, new_p, new_u):
    """A warm-up step's layer trees dropped as they are made."""
    return old_p, old_u


class CapturedGatherStep:
    """One captured gather step for ``batch_rows`` rows a step and up to
    ``capacity`` steps a dispatch.  ``step_fn(params, updater_state,
    net_state, idx, scalars, sink)`` is the network's gather step, which
    hands each layer's new trees to ``sink`` (:func:`_commit` in the
    graph, :func:`_discard` in the warm-up); ``columns`` names the table's
    columns as ``(layer key, scalar name)``."""

    def __init__(self, net, static: StaticTrees, step_fn, batch_rows: int,
                 capacity: int, columns, score_dtype: torch.dtype,
                 health_width: int, pool, recompile: bool = False):
        dev = net.device
        self.capacity = capacity
        self.ctr = torch.zeros((1,), dtype=torch.long, device=dev)
        self.rows = torch.zeros((capacity, batch_rows), dtype=torch.long,
                                device=dev)
        self.table = torch.zeros((capacity, len(columns)),
                                 dtype=torch.float64, device=dev)
        self.scores = torch.zeros((capacity,), dtype=score_dtype,
                                  device=dev)
        # no buffer when the step computes no health vector (width 0)
        self.health: Optional[torch.Tensor] = torch.zeros(
            (capacity, health_width), dtype=torch.float32,
            device=dev) if health_width else None
        self._static = static
        self._columns = columns
        self._step_fn = step_fn
        self.graph = self._capture(net, pool, recompile)

    def _scalars(self, row: torch.Tensor) -> Dict[Any, Dict[str, Any]]:
        out: Dict[Any, Dict[str, Any]] = {}
        for col, (key, name) in enumerate(self._columns):
            out.setdefault(key, {})[name] = row[col]
        return out

    def _compute(self, sink):
        j = self.ctr
        idx = self.rows.index_select(0, j).reshape(-1)
        row = self.table.index_select(0, j).reshape(-1)
        st = self._static
        return self._step_fn(st.params, st.updater_state, st.net_state, idx,
                             self._scalars(row), sink)

    def _body(self) -> None:
        new_p, new_u, new_s, score, hvec = self._compute(_commit)
        st = self._static
        with torch.no_grad():
            _copy_into(st.params, new_p)
            _copy_into(st.updater_state, new_u)
            _copy_into(st.net_state, new_s)
            self.scores.index_copy_(0, self.ctr,
                                    score.detach().reshape(1).to(
                                        self.scores.dtype))
            if self.health is not None:
                self.health.index_copy_(0, self.ctr, hvec.reshape(1, -1))
            self.ctr.add_(1)

    def _capture(self, net, pool, recompile: bool) -> torch.cuda.CUDAGraph:
        # the warm-up steps and the capture are this step's build: one
        # compile of "<mln|cg>.gather_train_step" in the compile watch, a
        # recompile when the network already holds a step for this dataset
        with _jit_watch.compiling(gather_step_name(net), signature=(
                f"rows={tuple(self.rows.shape)}; "
                f"health={self.health is not None}"), recompile=recompile):
            return self._capture_graph(net, pool)

    def _capture_graph(self, net, pool) -> torch.cuda.CUDAGraph:
        # the graphs and pools of dropped networks go first, with the card
        # idle: released during a capture, they invalidate it
        gc.collect()
        torch.cuda.synchronize(net.device)
        gen = net._rng
        saved = gen.get_state()
        side = torch.cuda.Stream(device=net.device)
        side.wait_stream(torch.cuda.current_stream(net.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._compute(_discard)
        torch.cuda.current_stream(net.device).wait_stream(side)
        gen.set_state(saved)           # the warm-up draws are not kept
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=pool):
            self._body()
        return graph

    def run(self, rows: torch.Tensor, table: torch.Tensor):
        """Replay the step once per row of ``rows`` (S, batch_rows) with
        the iteration scalars ``table`` (S, columns), both on the device.
        Returns the (S,) scores and (S, width) health vectors (None
        without them), on the device."""
        steps = rows.shape[0]
        if steps > self.capacity:
            raise ValueError(f"{steps} steps for a captured step of "
                             f"capacity {self.capacity}")
        self.rows[:steps].copy_(rows)
        self.table[:steps].copy_(table)
        self.ctr.zero_()
        for _ in range(steps):
            self.graph.replay()
        return self.scores[:steps].clone(), (
            None if self.health is None else self.health[:steps].clone())


def table_columns(net) -> List[Tuple[Any, str]]:
    """``(layer key, scalar name)`` of every iteration scalar the
    network's updaters read, in ``_slots()`` order."""
    from . import updaters
    cols = []
    for key, _ in net._slots():
        if not net.params[key]:
            continue
        for name in sorted(updaters.step_scalars(net._updater_conf(key), 0)):
            cols.append((key, name))
    return cols


def scalar_table(net, columns, first_iteration: int, count: int,
                 device) -> torch.Tensor:
    """(count, columns) float64 table of the iteration scalars of
    iterations ``first_iteration ..``, computed on the host by
    ``updaters.step_scalars`` and copied to ``device`` once."""
    from . import updaters
    rows = []
    for it in range(first_iteration, first_iteration + count):
        per_key: Dict[Any, Dict[str, float]] = {}
        row = []
        for key, name in columns:
            if key not in per_key:
                per_key[key] = updaters.step_scalars(
                    net._updater_conf(key), it)
            row.append(per_key[key][name])
        rows.append(row)
    return torch.tensor(rows, dtype=torch.float64).reshape(
        count, len(columns)).to(device)


def capture_key(data_fs, data_ls, batch_rows: int, capacity: int,
                health_key: tuple) -> tuple:
    """The dataset (first two entries), the step's shape and the health
    configuration a captured step was made for."""
    return (tuple(id(t) for t in data_fs), tuple(id(t) for t in data_ls),
            batch_rows, capacity, health_key)
