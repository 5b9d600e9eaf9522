"""Cross-replica sharding of the weight update, ZeRO-1 (port of
``deeplearning4j_tpu/parallel/zero.py``; Xu et al., arXiv:2004.13336).

Lockstep data parallelism in which each zero slot updates only its
``1/n`` slice of the flat parameter vector and holds only that slice's
updater state (and, under ``mixed_bf16``, its slice of the fp32 masters);
the updated slices are gathered back into the params.  Updater-state
bytes per slot drop n-fold; the result is the replicated step's.

A step, on the slots of a :class:`~deeplearning4j_tpu_torch.parallel.
mesh.MeshRuntime` (batches over the flattened data x zero extent, state
over zero only, replicated over data):

- each slot takes its batch's gradient (autograd of ``_loss_fn``);
- the gradients, layer state and scores fold over the slots weighted by
  each batch's mask count, ``sum(g * w) / sum(w)`` (``mesh.sum_over``),
  so a masked batch counts by its unmasked steps as in one big batch;
- then, in the replicated path's order: l1/l2 into the gradients (against
  the params), per-layer normalization, zeros for frozen layers;
- each zero slot runs the updater on its slice (``updaters.
  compute_update`` over one flat leaf) against its state (the fp32 master
  slice when there is one), and the slices are gathered back
  (``mesh.gather_over`` along zero) into the params.

The flat vector is the params' leaves in the JAX package's order
(``mesh.tree_leaves``: dict keys sorted), padded to ``ceil(total/n) * n``.

Scope (raise, don't diverge): one updater config network-wide, no
``direct_update_params`` layer, no ``lars`` (its per-tensor trust ratios
would break on a flat slice).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..nn import updaters as U
from .mesh import (MeshRuntime, Sharded, default_devices, tree_leaves,
                   tree_to, tree_unflatten, worker_generator)
from .parallel_wrapper import _trimmed, check_uniform_masks

_DP = ("data", "zero")


def _flat(tree, dtype=None) -> torch.Tensor:
    leaves = [t.reshape(-1) if dtype is None else t.reshape(-1).to(dtype)
              for t in tree_leaves(tree)]
    return torch.cat(leaves) if leaves else torch.zeros(0)


def _unflat(flat: torch.Tensor, template, dtype=None):
    out, offset = [], 0
    for t in tree_leaves(template):
        n = t.numel()
        out.append(flat[offset:offset + n].reshape(t.shape).to(
            t.dtype if dtype is None else dtype))
        offset += n
    return tree_unflatten(template, out)


class ZeroShardedParallelWrapper:
    """Lockstep data parallelism with the weight update sharded across
    replicas (ZeRO-1).  ``workers`` zero slots over ``devices`` (default:
    every visible card; ``["cuda:0"] * 4`` on one card), or a pod's
    ``runtime``."""

    def __init__(self, model, workers: Optional[int] = None,
                 devices: Optional[list] = None,
                 runtime: Optional[MeshRuntime] = None):
        from ..nn.multilayer import MultiLayerNetwork
        if not isinstance(model, MultiLayerNetwork):
            raise ValueError("ZeRO sharding currently supports "
                             "MultiLayerNetwork")
        self.model = model
        model.init()
        if runtime is None:
            devices = list(devices) if devices is not None \
                else default_devices()
            workers = workers or len(devices)
            if workers > len(devices):
                raise ValueError(
                    f"{workers} workers > {len(devices)} devices")
            runtime = MeshRuntime.local(zero=workers, devices=devices)
        elif runtime.pipe_degree != 1:
            raise ValueError(
                "ZeRO sharding runs on the data x zero extent; got a "
                f"runtime with pipe={runtime.pipe_degree}")
        self.runtime = runtime
        self.devices = list(runtime.devices)
        if any(d.type != model.device.type for d in self.devices):
            raise ValueError(
                f"the network lives on {model.device}; the slots' devices "
                f"{[str(d) for d in self.devices]} must be of that type")
        self.workers = runtime.dp_degree
        self.zero_n = runtime.zero_degree
        self._validate()
        self._build()

    # ---- scope checks (implement-or-raise) -------------------------------
    def _validate(self) -> None:
        net = self.model
        confs = [net._updater_conf(i) for i in range(len(net.layers))]
        first = confs[0]
        if any(c != first for c in confs):
            raise ValueError(
                "ZeRO weight-update sharding needs ONE updater config "
                "network-wide; per-layer overrides found")
        for layer in net.layers:
            if layer.direct_update_params():
                raise ValueError(
                    f"layer {type(layer).__name__} uses direct-update params "
                    f"(unsupported under ZeRO sharding)")
        if first.updater.lower() == "lars":
            raise ValueError(
                "lars computes per-TENSOR trust ratios; flat-slice "
                "sharding would break them — use replicated DP for lars")
        self.uconf = first

    # ---- static flat metadata --------------------------------------------
    def _build(self) -> None:
        net = self.model
        pol = net._pol()
        flat = _flat(net.params)
        self._flat_dtype = flat.dtype
        self.total = flat.numel()
        n = self.zero_n
        self.shard = -(-self.total // n)          # ceil
        self.padded = self.shard * n
        # state keys from the one source of truth (updaters.init_state)
        keys = list(U.init_state(self.uconf, {"w": torch.zeros(1)}).keys())
        self._masters = bool(pol.master_weights
                             and flat.element_size() < 4)
        padded_master = None
        if self._masters:
            # the fp32 master slice IS part of the sharded state
            padded_master = torch.nn.functional.pad(
                flat.float(), (0, self.padded - self.total))
        #: zero index -> that slice's state, for the zero indices of this
        #: process's slots (each on its first slot's device)
        self._state: Dict[int, Dict[str, torch.Tensor]] = {}
        for slot, dev in zip(self.runtime.local_slots, self.devices):
            z = self.runtime.coords(slot)[1]
            if z in self._state:
                continue
            state = {k: torch.zeros(self.shard, dtype=pol.updater_dtype,
                                    device=dev) for k in keys}
            if padded_master is not None:
                state[U.MASTER_KEY] = padded_master[
                    z * self.shard:(z + 1) * self.shard].to(dev).clone()
            self._state[z] = state
        self.runtime.publish_state_bytes(self.state_tree(), axis="zero")

    def state_tree(self) -> Dict[str, Sharded]:
        """The sharded state as ``{key: Sharded((zero, shard))}``, this
        process holding its zero indices' rows (the JAX package's state
        sharded over zero): what the gauge counts and a pod checkpoint
        writes."""
        first = next(iter(self._state.values()))
        return {key: Sharded(
            (self.zero_n, self.shard), first[key].dtype,
            [(((z, z + 1), (0, self.shard)), self._state[z][key][None])
             for z in sorted(self._state)]) for key in sorted(first)}

    def load_state(self, stacked: Dict[str, Any]) -> None:
        """Set the sharded state from whole (zero, shard) host arrays (a
        pod checkpoint's), each zero index taking its row."""
        for z, state in self._state.items():
            for key, t in state.items():
                state[key] = torch.as_tensor(stacked[key][z]).to(
                    device=t.device, dtype=t.dtype)

    # ------------------------------------------------------------ the step
    def _slot_grads(self, slot: int, dev: torch.device, ds):
        """One slot's gradient, data loss, new layer state and mask
        weight on its batch."""
        net = self.model
        f, l, fm, lm = tree_to(net._batch(ds), dev)
        params = tree_to(net.params, dev)
        gen = worker_generator(int(net.conf.conf.seed), net.iteration, slot,
                               dev)
        data_loss, new_state, _, flat = net._loss_and_grads(
            params, tree_to(net.net_state, dev),
            lambda p, s: net._loss_fn(p, s, f, l, fm, lm, gen, True), False)
        grads = iter(flat)
        grads = [{k: next(grads) for k in tree} for tree in params]
        mask = lm if lm is not None else fm
        wgt = (mask.sum().to(torch.float32) if mask is not None
               else torch.ones((), dtype=torch.float32, device=dev))
        return (grads, data_loss.detach(), net._stored_state(new_state),
                wgt)

    def _run_step(self, batches) -> None:
        net = self.model
        rt = self.runtime
        rows = min(ds.num_examples() for ds in batches)
        items = [_trimmed(ds, rows) for ds in batches]
        check_uniform_masks(items, "ZeRO step")
        per_slot = [self._slot_grads(slot, dev, items[slot])
                    for slot, dev in zip(rt.local_slots, self.devices)]
        # the weighted fold over every replica: sum(g*w) / sum(w)
        wide = torch.float64 if self._flat_dtype == torch.float64 \
            else torch.float32
        folded = rt.sum_over(
            [torch.cat([_flat(g, wide) * w.to(wide),
                        (loss.to(wide) * w.to(wide)).reshape(1),
                        w.to(wide).reshape(1)])
             for g, loss, _, w in per_slot], _DP)
        states = rt.mean_trees([s for _, _, s, _ in per_slot], _DP)
        template = per_slot[0][0]
        reg = net._reg_score(net.params)
        slices, done = [], {}
        for i, (slot, dev) in enumerate(zip(rt.local_slots, self.devices)):
            z = rt.coords(slot)[1]
            if z not in done:
                done[z] = self._update_slice(z, dev, folded[i], template)
            slices.append(done[z])
        gathered = rt.gather_over(slices, ("zero",))[0]
        new_flat = torch.cat([s.to(net.device) for s in gathered])
        net.params = _unflat(new_flat[:self.total], net.params)
        net.net_state = tree_to(states[0], net.device)
        wsum = folded[0][-1]
        score = (folded[0][-2] / wsum).to(net.device) + reg
        net.iteration += 1
        net._score = score
        rt.publish_state_bytes(self.state_tree(), axis="zero")
        for listener in net.listeners:
            listener.iteration_done(net, net.iteration)

    def _update_slice(self, z: int, dev: torch.device, folded: torch.Tensor,
                      template) -> torch.Tensor:
        """Zero slot ``z``'s new params slice: the folded gradient
        regularized, normalized and frozen per layer (in the replicated
        path's order), sliced, and run through the updater against the
        slice's state."""
        net = self.model
        total = self.total
        flat_g = folded[:total] / folded[-1]
        grads = _unflat(flat_g, template, folded.dtype)
        params = tree_to(net.params, dev)
        grads = [U.regularize(g, p, layer.l1_by_param(),
                              layer.l2_by_param())
                 for layer, p, g in zip(net.layers, params, grads)]
        grads = [U.normalize_gradients(
            g, layer.gradient_normalization,
            layer.gradient_normalization_threshold)
            for layer, g in zip(net.layers, grads)]
        # frozen layers take no update: zeros AFTER regularization, so
        # that l2 decay cannot leak into them
        grads = [{k: torch.zeros_like(v) for k, v in g.items()}
                 if getattr(layer, "frozen", False) else g
                 for layer, g in zip(net.layers, grads)]
        pad = self.padded - total
        lo, hi = z * self.shard, (z + 1) * self.shard
        my_g = torch.nn.functional.pad(_flat(grads), (0, pad))[lo:hi]
        my_p = torch.nn.functional.pad(_flat(params), (0, pad))[lo:hi]
        state = dict(self._state[z])
        master = state.pop(U.MASTER_KEY, None)
        if master is not None:
            my_g = my_g.float()
        updates, new_state = U.compute_update(
            self.uconf, {"w": my_g}, {k: {"w": v} for k, v in state.items()},
            net.iteration)
        new_state = {k: v["w"] for k, v in new_state.items()}
        if master is not None:
            new_master = master - updates["w"]
            new_state[U.MASTER_KEY] = new_master
            new_slice = new_master.to(my_p.dtype)
        else:
            new_slice = my_p - updates["w"]
        self._state[z] = new_state
        return new_slice

    # ------------------------------------------------------------------ fit
    def fit(self, iterator, epochs: int = 1) -> "ZeroShardedParallelWrapper":
        """One step per ``workers`` batches; an incomplete last group is
        padded by cycling its batches (the JAX package's rule)."""
        w = self.workers
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            pending: List[Any] = []
            for ds in iterator:
                pending.append(ds)
                if len(pending) == w:
                    self._run_step(pending)
                    pending = []
            if pending:
                n = len(pending)
                for i in range(w - n):
                    pending.append(pending[i % n])
                self._run_step(pending)
        # the model's per-layer updater state follows, so that a plain
        # net.fit or a serialization resumes with the trained state
        self._sync_model_state()
        return self

    def _sync_model_state(self) -> None:
        net = self.model
        keys = list(next(iter(self._state.values())))
        if self.runtime.is_multiprocess or not keys:
            # a pod's full state is in no one process (its checkpoints
            # write the shards); a stateless updater has nothing to sync
            return
        per_key = {}
        for key in keys:
            flat = torch.cat([self._state[z][key].to(net.device)
                              for z in range(self.zero_n)])[:self.total]
            per_key[key] = _unflat(flat, [state.get(key, {})
                                          for state in net.updater_state])
        net.updater_state = [
            {key: (per_key[key][i] if key in per_key else value)
             for key, value in state.items()}
            for i, state in enumerate(net.updater_state)]

    # ---- introspection ----------------------------------------------------
    def state_elements_per_replica(self) -> int:
        """Updater-state elements each replica holds: ``ceil(total/n)``
        per state tensor, where replicated DP holds ``total``."""
        return sum(t.numel() for t in next(iter(self._state.values()))
                   .values())
