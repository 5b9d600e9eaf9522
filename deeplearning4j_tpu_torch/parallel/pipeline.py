"""Pipeline parallelism, GPipe-style (port of
``deeplearning4j_tpu/parallel/pipeline.py``).

The layer stack is partitioned into S contiguous stages
(:func:`partition_stages`, balanced by parameter count), one a pipe slot
of a :class:`~deeplearning4j_tpu_torch.parallel.mesh.MeshRuntime`; a
minibatch is cut into M equal microbatches.  In one process, each
microbatch flows stage to stage, its activation handed on with ``.to``
to the next stage's device, and each stage runs its layers on its own
device: the stage takes its layers' params with ``.to`` (no copy when
the stage's device is the network's, as on one card).  Autograd carries
the cotangents back through the same hops, so the step needs no
hand-written backward schedule.  The loss is the mean of the
microbatches' mean losses, which for equal microbatches is the serial
step's full-batch mean; the update is the network's own
``_Network._train_step``.  The JAX package runs the same schedule as one
``shard_map`` program with ``ppermute`` hops, its stages computing
concurrently; here they run one after another, and one card gains no
overlap either way.

A pipe axis across processes raises ``NotImplementedError``: it waits for
the next slice, with NCCL ``send``/``recv`` between stages (the JAX pod
never runs one either: its worker's ``--mode`` is ``dp`` or ``zero``).

Scope (raise, don't diverge): feed-forward stacks with 2-D activations
between stages, no dropout, no stateful layers, no input preprocessors,
no score against the input, one iteration per batch, no line-search
solver.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..datasets.dataset import DataSet
from .mesh import MeshRuntime, default_devices


def partition_stages(layers: Sequence, params: Sequence,
                     n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) layer ranges balanced by parameter count
    (the usual pipeline partitioner heuristic)."""
    counts = [sum(int(np.prod(tuple(v.shape))) for v in p.values()) or 1
              for p in params]
    total = sum(counts)
    bounds = [0]
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        # close the current stage once it holds its fair share, keeping
        # enough layers for the remaining stages
        remaining_stages = n_stages - len(bounds)
        remaining_layers = len(counts) - (i + 1)
        if (acc >= total * len(bounds) / n_stages
                and remaining_layers >= remaining_stages):
            bounds.append(i + 1)
            if len(bounds) == n_stages:
                break
    while len(bounds) < n_stages:
        bounds.append(bounds[-1] + 1)
    bounds.append(len(counts))
    return [(bounds[i], bounds[i + 1]) for i in range(n_stages)]


class PipelineParallel:
    """GPipe-style trainer: ``PipelineParallel(net, stages=4,
    microbatches=8, devices=["cuda:0"] * 4).fit(iterator)``; ``devices``
    default to every visible card."""

    def __init__(self, model, stages: Optional[int] = None,
                 microbatches: int = 4, devices: Optional[list] = None,
                 runtime: Optional[MeshRuntime] = None):
        from ..nn.multilayer import MultiLayerNetwork
        if not isinstance(model, MultiLayerNetwork):
            raise ValueError("PipelineParallel supports MultiLayerNetwork")
        self.model = model
        model.init()
        if runtime is None:
            devices = list(devices) if devices is not None \
                else default_devices()
            self.stages = stages or len(devices)
            if self.stages > len(devices):
                raise ValueError(
                    f"{self.stages} stages > {len(devices)} devices")
            runtime = MeshRuntime.local(pipe=self.stages, devices=devices)
        else:
            if runtime.data_degree != 1 or runtime.zero_degree != 1:
                raise ValueError(
                    "PipelineParallel runs on the pipe axis; got a runtime "
                    f"with data={runtime.data_degree} "
                    f"zero={runtime.zero_degree} (compose DP via "
                    "ParallelWrapper/ZeroShardedParallelWrapper)")
            if runtime.is_multiprocess:
                raise NotImplementedError(
                    "a pipe axis across processes (stages handing "
                    "activations over NCCL send/recv) is the next slice of "
                    "the parallel tier (ROADMAP A9); run the pipeline in one "
                    "process over a device list")
            self.stages = runtime.pipe_degree
        if self.stages > len(model.layers):
            raise ValueError(
                f"{self.stages} stages > {len(model.layers)} layers")
        self.runtime = runtime
        self.devices = list(runtime.devices)
        if any(d.type != model.device.type for d in self.devices):
            raise ValueError(
                f"the network lives on {model.device}; the stages' devices "
                f"{[str(d) for d in self.devices]} must be of that type")
        self.microbatches = microbatches
        self._validate()
        self.ranges = partition_stages(model.layers, model.params,
                                       self.stages)

    def _validate(self) -> None:
        net = self.model
        from ..nn.layers.base import FeedForwardLayerConfig
        for layer in net.layers:
            if not isinstance(layer, FeedForwardLayerConfig):
                raise ValueError(
                    f"pipeline stages need 2-D feed-forward activations "
                    f"with explicit n_in/n_out; layer "
                    f"{type(layer).__name__} is not feed-forward")
            if layer.dropout:
                raise ValueError(
                    "dropout inside pipeline stages is not supported yet "
                    "(per-stage rng plumbing)")
        for state in net.net_state:
            if state:
                raise ValueError(
                    "stateful layers (batch-norm running stats) are not "
                    "supported inside pipeline stages yet")
        if net.conf.input_preprocessors:
            raise ValueError("input preprocessors inside the stack are "
                             "not supported across pipeline boundaries")
        out_layer = net.layers[-1]
        if getattr(out_layer, "NEEDS_INPUT_FOR_SCORE", False):
            raise ValueError(
                f"{type(out_layer).__name__} scores against its input "
                f"features (compute_score_with_input); not supported "
                f"inside pipeline stages")
        gconf = net.conf.conf
        if getattr(gconf, "num_iterations", 1) not in (None, 1):
            raise ValueError("num_iterations > 1 is not supported under "
                             "pipeline parallelism")
        algo = (getattr(gconf, "optimization_algo", None)
                or "stochastic_gradient_descent").lower()
        if algo != "stochastic_gradient_descent":
            raise ValueError(f"optimization_algo {algo!r} (line-search "
                             "solvers) is not supported under pipeline "
                             "parallelism")

    def _boundary_widths(self) -> List[int]:
        """Activation width entering each stage (and the final output)."""
        net = self.model
        widths = [int(net.layers[start].n_in) for start, _ in self.ranges]
        widths.append(int(net.layers[-1].n_out))
        return widths

    # ------------------------------------------------------------ the step
    def _pipeline_loss(self, params, x_mb: List[torch.Tensor],
                       y_mb: List[torch.Tensor]):
        """The mean of the microbatches' losses, each microbatch flowing
        through the stages on their devices; the last stage contributes
        its pre-activation, which the loss fuses with its activation."""
        net = self.model
        out_layer = net.layers[-1]
        average = bool(getattr(net.conf.conf, "mini_batch", True))
        last = len(net.layers) - 1
        staged = []
        for (start, end), dev in zip(self.ranges, self.devices):
            staged.append([{k: v.to(dev) for k, v in params[i].items()}
                           if start <= i < end else params[i]
                           for i in range(len(params))])
        losses = []
        for x, y in zip(x_mb, y_mb):
            for (start, end), dev, p in zip(self.ranges, self.devices,
                                            staged):
                x, _, _ = net._forward(
                    p, net.net_state, x.to(dev), train=True, rng=None,
                    from_layer=start, to_layer=end - 1,
                    preoutput_last=(end - 1 == last))
            losses.append(out_layer.compute_score(
                y.to(x.device), x, None, average))
        home = losses[0].device
        total = sum(loss.to(home) for loss in losses)
        return total / len(losses) if average else total

    # ------------------------------------------------------------------ fit
    def fit(self, iterator, epochs: int = 1) -> "PipelineParallel":
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            for ds in iterator:
                self._run_step(ds)
        return self

    def _run_step(self, ds: DataSet) -> None:
        net = self.model
        M = self.microbatches
        if ds.features_mask is not None or ds.labels_mask is not None:
            raise ValueError("masked DataSets are not supported under "
                             "pipeline parallelism (2-D activations only)")
        f, y, _, _ = net._batch(ds)
        b = f.shape[0]
        if b % M:
            raise ValueError(f"batch {b} not divisible by {M} microbatches")
        x_mb = list(f.reshape(M, b // M, -1).unbind(0))
        y_mb = list(y.reshape(M, b // M, -1).unbind(0))
        (net.params, net.updater_state, net.net_state, score, _,
         _) = net._train_step(
            net.params, net.updater_state, net.net_state,
            lambda p, s: (self._pipeline_loss(p, x_mb, y_mb), s, None),
            net.iteration)
        net.iteration += 1
        net._score = score
        for listener in net.listeners:
            listener.iteration_done(net, net.iteration)
