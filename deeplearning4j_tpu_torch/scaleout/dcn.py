"""Multi-host wiring for cluster training (port of
``deeplearning4j_tpu/scaleout/dcn.py``): where the reference's
``ParameterAveragingTrainingMaster`` moves params master↔executor over
the Spark shuffle, each host runs one process, trains its shard of
exported minibatch files, and the cross-host parameter average is one
collective over a ``torch.distributed`` group.

The group is joined through :func:`parallel.mesh.ensure_distributed`, the
one bootstrap of the port (as the JAX module delegates to its own); its
backend follows the device, NCCL on ``cuda`` and gloo on ``cpu``, with no
switch and no fallback.  A single process (no coordinator, or a topology
of one process without a group) runs the same code with a world of one,
where the mean is the identity.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike


def initialize_from_env(device: DeviceLike = None) -> bool:
    """Join the process group from the standard env vars
    (``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``) on
    ``device`` (None: this rank's card).  Returns True when running
    multi-process; False (no-op) when the env vars are absent.  Delegates
    to :func:`parallel.mesh.ensure_distributed` (flags > env), so this
    module and the pod runtime can never join two conflicting
    topologies."""
    from ..parallel.mesh import ensure_distributed
    return ensure_distributed(device=device)


def _world() -> tuple:
    """(rank, world size) of this process's group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(paths: Sequence[str],
               process_id: Optional[int] = None,
               process_count: Optional[int] = None) -> List[str]:
    """This host's share of the exported minibatch files (the per-host data
    sharding that replaces Spark's RDD partitioning): the rank and the
    world size of the process group, unless given."""
    rank, world = _world()
    pid = rank if process_id is None else process_id
    n = world if process_count is None else process_count
    return list(paths[pid::n])


def _group_device() -> torch.device:
    """Where the group's collectives run: this rank's card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def cross_host_mean(flat: np.ndarray, weight: float = 1.0) -> np.ndarray:
    """Weighted mean of a flat param vector across hosts (replaces the
    Spark ``aggregate`` of ``ParameterAveragingElementAddFunction``): each
    host contributes ``[weight * params, weight]`` stacked in float32, as
    the JAX package does; every rank's row is gathered and the rows are
    summed in rank order, so every rank computes the same bits; the mean
    is ``sum(w·p) / sum(w)`` cast to ``flat``'s dtype.  With one process
    (no group, or a group of one) this is the identity, as in the JAX
    package."""
    if _world()[1] == 1:
        return flat
    stacked = np.concatenate([flat * weight, [weight]]).astype(np.float32)
    mine = torch.from_numpy(stacked).to(_group_device())
    rows = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, mine)
    summed = np.zeros_like(stacked)
    for row in rows:
        summed += row.cpu().numpy()
    return (summed[:-1] / summed[-1]).astype(flat.dtype)


def run_multi_host_training(net, training_master, all_paths: Sequence[str],
                            epochs: int = 1) -> List[str]:
    """The full multi-host loop: every host trains its shard with the local
    master, then params are cross-host averaged after every epoch
    (executors fit partitions, the per-split averaging is local to each
    host's workers, and the cross-host average is per epoch, the local-SGD
    layering).

    Returns this host's shard (the paths actually trained)."""
    shard = host_shard(all_paths)
    for _ in range(epochs):
        training_master.execute_training_paths(net, shard)
        net.set_flat_params(cross_host_mean(
            net.get_flat_params(), weight=float(len(shard) or 1)))
    return shard
