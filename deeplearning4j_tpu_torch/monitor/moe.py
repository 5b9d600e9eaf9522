"""The device counter of a mixture-of-experts network, read on demand.

Each ``MoEBlock`` keeps ``expert_tokens`` in its layer state: an int64
(n_experts,) tensor on the device that every training step adds its
routing counts to inside the step, so a replayed CUDA graph counts too
and no step reads it.  :func:`expert_tokens` copies them to the host in
one transfer; :func:`publish_expert_tokens` also brings the
``moe_expert_tokens_total{layer,expert}`` counter up to them.  Call them
when a run asks for the numbers (a report, the end of a traced stretch),
never once a step: each is a device sync.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import metrics as _metrics

COUNTER = "moe_expert_tokens_total"
_HELP = "tokens routed to each expert of each MoE layer by training steps"


def expert_tokens(net) -> Tuple[List[object], np.ndarray]:
    """``(layer keys, counts)``: the keys of the network's MoE layers in
    layer order and their (layers, n_experts) int64 counts, read from the
    device in one copy.  No MoE layer: ``([], (0, 0) array)``."""
    keys, rows = [], []
    for key, state in net._items(net.net_state):
        if "expert_tokens" in state:
            keys.append(key)
            rows.append(state["expert_tokens"])
    if not rows:
        return [], np.zeros((0, 0), dtype=np.int64)
    return keys, torch.stack(rows).cpu().numpy()


def publish_expert_tokens(net) -> np.ndarray:
    """:func:`expert_tokens`, with the counter raised to each count (it
    never goes down: a network whose counts are lower, a fresh one, adds
    nothing until it passes them)."""
    keys, counts = expert_tokens(net)
    c = _metrics.registry().counter(COUNTER, _HELP)
    for key, row in zip(keys, counts):
        for e, n in enumerate(row.tolist()):
            labels = {"layer": str(key), "expert": str(e)}
            delta = n - c.value(**labels)
            if delta > 0:
                c.inc(delta, **labels)
    return counts
