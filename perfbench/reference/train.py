"""What the reference computes for a cell, on its own, from the weights
and images the harness made: the first three training steps, read as
norms per leaf, and the inference forward of served rows.

``model`` is one of this package's model modules (``resnet``, ``vgg``);
``quant`` ("fp8", "bf16") computes every layer in that format
(``ops.q``); fp8 is the control that has to come out as not correct.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import ops


def three_steps(model, cfg, P: Dict[str, torch.Tensor],
                S: Dict[str, torch.Tensor],
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                quant: Optional[str] = None) -> dict:
    """Train from ``P``/``S`` (float32, modified in place) on each
    ``(images, one-hot labels)`` of ``batches`` with the configuration's
    Nesterov step.  Returns each step's score (data loss plus the l2
    term), each leaf's first gradient as the updater takes it (l2
    included), and each leaf's change over all the steps, running
    statistics included."""
    l2 = model.l2_of(cfg)
    lr, mu = cfg["learning_rate"], cfg["momentum"]
    start = {k: v.detach().clone() for k, v in list(P.items())
             + list(S.items())}
    velocity = {k: torch.zeros_like(v) for k, v in P.items()}
    names = list(P)
    losses: List[float] = []
    first: Dict[str, torch.Tensor] = {}
    for step, (x, y) in enumerate(batches):
        leaves = [P[k].detach().requires_grad_(True) for k in names]
        live = dict(zip(names, leaves))
        logits, new_s = model.forward(cfg, live, S, x, True, quant)
        loss = ops.data_loss(logits, y)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            losses.append(float(loss + ops.l2_term(P, l2)))
            g = dict(zip(names, grads))
            if step == 0:
                first = {k: g[k] + l2.get(k, 0.0) * P[k] for k in names}
            ops.nesterovs(P, velocity, g, l2, lr, mu)
            S.update({k: v.detach() for k, v in new_s.items()})
        del logits, loss, grads, leaves, live, g
    change = {k: (P[k] if k in P else S[k]) - v for k, v in start.items()}
    return {"losses": losses, "grads": first, "changes": change}


def logits(model, cfg, P, S, x: torch.Tensor, quant: Optional[str] = None,
           block: int = 64) -> torch.Tensor:
    """Inference logits of NHWC ``x``, ``block`` rows at a time."""
    with torch.no_grad():
        return torch.cat([model.forward(cfg, P, S, x[i:i + block], False,
                                        quant)[0]
                          for i in range(0, x.shape[0], block)])


def batch_statistics(model, cfg, P, S, x: torch.Tensor) -> Dict:
    """The batch norms' statistics of ``x`` in a training forward: what
    the running statistics would hold after long training on such
    images."""
    plain = dict(cfg, bn_decay=0.0)
    with torch.no_grad():
        return model.forward(plain, P, S, x, True)[1]
