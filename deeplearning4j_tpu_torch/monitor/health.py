"""Device-side training health: per-layer statistics inside the train step
and the divergence guard (port of ``deeplearning4j_tpu/monitor/health.py``).

- :func:`layer_stats` packs per-layer grad L2 norm, param L2 norm and
  update:param ratio plus a non-finite/explosion flag into ONE small f32
  tensor on the network's device, from values the step already holds.
  The fused paths stack the per-step vectors on the device, so the host
  reads them once per dispatch.
- :func:`guard_select` is the divergence guard: under policy
  ``skip_update`` a flagged step's outputs are replaced leaf for leaf by
  the pre-step values (``torch.where``), so its params stay bit-identical.
- :func:`record_dispatch` is the host half: it reads the stack, publishes
  the ``train_health_*`` series and enforces the policy (``abort`` raises
  :class:`TrainingDivergedError` with the offending step and layer;
  ``warn`` logs and marks the process diverged).

Packed vector layout for a network with L layers (all float32)::

    [loss, flag, grad_l2[0..L), param_l2[0..L), update_ratio[0..L)]

``flag`` is 1.0 when the step's loss, any per-layer grad norm or any
per-layer update norm is non-finite, or any grad norm exceeds the limit.

Configuration comes from :func:`enable`/:func:`disable`, else from
``DL4J_TPU_HEALTH``, ``DL4J_TPU_HEALTH_POLICY`` and
``DL4J_TPU_GRAD_NORM_LIMIT``, as in the JAX package.  A step reads it when
it runs eagerly, and when it is captured into a CUDA graph (the cache path
on the card): configure health before the first ``fit`` of a network, as
the JAX package asks before its first trace.  A step computes the vector
and the guard only when :func:`in_step` says so (health enabled, or policy
``skip_update``); otherwise it skips both, and :func:`record_dispatch`
only stamps the dispatch time.

A divergence dumps a ``divergence`` flight-recorder bundle
(:mod:`.flight_recorder`) before the policy acts, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .metrics import registry

logger = logging.getLogger("deeplearning4j_tpu_torch")

POLICIES = ("warn", "skip_update", "abort")
DEFAULT_GRAD_NORM_LIMIT = 1e6

_EPS = 1e-12

# the train_health_* series
LOSS = "train_health_loss"
GRAD_L2 = "train_health_grad_l2"
PARAM_L2 = "train_health_param_l2"
UPDATE_RATIO = "train_health_update_ratio"
STATE = "train_health_state"
LAST_DISPATCH_TS = "train_health_last_dispatch_ts"
NONFINITE_TOTAL = "train_health_nonfinite_steps_total"
SKIPPED_TOTAL = "train_health_skipped_steps_total"

_HELP = {
    LOSS: "last device-observed per-step training loss",
    GRAD_L2: "last-step per-layer gradient L2 norm (computed on device)",
    PARAM_L2: "last-step per-layer parameter L2 norm (computed on device)",
    UPDATE_RATIO: "last-step per-layer update:param L2 ratio "
                  "(computed on device)",
    STATE: "training health state: 0 ok, 1 diverged (sticky until "
           "health reset)",
    LAST_DISPATCH_TS: "unix time of the most recent train-step dispatch",
    NONFINITE_TOTAL: "train steps flagged non-finite or grad-exploded "
                     "by the device-side guard",
    SKIPPED_TOTAL: "flagged train steps replaced by the identity update "
                   "(guard policy skip_update)",
}


class TrainingDivergedError(RuntimeError):
    """Raised by guard policy ``abort``: a dispatch held a step whose
    loss, grad or update statistics were non-finite (or whose grad norm
    exceeded the limit).  ``step`` is the global iteration of the first
    flagged step, ``layer`` the first offending layer label (``"loss"``
    when the loss itself was the first non-finite value)."""

    def __init__(self, message: str, step: Optional[int] = None,
                 layer: Optional[str] = None):
        super().__init__(message)
        self.step = step
        self.layer = layer


class HealthConfig:
    """Immutable snapshot of the health-layer configuration."""

    __slots__ = ("enabled", "policy", "grad_norm_limit")

    def __init__(self, enabled: bool, policy: str, grad_norm_limit: float):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown guard policy {policy!r}; pick one of {POLICIES}")
        self.enabled = bool(enabled)
        self.policy = policy
        self.grad_norm_limit = float(grad_norm_limit)


_lock = threading.Lock()
_config: Optional[HealthConfig] = None   # None -> read the env


class _HostState:
    def __init__(self):
        self.lock = threading.Lock()
        self.diverged = False
        self.last: Optional[Dict[str, Any]] = None
        self.last_dispatch_ts: Optional[float] = None


_state = _HostState()


def _env_config() -> HealthConfig:
    raw = os.environ.get("DL4J_TPU_HEALTH", "0").strip().lower()
    enabled = raw not in ("", "0", "false", "off")
    policy = os.environ.get("DL4J_TPU_HEALTH_POLICY", "warn").strip() \
        .lower() or "warn"
    limit = float(os.environ.get("DL4J_TPU_GRAD_NORM_LIMIT",
                                 DEFAULT_GRAD_NORM_LIMIT))
    return HealthConfig(enabled, policy, limit)


def config() -> HealthConfig:
    """The active configuration: :func:`enable`/:func:`disable`, else the
    environment."""
    with _lock:
        if _config is not None:
            return _config
    return _env_config()


def enable(policy: str = "warn",
           grad_norm_limit: float = DEFAULT_GRAD_NORM_LIMIT) -> None:
    """Turn the health layer on with a guard policy (``warn`` /
    ``skip_update`` / ``abort``), before the first fit of a network."""
    global _config
    with _lock:
        _config = HealthConfig(True, policy, grad_norm_limit)


def disable() -> None:
    """Turn the health layer off (no stats, no guard)."""
    global _config
    with _lock:
        _config = HealthConfig(False, "warn", DEFAULT_GRAD_NORM_LIMIT)


def enabled() -> bool:
    return config().enabled


def in_step() -> bool:
    """Whether a train step computes the packed vector and the guard: when
    the layer is enabled, or under policy ``skip_update`` (the guard holds
    whether or not the stats are read, as in the JAX package).  The JAX
    package gets the unread stats for free inside its jitted step; the
    eager port would pay launches for them."""
    cfg = config()
    return cfg.enabled or cfg.policy == "skip_update"


def config_key() -> tuple:
    """What a captured step fixes at capture time: the configuration's
    (enabled, policy, grad norm limit)."""
    cfg = config()
    return (cfg.enabled, cfg.policy, cfg.grad_norm_limit)


def reset() -> None:
    """Forget overrides (back to the environment) and clear the host
    state (diverged flag, last-dispatch snapshot)."""
    global _config
    with _lock:
        _config = None
    with _state.lock:
        _state.diverged = False
        _state.last = None
        _state.last_dispatch_ts = None


# ------------------------------------------------------------- on device
def _layer_matrix(counts: Sequence[int], device) -> torch.Tensor:
    """(L, widest layer) indices of each layer's leaves in the flat leaf
    order, padded with the index one past the last leaf (a zero)."""
    width = max([1] + list(counts))
    pad = sum(counts)
    rows, col = [], 0
    for n in counts:
        rows.append(list(range(col, col + n)) + [pad] * (width - n))
        col += n
    return torch.tensor(rows, dtype=torch.long).reshape(
        len(counts), width).to(device)


def _norms(leaves: List[torch.Tensor], matrix: torch.Tensor) -> torch.Tensor:
    """Per-layer f32 L2 norms: the root of the sum of each layer's leaves'
    squared norms (the leaves taken in f32, as the JAX package casts
    them), gathered by ``matrix`` (an empty layer gives 0; no product
    with 0, so an infinite leaf stays in its own layer)."""
    if leaves:
        sq = torch.stack(torch._foreach_norm(
            [t.float() for t in leaves])).square()
    else:
        sq = torch.zeros((0,), dtype=torch.float32, device=matrix.device)
    sq = torch.cat([sq, sq.new_zeros(1)])
    return torch.sqrt(sq[matrix].sum(1))


def layer_stats(old_params, new_params, grads, loss, counts: Sequence[int],
                matrix: torch.Tensor):
    """Pack per-layer health statistics inside the train step.

    ``old_params``/``new_params``/``grads`` are flat lists of leaves in
    the network's layer order, ``counts`` the number of leaves of each
    layer (its ``_slots()``), ``matrix`` the leaf indices of each layer
    (:func:`layer_matrix`) on the step's device.  Returns ``(vec, bad)``: the packed
    f32 vector and the 0-dim bool that feeds :func:`guard_select`.  The
    update norm is taken from ``old - new``, the step the updater applied,
    so a flagged step reports the would-be explosion even when the guard
    then skips it."""
    cfg = config()
    diffs = torch._foreach_sub([o.float() for o in old_params],
                               [n.float() for n in new_params]) \
        if old_params else []
    g = _norms(list(grads), matrix)
    p = _norms(list(old_params), matrix)
    u = _norms(diffs, matrix)
    loss = loss.detach().float().reshape(1)
    bad = (~torch.isfinite(loss[0]) | ~torch.isfinite(g).all()
           | ~torch.isfinite(u).all() | (g > cfg.grad_norm_limit).any())
    vec = torch.cat([loss, bad.float().reshape(1), g, p, u / (p + _EPS)])
    return vec, bad


def layer_matrix(net) -> torch.Tensor:
    """The per-layer leaf indices of ``net`` on its device, built once
    (the one host-to-device copy of the health layer)."""
    m = getattr(net, "_health_matrix", None)
    if m is None:
        m = net._health_matrix = _layer_matrix(leaf_counts(net), net.device)
    return m


def leaf_counts(net) -> List[int]:
    return [len(net.params[key]) for key, _ in net._slots()]


def guard_select(bad, new, old):
    """Under policy ``skip_update`` a flagged step's outputs are replaced
    leaf for leaf by the pre-step values; under any other policy this is
    the identity.  ``new``/``old`` are matching nested dicts and lists of
    tensors."""
    if config().policy != "skip_update":
        return new
    return _where(bad, new, old)


def _where(bad, new, old):
    if isinstance(new, dict):
        return {k: _where(bad, v, old[k]) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        return type(new)(_where(bad, n, o) for n, o in zip(new, old))
    return torch.where(bad, old, new)


# ------------------------------------------------------------- host side
def layer_labels(model) -> List[str]:
    """Per-layer labels in the packed vector's order: layer indices for a
    ``MultiLayerNetwork``, topo-ordered vertex names for a graph."""
    return [str(key) for key, _ in model._slots()]


def _offender(row: np.ndarray, names: List[str], limit: float) -> tuple:
    """The first offending (layer, reason) of a flagged step's vector."""
    L = len(names)
    if not np.isfinite(row[0]):
        return "loss", "non-finite loss"
    for j, n in enumerate(names):
        g = row[2 + j]
        r = row[2 + 2 * L + j]
        if not np.isfinite(g):
            return n, "non-finite gradient"
        if g > limit:
            return n, f"gradient L2 {g:.3g} > limit {limit:.3g}"
        if not np.isfinite(r):
            return n, "non-finite update"
    return "unknown", "flagged"


def record_dispatch(model, stack, first_iteration: int) -> None:
    """Host half of the health layer, called once per train dispatch with
    the packed per-step stats (``(S, 2+3L)`` from the fused paths,
    ``(2+3L,)`` from the per-batch step).

    Always stamps the last-dispatch time (no device sync).  When health is
    enabled it also reads the stack (the ONE device-to-host copy per
    dispatch), publishes the ``train_health_*`` gauges from the last step,
    keeps the snapshot on the model and enforces the policy: ``abort``
    raises :class:`TrainingDivergedError` at the first flagged step and
    layer; ``warn``/``skip_update`` log and mark the process diverged."""
    now = time.time()
    with _state.lock:
        _state.last_dispatch_ts = now
    reg = registry()
    reg.gauge(LAST_DISPATCH_TS, _HELP[LAST_DISPATCH_TS]).set(now)
    cfg = config()
    if not cfg.enabled:
        return
    arr = np.atleast_2d(np.asarray(
        stack.detach().float().cpu() if isinstance(stack, torch.Tensor)
        else stack, dtype=np.float32))
    names = layer_labels(model)
    L = len(names)
    last = arr[-1]
    reg.gauge(LOSS, _HELP[LOSS]).set(float(last[0]))
    layers: Dict[str, Dict[str, float]] = {}
    for j, n in enumerate(names):
        stats = {"grad_l2": float(last[2 + j]),
                 "param_l2": float(last[2 + L + j]),
                 "update_ratio": float(last[2 + 2 * L + j])}
        layers[n] = stats
        reg.gauge(GRAD_L2, _HELP[GRAD_L2]).set(stats["grad_l2"], layer=n)
        reg.gauge(PARAM_L2, _HELP[PARAM_L2]).set(stats["param_l2"],
                                                 layer=n)
        reg.gauge(UPDATE_RATIO, _HELP[UPDATE_RATIO]).set(
            stats["update_ratio"], layer=n)
    flags = ~np.isfinite(arr[:, 1]) | (arr[:, 1] != 0.0)
    n_bad = int(flags.sum())
    snap: Dict[str, Any] = {
        "time": now,
        "model": type(model).__name__,
        "policy": cfg.policy,
        "first_iteration": int(first_iteration),
        "steps": int(arr.shape[0]),
        "flagged_steps": n_bad,
        "loss": float(last[0]),
        "layers": layers,
    }
    model._health_last = snap
    model._health_last_stack = arr
    if n_bad:
        s = int(np.argmax(flags))
        step = int(first_iteration) + s
        layer, reason = _offender(arr[s], names, cfg.grad_norm_limit)
        snap["diverged_at"] = {"step": step, "layer": layer,
                               "reason": reason}
        reg.counter(NONFINITE_TOTAL, _HELP[NONFINITE_TOTAL]).inc(n_bad)
        reg.gauge(STATE, _HELP[STATE]).set(1.0)
        with _state.lock:
            _state.diverged = True
            _state.last = snap
        msg = (f"training diverged at step {step} (layer {layer}: "
               f"{reason}); {n_bad}/{arr.shape[0]} steps in this "
               f"dispatch flagged, policy={cfg.policy}")
        # the bundle captures spans and metrics as they are at the moment
        # of divergence, before an abort unwinds (lazy import: the
        # recorder imports this module)
        from . import flight_recorder as _flight
        _flight.record_incident("divergence", dict(
            snap["diverged_at"], policy=cfg.policy,
            flagged_steps=n_bad, loss=snap["loss"]))
        if cfg.policy == "abort":
            raise TrainingDivergedError(msg, step=step, layer=layer)
        if cfg.policy == "skip_update":
            reg.counter(SKIPPED_TOTAL, _HELP[SKIPPED_TOTAL]).inc(n_bad)
        logger.warning(msg)
        return
    reg.gauge(STATE, _HELP[STATE]).set(1.0 if _state.diverged else 0.0)
    with _state.lock:
        _state.last = snap


def last_for(model) -> Optional[Dict[str, Any]]:
    """The last recorded dispatch snapshot of ``model`` (None before
    one)."""
    return getattr(model, "_health_last", None)


def last_stack_for(model) -> Optional[np.ndarray]:
    """The ``(S, 2+3L)`` per-step stats of the model's last recorded
    dispatch."""
    return getattr(model, "_health_last_stack", None)


def state() -> str:
    """``"ok"`` or ``"diverged"`` (sticky until :func:`reset`)."""
    with _state.lock:
        return "diverged" if _state.diverged else "ok"


def last_dispatch_timestamp() -> Optional[float]:
    with _state.lock:
        return _state.last_dispatch_ts


def snapshot() -> Dict[str, Any]:
    """Configuration, state and the last dispatch's per-layer stats."""
    cfg = config()
    with _state.lock:
        return {
            "enabled": cfg.enabled,
            "policy": cfg.policy,
            "grad_norm_limit": cfg.grad_norm_limit,
            "state": "diverged" if _state.diverged else "ok",
            "last_dispatch_timestamp": _state.last_dispatch_ts,
            "last_dispatch": _state.last,
        }
