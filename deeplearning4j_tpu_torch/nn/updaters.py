"""Updaters, learning-rate policies and gradient normalization (port of
``deeplearning4j_tpu/nn/updaters.py``).

DL4J's order of operations, per layer:

1. l1/l2 regularization into the raw gradient
   (``gradient += l2 * param + l1 * sign(param)``);
2. gradient normalization (RenormalizeL2PerLayer, ..., ClipL2PerParamType);
3. the learning-rate policy for the current iteration, momentum and the
   per-param updater rule, giving the step that is subtracted from the
   params.

All seven rules of the JAX package are here (sgd, nesterovs, adagrad,
rmsprop, adam, adadelta, lars, plus none).  Updater state is a dict of
dicts of tensors mirroring the params; under a mixed precision policy it
also carries fp32 masters under ``"_master"``.  Updates are applied under
``torch.no_grad`` and build new tensors (the JAX package's functional
form), so a caller's references to the old params stay valid.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .conf import serde as _serde

Tensor = torch.Tensor
ParamTree = Dict[str, Tensor]

_EPS_ADAGRAD = 1e-6
_EPS_ADAM = 1e-8
_EPS_ADADELTA = 1e-6
_EPS_RMSPROP = 1e-8

MASTER_KEY = "_master"


@_serde.register("updater_conf", custom=True)
@dataclasses.dataclass
class UpdaterConfig:
    """Serializable updater hyperparameters (same fields and JSON as the
    JAX package's ``UpdaterConfig``)."""

    updater: str = "sgd"
    learning_rate: float = 0.1
    lr_policy: str = "none"
    lr_policy_decay_rate: float = 0.0
    lr_policy_power: float = 1.0
    lr_policy_steps: float = 1.0
    max_num_iterations: int = 1
    lr_schedule: Optional[Dict[int, float]] = None
    momentum: float = 0.9
    momentum_schedule: Optional[Dict[int, float]] = None
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    rms_decay: float = 0.95
    rho: float = 0.95
    epsilon: float = 1e-6
    lars_trust_coefficient: float = 0.001
    lars_weight_decay: float = 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("lr_schedule", "momentum_schedule"):
            if d[k] is not None:
                d[k] = {str(i): v for i, v in d[k].items()}
        return d

    @staticmethod
    def from_dict(d: dict) -> "UpdaterConfig":
        d = dict(d)
        for k in ("lr_schedule", "momentum_schedule"):
            if d.get(k):
                d[k] = {int(i): v for i, v in d[k].items()}
        return UpdaterConfig(**d)


# ---------------------------------------------------------------------------
# Learning-rate policies: numpy float32 on the host, in the JAX package's
# operation order (it traces lr, the iteration and every power/exp in
# float32, and XLA turns a division by a constant into a product with its
# float32 reciprocal); a captured step reads them from a device table:
# step_scalars
# ---------------------------------------------------------------------------

_f32 = np.float32


def _learning_rate_f32(conf: UpdaterConfig, iteration: int) -> np.float32:
    lr = _f32(conf.learning_rate)
    it = _f32(iteration)
    policy = conf.lr_policy.lower()
    decay = _f32(conf.lr_policy_decay_rate)
    power = _f32(conf.lr_policy_power)
    one = _f32(1.0)
    if policy in ("none", ""):
        return lr
    if policy == "exponential":
        return lr * np.power(decay, it)
    if policy == "inverse":
        return lr / np.power(one + decay * it, power)
    if policy in ("step", "torchstep"):
        return lr * np.power(decay, np.floor(
            it * (one / _f32(conf.lr_policy_steps))))
    if policy == "poly":
        frac = np.clip(it * (one / _f32(max(conf.max_num_iterations, 1))),
                       _f32(0.0), one)
        return lr * np.power(one - frac, power)
    if policy == "sigmoid":
        return lr / (one + np.exp(-decay * (it - _f32(conf.lr_policy_steps))))
    if policy == "schedule":
        out = lr
        for step, value in sorted((conf.lr_schedule or {}).items()):
            if it >= step:
                out = _f32(value)
        return out
    raise ValueError(f"Unknown lr policy '{conf.lr_policy}'")


def learning_rate_for(conf: UpdaterConfig, iteration: int) -> float:
    """Effective learning rate at ``iteration``: a float32 value, as the
    JAX package computes it, returned as a Python float."""
    return float(_learning_rate_f32(conf, iteration))


def momentum_for(conf: UpdaterConfig, iteration: int) -> float:
    """Momentum at ``iteration``, a float32 value as a Python float."""
    mu = _f32(conf.momentum)
    for step, value in sorted((conf.momentum_schedule or {}).items()):
        if _f32(iteration) >= step:
            mu = _f32(value)
    return float(mu)


def step_scalars(conf: UpdaterConfig, iteration: int) -> Dict[str, float]:
    """Every scalar of :func:`compute_update` that depends on the
    iteration, each a float32 value as the JAX package traces it:
    ``lr``; ``mu`` and ``mu1`` (``1 + mu``) for the momentum rules;
    ``alpha``, the bias-corrected Adam step.  A CUDA-graph step
    (``nn/step_graph.py``) cannot take host floats that change from
    replay to replay, so it reads these from a device table the host
    filled with this function, and :func:`compute_update` takes them
    there as 0-dim tensors."""
    name = conf.updater.lower()
    lr = learning_rate_for(conf, iteration)
    if name in ("sgd", "adagrad", "rmsprop"):
        return {"lr": lr}
    if name in ("nesterovs", "lars"):
        mu = momentum_for(conf, iteration)
        return {"lr": lr, "mu": mu, "mu1": float(_f32(1.0) + _f32(mu))}
    if name == "adam":
        # bias-corrected step (reference Adam.getGradient), in float32 as
        # the JAX package traces it (lr, t and the decays as f32)
        t = _f32(iteration) + _f32(1.0)
        alpha = _f32(lr) * np.sqrt(_f32(1.0) - np.power(
            _f32(conf.adam_var_decay), t)) / (_f32(1.0) - np.power(
                _f32(conf.adam_mean_decay), t))
        return {"alpha": float(alpha)}
    return {}


def _mul(s, t: Tensor) -> Tensor:
    """``s * t`` for a host float ``s``, or the same value for a 0-dim
    tensor ``s``: PyTorch rounds a host scalar to the op's math type
    (float32 for bf16/f16/f32, float64 for f64) and rounds the product to
    ``t``'s dtype, so the tensor form does exactly that."""
    if not isinstance(s, Tensor):
        return s * t
    if t.dtype in (torch.bfloat16, torch.float16):
        return (s.float() * t.float()).to(t.dtype)
    return s.to(t.dtype) * t


# ---------------------------------------------------------------------------
# Gradient normalization
# ---------------------------------------------------------------------------

def _global_norm(grads: ParamTree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))


def normalize_gradients(grads: ParamTree, mode: Optional[str],
                        threshold: float = 1.0) -> ParamTree:
    """Apply a DL4J ``GradientNormalization`` mode over one layer's grads."""
    if not mode or mode.lower() == "none":
        return grads
    mode = mode.lower()
    if mode == "renormalizel2perlayer":
        scale = 1.0 / torch.clamp_min(_global_norm(grads), 1e-12)
        return {k: g * scale for k, g in grads.items()}
    if mode == "renormalizel2perparamtype":
        return {k: g / torch.clamp_min(torch.linalg.norm(g.reshape(-1)),
                                       1e-12)
                for k, g in grads.items()}
    if mode == "clipelementwiseabsolutevalue":
        return {k: torch.clamp(g, -threshold, threshold)
                for k, g in grads.items()}
    if mode == "clipl2perlayer":
        norm = _global_norm(grads)
        scale = torch.where(norm > threshold, threshold / norm,
                            torch.ones_like(norm))
        return {k: g * scale for k, g in grads.items()}
    if mode == "clipl2perparamtype":
        def clip_one(g):
            norm = torch.linalg.norm(g.reshape(-1))
            return g * torch.where(norm > threshold, threshold / norm,
                                   torch.ones_like(norm))
        return {k: clip_one(g) for k, g in grads.items()}
    raise ValueError(f"Unknown gradient normalization '{mode}'")


# ---------------------------------------------------------------------------
# Per-param updaters
# ---------------------------------------------------------------------------

def init_state(conf: UpdaterConfig, params: ParamTree,
               policy=None) -> Dict[str, Any]:
    """Zero updater state mirroring ``params`` (adam keeps m and v,
    nesterovs and lars a velocity, ...).  Under a policy with
    ``master_weights`` and sub-fp32 params, fp32 masters ride along under
    ``"_master"``."""
    name = conf.updater.lower()

    def zeros():
        return {k: torch.zeros(p.shape, device=p.device,
                               dtype=policy.updater_dtype if policy
                               else p.dtype)
                for k, p in params.items()}

    if name in ("sgd", "none", "noop"):
        state: Dict[str, Any] = {}
    elif name in ("nesterovs", "lars"):
        state = {"v": zeros()}
    elif name == "adagrad":
        state = {"h": zeros()}
    elif name == "rmsprop":
        state = {"cache": zeros()}
    elif name == "adam":
        state = {"m": zeros(), "v": zeros()}
    elif name == "adadelta":
        state = {"msg": zeros(), "msdx": zeros()}
    else:
        raise ValueError(f"Unknown updater '{conf.updater}'")
    if policy is not None and policy.master_weights and any(
            p.is_floating_point() and p.element_size() < 4
            for p in params.values()):
        state[MASTER_KEY] = {k: p.detach().float().clone()
                             for k, p in params.items()}
    return state


def compute_update(conf: UpdaterConfig, grads: ParamTree, state: dict,
                   iteration: int, params: Optional[ParamTree] = None,
                   scalars: Optional[Dict[str, Any]] = None):
    """Turn (regularized, normalized) grads into the step to subtract.
    Returns ``(updates, new_state)``.  ``scalars`` overrides
    :func:`step_scalars` of ``iteration`` (0-dim tensors of a captured
    step)."""
    name = conf.updater.lower()
    sc = step_scalars(conf, iteration) if scalars is None else scalars
    if name in ("none", "noop"):
        return grads, state
    if name == "sgd":
        return {k: _mul(sc["lr"], g) for k, g in grads.items()}, state
    if name == "nesterovs":
        mu, lr = sc["mu"], sc["lr"]
        v_prev = state["v"]
        v_new = {k: _mul(mu, v_prev[k]) - _mul(lr, g)
                 for k, g in grads.items()}
        # reference Nesterovs.getGradient: step = mu*vPrev - (1+mu)*vNew
        updates = {k: _mul(mu, v_prev[k]) - _mul(sc["mu1"], v_new[k])
                   for k in grads}
        return updates, {"v": v_new}
    if name == "adagrad":
        h = {k: state["h"][k] + torch.square(g) for k, g in grads.items()}
        updates = {k: _mul(sc["lr"], g) / (torch.sqrt(h[k]) + _EPS_ADAGRAD)
                   for k, g in grads.items()}
        return updates, {"h": h}
    if name == "rmsprop":
        d = conf.rms_decay
        cache = {k: d * state["cache"][k] + (1.0 - d) * torch.square(g)
                 for k, g in grads.items()}
        updates = {k: _mul(sc["lr"], g)
                   / (torch.sqrt(cache[k]) + _EPS_RMSPROP)
                   for k, g in grads.items()}
        return updates, {"cache": cache}
    if name == "adam":
        b1, b2 = conf.adam_mean_decay, conf.adam_var_decay
        m = {k: b1 * state["m"][k] + (1 - b1) * g for k, g in grads.items()}
        v = {k: b2 * state["v"][k] + (1 - b2) * torch.square(g)
             for k, g in grads.items()}
        updates = {k: _mul(sc["alpha"], m[k]) / (torch.sqrt(v[k]) + _EPS_ADAM)
                   for k in grads}
        return updates, {"m": m, "v": v}
    if name == "adadelta":
        rho, eps = conf.rho, conf.epsilon or _EPS_ADADELTA
        msg = {k: rho * state["msg"][k] + (1 - rho) * torch.square(g)
               for k, g in grads.items()}
        updates = {k: g * torch.sqrt(state["msdx"][k] + eps)
                   / torch.sqrt(msg[k] + eps) for k, g in grads.items()}
        msdx = {k: rho * state["msdx"][k] + (1 - rho) * torch.square(u)
                for k, u in updates.items()}
        return updates, {"msg": msg, "msdx": msdx}
    if name == "lars":
        if params is None:
            raise ValueError("lars needs the params (trust ratios are "
                             "weight-norm relative)")
        eta, wd = conf.lars_trust_coefficient, conf.lars_weight_decay
        mu, lr = sc["mu"], sc["lr"]

        def one(w, g, v):
            w_norm = torch.linalg.norm(w.reshape(-1))
            g_norm = torch.linalg.norm(g.reshape(-1))
            trust = torch.where(
                (w_norm > 0) & (g_norm > 0),
                eta * w_norm / (g_norm + wd * w_norm + 1e-12),
                torch.ones_like(w_norm))
            return _mul(mu, v) + _mul(lr, trust) * (g + wd * w)

        v_new = {k: one(params[k], g, state["v"][k])
                 for k, g in grads.items()}
        return v_new, {"v": v_new}
    raise ValueError(f"Unknown updater '{conf.updater}'")


def regularize(grads: ParamTree, params: ParamTree,
               l1_by_param: Dict[str, float],
               l2_by_param: Dict[str, float]) -> ParamTree:
    """``gradient += l2 * param + l1 * sign(param)``, per param name."""
    out = {}
    for k, g in grads.items():
        l1 = l1_by_param.get(k, 0.0)
        l2 = l2_by_param.get(k, 0.0)
        if l2:
            g = g + l2 * params[k]
        if l1:
            g = g + l1 * torch.sign(params[k])
        out[k] = g
    return out


def regularization_score(params: ParamTree, l1_by_param: Dict[str, float],
                         l2_by_param: Dict[str, float]):
    """0.5*l2*||w||^2 + l1*||w||_1 over the layer's params, in fp32 (fp64
    for fp64 params); the float 0.0 when the layer has no
    regularization."""
    terms = []
    for k, p in params.items():
        l1 = l1_by_param.get(k, 0.0)
        l2 = l2_by_param.get(k, 0.0)
        if l1 or l2:
            p = p if p.dtype == torch.float64 else p.float()
        if l2:
            terms.append(0.5 * l2 * torch.sum(torch.square(p)))
        if l1:
            terms.append(l1 * torch.sum(torch.abs(p)))
    return sum(terms) if terms else 0.0


def updatable_params(layer, params: ParamTree) -> ParamTree:
    """The params of a layer that go through the updater: all but its
    ``direct_update_params``, which carry no updater state (so a flat
    updater vector keeps the JAX package's length)."""
    direct = set(layer.direct_update_params())
    if not direct:
        return params
    return {k: v for k, v in params.items() if k not in direct}


def apply_layer_updates(uconf: UpdaterConfig, layer, params: ParamTree,
                        state: dict, grads: ParamTree, iteration: int,
                        scalars: Optional[Dict[str, Any]] = None):
    """Full DL4J-order update of one layer: returns ``(new_params,
    new_state)``.  With fp32 masters in ``state`` every step of the
    updater math runs on the masters in fp32 and the storage params are
    re-derived by one cast.  The layer's ``direct_update_params`` go
    around all of it as ``p -= g`` (in fp32 for sub-fp32 storage).
    ``scalars``: see :func:`compute_update`."""
    if getattr(layer, "frozen", False):
        return dict(params), state
    masters = state.get(MASTER_KEY)
    g = dict(grads)
    g_direct = {k: g.pop(k) for k in layer.direct_update_params() if k in g}
    if masters is not None:
        work = {k: masters[k] for k in g}
        g = {k: v.float() for k, v in g.items()}
        mstate = {k: v for k, v in state.items() if k != MASTER_KEY}
    else:
        work = {k: params[k] for k in g}
        mstate = state
    g = regularize(g, work, layer.l1_by_param(), layer.l2_by_param())
    g = normalize_gradients(g, layer.gradient_normalization,
                            layer.gradient_normalization_threshold)
    updates, new_state = compute_update(uconf, g, mstate, iteration,
                                        params=work, scalars=scalars)
    new_params = dict(params)
    if masters is not None:
        new_masters = dict(masters)
        for k, u in updates.items():
            new_masters[k] = work[k] - u
            new_params[k] = new_masters[k].to(params[k].dtype)
        new_state = dict(new_state)
        new_state[MASTER_KEY] = new_masters
    else:
        for k, u in updates.items():
            new_params[k] = params[k] - u
    for k, gd in g_direct.items():
        p = params[k]
        if p.element_size() < 4:
            new_params[k] = (p.float() - gd.float()).to(p.dtype)
        else:
            new_params[k] = p - gd
    return new_params, new_state
