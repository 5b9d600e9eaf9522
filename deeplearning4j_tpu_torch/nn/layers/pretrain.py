"""Unsupervised pretraining layers: AutoEncoder and RBM (port of
``deeplearning4j_tpu/nn/layers/pretrain.py``).

Param layout ``W`` (n_in, n_out), ``b`` (n_out,), ``vb`` (n_in,): the
visible bias exists for the unsupervised phase only, so the supervised
``forward`` (encode / propUp) reads ``W`` and ``b`` alone.

Each pretrainable layer exposes ``pretrain_grads(params, x, draws) ->
(score, grads)``, one unsupervised step's score and parameter gradients,
which ``MultiLayerNetwork.pretrain``/``ComputationGraph.pretrain`` feed
through the DL4J-order updater.  The AutoEncoder's gradients are autograd
of its reconstruction loss; contrastive divergence is the gradient of no
loss, so the RBM computes its CD-k statistics explicitly.

Random draws are explicit inputs (a deliberate difference of RNG
streams): ``pretrain_draw_specs(batch)`` lists the uniforms and normals a
step consumes, in the order of the JAX package's keys, and
``pretrain_grads`` takes them as tensors.  A Bernoulli sample is ``u <
p`` (``jax.random.bernoulli`` in its default mode).  The network draws
them from a ``torch.Generator`` seeded by its seed and the iteration
(:func:`pretrain_seed`); parity tests feed the JAX package's draws
instead (``fold_in(PRNGKey(seed), iteration)``, then ``split(rng, 2k+1)``
for the RBM).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import lossfunctions as _losses
from ..conf import serde
from ..weights import init_weights
from .base import FeedForwardLayerConfig, ParamTree, StateTree, Tensor

#: one random input of a pretrain step: ("uniform" | "normal", shape), or
#: None where the JAX package draws a key whose values nothing reads
DrawSpec = Optional[Tuple[str, Tuple[int, ...]]]
Draws = Sequence[Optional[Tensor]]


def pretrain_seed(seed: int, iteration: int) -> int:
    """The generator seed of one pretrain step: the network's seed and the
    iteration mixed by ``np.random.SeedSequence``, the role of
    ``fold_in(PRNGKey(seed), iteration)`` in the JAX package."""
    state = np.random.SeedSequence(
        [int(seed) % 2 ** 64, int(iteration)]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def draw_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a network draws in for a computation in ``dtype``:
    float64 for float64, else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def make_draws(specs: Sequence[DrawSpec], gen: torch.Generator,
               device, dtype: torch.dtype) -> List[Optional[Tensor]]:
    """The tensors of ``specs`` from ``gen`` (a generator on ``device``),
    in order."""
    out: List[Optional[Tensor]] = []
    for spec in specs:
        if spec is None:
            out.append(None)
            continue
        kind, shape = spec
        fn = torch.rand if kind == "uniform" else torch.randn
        out.append(fn(tuple(shape), generator=gen, device=device,
                      dtype=dtype))
    return out


def host_pretrain_draws(seed: int):
    """A ``pretrain_draw_source`` whose draws come from a CPU generator
    seeded by ``seed`` and the iteration, in float32: a network on the
    card and one on the CPU then take the same draws (card-against-CPU
    checks)."""
    def source(layer, iteration: int, specs: Sequence[DrawSpec]):
        gen = torch.Generator().manual_seed(pretrain_seed(seed, iteration))
        return make_draws(specs, gen, "cpu", torch.float32)
    return source


def check_draws(specs: Sequence[DrawSpec], draws: Draws, where: str) -> None:
    """Raise unless ``draws`` has a tensor of each spec's shape (and None
    where the spec is None)."""
    if len(draws) != len(specs):
        raise ValueError(f"{where}: {len(draws)} draws for {len(specs)} "
                         "specs")
    for spec, d in zip(specs, draws):
        want = None if spec is None else tuple(spec[1])
        got = None if d is None else tuple(d.shape)
        if spec is not None and got != want:
            raise ValueError(f"{where}: a draw of shape {got}; expected "
                             f"{want}")


def bernoulli(u: Tensor, p: Tensor) -> Tensor:
    """``u < p`` as ``p``'s dtype (``jax.random.bernoulli``'s low mode)."""
    return (u < p).to(p.dtype)


def autograd_pretrain_grads(loss_fn, params: ParamTree, *args):
    """``(loss, grads)`` of ``loss_fn(params, *args)`` by autograd, every
    param a fresh leaf (a param the loss does not read gets zeros)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves, *args)
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), got)}
    return loss.detach(), grads


@dataclasses.dataclass
class BasePretrainLayer(FeedForwardLayerConfig):
    """What AutoEncoder and RBM share: params ``W, b, vb``, the visible
    bias regularized like a bias, and the encode-only supervised
    forward."""

    IS_PRETRAINABLE = True

    loss: str = "xent"  # reconstruction loss
    visible_bias_init: float = 0.0

    def param_order(self) -> tuple[str, ...]:
        return ("W", "b", "vb")

    def init_params(self, gen: torch.Generator, dtype: torch.dtype,
                    device: torch.device) -> ParamTree:
        return {
            "W": init_weights(gen, (self.n_in, self.n_out),
                              self.weight_init or "xavier", self.dist, dtype,
                              device),
            "b": torch.full((self.n_out,), float(self.bias_init or 0.0),
                            dtype=dtype, device=device),
            "vb": torch.full((self.n_in,), float(self.visible_bias_init),
                             dtype=dtype, device=device),
        }

    def l1_by_param(self) -> Dict[str, float]:
        return {k: ((self.l1_bias if k in ("b", "vb") else self.l1) or 0.0)
                for k in self.param_order()}

    def l2_by_param(self) -> Dict[str, float]:
        return {k: ((self.l2_bias if k in ("b", "vb") else self.l2) or 0.0)
                for k in self.param_order()}

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None) -> Tuple[Tensor, StateTree]:
        x = self.apply_dropout(x, train, rng)
        return self._activate(x @ params["W"] + params["b"]), state

    # -- unsupervised phase ------------------------------------------------
    def pretrain_draw_specs(self, batch: int) -> List[DrawSpec]:
        return []

    def pretrain_loss(self, params: ParamTree, x: Tensor,
                      draws: Draws) -> Tensor:
        raise NotImplementedError

    def pretrain_grads(self, params: ParamTree, x: Tensor, draws: Draws):
        return autograd_pretrain_grads(self.pretrain_loss, params, x, draws)


@serde.register("autoencoder")
@dataclasses.dataclass
class AutoEncoder(BasePretrainLayer):
    """Denoising autoencoder with tied weights: encode ``act(x W + b)``,
    decode ``act(y W^T + vb)``.  The pretrain loss is the configured
    reconstruction loss of decode(encode(corrupt(x))) against the *clean*
    input, plus the KL sparsity penalty on the mean hidden activation when
    ``sparsity`` > 0; corruption zeroes each input with probability
    ``corruption_level`` (one uniform per input)."""

    corruption_level: float = 0.3
    sparsity: float = 0.0

    def encode(self, params: ParamTree, x: Tensor) -> Tensor:
        return self._activate(x @ params["W"] + params["b"])

    def decode_preact(self, params: ParamTree, y: Tensor) -> Tensor:
        return y @ params["W"].T + params["vb"]

    def decode(self, params: ParamTree, y: Tensor) -> Tensor:
        return self._activate(self.decode_preact(params, y))

    def reconstruct(self, params: ParamTree, x: Tensor) -> Tensor:
        return self.decode(params, self.encode(params, x))

    def pretrain_draw_specs(self, batch: int) -> List[DrawSpec]:
        if self.corruption_level > 0:
            return [("uniform", (batch, self.n_in))]
        return []

    def pretrain_loss(self, params: ParamTree, x: Tensor,
                      draws: Draws) -> Tensor:
        corrupted = x
        if self.corruption_level > 0:
            keep = draws[0] < 1.0 - self.corruption_level
            corrupted = torch.where(keep, x, torch.zeros_like(x))
        y = self.encode(params, corrupted)
        pre_z = self.decode_preact(params, y)
        loss = _losses.score(self.loss, x, pre_z, self.activation or "sigmoid",
                             None, True)
        if self.sparsity > 0:
            # KL(sparsity || mean activation) over the hidden units
            rho_hat = torch.clamp(y.mean(dim=0), 1e-7, 1 - 1e-7)
            rho = self.sparsity
            loss = loss + torch.sum(
                rho * torch.log(rho / rho_hat)
                + (1 - rho) * torch.log((1 - rho) / (1 - rho_hat)))
        return loss


@serde.register("rbm")
@dataclasses.dataclass
class RBM(BasePretrainLayer):
    """Restricted Boltzmann machine trained by CD-k.  Hidden units
    ``binary`` (sigmoid probabilities, Bernoulli samples) or ``rectified``
    (relu mean, N(mean, sigmoid(mean)) samples clipped at 0); visible
    units ``binary`` or ``gaussian`` (identity mean; the chain uses the
    mean, as the JAX package does).  The supervised forward is propUp
    with the layer activation."""

    hidden_unit: str = "binary"
    visible_unit: str = "binary"
    k: int = 1
    sparsity: float = 0.0

    activation: Optional[str] = "sigmoid"

    def prop_up(self, params: ParamTree, v: Tensor) -> Tensor:
        pre = v @ params["W"] + params["b"]
        if self.hidden_unit == "binary":
            return torch.sigmoid(pre)
        if self.hidden_unit == "rectified":
            return torch.relu(pre)
        raise ValueError(f"Unsupported hidden unit {self.hidden_unit!r}")

    def prop_down_pre(self, params: ParamTree, h: Tensor) -> Tensor:
        return h @ params["W"].T + params["vb"]

    def _visible_act(self, pre: Tensor) -> Tensor:
        if self.visible_unit == "binary":
            return torch.sigmoid(pre)
        if self.visible_unit == "gaussian":
            return pre
        raise ValueError(f"Unsupported visible unit {self.visible_unit!r}")

    def prop_down(self, params: ParamTree, h: Tensor) -> Tensor:
        return self._visible_act(self.prop_down_pre(params, h))

    def _sample_h(self, draw: Tensor, hprob: Tensor) -> Tensor:
        if self.hidden_unit == "binary":
            return bernoulli(draw, hprob)
        noise = draw.to(hprob.dtype)
        return torch.relu(hprob + noise * torch.sqrt(
            torch.sigmoid(hprob) + 1e-8))

    def pretrain_draw_specs(self, batch: int) -> List[DrawSpec]:
        """``2k+1`` entries in the order of the JAX package's keys: the
        first hidden sample, then per chain step the visible sample
        (binary visible units only) and the hidden sample.  The last
        hidden sample is never read."""
        h = ("uniform" if self.hidden_unit == "binary" else "normal",
             (batch, self.n_out))
        v = (("uniform", (batch, self.n_in))
             if self.visible_unit == "binary" else None)
        specs: List[DrawSpec] = [h]
        for step in range(self.k):
            specs += [v, h if step < self.k - 1 else None]
        return specs

    def pretrain_grads(self, params: ParamTree, x: Tensor, draws: Draws):
        batch = x.shape[0]
        hprob0 = self.prop_up(params, x)
        hsamp = self._sample_h(draws[0], hprob0)
        vprob, hprob, pre_vk = x, hprob0, x
        for step in range(self.k):
            pre_vk = self.prop_down_pre(params, hsamp)
            vprob = self._visible_act(pre_vk)
            vsamp = (bernoulli(draws[2 * step + 1], vprob)
                     if self.visible_unit == "binary" else vprob)
            hprob = self.prop_up(params, vsamp)
            if step < self.k - 1:
                hsamp = self._sample_h(draws[2 * step + 2], hprob)
        vk, hk = vprob, hprob
        # likelihood ascent: the updater subtracts, so the gradient is the
        # negated (positive - negative) statistics
        grads = {
            "W": -(x.T @ hprob0 - vk.T @ hk) / batch,
            "b": -torch.mean(hprob0 - hk, dim=0),
            "vb": -torch.mean(x - vk, dim=0),
        }
        # the monitored score: reconstruction error against the chain's
        # last negative visible phase
        act = "sigmoid" if self.visible_unit == "binary" else "identity"
        score = _losses.score(self.loss if self.visible_unit == "binary"
                              else "mse", x, pre_vk, act, None, True)
        return score, grads

    def free_energy(self, params: ParamTree, v: Tensor) -> Tensor:
        """Mean free energy ``F(v) = -v.vb - sum log(1 + e^{vW+b})``."""
        pre = v @ params["W"] + params["b"]
        return torch.mean(-v @ params["vb"]
                          - torch.nn.functional.softplus(pre).sum(dim=-1))
