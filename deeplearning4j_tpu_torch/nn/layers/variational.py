"""Variational autoencoder and its reconstruction distributions (port of
``deeplearning4j_tpu/nn/layers/variational.py``).

- The encoder MLP gives the pre-activations of q(z|x)'s mean and log
  sigma^2 (two heads on the last encoder activation, ``pzx_activation``
  on both).
- The pretrain loss is the analytic KL[q(z|x) || N(0, I)] averaged over
  the minibatch, plus the reconstruction negative log probability summed
  over the ``num_samples`` Monte Carlo samples and averaged over samples
  and minibatch.  Its gradients are autograd's.
- ``z = mean + sigma * eps``; the decoder MLP gives the distribution's
  pre-activations.

The normals ``eps`` are explicit inputs (``pretrain_draw_specs``: one
(batch, n_out) normal per sample, the JAX package's ``fold_in(rng, s)``),
as are the draws of ``reconstruction_log_probability`` and of
``generate_random_given_z``; see :mod:`.pretrain` for the network's own
stream.  The supervised ``forward`` returns ``pzx_activation`` of the
mean head: a VAE inside a backprop net contributes its posterior mean.

Param keys and order are the JAX package's: ``e{i}W``/``e{i}b`` (encoder),
``pZXMeanW``/``pZXMeanb``/``pZXLogStd2W``/``pZXLogStd2b`` (posterior
heads), ``d{i}W``/``d{i}b`` (decoder), ``pXZW``/``pXZb`` (reconstruction
head).  The distributions keep the JAX serde names (``*_reconstruction``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import activations as _activations
from .. import lossfunctions as _losses
from ..conf import serde
from ..weights import init_weights
from .base import FeedForwardLayerConfig, ParamTree, StateTree, Tensor
from .pretrain import (DrawSpec, Draws, autograd_pretrain_grads, bernoulli,
                       draw_dtype, make_draws)

_NEG_HALF_LOG_2PI = -0.5 * math.log(2.0 * math.pi)

#: the lower end of an exponential sample's uniforms (the JAX package draws
#: them in [1e-10, 1); a draw below is clamped to it)
_EXP_U_MIN = 1e-10


# --------------------------------------------------------------------------
# Reconstruction distributions
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ReconstructionDistribution:
    """p(x|z) parameterized by decoder pre-activations.  ``sample`` takes
    the draws of ``sample_specs`` (one entry for a simple distribution,
    one per part for a composite)."""

    activation: str = "identity"

    def input_size(self, data_size: int) -> int:
        return data_size

    def neg_log_prob_examples(self, x: Tensor, preout: Tensor) -> Tensor:
        """-log p(x|preout) per example, shape (batch,)."""
        raise NotImplementedError

    def neg_log_prob(self, x: Tensor, preout: Tensor) -> Tensor:
        """-log p(x|preout) summed over batch and features."""
        return self.neg_log_prob_examples(x, preout).sum()

    def generate_at_mean(self, preout: Tensor) -> Tensor:
        raise NotImplementedError

    def sample_specs(self, rows: int, data_size: int) -> List[DrawSpec]:
        return [None]

    def sample(self, preout: Tensor, draws: Draws) -> Tensor:
        raise NotImplementedError


@serde.register("gaussian_reconstruction")
@dataclasses.dataclass
class GaussianReconstructionDistribution(ReconstructionDistribution):
    """preout is ``[mean | log sigma^2]`` (twice the data size), the
    activation applied to both halves."""

    def input_size(self, data_size: int) -> int:
        return 2 * data_size

    def _params(self, preout: Tensor) -> Tuple[Tensor, Tensor]:
        out = _activations.get(self.activation)(preout)
        size = preout.shape[-1] // 2
        return out[..., :size], out[..., size:]

    def neg_log_prob_examples(self, x: Tensor, preout: Tensor) -> Tensor:
        mean, log_sigma2 = self._params(preout)
        sigma2 = torch.exp(log_sigma2)
        log_prob = ((preout.shape[-1] // 2) * _NEG_HALF_LOG_2PI
                    - 0.5 * log_sigma2.sum(dim=-1)
                    - ((x - mean) ** 2 / (2.0 * sigma2)).sum(dim=-1))
        return -log_prob

    def generate_at_mean(self, preout: Tensor) -> Tensor:
        return self._params(preout)[0]

    def sample_specs(self, rows: int, data_size: int) -> List[DrawSpec]:
        return [("normal", (rows, data_size))]

    def sample(self, preout: Tensor, draws: Draws) -> Tensor:
        mean, log_sigma2 = self._params(preout)
        return mean + torch.exp(0.5 * log_sigma2) * draws[0].to(mean.dtype)


@serde.register("bernoulli_reconstruction")
@dataclasses.dataclass
class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """Bernoulli over each feature, sigmoid by default (then scored in the
    fused softplus form)."""

    activation: str = "sigmoid"

    def neg_log_prob_examples(self, x: Tensor, preout: Tensor) -> Tensor:
        if self.activation == "sigmoid":
            return (F.softplus(preout) - x * preout).sum(dim=-1)
        p = torch.clamp(_activations.get(self.activation)(preout), 1e-10,
                        1 - 1e-10)
        return -(x * torch.log(p) + (1 - x) * torch.log1p(-p)).sum(dim=-1)

    def generate_at_mean(self, preout: Tensor) -> Tensor:
        return _activations.get(self.activation)(preout)

    def sample_specs(self, rows: int, data_size: int) -> List[DrawSpec]:
        return [("uniform", (rows, data_size))]

    def sample(self, preout: Tensor, draws: Draws) -> Tensor:
        return bernoulli(draws[0], self.generate_at_mean(preout))


@serde.register("exponential_reconstruction")
@dataclasses.dataclass
class ExponentialReconstructionDistribution(ReconstructionDistribution):
    """The network models gamma = log(lambda): log p(x) = gamma - lambda
    x.  A sample takes uniforms in [1e-10, 1)."""

    def neg_log_prob_examples(self, x: Tensor, preout: Tensor) -> Tensor:
        gamma = _activations.get(self.activation)(preout)
        return -(gamma - torch.exp(gamma) * x).sum(dim=-1)

    def generate_at_mean(self, preout: Tensor) -> Tensor:
        gamma = _activations.get(self.activation)(preout)
        return torch.exp(-gamma)  # mean = 1/lambda

    def sample_specs(self, rows: int, data_size: int) -> List[DrawSpec]:
        return [("uniform", (rows, data_size))]

    def sample(self, preout: Tensor, draws: Draws) -> Tensor:
        gamma = _activations.get(self.activation)(preout)
        u = torch.clamp_min(draws[0].to(gamma.dtype), _EXP_U_MIN)
        return -torch.log(u) * torch.exp(-gamma)


@serde.register("loss_wrapper_reconstruction")
@dataclasses.dataclass
class LossFunctionWrapper(ReconstructionDistribution):
    """A loss function as an (improper) reconstruction distribution: its
    per-example loss, no probabilistic reading; a sample is the mean."""

    loss: str = "mse"

    def neg_log_prob_examples(self, x: Tensor, preout: Tensor) -> Tensor:
        return _losses.score_examples(self.loss, x, preout, self.activation)

    def generate_at_mean(self, preout: Tensor) -> Tensor:
        return _activations.get(self.activation)(preout)

    def sample(self, preout: Tensor, draws: Draws) -> Tensor:
        return self.generate_at_mean(preout)


@serde.register("composite_reconstruction")
@dataclasses.dataclass
class CompositeReconstructionDistribution(ReconstructionDistribution):
    """Distributions over slices of the data vector: ``parts`` is a list
    of ``(data_size, distribution)`` pairs.  A sample takes one draw per
    part (the JAX package's ``split(rng, len(parts))``)."""

    parts: Sequence[Tuple[int, ReconstructionDistribution]] = ()

    def __post_init__(self):
        # from JSON the parts arrive as [[size, {"type": ...}], ...]
        decoded = []
        for size, dist in self.parts:
            if isinstance(dist, dict):
                dist = serde.from_dict(dist)
            decoded.append((int(size), dist))
        self.parts = tuple(decoded)

    def input_size(self, data_size: int) -> int:
        total = sum(size for size, _ in self.parts)
        if total != data_size:
            raise ValueError(
                f"Composite parts cover {total} features, data has "
                f"{data_size}")
        return sum(dist.input_size(size) for size, dist in self.parts)

    def _slices(self):
        x_off = p_off = 0
        for size, dist in self.parts:
            p_size = dist.input_size(size)
            yield (slice(x_off, x_off + size),
                   slice(p_off, p_off + p_size), dist)
            x_off += size
            p_off += p_size

    def neg_log_prob_examples(self, x: Tensor, preout: Tensor) -> Tensor:
        total = None
        for xs, ps, dist in self._slices():
            part = dist.neg_log_prob_examples(x[..., xs], preout[..., ps])
            total = part if total is None else total + part
        return total

    def generate_at_mean(self, preout: Tensor) -> Tensor:
        return torch.cat([dist.generate_at_mean(preout[..., ps])
                          for _, ps, dist in self._slices()], dim=-1)

    def sample_specs(self, rows: int, data_size: int) -> List[DrawSpec]:
        return [dist.sample_specs(rows, size)[0]
                for size, dist in self.parts]

    def sample(self, preout: Tensor, draws: Draws) -> Tensor:
        return torch.cat([dist.sample(preout[..., ps], [draws[i]])
                          for i, (_, ps, dist) in enumerate(self._slices())],
                         dim=-1)


# --------------------------------------------------------------------------
# The layer
# --------------------------------------------------------------------------


@serde.register("variational_autoencoder")
@dataclasses.dataclass
class VariationalAutoencoder(FeedForwardLayerConfig):
    """``n_out`` is the latent size; ``activation`` (tanh by default) is
    the encoder's and decoder's."""

    IS_PRETRAINABLE = True

    encoder_layer_sizes: Sequence[int] = (100,)
    decoder_layer_sizes: Sequence[int] = (100,)
    pzx_activation: str = "identity"
    reconstruction_distribution: ReconstructionDistribution = \
        dataclasses.field(default_factory=GaussianReconstructionDistribution)
    num_samples: int = 1

    def param_order(self) -> tuple[str, ...]:
        order: List[str] = []
        for i in range(len(self.encoder_layer_sizes)):
            order += [f"e{i}W", f"e{i}b"]
        order += ["pZXMeanW", "pZXMeanb", "pZXLogStd2W", "pZXLogStd2b"]
        for i in range(len(self.decoder_layer_sizes)):
            order += [f"d{i}W", f"d{i}b"]
        order += ["pXZW", "pXZb"]
        return tuple(order)

    def l1_by_param(self):
        return {k: ((self.l1_bias if k.endswith("b") else self.l1) or 0.0)
                for k in self.param_order()}

    def l2_by_param(self):
        return {k: ((self.l2_bias if k.endswith("b") else self.l2) or 0.0)
                for k in self.param_order()}

    def init_params(self, gen: torch.Generator, dtype: torch.dtype,
                    device: torch.device) -> ParamTree:
        wi = self.weight_init or "xavier"
        bias = float(self.bias_init or 0.0)
        params: ParamTree = {}

        def dense(name: str, n_in: int, n_out: int) -> None:
            params[f"{name}W"] = init_weights(gen, (n_in, n_out), wi,
                                              self.dist, dtype, device)
            params[f"{name}b"] = torch.full((n_out,), bias, dtype=dtype,
                                            device=device)

        n_prev = self.n_in
        for i, h in enumerate(self.encoder_layer_sizes):
            dense(f"e{i}", n_prev, h)
            n_prev = h
        dense("pZXMean", n_prev, self.n_out)
        dense("pZXLogStd2", n_prev, self.n_out)
        n_prev = self.n_out
        for i, h in enumerate(self.decoder_layer_sizes):
            dense(f"d{i}", n_prev, h)
            n_prev = h
        dense("pXZ", n_prev,
              self.reconstruction_distribution.input_size(self.n_in))
        return params

    # ------------------------------------------------------------- pieces
    def _afn(self):
        return _activations.get(self.activation or "tanh")

    def _encode(self, params: ParamTree, x: Tensor) -> Tensor:
        afn = self._afn()
        for i in range(len(self.encoder_layer_sizes)):
            x = afn(x @ params[f"e{i}W"] + params[f"e{i}b"])
        return x

    def _posterior(self, params: ParamTree, x: Tensor):
        enc = self._encode(params, x)
        pzx_fn = _activations.get(self.pzx_activation)
        mean = pzx_fn(enc @ params["pZXMeanW"] + params["pZXMeanb"])
        log_sigma2 = pzx_fn(enc @ params["pZXLogStd2W"]
                            + params["pZXLogStd2b"])
        return mean, log_sigma2

    def _decode(self, params: ParamTree, z: Tensor) -> Tensor:
        afn = self._afn()
        x = z
        for i in range(len(self.decoder_layer_sizes)):
            x = afn(x @ params[f"d{i}W"] + params[f"d{i}b"])
        return x @ params["pXZW"] + params["pXZb"]

    # ---------------------------------------------------------- supervised
    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None) -> Tuple[Tensor, StateTree]:
        x = self.apply_dropout(x, train, rng)
        enc = self._encode(params, x)
        pzx_fn = _activations.get(self.pzx_activation)
        return pzx_fn(enc @ params["pZXMeanW"] + params["pZXMeanb"]), state

    # --------------------------------------------------------- unsupervised
    def pretrain_draw_specs(self, batch: int) -> List[DrawSpec]:
        return [("normal", (batch, self.n_out))] * self.num_samples

    def pretrain_loss(self, params: ParamTree, x: Tensor,
                      draws: Draws) -> Tensor:
        batch = x.shape[0]
        mean, log_sigma2 = self._posterior(params, x)
        sigma2 = torch.exp(log_sigma2)
        kl = (-0.5 / batch) * torch.sum(1.0 + log_sigma2 - mean * mean
                                        - sigma2)
        sigma = torch.sqrt(sigma2)
        nll = None
        for s in range(self.num_samples):
            z = mean + sigma * draws[s].to(mean.dtype)
            term = self.reconstruction_distribution.neg_log_prob(
                x, self._decode(params, z))
            nll = term if nll is None else nll + term
        return kl + nll / (self.num_samples * batch)

    def pretrain_grads(self, params: ParamTree, x: Tensor, draws: Draws):
        return autograd_pretrain_grads(self.pretrain_loss, params, x, draws)

    # ----------------------------------------------------------- public API
    def reconstruction_log_probability(
            self, params: ParamTree, x: Tensor, num_samples: int,
            draws: Optional[Draws] = None,
            gen: Optional[torch.Generator] = None) -> Tensor:
        """Per-example importance-sampling estimate of log P(x): the
        log-mean-exp over ``num_samples`` samples z_s ~ q(z|x) of log
        p(x|z_s).  ``draws`` are the samples' (batch, n_out) normals (the
        JAX package's ``fold_in(rng, s)``), else drawn from ``gen``."""
        mean, log_sigma2 = self._posterior(params, x)
        if draws is None:
            draws = make_draws([("normal", tuple(mean.shape))] * num_samples,
                               gen, mean.device, draw_dtype(mean.dtype))
        sigma = torch.exp(0.5 * log_sigma2)
        per = torch.stack([
            -self.reconstruction_distribution.neg_log_prob_examples(
                x, self._decode(params, mean + sigma * draws[s].to(
                    mean.dtype)))
            for s in range(num_samples)])              # (S, batch)
        return torch.logsumexp(per, dim=0) - math.log(float(num_samples))

    def generate_at_mean_given_z(self, params: ParamTree, z: Tensor
                                 ) -> Tensor:
        return self.reconstruction_distribution.generate_at_mean(
            self._decode(params, z))

    def generate_random_given_z(
            self, params: ParamTree, z: Tensor,
            draws: Optional[Draws] = None,
            gen: Optional[torch.Generator] = None) -> Tensor:
        """A sample of p(x|z): ``draws`` per the distribution's
        ``sample_specs`` (else drawn from ``gen``)."""
        preout = self._decode(params, z)
        dist = self.reconstruction_distribution
        if draws is None:
            draws = make_draws(dist.sample_specs(z.shape[0], self.n_in), gen,
                               preout.device, draw_dtype(preout.dtype))
        return dist.sample(preout, draws)
