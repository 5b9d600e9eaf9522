"""The port's VariationalAutoencoder (``nn/layers/variational.py``)
against the JAX package's, on the CPU: for each reconstruction
distribution (Gaussian with identity and tanh, Bernoulli with sigmoid and
hard sigmoid, exponential, a loss function, and a composite of three)
the supervised forward, the pretrain score and gradients on the JAX
step's draws, three ``pretrain_layer`` steps and one ``fit`` step in
float64 (1e-10); two distributions under Adam in float32 (1e-5); and the
public API (``reconstruction_log_probability``,
``generate_at_mean_given_z``, ``generate_random_given_z``) on the same
draws.  Networks and draws: ``tests/pretrain_pairs.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
from deeplearning4j_tpu_torch.datasets import DataSet
from pretrain_pairs import (CASES, DISTS, N, N_IN, TOL, _close, _data,
                            _flat, _ids, _pair, _stack, check_layer_case)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "vae"],
                         ids=_ids)
def test_vae_forward_pretrain_grads_and_steps_match_jax(case):
    check_layer_case(case)


@pytest.mark.parametrize("case", [("vae", "composite"), ("vae", "gaussian")],
                         ids=_ids)
def test_float32_adam_vae_pretrain_matches_jax(case):
    kind, c = case
    jnet, pnet = _pair(_stack(kind, c, "float32", "adam", 0.01))
    x, y = _data("float32", binary=kind == "rbm")
    jnet.pretrain_layer(0, JDS(x, y), epochs=2)
    pnet.pretrain_layer(0, DataSet(x, y), epochs=2)
    np.testing.assert_allclose(float(pnet._score), float(jnet._score),
                               rtol=TOL["float32"])
    _close(_flat(pnet), _flat(jnet), TOL["float32"])


def test_vae_public_api_matches_jax():
    """``reconstruction_log_probability`` (log-sum-exp over 4 samples),
    ``generate_at_mean_given_z`` and ``generate_random_given_z`` for every
    distribution, on the JAX package's draws."""
    for name in DISTS:
        jnet, pnet = _pair(_stack("vae", name))
        x, _ = _data()
        jl, pl = jnet.layers[0], pnet.layers[0]
        jp, pp = jnet.params[0], pnet.params[0]
        rng = jax.random.PRNGKey(3)
        draws = [torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(rng, s), (N, 3), jnp.float64)))
            for s in range(4)]
        _close(pl.reconstruction_log_probability(
            pp, torch.from_numpy(x), 4, draws=draws),
            jl.reconstruction_log_probability(jp, x, 4, rng), 1e-10)
        z = np.random.RandomState(1).randn(5, 3)
        zt = torch.from_numpy(z)
        _close(pl.generate_at_mean_given_z(pp, zt),
               jl.generate_at_mean_given_z(jp, z), 1e-10)
        dist = jl.reconstruction_distribution
        specs = pl.reconstruction_distribution.sample_specs(5, N_IN)
        parts = getattr(dist, "parts", None)
        keys = (jax.random.split(rng, len(parts)) if parts else [rng])
        dists = [d for _, d in parts] if parts else [dist]
        sdraws = []
        for key, d, spec in zip(keys, dists, specs):
            kind = type(d).__name__
            if spec is None:
                sdraws.append(None)
            elif kind.startswith("Gaussian"):
                sdraws.append(jax.random.normal(key, spec[1], jnp.float64))
            elif kind.startswith("Exponential"):
                sdraws.append(jax.random.uniform(key, spec[1], jnp.float64,
                                                 1e-10, 1.0))
            else:
                sdraws.append(jax.random.uniform(key, spec[1], jnp.float64))
        sdraws = [None if d is None else torch.from_numpy(np.asarray(d))
                  for d in sdraws]
        _close(pl.generate_random_given_z(pp, zt, draws=sdraws),
               jl.generate_random_given_z(jp, z, rng), 1e-10)
