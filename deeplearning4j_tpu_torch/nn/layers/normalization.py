"""BatchNormalization and LocalResponseNormalization (port of
``deeplearning4j_tpu/nn/layers/normalization.py``).

The running mean and variance are layer state (``net_state``), not
params, as in the JAX package; the ModelSerializer stores them in its
``state.bin`` entry.  Training updates them as ``decay * running + (1 -
decay) * batch`` with the batch's biased variance (``F.batch_norm`` would
keep the unbiased one).
"""

from __future__ import annotations

import dataclasses

import torch

from ...ops import convolution as conv_ops
from ..conf import inputs as _inputs
from ..conf import serde
from .base import BaseLayerConfig, ParamTree, StateTree, Tensor

InputType = _inputs.InputType


@serde.register("batch_norm")
@dataclasses.dataclass
class BatchNormalization(BaseLayerConfig):
    """Batch norm over the last (feature/channel) axis: decay 0.9, eps
    1e-5; ``lock_gamma_beta`` fixes gamma and beta at their init values
    (no params)."""

    INPUT_KIND = "any"

    n_out: int = 0            # feature/channel count (inferred)
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    gamma_init: float = 1.0
    beta_init: float = 0.0
    activation: str = "identity"

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_out <= 0:
            if input_type.kind in ("cnn", "cnn_flat"):
                self.n_out = input_type.channels
            else:
                self.n_out = input_type.flat_size()

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def param_order(self) -> tuple[str, ...]:
        return () if self.lock_gamma_beta else ("gamma", "beta")

    def init_params(self, gen, dtype, device) -> ParamTree:
        if self.lock_gamma_beta:
            return {}
        return {
            "gamma": torch.full((self.n_out,), float(self.gamma_init),
                                dtype=dtype, device=device),
            "beta": torch.full((self.n_out,), float(self.beta_init),
                               dtype=dtype, device=device),
        }

    def init_state(self, dtype, device) -> StateTree:
        return {"mean": torch.zeros((self.n_out,), dtype=dtype,
                                    device=device),
                "var": torch.ones((self.n_out,), dtype=dtype,
                                  device=device)}

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None):
        gamma = params.get("gamma")
        if gamma is None:
            gamma = torch.tensor(self.gamma_init, dtype=x.dtype,
                                 device=x.device)
        beta = params.get("beta")
        if beta is None:
            beta = torch.tensor(self.beta_init, dtype=x.dtype,
                                device=x.device)
        if train:
            axes = tuple(range(x.dim() - 1))  # all but the channel axis
            out, mean, var = conv_ops.batch_norm_train(x, gamma, beta, axes,
                                                       self.eps)
            d = self.decay
            new_state = {
                "mean": (d * state["mean"] + (1.0 - d) * mean.detach()).to(
                    state["mean"].dtype),
                "var": (d * state["var"] + (1.0 - d) * var.detach()).to(
                    state["var"].dtype),
            }
            return self._activate(out), new_state
        out = conv_ops.batch_norm_inference(x, gamma, beta, state["mean"],
                                            state["var"], self.eps)
        return self._activate(out), state


@serde.register("lrn")
@dataclasses.dataclass
class LocalResponseNormalization(BaseLayerConfig):
    """Cross-channel LRN; k=2, n=5, alpha=1e-4, beta=0.75 by default."""

    INPUT_KIND = "cnn"

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75
    activation: str = "identity"

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None):
        return conv_ops.local_response_normalization(
            x, self.k, self.n, self.alpha, self.beta), state
