"""CenterLossOutputLayer (port of
``deeplearning4j_tpu/nn/layers/training.py``).

Loss = supervised loss + (lambda/2) ||features - center_label||^2, params
``W``, ``b`` and the per-class centers ``cL`` (n_out, n_in), which start
at zero.  The centers move by their own rate ``alpha``, not the
optimizer's: the applied delta is ``alpha * sum_{i: y_i = j}(c_j - x_i) /
(count_j + 1)``.  The score splits in two:

- the feature term pulls the features toward centers held fixed (the
  assigned centers carry no gradient), averaged with the supervised loss,
  and flows through the updater to ``W``, ``b`` and the layers below;
- a zero-valued *carrier* whose gradient with respect to ``cL`` is exactly
  that delta, not averaged over the batch; ``direct_update_params`` routes
  ``cL`` around the updater (``nn/updaters.py``), so ``cL -= delta``
  as it is, inside the same step (the captured one included).

With ``gradient_check=True`` both paths use the exact lambda-scaled term
(the full-flow gradient the numerical checker expects) and ``cL`` goes
through the updater.  Scoring needs the layer's *input* (the features):
``NEEDS_INPUT_FOR_SCORE`` routes the containers' loss accordingly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import lossfunctions as _losses
from ..conf import serde
from .base import (FeedForwardLayerConfig, ParamTree, StateTree, Tensor,
                   dense_params)


@serde.register("center_loss_output")
@dataclasses.dataclass
class CenterLossOutputLayer(FeedForwardLayerConfig):
    """An output layer with an auxiliary center-loss term pulling each
    class's penultimate features toward a learned per-class center."""

    NEEDS_INPUT_FOR_SCORE = True

    activation: str = "softmax"
    loss: str = "mcxent"
    alpha: float = 0.05
    lambda_: float = 2e-4
    gradient_check: bool = False

    def param_order(self) -> tuple[str, ...]:
        return ("W", "b", "cL")

    def init_params(self, gen: torch.Generator, dtype: torch.dtype,
                    device: torch.device) -> ParamTree:
        params = dense_params(self, gen, dtype, device)
        params["cL"] = torch.zeros((self.n_out, self.n_in), dtype=dtype,
                                   device=device)
        return params

    def direct_update_params(self) -> tuple[str, ...]:
        return () if self.gradient_check else ("cL",)

    def l1_by_param(self):
        # the centers are not regularized
        return {"W": self.l1 or 0.0, "b": self.l1_bias or 0.0, "cL": 0.0}

    def l2_by_param(self):
        return {"W": self.l2 or 0.0, "b": self.l2_bias or 0.0, "cL": 0.0}

    def forward(self, params: ParamTree, state: StateTree, x: Tensor, *,
                train: bool, rng=None, mask=None) -> Tuple[Tensor, StateTree]:
        x = self.apply_dropout(x, train, rng)
        return self._activate(self.pre_output(params, x)), state

    def pre_output(self, params: ParamTree, x: Tensor) -> Tensor:
        return x @ params["W"].to(x.dtype) + params["b"].to(x.dtype)

    def _assigned(self, params: ParamTree, labels: Tensor, x: Tensor,
                  mask: Optional[Tensor]):
        """(labels as x's dtype with masked rows zeroed, each example's
        center)."""
        lab = labels.to(x.dtype)
        if mask is not None:
            lab = lab * mask.reshape(lab.shape[0],
                                     *([1] * (lab.dim() - 1))).to(x.dtype)
        return lab, lab @ params["cL"].to(x.dtype)

    @staticmethod
    def _masked(term: Tensor, mask: Optional[Tensor]) -> Tensor:
        return term if mask is None else term * mask.reshape(
            term.shape).to(term.dtype)

    def compute_score_with_input(self, params: ParamTree, labels: Tensor,
                                 x: Tensor, mask: Optional[Tensor] = None,
                                 average: bool = True) -> Tensor:
        supervised = _losses.score(self.loss, labels,
                                   self.pre_output(params, x),
                                   self.activation, mask, average)
        lab, assigned = self._assigned(params, labels, x, mask)
        if self.gradient_check:
            center_term = self._masked(0.5 * self.lambda_ * torch.sum(
                (x - assigned) ** 2, dim=-1), mask)
            total = center_term.mean() if average else center_term.sum()
            return supervised + total
        feat_term = self._masked(0.5 * self.lambda_ * torch.sum(
            (x - assigned.detach()) ** 2, dim=-1), mask)
        total = feat_term.mean() if average else feat_term.sum()
        # the carrier: zero in value; its gradient with respect to cL is
        # alpha * labels^T (center - feature) with the per-class
        # 1/(count + 1), not averaged over the batch
        counts = lab.sum(dim=0)
        w = lab @ (1.0 / (counts + 1.0))
        carrier = 0.5 * self.alpha * torch.sum(
            w * torch.sum((x.detach() - assigned) ** 2, dim=-1))
        return supervised + total + carrier - carrier.detach()

    def compute_score_examples_with_input(self, params: ParamTree,
                                          labels: Tensor, x: Tensor,
                                          mask: Optional[Tensor] = None
                                          ) -> Tensor:
        """Per-example scores: the supervised loss plus lambda/2 ||x -
        c_y||^2 of each example."""
        supervised = _losses.score_examples(
            self.loss, labels, self.pre_output(params, x), self.activation,
            mask)
        _, assigned = self._assigned(params, labels, x, mask)
        return supervised + self._masked(0.5 * self.lambda_ * torch.sum(
            (x - assigned) ** 2, dim=-1), mask)
