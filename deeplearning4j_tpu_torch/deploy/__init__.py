"""Zero-downtime continuous deployment: the learner-to-server weight
hot-swap control plane (port of ``deeplearning4j_tpu/deploy``).

Bucket callables take weights as call operands, so a server swaps a
resident model's weights without making any callable, and deployment is
pure data motion:

- :class:`~deeplearning4j_tpu_torch.deploy.store.VersionedWeightStore`:
  monotonically versioned, SHA-manifested weight snapshots published
  from a live ``fit()`` (:class:`~deeplearning4j_tpu_torch.deploy.store.
  DeploymentListener`) or a parameter server
  (:class:`~deeplearning4j_tpu_torch.deploy.store.ParamServerPoller`);
- :class:`~deeplearning4j_tpu_torch.deploy.rollout.RolloutController`:
  pages version N+1 in alongside N, canaries a traffic fraction, gates on
  per-version p99, accuracy or agreement and the gating alerts, then
  promotes (an atomic pointer flip) or rolls back with a
  ``rollout_rollback`` flight-recorder bundle.

The JAX package's ``FleetCanary`` waits for the serving fleet
(ROADMAP A8).
"""

from .rollout import CANARY, IDLE, RolloutController, RolloutError
from .store import (DeploymentListener, ParamServerPoller,
                    VersionedWeightStore, WeightSnapshot,
                    WeightStoreCorruptError, tree_from_flat)

__all__ = ["CANARY", "DeploymentListener", "IDLE", "ParamServerPoller",
           "RolloutController", "RolloutError", "VersionedWeightStore",
           "WeightSnapshot", "WeightStoreCorruptError", "tree_from_flat"]
