"""MultiLayerNetwork: the sequential network container (port of
``deeplearning4j_tpu/nn/multilayer.py``).

Eager PyTorch: ``fit`` runs one forward, one autograd backward and one
DL4J-order updater step per batch.  Params are a list of per-layer dicts
of tensors in the JAX package's layouts and order, so the flat parameter
vector (``get_flat_params``/``set_flat_params``) maps one to one between
the packages.

The network lives on one device: the card unless ``device="cpu"`` is
passed.  Its precision policy follows that device (``mixed_bf16`` on the
card, fp32 on the CPU; see :mod:`.precision`), with the fp32-logits
contract: the output head's logits are cast to fp32 before the
softmax/loss, and every output the network returns is fp32.

Not ported yet: the fused multi-step scans, the device-cached ingest,
tBPTT, streaming/decode steps, health telemetry, listeners, solvers,
pretraining and checkpointing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..datasets.dataset import DataSet
from ..device import DeviceLike, resolve_device
from . import precision as _precision
from . import updaters as _updaters
from .conf.neural_net_configuration import MultiLayerConfiguration

Tensor = torch.Tensor


class MultiLayerNetwork:
    """Sequential model: list of layer configs -> train/inference."""

    def __init__(self, conf: MultiLayerConfiguration,
                 device: DeviceLike = None):
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self.params: List[Dict[str, Tensor]] = []
        self.net_state: List[Dict[str, Tensor]] = []
        self.updater_state: List[Dict[str, Any]] = []
        self.iteration = 0
        self.epoch = 0
        self._init_done = False
        self._score: Optional[Tensor] = None
        self._rng: Optional[torch.Generator] = None
        self._policy: Optional[_precision.PrecisionPolicy] = None

    def _pol(self) -> _precision.PrecisionPolicy:
        if self._policy is None:
            self._policy = _precision.resolve_policy(self.conf.conf,
                                                     self.device)
        return self._policy

    # ------------------------------------------------------------------ init
    def init(self) -> "MultiLayerNetwork":
        """Initialize params, layer state and updater state from the conf
        seed (CPU draws, then moved to the device)."""
        if self._init_done:
            return self
        pol = self._pol()
        seed = int(self.conf.conf.seed)
        gen = torch.Generator().manual_seed(seed)
        self.params = [layer.init_params(gen, pol.param_dtype, self.device)
                       for layer in self.layers]
        self.net_state = [layer.init_state(pol.param_dtype, self.device)
                          for layer in self.layers]
        self.updater_state = [
            _updaters.init_state(self._updater_conf(i), self.params[i],
                                 policy=pol)
            for i in range(len(self.layers))]
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._init_done = True
        return self

    def _updater_conf(self, i: int) -> _updaters.UpdaterConfig:
        return self.layers[i].updater or self.conf.conf.updater

    # --------------------------------------------------------------- forward
    def _forward(self, params, net_state, x: Tensor, *, train: bool,
                 rng: Optional[torch.Generator], mask=None,
                 preoutput_last: bool = False):
        """Compose the layers.  Returns (out, new_state).  With
        ``preoutput_last`` the output layer contributes its
        pre-activation, so the loss can fuse softmax stably."""
        pol = self._pol()
        if x.is_floating_point():
            x = x.to(pol.compute_dtype)
        if pol.compute_dtype != pol.param_dtype:
            params = [{k: p.to(pol.compute_dtype) if p.is_floating_point()
                       else p for k, p in tree.items()} for tree in params]
        new_state = list(net_state)
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            last = i == n - 1
            if last and preoutput_last and hasattr(layer, "pre_output"):
                x = layer.apply_dropout(x, train, rng)
                x = layer.pre_output(params[i], x)
            elif last and pol.downcasts_output and hasattr(
                    layer, "pre_output"):
                # fp32 logits contract: the head's logits go to fp32
                # BEFORE the softmax, so probabilities are not bf16-rounded
                x = layer.apply_dropout(x, train, rng)
                x = layer._activate(layer.pre_output(params[i], x).float())
            else:
                x, new_state[i] = layer.forward(
                    params[i], net_state[i], x, train=train, rng=rng,
                    mask=mask)
        if pol.downcasts_output:
            x = x.float()
        return x, new_state

    # ----------------------------------------------------------------- loss
    def _loss_fn(self, params, net_state, features, labels, features_mask,
                 labels_mask, rng, train: bool, per_example: bool = False):
        """Data loss (regularization is added to the reported score only,
        and to the gradient by the updater, in DL4J order)."""
        out_layer = self.layers[-1]
        if not hasattr(out_layer, "compute_score"):
            raise ValueError("Last layer must be an output/loss layer to "
                             "fit()")
        preout, new_state = self._forward(
            params, net_state, features, train=train, rng=rng,
            mask=features_mask, preoutput_last=True)
        lmask = labels_mask
        if lmask is None and features_mask is not None and preout.dim() == 3:
            lmask = features_mask   # per-timestep output: features mask
        if per_example:
            return out_layer.compute_score_examples(labels, preout,
                                                    lmask), new_state
        return out_layer.compute_score(
            labels, preout, lmask,
            average=self.conf.conf.mini_batch), new_state

    def _reg_score(self, params):
        return sum(_updaters.regularization_score(
            params[i], layer.l1_by_param(), layer.l2_by_param())
            for i, layer in enumerate(self.layers))

    # ------------------------------------------------------------- training
    def _tensor(self, a, dtype: Optional[torch.dtype] = None
                ) -> Optional[Tensor]:
        if a is None:
            return None
        t = torch.as_tensor(a, device=self.device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    def _batch(self, ds: DataSet):
        return (self._tensor(ds.features), self._tensor(ds.labels,
                                                        torch.float32),
                self._tensor(ds.features_mask, torch.float32),
                self._tensor(ds.labels_mask, torch.float32))

    def _fit_batch(self, ds: DataSet) -> None:
        """One forward, one backward and one update per iteration."""
        features, labels, fmask, lmask = self._batch(ds)
        self.last_batch_size = ds.num_examples()
        for _ in range(self.conf.conf.num_iterations):
            leaves = [{k: p.detach().requires_grad_(p.is_floating_point())
                       for k, p in tree.items()} for tree in self.params]
            data_loss, new_state = self._loss_fn(
                leaves, self.net_state, features, labels, fmask, lmask,
                self._rng, True)
            flat = [p for tree in leaves for p in tree.values()]
            grads = torch.autograd.grad(data_loss, flat, allow_unused=True)
            with torch.no_grad():
                score = data_loss.detach() + self._reg_score(self.params)
                self._apply_updates(flat, grads)
            self.net_state = [{k: v.detach() for k, v in s.items()}
                              for s in new_state]
            self._score = score
            self.iteration += 1

    def _apply_updates(self, flat_leaves, flat_grads) -> None:
        grads_iter = iter(flat_grads)
        leaves_iter = iter(flat_leaves)
        for i, layer in enumerate(self.layers):
            g = {}
            for name in self.params[i]:
                grad, leaf = next(grads_iter), next(leaves_iter)
                g[name] = torch.zeros_like(leaf) if grad is None else grad
            if not g:
                continue
            self.params[i], self.updater_state[i] = \
                _updaters.apply_layer_updates(
                    self._updater_conf(i), layer, self.params[i],
                    self.updater_state[i], g, self.iteration)

    def fit(self, data, labels=None, epochs: int = 1) -> "MultiLayerNetwork":
        """Train on a :class:`DataSet`, an iterable of DataSets, or a
        features array with ``labels``: one update per batch."""
        self.init()
        if not self.conf.backprop:
            return self
        if labels is not None:
            data = DataSet(data, labels)
        batches = [data] if isinstance(data, DataSet) else data
        for _ in range(epochs):
            if hasattr(batches, "reset"):
                batches.reset()
            for ds in batches:
                self._fit_batch(ds)
            self.epoch += 1
        return self

    # ------------------------------------------------------------ inference
    def output(self, features, train: bool = False,
               features_mask=None) -> Tensor:
        """Forward pass (inference tier unless ``train``); a tensor on the
        network's device, fp32 under the mixed policy."""
        self.init()
        with torch.no_grad():
            out, _ = self._forward(
                self.params, self.net_state, self._tensor(features),
                train=train, rng=self._rng if train else None,
                mask=self._tensor(features_mask, torch.float32))
        return out

    def score(self, dataset: Optional[DataSet] = None) -> float:
        """Mean loss (+ regularization) on ``dataset``; without one, the
        score of the last training batch."""
        if dataset is None:
            return float("nan") if self._score is None else \
                float(self._score)
        self.init()
        features, labels, fmask, lmask = self._batch(dataset)
        with torch.no_grad():
            loss, _ = self._loss_fn(self.params, self.net_state, features,
                                    labels, fmask, lmask, None, False)
            return float(loss + self._reg_score(self.params))

    def score_examples(self, data: DataSet,
                       add_regularization_terms: bool = True) -> Tensor:
        """Per-example loss vector (batch,), no batch averaging."""
        self.init()
        features, labels, fmask, lmask = self._batch(data)
        with torch.no_grad():
            per, _ = self._loss_fn(self.params, self.net_state, features,
                                   labels, fmask, lmask, None, False,
                                   per_example=True)
            if add_regularization_terms:
                per = per + self._reg_score(self.params)
        return per

    # ------------------------------------------------ flat-param invariant
    def _ordered(self):
        for i, layer in enumerate(self.layers):
            for name in layer.param_order():
                yield i, name

    def param_table(self) -> Dict[str, np.ndarray]:
        """Named params ``{"0_Wq": ..., "1_b": ...}`` as float32 numpy."""
        self.init()
        return {f"{i}_{name}": self.params[i][name].detach().float().cpu()
                .numpy() for i, name in self._ordered()}

    def num_params(self) -> int:
        self.init()
        return sum(p.numel() for tree in self.params for p in tree.values())

    def get_flat_params(self) -> np.ndarray:
        """All params as one float32 vector, in layer/param order (the
        JAX package's ``get_flat_params`` order)."""
        self.init()
        chunks = [self.params[i][name].detach().reshape(-1).float().cpu()
                  for i, name in self._ordered()]
        if not chunks:
            return np.zeros((0,), np.float32)
        return torch.cat(chunks).numpy()

    def set_flat_params(self, flat) -> None:
        """Assign every param from one vector in ``get_flat_params`` order
        (cast to each param's dtype); fp32 masters are re-derived."""
        self.init()
        flat = torch.as_tensor(np.asarray(flat, dtype=np.float32))
        offset = 0
        for i, name in self._ordered():
            p = self.params[i][name]
            size = p.numel()
            if offset + size > flat.numel():
                raise ValueError(f"Flat param size mismatch: vector of "
                                 f"{flat.numel()} is too short")
            self.params[i][name] = flat[offset:offset + size].reshape(
                p.shape).to(device=self.device, dtype=p.dtype)
            offset += size
        if offset != flat.numel():
            raise ValueError(f"Flat param size mismatch: expected {offset}, "
                             f"got {flat.numel()}")
        self._sync_masters_from_params()

    def _sync_masters_from_params(self) -> None:
        """Re-derive the fp32 masters from freshly assigned params, so that
        params == cast(masters) holds after a direct write."""
        for i, state in enumerate(self.updater_state):
            masters = state.get(_updaters.MASTER_KEY)
            if masters is not None:
                state[_updaters.MASTER_KEY] = {
                    k: self.params[i][k].float().clone() for k in masters}
