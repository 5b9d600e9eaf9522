"""Network configuration: global hyperparameters, fluent builder and the
multi-layer configuration with JSON round-trip (port of
``deeplearning4j_tpu/nn/conf/neural_net_configuration.py``).

The dataclasses and serde type names are the JAX package's, so
``MultiLayerConfiguration.from_json`` reads the JSON its ``to_json``
writes.  Shape inference covers the layer families ported so far:
a preprocessor between families (ff <-> rnn <-> cnn) is not ported yet and
raises.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from .. import layers as _layers  # noqa: F401  (registers the layer types)
from ..layers.base import BaseLayerConfig
from ..updaters import UpdaterConfig
from ..weights import Distribution
from . import inputs as _inputs
from . import serde

InputType = _inputs.InputType


@serde.register("global_conf")
@dataclasses.dataclass
class GlobalConfig:
    """Network-level defaults cloned into layers unless overridden."""

    seed: int = 12345
    num_iterations: int = 1
    optimization_algo: str = "stochastic_gradient_descent"
    mini_batch: bool = True
    minimize: bool = True
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    updater: UpdaterConfig = dataclasses.field(default_factory=UpdaterConfig)
    activation: str = "sigmoid"
    weight_init: str = "xavier"
    dist: Optional[Distribution] = None
    bias_init: float = 0.0
    dropout: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0

    def layer_defaults(self) -> Dict[str, object]:
        return {
            "activation": self.activation,
            "weight_init": self.weight_init,
            "dist": self.dist,
            "bias_init": self.bias_init,
            "dropout": self.dropout,
            "l1": self.l1,
            "l2": self.l2,
            "l1_bias": self.l1_bias,
            "l2_bias": self.l2_bias,
            "updater": self.updater,
            "gradient_normalization": (
                None if self.gradient_normalization in ("none", None)
                else self.gradient_normalization),
        }


@serde.register("multi_layer_conf")
@dataclasses.dataclass
class MultiLayerConfiguration:
    """Ordered layer configs + input preprocessors + backprop settings."""

    conf: GlobalConfig = dataclasses.field(default_factory=GlobalConfig)
    layers: List[BaseLayerConfig] = dataclasses.field(default_factory=list)
    input_preprocessors: Dict[int, object] = dataclasses.field(
        default_factory=dict)
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 0
    input_type: Optional[object] = None

    def to_dict(self) -> dict:
        return serde.to_dict(self)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        out = serde.from_dict(d)
        if not isinstance(out, MultiLayerConfiguration):
            raise ValueError("not a multi_layer_conf document")
        for i, layer in enumerate(out.layers):
            if not isinstance(layer, BaseLayerConfig):
                kind = layer.get("type") if isinstance(layer, dict) else layer
                raise NotImplementedError(
                    f"layer {i} of type {kind!r} is not ported yet")
        if out.input_preprocessors:
            raise NotImplementedError(
                "input preprocessors are not ported yet")
        return out

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))


class NeuralNetConfiguration:
    """``NeuralNetConfiguration.builder()`` starts a fluent config chain."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    """Fluent global-hyperparameter builder."""

    def __init__(self):
        self._g = GlobalConfig()

    def _set(self, **fields) -> "Builder":
        for name, value in fields.items():
            setattr(self._g, name, value)
        return self

    def _set_updater(self, **fields) -> "Builder":
        for name, value in fields.items():
            setattr(self._g.updater, name, value)
        return self

    def seed(self, seed: int) -> "Builder":
        return self._set(seed=int(seed))

    def iterations(self, n: int) -> "Builder":
        return self._set(num_iterations=int(n))

    def optimization_algo(self, algo: str) -> "Builder":
        return self._set(optimization_algo=algo.lower())

    def mini_batch(self, flag: bool) -> "Builder":
        return self._set(mini_batch=flag)

    def minimize(self, flag: bool = True) -> "Builder":
        return self._set(minimize=flag)

    def dtype(self, dtype: str) -> "Builder":
        return self._set(dtype=dtype)

    def compute_dtype(self, dtype: str) -> "Builder":
        return self._set(compute_dtype=dtype)

    def updater(self, updater) -> "Builder":
        if isinstance(updater, UpdaterConfig):
            return self._set(updater=updater)
        return self._set_updater(updater=updater.lower())

    def learning_rate(self, lr: float) -> "Builder":
        return self._set_updater(learning_rate=float(lr))

    def learning_rate_decay_policy(self, policy: str) -> "Builder":
        return self._set_updater(lr_policy=policy.lower())

    def lr_policy_decay_rate(self, rate: float) -> "Builder":
        return self._set_updater(lr_policy_decay_rate=float(rate))

    def lr_policy_power(self, power: float) -> "Builder":
        return self._set_updater(lr_policy_power=float(power))

    def lr_policy_steps(self, steps: float) -> "Builder":
        return self._set_updater(lr_policy_steps=float(steps))

    def learning_rate_schedule(self, schedule: Dict[int, float]) -> "Builder":
        return self._set_updater(lr_schedule=dict(schedule),
                                 lr_policy="schedule")

    def momentum(self, momentum: float) -> "Builder":
        return self._set_updater(momentum=float(momentum))

    def momentum_after(self, schedule: Dict[int, float]) -> "Builder":
        return self._set_updater(momentum_schedule=dict(schedule))

    def rms_decay(self, decay: float) -> "Builder":
        return self._set_updater(rms_decay=float(decay))

    def adam_mean_decay(self, b1: float) -> "Builder":
        return self._set_updater(adam_mean_decay=float(b1))

    def adam_var_decay(self, b2: float) -> "Builder":
        return self._set_updater(adam_var_decay=float(b2))

    def rho(self, rho: float) -> "Builder":
        return self._set_updater(rho=float(rho))

    def epsilon(self, eps: float) -> "Builder":
        return self._set_updater(epsilon=float(eps))

    def activation(self, name: str) -> "Builder":
        return self._set(activation=name.lower())

    def weight_init(self, scheme: str) -> "Builder":
        return self._set(weight_init=scheme.lower())

    def dist(self, dist: Distribution) -> "Builder":
        return self._set(dist=dist, weight_init="distribution")

    def bias_init(self, value: float) -> "Builder":
        return self._set(bias_init=float(value))

    def drop_out(self, p: float) -> "Builder":
        return self._set(dropout=float(p))

    def l1(self, value: float) -> "Builder":
        return self._set(l1=float(value))

    def l2(self, value: float) -> "Builder":
        return self._set(l2=float(value))

    def l1_bias(self, value: float) -> "Builder":
        return self._set(l1_bias=float(value))

    def l2_bias(self, value: float) -> "Builder":
        return self._set(l2_bias=float(value))

    def gradient_normalization(self, mode: str,
                               threshold: float = 1.0) -> "Builder":
        return self._set(gradient_normalization=mode,
                         gradient_normalization_threshold=float(threshold))

    def list(self) -> "ListBuilder":
        return ListBuilder(self._g)

    def build_global(self) -> GlobalConfig:
        return self._g


class ListBuilder:
    """Ordered layers + optional input type -> MultiLayerConfiguration."""

    def __init__(self, global_conf: GlobalConfig):
        self._mlc = MultiLayerConfiguration(conf=global_conf)

    def layer(self, index_or_layer, layer: Optional[BaseLayerConfig] = None
              ) -> "ListBuilder":
        """``layer(conf)`` appends; ``layer(i, conf)`` sets position i."""
        if layer is None:
            self._mlc.layers.append(index_or_layer)
        else:
            idx = int(index_or_layer)
            while len(self._mlc.layers) <= idx:
                self._mlc.layers.append(None)  # type: ignore
            self._mlc.layers[idx] = layer
        return self

    def backprop(self, flag: bool) -> "ListBuilder":
        self._mlc.backprop = flag
        return self

    def set_input_type(self, input_type: InputType) -> "ListBuilder":
        self._mlc.input_type = input_type
        return self

    def build(self) -> MultiLayerConfiguration:
        mlc = self._mlc
        if any(l is None for l in mlc.layers):
            raise ValueError(
                "Gaps in layer list (layer(i, ...) skipped an index)")
        defaults = mlc.conf.layer_defaults()
        for layer in mlc.layers:
            layer.finalize_defaults(defaults)
        if mlc.input_type is not None:
            _infer_shapes(mlc)
        from .validation import validate_multi_layer_configuration
        validate_multi_layer_configuration(mlc)
        return mlc


def _infer_shapes(mlc: MultiLayerConfiguration) -> None:
    """Set each layer's n_in from the declared input type, walking the
    list.  A family boundary that needs a preprocessor raises."""
    current = mlc.input_type
    for i, layer in enumerate(mlc.layers):
        want = getattr(layer, "INPUT_KIND", "ff")
        kind = current.kind
        if not (want == "any" or kind == want
                or (kind, want) in (("recurrent", "rnn"), ("cnn_flat", "ff"))):
            raise NotImplementedError(
                f"layer {i}: the {kind} -> {want} preprocessor is not "
                "ported yet")
        layer.set_n_in(current)
        current = layer.output_type(current)
