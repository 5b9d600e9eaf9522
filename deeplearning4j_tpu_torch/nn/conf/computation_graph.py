"""ComputationGraph configuration: a DAG of named vertices (port of
``deeplearning4j_tpu/nn/conf/computation_graph.py``).

The vertex dataclasses, ``ComputationGraphConfiguration`` and the
``GraphBuilder`` are the JAX package's, under the same serde type names
(``vertex_*``, ``computation_graph_conf``), so ``to_json`` writes the same
text in both packages and either package reads the other's.  Each vertex
has ``output_type`` (shape inference) and ``apply`` on torch tensors.
Activations keep features last (NHWC images, (batch, time, features)
sequences), so ``MergeVertex`` concatenates on the last axis.

``topological_order`` is Kahn's algorithm with the insertion-order
tie-break: the flat parameter vector, the flat updater state and the
model zip all follow it, so it must equal the JAX package's order.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import torch

from . import inputs as _inputs
from . import serde
from ..layers.base import BaseLayerConfig

InputType = _inputs.InputType
Tensor = torch.Tensor


# --------------------------------------------------------------- vertices
@dataclasses.dataclass
class BaseVertex:
    """A DAG node: consumes the activations of ``inputs`` (vertex or
    network-input names) and produces one activation.  Stateless vertices
    implement ``apply``; a LayerVertex runs its layer config."""

    inputs: List[str] = dataclasses.field(default_factory=list)

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *xs: Tensor, masks=None) -> Tensor:
        raise NotImplementedError


@serde.register("vertex_layer")
@dataclasses.dataclass
class LayerVertex(BaseVertex):
    """Wraps a layer config, with an optional input preprocessor applied
    before the layer."""

    layer: Optional[BaseLayerConfig] = None
    preprocessor: Optional[object] = None

    def output_type(self, *input_types: InputType) -> InputType:
        it = input_types[0]
        if self.preprocessor is not None:
            it = self.preprocessor.output_type(it)
        return self.layer.output_type(it)


@serde.register("vertex_merge")
@dataclasses.dataclass
class MergeVertex(BaseVertex):
    """Concatenate along the feature (last) axis."""

    def output_type(self, *input_types: InputType) -> InputType:
        first = input_types[0]
        if first.kind == "ff":
            return _inputs.feed_forward(sum(t.size for t in input_types))
        if first.kind == "recurrent":
            return _inputs.recurrent(sum(t.size for t in input_types),
                                     first.timesteps)
        if first.kind == "cnn":
            return _inputs.convolutional(
                first.height, first.width,
                sum(t.channels for t in input_types))
        raise ValueError(f"MergeVertex cannot merge {first.kind}")

    def apply(self, *xs: Tensor, masks=None) -> Tensor:
        return torch.cat(xs, dim=-1)


@serde.register("vertex_elementwise")
@dataclasses.dataclass
class ElementWiseVertex(BaseVertex):
    """Pointwise combine: add, subtract, product, average or max.  ``max``
    splits the gradient of tied inputs in half, as ``jnp.maximum`` does
    (``torch.maximum``'s own rule)."""

    op: str = "add"

    def apply(self, *xs: Tensor, masks=None) -> Tensor:
        op = self.op.lower()
        if op == "add":
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out
        if op == "subtract":
            if len(xs) != 2:
                raise ValueError("subtract needs exactly 2 inputs")
            return xs[0] - xs[1]
        if op == "product":
            out = xs[0]
            for x in xs[1:]:
                out = out * x
            return out
        if op == "average":
            return sum(xs) / len(xs)
        if op == "max":
            out = xs[0]
            for x in xs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown elementwise op '{self.op}'")


@serde.register("vertex_subset")
@dataclasses.dataclass
class SubsetVertex(BaseVertex):
    """Feature slice [from, to], both ends included."""

    from_index: int = 0
    to_index: int = 0

    def output_type(self, *input_types: InputType) -> InputType:
        n = self.to_index - self.from_index + 1
        it = input_types[0]
        if it.kind == "recurrent":
            return _inputs.recurrent(n, it.timesteps)
        return _inputs.feed_forward(n)

    def apply(self, *xs: Tensor, masks=None) -> Tensor:
        return xs[0][..., self.from_index:self.to_index + 1]


@serde.register("vertex_stack")
@dataclasses.dataclass
class StackVertex(BaseVertex):
    """Concatenate along the batch axis (weight-shared branches)."""

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *xs: Tensor, masks=None) -> Tensor:
        return torch.cat(xs, dim=0)


@serde.register("vertex_unstack")
@dataclasses.dataclass
class UnstackVertex(BaseVertex):
    """Batch slice ``from_index`` of ``stack_size`` equal chunks."""

    from_index: int = 0
    stack_size: int = 1

    def apply(self, *xs: Tensor, masks=None) -> Tensor:
        x = xs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_index * step:(self.from_index + 1) * step]


@serde.register("vertex_scale")
@dataclasses.dataclass
class ScaleVertex(BaseVertex):
    """Multiply by a fixed scalar."""

    scale_factor: float = 1.0

    def apply(self, *xs: Tensor, masks=None) -> Tensor:
        return xs[0] * self.scale_factor


@serde.register("vertex_shift")
@dataclasses.dataclass
class ShiftVertex(BaseVertex):
    """Add a fixed scalar."""

    shift_factor: float = 0.0

    def apply(self, *xs: Tensor, masks=None) -> Tensor:
        return xs[0] + self.shift_factor


@serde.register("vertex_preprocessor")
@dataclasses.dataclass
class PreprocessorVertex(BaseVertex):
    """A standalone input preprocessor."""

    preprocessor: Optional[object] = None

    def output_type(self, *input_types: InputType) -> InputType:
        return self.preprocessor.output_type(input_types[0])

    def apply(self, *xs: Tensor, masks=None) -> Tensor:
        return self.preprocessor(xs[0])


@serde.register("vertex_l2")
@dataclasses.dataclass
class L2Vertex(BaseVertex):
    """Pairwise L2 distance of two activations, (batch, 1)."""

    eps: float = 1e-8

    def output_type(self, *input_types: InputType) -> InputType:
        return _inputs.feed_forward(1)

    def apply(self, *xs: Tensor, masks=None) -> Tensor:
        a, b = xs
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=1, keepdim=True) + self.eps)


@serde.register("vertex_l2_normalize")
@dataclasses.dataclass
class L2NormalizeVertex(BaseVertex):
    """Scale each example to unit L2 norm."""

    eps: float = 1e-8

    def apply(self, *xs: Tensor, masks=None) -> Tensor:
        x = xs[0]
        flat = x.reshape(x.shape[0], -1)
        norm = torch.sqrt(torch.sum(flat * flat, dim=1) + self.eps)
        return x / norm.reshape((-1,) + (1,) * (x.dim() - 1))


@serde.register("vertex_last_time_step")
@dataclasses.dataclass
class LastTimeStepVertex(BaseVertex):
    """(batch, time, f) -> (batch, f) at the last *unmasked* step;
    ``mask_input`` names the network input whose mask marks the ends."""

    mask_input: Optional[str] = None

    def output_type(self, *input_types: InputType) -> InputType:
        return _inputs.feed_forward(input_types[0].size)

    def apply(self, *xs: Tensor, masks=None) -> Tensor:
        x = xs[0]
        mask = None if masks is None else masks.get(self.mask_input)
        if mask is None:
            return x[:, -1]
        idx = torch.sum(mask > 0, dim=1).to(torch.int64) - 1
        idx = torch.clamp(idx, 0, x.shape[1] - 1)
        return torch.take_along_dim(x, idx[:, None, None], dim=1)[:, 0]


@serde.register("vertex_duplicate_to_time_series")
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(BaseVertex):
    """(batch, f) -> (batch, time, f), broadcast along the time axis of the
    network input ``reference_input``."""

    reference_input: Optional[str] = None

    def output_type(self, *input_types: InputType) -> InputType:
        return _inputs.recurrent(input_types[0].flat_size())

    def apply(self, *xs: Tensor, masks=None,
              timesteps: Optional[int] = None) -> Tensor:
        x = xs[0]
        if timesteps is None:
            raise ValueError("DuplicateToTimeSeriesVertex needs the "
                             "reference input's timestep count")
        return x[:, None, :].expand(x.shape[0], timesteps, x.shape[1])


# ----------------------------------------------------------- configuration
@serde.register("computation_graph_conf")
@dataclasses.dataclass
class ComputationGraphConfiguration:
    """Named DAG of vertices plus the global configuration."""

    conf: object = None                      # GlobalConfig
    network_inputs: List[str] = dataclasses.field(default_factory=list)
    network_outputs: List[str] = dataclasses.field(default_factory=list)
    vertices: Dict[str, BaseVertex] = dataclasses.field(default_factory=dict)
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 0
    input_types: Optional[List[object]] = None

    def topological_order(self) -> List[str]:
        """Kahn's algorithm over vertex names, ties broken by insertion
        order.  Raises on a cycle or an input that is neither a vertex
        nor a network input."""
        indeg = {name: 0 for name in self.vertices}
        dependents: Dict[str, List[str]] = {n: [] for n in self.vertices}
        for name, v in self.vertices.items():
            for inp in v.inputs:
                if inp in self.vertices:
                    indeg[name] += 1
                    dependents[inp].append(name)
                elif inp not in self.network_inputs:
                    raise ValueError(
                        f"Vertex '{name}' consumes unknown input '{inp}'")
        queue = [n for n, d in indeg.items() if d == 0]
        order: List[str] = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for dep in dependents[n]:
                indeg[dep] -= 1
                if indeg[dep] == 0:
                    queue.append(dep)
        if len(order) != len(self.vertices):
            cyclic = sorted(set(self.vertices) - set(order))
            raise ValueError(f"Graph has a cycle involving {cyclic}")
        return order

    # ---- JSON round-trip -------------------------------------------------
    def to_dict(self) -> dict:
        return serde.to_dict(self)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        from .neural_net_configuration import not_ported
        out = serde.from_dict(d)
        if not isinstance(out, ComputationGraphConfiguration):
            raise ValueError("not a computation_graph_conf document")
        for name, v in out.vertices.items():
            if not isinstance(v, BaseVertex):
                raise not_ported(v.get("type") if isinstance(v, dict)
                                 else v)
            if isinstance(v, LayerVertex) and not isinstance(
                    v.layer, BaseLayerConfig):
                raise not_ported(v.layer.get("type")
                                 if isinstance(v.layer, dict) else v.layer)
        return out

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    def to_yaml(self) -> str:
        """The configuration as YAML (reference ``toYaml``); PyYAML is
        imported here, so the package needs it only for this call."""
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        import yaml
        return ComputationGraphConfiguration.from_dict(yaml.safe_load(s))


class GraphBuilder:
    """The fluent graph API (``NeuralNetConfiguration.builder()...
    .graph_builder()``)."""

    def __init__(self, global_conf):
        self._cgc = ComputationGraphConfiguration(conf=global_conf)

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._cgc.network_inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: BaseLayerConfig,
                  *inputs: str, preprocessor=None) -> "GraphBuilder":
        self._cgc.vertices[name] = LayerVertex(
            inputs=list(inputs), layer=layer, preprocessor=preprocessor)
        return self

    layer = add_layer

    def add_vertex(self, name: str, vertex: BaseVertex,
                   *inputs: str) -> "GraphBuilder":
        vertex.inputs = list(inputs)
        self._cgc.vertices[name] = vertex
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._cgc.network_outputs = list(names)
        return self

    def set_input_types(self, *input_types) -> "GraphBuilder":
        self._cgc.input_types = list(input_types)
        return self

    def backprop_type(self, kind: str) -> "GraphBuilder":
        """``"standard"`` or ``"tbptt"`` (truncated BPTT)."""
        self._cgc.backprop_type = kind.lower()
        return self

    def t_bptt_forward_length(self, n: int) -> "GraphBuilder":
        self._cgc.tbptt_fwd_length = int(n)
        return self

    def t_bptt_backward_length(self, n: int) -> "GraphBuilder":
        """0 means the forward length."""
        self._cgc.tbptt_back_length = int(n)
        return self

    def pretrain(self, flag: bool) -> "GraphBuilder":
        self._cgc.pretrain = flag
        return self

    def backprop(self, flag: bool) -> "GraphBuilder":
        self._cgc.backprop = flag
        return self

    def build(self) -> ComputationGraphConfiguration:
        cgc = self._cgc
        if not cgc.network_inputs:
            raise ValueError("addInputs() never called")
        if not cgc.network_outputs:
            raise ValueError("setOutputs() never called")
        for out in cgc.network_outputs:
            if out not in cgc.vertices:
                raise ValueError(f"Output '{out}' is not a vertex")
        defaults = cgc.conf.layer_defaults()
        for v in cgc.vertices.values():
            if isinstance(v, LayerVertex) and v.layer is not None:
                v.layer.finalize_defaults(defaults)
        if cgc.input_types is not None:
            _infer_graph_shapes(cgc)
        cgc.topological_order()  # validates acyclicity and the inputs
        from .validation import validate_computation_graph_configuration
        validate_computation_graph_configuration(cgc)
        return cgc


def _infer_graph_shapes(cgc: ComputationGraphConfiguration) -> None:
    """Propagate InputTypes through the DAG in topological order, setting
    each layer's ``n_in`` and auto-inserting the family preprocessor of
    each layer vertex."""
    from .neural_net_configuration import _preprocessor_for

    if len(cgc.input_types) != len(cgc.network_inputs):
        raise ValueError(
            f"{len(cgc.network_inputs)} inputs but "
            f"{len(cgc.input_types)} input types")
    types: Dict[str, InputType] = dict(zip(cgc.network_inputs,
                                           cgc.input_types))
    for name in cgc.topological_order():
        v = cgc.vertices[name]
        in_types = [types[i] for i in v.inputs]
        if isinstance(v, LayerVertex):
            it = in_types[0]
            if v.preprocessor is None:
                pp = _preprocessor_for(it, getattr(v.layer, "INPUT_KIND",
                                                   "ff"))
                if pp is not None:
                    v.preprocessor = pp
            if v.preprocessor is not None:
                it = v.preprocessor.output_type(it)
            v.layer.set_n_in(it)
            types[name] = v.layer.output_type(it)
        else:
            types[name] = v.output_type(*in_types)
    cgc._inferred_types = types
