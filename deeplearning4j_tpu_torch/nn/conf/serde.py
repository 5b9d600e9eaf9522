"""JSON serde registry for config polymorphism.

The reference uses Jackson subtype polymorphism to round-trip layer/vertex/
preprocessor configs through JSON/YAML (``MultiLayerConfiguration.toJson`` /
``fromJson`` — reference ``nn/conf/MultiLayerConfiguration.java:79-124``).
Here every config dataclass registers under a type name and serializes to a
``{"type": <name>, ...fields}`` dict; nested dataclasses recurse.

A copy of ``deeplearning4j_tpu/nn/conf/serde.py`` (which imports no JAX):
the port keeps its own registry, under the same type names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")

_REGISTRY: Dict[str, type] = {}


def register(type_name: str, custom: bool = False):
    """Class decorator registering a config dataclass for polymorphic serde.

    ``custom=True`` classes provide their own ``to_dict``/``from_dict``
    (e.g. to keep integer schedule keys) and are wrapped, not introspected.
    """

    def wrap(cls):
        cls._serde_type = type_name
        cls._serde_custom = custom
        _REGISTRY[type_name] = cls
        return cls

    return wrap


def register_class(cls, type_name: str, custom: bool = False):
    """Imperative form of :func:`register` for classes defined in modules
    that must not import this one (avoids circular imports)."""
    return register(type_name, custom)(cls)


def _encode(value: Any) -> Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        if getattr(value, "_serde_custom", False):
            d = value.to_dict()
            d["type"] = value._serde_type
            return d
        d = {}
        if hasattr(value, "_serde_type"):
            d["type"] = value._serde_type
        for f in dataclasses.fields(value):
            d[f.name] = _encode(getattr(value, f.name))
        return d
    if isinstance(value, dict):
        return {str(k): _encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    return value


def to_dict(obj: Any) -> Any:
    return _encode(obj)


def from_dict(d: Any, cls: Type[T] | None = None) -> Any:
    """Decode a dict produced by :func:`to_dict`.

    Polymorphic dicts carry a ``type`` key resolved via the registry;
    otherwise ``cls`` must be given.
    """
    if isinstance(d, dict) and "type" in d and d["type"] in _REGISTRY:
        cls = _REGISTRY[d["type"]]
    if cls is None or not dataclasses.is_dataclass(cls):
        return d
    if getattr(cls, "_serde_custom", False):
        return cls.from_dict({k: v for k, v in d.items() if k != "type"})
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in d.items():
        if key == "type" or key not in hints:
            continue
        f = hints[key]
        if isinstance(value, dict) and "type" in value and value["type"] in _REGISTRY:
            kwargs[key] = from_dict(value)
        elif isinstance(value, list):
            kwargs[key] = [
                from_dict(v) if isinstance(v, dict) and "type" in v else v
                for v in value
            ]
        elif isinstance(value, dict) and dataclasses.is_dataclass(_field_type(f)):
            kwargs[key] = from_dict(value, _field_type(f))
        elif isinstance(value, dict):
            # Plain mapping whose values may be polymorphic configs
            # (e.g. ComputationGraphConfiguration.vertices).
            kwargs[key] = {
                k: (from_dict(v) if isinstance(v, dict) and "type" in v
                    else v)
                for k, v in value.items()}
        else:
            kwargs[key] = value
    # tuples serialized as lists: coerce back where the default is a tuple
    for name, f in hints.items():
        if name in kwargs and isinstance(kwargs[name], list):
            default = _field_default(f)
            if isinstance(default, tuple):
                kwargs[name] = tuple(kwargs[name])
    return cls(**kwargs)


def _field_type(f: dataclasses.Field):
    t = f.type
    if isinstance(t, str):
        return None  # forward-ref string annotations handled via registry
    return t if dataclasses.is_dataclass(t) else None


def _field_default(f: dataclasses.Field):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:  # type: ignore
        return f.default_factory()  # type: ignore
    return None


def registry() -> Dict[str, type]:
    return dict(_REGISTRY)
