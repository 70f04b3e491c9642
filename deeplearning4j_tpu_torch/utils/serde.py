"""Config JSON serde — the port's copy of `deeplearning4j_tpu/utils/serde.py`.

Every config object is a frozen dataclass registered by class name, so a
configuration written by the JAX package (`conf.to_json()`) loads here
into the port's own classes with the same `@class` discriminators.

One deliberate difference: a tagged dict whose class the port has not
ported yet is kept as plain data instead of raising, so such a JAX
config still loads and writes back out unchanged (`MultiLayerConfiguration
.from_json` then refuses a layer that is not ported).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type

_TYPE_REGISTRY: Dict[str, Type] = {}

_TAG = "@class"


def register_serde(cls):
    """Class decorator: register a dataclass for polymorphic JSON round-trip."""
    _TYPE_REGISTRY[cls.__name__] = cls
    return cls


def config_to_dict(obj: Any) -> Any:
    """Recursively convert a (possibly nested) config object to plain data."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {_TAG: type(obj).__name__}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None:
                continue
            out[f.name] = config_to_dict(v)
        return out
    if isinstance(obj, dict):
        return {k: config_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [config_to_dict(v) for v in obj]
    if callable(obj) and hasattr(obj, "__name__"):
        return {"@fn": obj.__name__}
    return obj


def config_from_dict(data: Any) -> Any:
    """Inverse of config_to_dict; unknown keys of a known class are dropped
    (forward compat), unknown classes stay plain tagged dicts."""
    if isinstance(data, dict):
        if _TAG in data and data[_TAG] in _TYPE_REGISTRY:
            cls = _TYPE_REGISTRY[data[_TAG]]
            field_names = {f.name for f in dataclasses.fields(cls)}
            kwargs = {k: config_from_dict(v) for k, v in data.items()
                      if k != _TAG and k in field_names}
            return cls(**kwargs)
        if "@fn" in data:
            return data["@fn"]
        return {k: config_from_dict(v) for k, v in data.items()}
    if isinstance(data, list):
        return [config_from_dict(v) for v in data]
    return data


def to_json(obj: Any, indent: int = 2) -> str:
    return json.dumps(config_to_dict(obj), indent=indent, sort_keys=False)


def from_json(s: str) -> Any:
    return config_from_dict(json.loads(s))
