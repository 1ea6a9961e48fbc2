"""Nested attribute-access config tree (JAX ``utils/config.py``, the port's
own copy).

An experiment's config is a nested dict {network, data, train, label} read as
``config.network.num_conv_blocks``; this module gives that view, the
flattening used for dotted result keys, and the experiment directory name.
"""

from __future__ import annotations

import json
from typing import Any, Mapping


class Config:
    """Read-only nested attribute access over a dict."""

    def __init__(self, data: Mapping[str, Any]):
        object.__setattr__(self, "_data", dict(data))

    def __getattr__(self, name: str):
        try:
            value = self._data[name]
        except KeyError:
            raise AttributeError(name)
        if isinstance(value, Mapping):
            return Config(value)
        return value

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __setattr__(self, name, value):
        raise AttributeError("Config is read-only")

    def __repr__(self) -> str:
        return "Config(" + json.dumps(self._data, indent=2,
                                      sort_keys=True) + ")"


def flatten(data: Mapping[str, Any], prefix: str = "") -> dict:
    """{"a": {"b": 1}} -> {"a.b": 1}."""
    out = {}
    for key in sorted(data):
        value = data[key]
        full = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flatten(value, full + "."))
        else:
            out[full] = value
    return out


def unflatten(data: Mapping[str, Any]) -> dict:
    out: dict = {}
    for key, value in data.items():
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def _format_value(value: Any) -> str:
    if isinstance(value, float) and not isinstance(value, bool):
        return f"{value:g}"
    return str(value)


def config_name(data: Mapping[str, Any]) -> str:
    """Experiment directory name: the config's values, in sorted flattened
    key order, skipping every key path with an underscore-prefixed part."""
    flat = flatten(data)
    parts = [_format_value(flat[key]) for key in sorted(flat)
             if not any(p.startswith("_") for p in key.split("."))]
    name = "-".join(parts)
    return name.replace("/", "_").replace(" ", "_") or "experiment"
