"""YAML config system (the port's own copy of ``istnet_tpu/utils/config.py``).

Replaces the reference's dependency on gorilla-core's ``Config.fromfile``
(reference ``train.py:50``): YAML files load into an attribute-accessible,
dict-like ``Config`` that also supports ``.get(key, default)`` — the access
patterns used throughout the reference (e.g. ``provider/dataset.py:23``,
``train.py:103``).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Iterator, Mapping

import yaml


class Config(Mapping):
    """Nested attribute-accessible config.

    >>> cfg = Config({"loss": {"gamma1": 1.0}})
    >>> cfg.loss.gamma1
    1.0
    >>> cfg.get("missing", 3)
    3
    """

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        for k, v in (data or {}).items():
            self[k] = v

    # -- construction -------------------------------------------------------
    @staticmethod
    def fromfile(path: str | os.PathLike) -> "Config":
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        if not isinstance(data, dict):
            raise TypeError(f"top-level YAML in {path} must be a mapping")
        cfg = Config(data)
        cfg["filename"] = str(path)
        return cfg

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        self._data[key] = value

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            self[key] = default
        return self._data[key]

    def update(self, other: Mapping) -> None:
        for k, v in other.items():
            if k in self._data and isinstance(self._data[k], Config) and isinstance(v, Mapping):
                self._data[k].update(v)
            else:
                self[k] = v

    def to_dict(self) -> dict:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, Config) else copy.deepcopy(v)
        return out

    def dump(self, path: str | os.PathLike) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"
