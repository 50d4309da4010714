"""Component registry: a copy of the JAX package's ``utils/registry.py``
(the reference's detectron2 ``Registry``).  The port registers its
datasets in ``DATASET_REGISTRY``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, obj: Any = None, *, name: str | None = None):
        if obj is None:  # use as decorator with kwargs
            return lambda o: self.register(o, name=name)
        key = name or obj.__name__
        if key in self._obj_map:
            raise KeyError(
                f"{key!r} already registered in registry {self._name!r}")
        self._obj_map[key] = obj
        return obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(
                f"{name!r} not found in registry {self._name!r}; "
                f"available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def keys(self) -> Iterable[str]:
        return self._obj_map.keys()


DATASET_REGISTRY = Registry("DATASET")
