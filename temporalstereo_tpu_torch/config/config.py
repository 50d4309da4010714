"""Hierarchical configuration tree with YAML overlay + CLI opts.

A copy of the JAX package's ``config/config.py`` (pure Python, no
framework): a plain attribute-dict supporting in-code default trees
(``defaults.py``), YAML overlay merge (``merge_from_file``), dotted-path CLI
opts merge (``merge_from_list``, e.g. ``["MODEL.LOCAL_MAP_SIZE", "3"]``),
freezing, cloning, and conversion to plain dicts.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List


class ConfigNode(dict):
    """Attribute-accessible nested dict with freeze semantics."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        self.__dict__[ConfigNode.IMMUTABLE] = False
        init_dict = init_dict or {}
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = ConfigNode(v)
            self[k] = v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__[ConfigNode.IMMUTABLE]:
            raise AttributeError(
                f"ConfigNode is frozen; cannot set {name}={value!r}"
            )
        if isinstance(value, dict) and not isinstance(value, ConfigNode):
            value = ConfigNode(value)
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if self.__dict__.get(ConfigNode.IMMUTABLE, False):
            raise AttributeError(
                f"ConfigNode is frozen; cannot set {name}={value!r}"
            )
        super().__setitem__(name, value)

    # -- freeze / clone -----------------------------------------------------
    def freeze(self) -> "ConfigNode":
        self.__dict__[ConfigNode.IMMUTABLE] = True
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        self.__dict__[ConfigNode.IMMUTABLE] = False
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return self.__dict__[ConfigNode.IMMUTABLE]

    def clone(self) -> "ConfigNode":
        return ConfigNode(self.to_dict())

    # -- conversion ---------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    # mirrors reference CfgNode.convert_to_dict (architecture/utils/config.py:21-38)
    convert_to_dict = to_dict

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True, default=str)

    def content_hash(self) -> int:
        return hash(json.dumps(self.to_dict(), sort_keys=True, default=str))

    # -- merging ------------------------------------------------------------
    def merge_from_other(self, other: "ConfigNode | Dict[str, Any]") -> "ConfigNode":
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), ConfigNode):
                self[k].merge_from_other(v)
            else:
                self[k] = ConfigNode(v) if isinstance(v, dict) else copy.deepcopy(v)
        return self

    def merge_from_file(self, path: str) -> "ConfigNode":
        import yaml

        with open(path, "r") as f:
            loaded = yaml.safe_load(f) or {}
        return self.merge_from_other(loaded)

    def merge_from_list(self, opts: List[str]) -> "ConfigNode":
        assert len(opts) % 2 == 0, f"opts must come in KEY VALUE pairs, got {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = ConfigNode()
                node = node[p]
            node[parts[-1]] = _decode_value(value)
        return self


def _decode_value(value: str) -> Any:
    """Parse CLI string values: python literals first, then plain string."""
    if not isinstance(value, str):
        return value
    try:
        import ast

        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


CN = ConfigNode
