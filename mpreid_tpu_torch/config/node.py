"""A minimal yacs-compatible configuration node.

The reference uses yacs (`config/defaults.py`, `config/defaults_base.py` in the
reference repo); we keep the same user-facing API — attribute access,
``merge_from_file`` (YAML overlay), ``merge_from_list`` (CLI ``KEY VALUE``
pairs), ``freeze``/``defrost``/``clone`` — without the dependency, so that the
reference's YAML config files work unmodified.

A copy kept in the port (ref mpreid_tpu/config/node.py::CfgNode), so the port
imports nothing of the JAX package. PyYAML is optional here: it is imported
only by ``merge_from_file``, and ``dump`` writes JSON.
"""

from __future__ import annotations

import ast
import copy
import json
from typing import Any

_FROZEN = "__frozen__"


class CfgNode(dict):
    """Nested dict with attribute access and freeze semantics."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(
                f"Attempted to set {name} on a frozen CfgNode")
        self[name] = value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(
                f"Attempted to set {key} on a frozen CfgNode")
        super().__setitem__(key, value)

    # -- freeze protocol -----------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    def __reduce__(self):
        # pickled as plain dicts and the flag: unpickling a dict subclass sets
        # its items before its attributes, which __setitem__ cannot take
        plain = {k: v.__reduce__()[1][0] if isinstance(v, CfgNode) else v
                 for k, v in self.items()}
        return _rebuild, (plain, self.is_frozen())

    def clone(self) -> "CfgNode":
        node = CfgNode()
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return node

    # -- merging -------------------------------------------------------------
    def _merge_dict(self, other: dict, path: str = "") -> None:
        for k, v in other.items():
            full = f"{path}.{k}" if path else k
            if k not in self:
                raise KeyError(f"Non-existent config key: {full}")
            cur = self[k]
            if isinstance(cur, CfgNode):
                if v is None:
                    # a section whose children are all commented out parses
                    # as None — treat as an empty overlay
                    continue
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot overwrite subtree {full} with a leaf")
                cur._merge_dict(v, full)
            else:
                super().__setitem__(k, _coerce(v, cur, full))

    def _check_mutable(self) -> None:
        if self.is_frozen():
            raise AttributeError("Attempted to merge into a frozen CfgNode")

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._check_mutable()
        self._merge_dict(other)

    def merge_from_file(self, path: str) -> None:
        self._check_mutable()
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
        if data:
            self._merge_dict(data)

    def merge_from_list(self, opts: list | None) -> None:
        if not opts:
            return
        self._check_mutable()
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(value, str):
                try:
                    value = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    pass
            dict.__setitem__(node, leaf, _coerce(value, node[leaf], key))

    # -- misc ------------------------------------------------------------------
    def dump(self) -> str:
        return json.dumps(_to_plain(self), indent=2, sort_keys=True)

    def __str__(self) -> str:
        return self.dump()

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _to_plain(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return list(node)
    return node


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Validate/convert a replacement value against the default's type."""
    if old is None or value is None:
        return value
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            if value.lower() in ("true", "1", "yes", "on"):
                return True
            if value.lower() in ("false", "0", "no", "off"):
                return False
        raise TypeError(f"Cannot coerce {value!r} to bool for key {key}")
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, (int, float)) and isinstance(value, str):
        try:
            return type(old)(ast.literal_eval(value))
        except (ValueError, SyntaxError):
            raise TypeError(f"Cannot coerce {value!r} for key {key}")
    # tuples in defaults written as ('market1501') are actually plain strings —
    # accept str↔str and anything whose types already match.
    return value


def _rebuild(plain: dict, frozen: bool) -> CfgNode:
    node = CfgNode(plain)
    if frozen:
        node.freeze()
    return node
