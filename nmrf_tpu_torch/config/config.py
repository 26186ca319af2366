"""Hierarchical configuration tree (the PyTorch port's own copy of
``nmrf_tpu/config/config.py``, so the port imports nothing of ``nmrf_tpu``).

A lightweight, dependency-free re-design of the reference's yacs-based config
system (see reference ``nmrf/config/config.py``): attribute-style nested nodes,
YAML round-trip, ``__BASE__`` file inheritance, freezing, and dotted-path CLI
overrides (``KEY VALUE`` pairs).  Unlike the reference we do not depend on
yacs; the tree is a plain dict subclass.
"""

import copy
import os
from typing import Any, Dict, List

import yaml

BASE_KEY = "__BASE__"


class CfgNode(dict):
    """A nested configuration node with attribute access and freeze support."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            self[k] = self._to_node(v)

    @classmethod
    def _to_node(cls, value):
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            return cls(value)
        return value

    # ---- attribute access ----
    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(f"Config key not found: {name}")

    def __setattr__(self, name, value):
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"Attempted to set {name} on an immutable CfgNode")
        self[name] = self._to_node(value)

    def __setitem__(self, key, value):
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"Attempted to set {key} on an immutable CfgNode")
        super().__setitem__(key, self._to_node(value))

    # ---- freezing ----
    def freeze(self):
        self._set_immutable(True)
        return self

    def defrost(self):
        self._set_immutable(False)
        return self

    def is_frozen(self):
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, value):
        object.__setattr__(self, CfgNode.IMMUTABLE, value)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    # ---- (de)serialization ----
    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    def clone(self) -> "CfgNode":
        node = CfgNode(self.to_dict())
        return node

    # ---- merging ----
    def merge_from_other(self, other: "CfgNode | dict", strict: bool = False,
                         _prefix: str = ""):
        """Merge another tree into this one.

        strict=True rejects keys absent from this tree (yacs parity:
        ``_merge_a_into_b``'s "Non-existent config key" — governs file
        merges, so a typo'd YAML key fails loudly instead of becoming a
        silent dead key).  strict=False permits new keys for programmatic
        construction (building the defaults tree itself)."""
        self._assert_mutable()
        for k, v in other.items():
            if strict and k not in self:
                raise KeyError(f"Non-existent config key: {_prefix}{k}")
            if isinstance(v, (dict, CfgNode)) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_other(v, strict=strict,
                                         _prefix=f"{_prefix}{k}.")
            else:
                v = _literal_coerce(v)
                self[k] = self._to_node(copy.deepcopy(v) if isinstance(v, (dict, list)) else v)
        return self

    def merge_from_file(self, filename: str, allow_unsafe: bool = False):
        """Merge a YAML file, honoring ``__BASE__`` inheritance.

        ``__BASE__`` may be a single path or a list of paths, each relative to
        the including file (mirrors reference ``nmrf/config/config.py:44-116``).
        """
        loaded = _load_yaml_with_base(filename)
        self.merge_from_other(loaded, strict=True)
        return self

    def merge_from_list(self, opts: List[str]):
        """Merge from dotted-path override pairs: ``["SOLVER.BASE_LR", "1e-4"]``.

        Unknown keys raise (yacs parity, ``_merge_a_into_b``'s "Non-existent
        config key"): silently creating keys turns a typo'd override — or a
        stray CLI flag like ``--config-file`` landing in the remainder args —
        into a no-op run with default config.
        """
        self._assert_mutable()
        assert len(opts) % 2 == 0, f"Override list must have even length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
                assert isinstance(node, CfgNode), f"{key}: {p} is not a config node"
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            old = node.get(leaf, None)
            node[leaf] = _decode_override(value, old)
        return self

    def _assert_mutable(self):
        if self.is_frozen():
            raise AttributeError("Attempted to modify a frozen CfgNode")


def _literal_coerce(value):
    """yacs parity: YAML strings that are python literals (e.g. the
    ``("kitti_mix",)`` tuples in the reference configs) are literal_eval'd;
    tuples become lists."""
    if isinstance(value, str):
        import ast

        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value
    if isinstance(value, tuple):
        value = [_literal_coerce(x) if isinstance(x, (str, tuple)) else x for x in value]
    return value


def _decode_override(value: str, old: Any):
    """Parse a CLI string override, type-guided by the existing value."""
    if not isinstance(value, str):
        return value
    try:
        decoded = yaml.safe_load(value)
    except yaml.YAMLError:
        decoded = value
    # Keep string-typed keys as strings even if they look numeric
    if isinstance(old, str) and not isinstance(decoded, str):
        return value
    # YAML 1.1 does not parse "2e-4" (no dot) as float; coerce for numeric keys
    if isinstance(decoded, str) and isinstance(old, (int, float)) and not isinstance(old, bool):
        try:
            return float(decoded)
        except ValueError:
            pass
    # yacs parity: CLI values are literal_eval'd, so tuple/list overrides like
    # DATASETS.TRAIN '("sceneflow",)' work (yacs config.py _decode_cfg_value)
    if isinstance(decoded, str) and not isinstance(old, str):
        decoded = _literal_coerce(decoded)
    return decoded


def _load_yaml_with_base(filename: str) -> Dict[str, Any]:
    with open(filename, "r") as f:
        cfg = yaml.safe_load(f) or {}
    bases = cfg.pop(BASE_KEY, None)
    if bases is None:
        return cfg
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base in bases:
        if not os.path.isabs(base):
            base = os.path.join(os.path.dirname(filename), base)
        base_cfg = _load_yaml_with_base(base)
        _deep_update(merged, base_cfg)
    _deep_update(merged, cfg)
    return merged


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst
