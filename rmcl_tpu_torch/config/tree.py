"""Hierarchical configuration tree — the ParamTree equivalent.

A copy of ``rmcl_tpu.config.tree`` (pure Python; the port keeps its own).

The reference parses free-form ROS 2 parameter namespaces into a recursive
``ParamTree`` ("sensors.*.correspondences.max_dist"-style trees — reference
rmcl_ros/include/rmcl_ros/util/ros_helper.h:86-176) with auto-declared
parameters. Here the same shape is a plain nested-dict wrapper with:

  * dotted-path access with defaults (``cfg.get("sensors.lidar.weight", 1.0)``)
  * sub-tree iteration (``cfg.subtree("sensors").items()`` — the loadSensor
    factory walk, reference micp_localization.cpp:507-808)
  * YAML or dict construction (the reference's launch YAML files load 1:1)
  * overlay/merge for dynamic reconfigure semantics
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple


class ParamTree:
    """Read-mostly nested configuration with dotted-path access."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        # deep copy: derived trees (subtree/merged/items) must never alias
        # the parent's nested dicts, or set() on a derived tree silently
        # rewrites the base config
        import copy

        self._data: Dict[str, Any] = copy.deepcopy(dict(data or {}))

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_yaml(path_or_str: str) -> "ParamTree":
        """Load from a YAML file path or YAML text. Uses PyYAML when
        available; falls back to a minimal parser good enough for the
        reference-style config files (nested mappings, scalars, flow lists).
        """
        import os

        text = path_or_str
        if os.path.exists(path_or_str):
            with open(path_or_str) as f:
                text = f.read()
        elif "\n" not in path_or_str and path_or_str.strip().endswith(
            (".yml", ".yaml", ".json")
        ):
            # a path-looking string that does not exist is almost certainly
            # a typo'd filename, not YAML text — fail loudly instead of
            # parsing the path itself as a one-string document
            raise FileNotFoundError(path_or_str)
        try:
            import yaml  # type: ignore

            return ParamTree(yaml.safe_load(text) or {})
        except ImportError:
            return ParamTree(_mini_yaml(text))

    @staticmethod
    def from_flat(flat: Dict[str, Any]) -> "ParamTree":
        """From {"a.b.c": v} style flat dicts (ROS parameter dumps)."""
        tree = ParamTree()
        for key, value in flat.items():
            tree.set(key, value)
        return tree

    # -- access ------------------------------------------------------------

    def get(self, path: str, default: Any = None) -> Any:
        node: Any = self._data
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def require(self, path: str) -> Any:
        sentinel = object()
        out = self.get(path, sentinel)
        if out is sentinel:
            raise KeyError(f"missing required config key '{path}'")
        return out

    def set(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self._data
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"config path '{path}' crosses a leaf")
        node[parts[-1]] = value

    def subtree(self, path: str) -> "ParamTree":
        sub = self.get(path, {})
        return ParamTree(sub if isinstance(sub, dict) else {})

    def items(self) -> Iterator[Tuple[str, "ParamTree"]]:
        """Iterate child (name, subtree) pairs — the sensors.* factory walk."""
        for key, value in self._data.items():
            if isinstance(value, dict):
                yield key, ParamTree(value)

    def leaves(self, prefix: str = "") -> Iterator[Tuple[str, Any]]:
        for key, value in self._data.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(value, dict):
                yield from ParamTree(value).leaves(path)
            else:
                yield path, value

    # -- mutation / merge --------------------------------------------------

    def merged(self, overlay: "ParamTree") -> "ParamTree":
        """Deep merge: overlay wins (dynamic-reconfigure semantics,
        reference add_on_set_parameters_callback usage)."""

        def deep(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
            out = dict(a)
            for k, v in b.items():
                if k in out and isinstance(out[k], dict) and isinstance(v, dict):
                    out[k] = deep(out[k], v)
                else:
                    out[k] = v
            return out

        return ParamTree(deep(self._data, overlay._data))

    def to_dict(self) -> Dict[str, Any]:
        import copy

        return copy.deepcopy(self._data)

    def __contains__(self, path: str) -> bool:
        sentinel = object()
        return self.get(path, sentinel) is not sentinel

    def __repr__(self) -> str:
        return f"ParamTree({self._data!r})"


def _mini_yaml(text: str) -> Dict[str, Any]:
    """Tiny YAML-subset parser: nested mappings by 2-space indent, scalar
    values (int/float/bool/str), inline [a, b, c] lists. No anchors/flow
    maps/multi-line strings."""

    def parse_scalar(s: str) -> Any:
        s = s.strip()
        if s.startswith("[") and s.endswith("]"):
            inner = s[1:-1].strip()
            return [parse_scalar(x) for x in inner.split(",")] if inner else []
        low = s.lower()
        if low in ("true", "yes"):
            return True
        if low in ("false", "no"):
            return False
        if low in ("null", "~", ""):
            return None
        for cast in (int, float):
            try:
                return cast(s)
            except ValueError:
                pass
        return s.strip("'\"")

    root: Dict[str, Any] = {}
    stack: list[Tuple[int, Dict[str, Any]]] = [(-1, root)]
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, rest = line.strip().partition(":")
        while stack and stack[-1][0] >= indent:
            stack.pop()
        parent = stack[-1][1]
        if rest.strip():
            parent[key] = parse_scalar(rest)
        else:
            child: Dict[str, Any] = {}
            parent[key] = child
            stack.append((indent, child))
    return root
