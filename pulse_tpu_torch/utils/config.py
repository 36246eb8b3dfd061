"""Hydra-style YAML config tree with group selection and dotted overrides.

Counterpart of `pulse_tpu/utils/config.py`: `load_config` reads the root
defaults, swaps groups via `group=name` arguments, follows group-level
`defaults:` inheritance, and applies strict `a.b.c=value` overrides. The
root has one key more than the JAX package's, `device` (default `cuda`).

The card's machine has no PyYAML, so this module parses the subset of YAML
the config files use: block mappings by indentation, flow lists `[a, b]`,
flow maps `{k: v}`, quoted and plain scalars, and `#` comments. Plain
scalars resolve as PyYAML's `safe_load` resolves them where they are
null, true/false, a decimal int or a float with a dot; anything else is a
string, but the YAML 1.1 forms PyYAML would read otherwise raise.
"""

from __future__ import annotations

import os
import re
from typing import Any

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
GROUPS = ("env", "learning", "robot", "sim")

_NULL = ("", "~", "null", "Null", "NULL")
_BOOL = {"true": True, "True": True, "TRUE": True, "false": False, "False": False, "FALSE": False}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
# as in PyYAML, a float needs its dot: "1e-4" stays a string
_FLOAT = re.compile(r"^[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
# YAML 1.1 forms PyYAML resolves and this parser does not: yes/no/on/off,
# .inf/.nan, octal, hex, binary and digit groups
_UNSUPPORTED = re.compile(r"^(?:yes|no|on|off|[-+]?\.(?:inf|nan)|[-+]?0(?:[0-7_]+|x[0-9a-f_]+|b[01_]+)"
                          r"|[-+]?[0-9][0-9_]*_[0-9_]*(?:\.[0-9_]*)?)$", re.IGNORECASE)


def _scalar(s: str) -> Any:
    """One plain or quoted scalar (double quotes take no escapes)."""
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return s[1:-1]
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    if _UNSUPPORTED.match(s):
        raise ValueError(f"unsupported YAML 1.1 scalar {s!r}")
    return s


def _split_top(s: str) -> list[str]:
    """Split a flow collection's body at the commas outside quotes and
    nested brackets."""
    parts, depth, quote, cur = [], 0, None, ""
    for ch in s:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
            continue
        cur += ch
    if cur.strip():
        parts.append(cur.strip())
    return parts


def parse_value(s: str) -> Any:
    """A scalar, a flow list or a flow map (an override's value, or what
    follows a key's colon)."""
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        return [parse_value(p) for p in _split_top(s[1:-1])]
    if s.startswith("{") and s.endswith("}"):
        out = {}
        for p in _split_top(s[1:-1]):
            k, sep, v = p.partition(":")
            if not sep:
                raise ValueError(f"flow map entry without a colon: {p!r}")
            out[_scalar(k.strip())] = parse_value(v)
        return out
    return _scalar(s)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str, where: str = "<yaml>") -> dict:
    """A document of block mappings (nesting by indentation) whose values
    are `parse_value` scalars or collections. A key with nothing after its
    colon and no deeper lines below is null."""
    root: dict = {}
    stack = [(-1, root)]          # (indent of the key line, its mapping)
    opened = []                   # (parent, key) of mappings opened by "key:"
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        m = re.match(r"^([^\s:\[\]{},#'\"][^:]*?|'[^']*'|\"[^\"]*\"):(?:\s+(.*))?$", body)
        if m is None:
            raise ValueError(f"{where}:{n}: unsupported YAML line {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        key = _scalar(m.group(1).strip())
        if m.group(2) is None or not m.group(2).strip():
            parent[key] = {}
            opened.append((parent, key))
            stack.append((indent, parent[key]))
        else:
            parent[key] = parse_value(m.group(2))
    for parent, key in opened:
        if parent[key] == {}:
            parent[key] = None
    return root


def _load_yaml(path: str) -> dict:
    with open(path) as fh:
        return parse_yaml(fh.read(), path)


def _set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    """Strict override: every path component must already exist in the
    composed config, so a typo errors instead of training the wrong
    config."""
    keys = dotted.split(".")
    node = cfg
    for i, k in enumerate(keys[:-1]):
        if not isinstance(node, dict) or k not in node:
            raise KeyError(
                f"unknown config key {'.'.join(keys[: i + 1])!r} "
                f"(from override {dotted!r}); available: {sorted(node)[:20]}"
            )
        node = node[k]
    if not isinstance(node, dict) or keys[-1] not in node:
        raise KeyError(
            f"unknown config key {dotted!r}; "
            f"available under {'.'.join(keys[:-1]) or 'root'}: {sorted(node)[:30]}"
        )
    node[keys[-1]] = value


def _load_group_yaml(config_dir: str, group: str, name: str, _seen: tuple = ()) -> dict:
    """One group file with group-level `defaults:` inheritance: its bases
    (files of the same group) compose first, in order, then its own keys
    win. Chains are followed; cycles raise."""
    if name in _seen:
        raise ValueError(f"cyclic defaults in {group}/: {' -> '.join(_seen + (name,))}")
    node = _load_yaml(os.path.join(config_dir, group, f"{name}.yaml"))
    bases = node.pop("defaults", None)
    if bases is None:
        return node
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for base in bases:
        merged.update(_load_group_yaml(config_dir, group, base, _seen + (name,)))
    merged.update(node)
    return merged


def load_config(overrides: list[str] | None = None, config_dir: str | None = None) -> dict:
    """The composed config: root keys, one dict per group (with its `_name`),
    then the dotted overrides."""
    config_dir = config_dir or CONFIG_DIR
    root = _load_yaml(os.path.join(config_dir, "config.yaml"))
    selections = dict(root.pop("defaults", {}))
    rest = []
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        if key in GROUPS:
            selections[key] = val
        else:
            rest.append(ov)

    cfg = dict(root)
    for group, name in selections.items():
        cfg[group] = _load_group_yaml(config_dir, group, name)
        cfg[group]["_name"] = name

    for ov in rest:
        key, _, val = ov.partition("=")
        _set_dotted(cfg, key, parse_value(val))
    return cfg
