"""Shared CLI helpers: the YAML reader and ``key=value`` overrides.

``safe_load`` uses PyYAML when it imports. Otherwise a small reader covers
the subset the repo's config files use -- nested block mappings, plain and
quoted scalars resolved as PyYAML's safe loader resolves them (null, bool,
int, float), flow lists ``[a, b]`` and ``#`` comments.
"""

from __future__ import annotations

import re
import typing as tp

try:
    import yaml as _yaml
except ImportError:  # the reader below takes over
    _yaml = None

# PyYAML's implicit resolvers (yaml/resolver.py), restricted to what a
# config scalar can be.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL_T = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_BOOL_F = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$"
)


def _strip_comment(line: str) -> str:
    out, quote = [], None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            break
        out.append(ch)
    return "".join(out).rstrip()


def _split_flow(body: str) -> tp.List[str]:
    items, cur, depth, quote = [], [], 0, None
    for ch in body:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if "".join(cur).strip():
        items.append("".join(cur))
    return items


def parse_scalar(text: str):
    """One YAML value: a flow list or a scalar, typed like ``yaml.safe_load``."""
    s = text.strip()
    if s.startswith("[") and s.endswith("]"):
        return [parse_scalar(x) for x in _split_flow(s[1:-1])]
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if _NULL.match(s):
        return None
    if _BOOL_T.match(s):
        return True
    if _BOOL_F.match(s):
        return False
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        low = s.lower()
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low.endswith("nan"):
            return float("nan")
        return float(s.replace("_", ""))
    return s


def _read_block(lines, i: int, indent: int, into: dict) -> int:
    while i < len(lines):
        ind, text = lines[i]
        if ind < indent:
            return i
        if ind > indent:
            raise ValueError(f"unexpected indentation: {text!r}")
        key, sep, rest = text.partition(":")
        if not sep:
            raise ValueError(f"expected 'key: value', got {text!r}")
        key, rest = key.strip(), rest.strip()
        if rest:
            into[key] = parse_scalar(rest)
            i += 1
        elif i + 1 < len(lines) and lines[i + 1][0] > indent:
            child: dict = {}
            i = _read_block(lines, i + 1, lines[i + 1][0], child)
            into[key] = child
        else:
            into[key] = None
            i += 1
    return i


def read_yaml_subset(text: str) -> dict:
    """The fallback reader for the repo's config subset."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    out: dict = {}
    if lines:
        _read_block(lines, 0, lines[0][0], out)
    return out


def safe_load(text: str):
    if _yaml is not None:
        return _yaml.safe_load(text)
    return read_yaml_subset(text)


def parse_value(text: str):
    """An override value, typed as a YAML scalar."""
    if _yaml is not None:
        return _yaml.safe_load(text)
    return parse_scalar(text)


def apply_overrides(config: dict, overrides: tp.Sequence[str]) -> dict:
    """Apply ``a.b.c=value`` overrides (values parsed as YAML scalars)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override {item!r} must be key=value")
        key, value = item.split("=", 1)
        parts = key.split(".")
        node = config
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_value(value)
    return config
