"""Config system (counterpart of ``accel_tpu/config/loader.py``): an
attribute dict of defaults with an experiment YAML merged over it.

The port keeps clear of a PyYAML dependency, so the YAML is read by
:func:`safe_load`, a reader for the subset the experiment configs use:

- block mappings, nested by indentation (spaces only);
- flow sequences on one line, nested (``[[1024, 2048]]``);
- single- and double-quoted strings;
- comments, and blank lines;
- plain scalars, resolved as PyYAML's YAML 1.1 resolver resolves them:
  ints (decimal, ``0x``, ``0b``, octal ``0...``, ``_`` separators),
  floats (a ``.`` is needed, and an exponent needs its sign, so ``5e-5``
  stays a str and ``0.00005`` is a float), bools (``true``/``yes``/``on``
  and their negations, in three cases), ``null``/``~``/empty as None,
  and everything else a str.

Anything else (tabs, block sequences, flow mappings, anchors and
aliases, tags, block scalars, multi-line scalars, document markers and
directives, sexagesimal numbers, timestamps, merge keys) raises
``ValueError`` rather than being read otherwise than PyYAML reads it.
"""

from __future__ import annotations

import copy
import math
import re
from collections.abc import Mapping
from typing import Any


class Config(dict):
    """A dict with attribute access and deep-merge update (easydict-alike)."""

    def __init__(self, d: Mapping[str, Any] | None = None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = self._wrap(v)

    @staticmethod
    def _wrap(v):
        if isinstance(v, Mapping) and not isinstance(v, Config):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Config._wrap(x) for x in v)
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)

    def __setitem__(self, name, value):
        super().__setitem__(name, self._wrap(value))

    def merge(self, other: Mapping[str, Any], strict: bool = True, _path: str = ""):
        """Deep-merge ``other`` into self. With ``strict`` a key of
        ``other`` that self lacks raises ``KeyError`` (the reference's
        check against typos in experiment YAMLs)."""
        for k, v in other.items():
            key_path = f"{_path}.{k}" if _path else str(k)
            if strict and k not in self:
                raise KeyError(f"unknown config key: {key_path}")
            if isinstance(v, Mapping) and isinstance(self.get(k), Config):
                self[k].merge(v, strict=strict, _path=key_path)
            else:
                self[k] = v
        return self

    def clone(self) -> "Config":
        return Config(copy.deepcopy(dict(self)))


def default_config() -> Config:
    from accel_tpu_torch.config.defaults import make_defaults

    return make_defaults()


def update_config(cfg: Config, yaml_path: str, strict: bool = True) -> Config:
    """Overlay an experiment YAML onto ``cfg`` in place (reference name)."""
    with open(yaml_path) as f:
        overlay = safe_load(f.read()) or {}
    cfg.merge(overlay, strict=strict)
    return cfg


def load_config(yaml_path: str | None = None, strict: bool = True) -> Config:
    cfg = default_config()
    if yaml_path is not None:
        update_config(cfg, yaml_path, strict=strict)
    return cfg


# ---- the YAML subset ---------------------------------------------------------

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF")
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                       |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                       |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                       |[-+]?\.(?:inf|Inf|INF)
                       |\.(?:nan|NaN|NAN)""", re.X)
_INT = re.compile(r"""[-+]?0b[0-1_]+
                     |[-+]?0[0-7_]+
                     |[-+]?(?:0|[1-9][0-9_]*)
                     |[-+]?0x[0-9a-fA-F_]+
                     |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_NULL = re.compile(r"~|null|Null|NULL|")
_TIMESTAMP = re.compile(r"[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt ].*)?")
# characters that cannot start a plain scalar (YAML 1.1 indicators), or
# start a construct outside the subset
_NOT_PLAIN_START = set("&*!|>%@`{}]")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line:
    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text


def _fail(line: _Line | int, why: str):
    n = line.number if isinstance(line, _Line) else line
    raise ValueError(f"YAML line {n}: {why} (outside the subset this reader takes)")


def _resolve_plain(s: str, line: _Line):
    """A plain scalar's value, as PyYAML's SafeLoader constructs it."""
    if _NULL.fullmatch(s):
        return None
    if _BOOL.fullmatch(s):
        return s.lower() in ("yes", "true", "on")
    if s in ("=", "<<") or _TIMESTAMP.fullmatch(s):
        _fail(line, f"the plain scalar {s!r} resolves to a YAML type this reader lacks")
    if _INT.fullmatch(s):
        v = s.replace("_", "")
        if ":" in v:
            _fail(line, f"sexagesimal int {s!r}")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.fullmatch(s):
        v = s.replace("_", "").lower()
        if ":" in v:
            _fail(line, f"sexagesimal float {s!r}")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * float(v)
    return s


def _quoted(text: str, pos: int, line: _Line) -> tuple[str, int]:
    """The quoted string starting at ``text[pos]``; returns it and the
    position after its closing quote."""
    q = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = text[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = text[i + 2:i + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    _fail(line, f"bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                _fail(line, f"escape \\{e} (or a line break inside a quoted string)")
            continue
        out.append(c)
        i += 1
    _fail(line, "a quoted string that does not close on its line")


def _rest_is_comment(text: str, pos: int, line: _Line) -> None:
    rest = text[pos:]
    if rest.strip() and not re.match(r"\s+#", rest):
        _fail(line, f"unexpected text {rest.strip()!r} after a value")


def _plain_end(text: str, pos: int, flow: bool) -> int:
    """Where a plain scalar that starts at ``pos`` ends: at a comment
    (`` #``), at the end of the line, or, inside a flow sequence, at
    ``,``, ``[`` or ``]``."""
    i = pos
    while i < len(text):
        c = text[i]
        if c == "#" and i > pos and text[i - 1] in " \t":
            break
        if flow and c in ",[]{}":
            break
        i += 1
    return i


def _flow_sequence(text: str, pos: int, line: _Line) -> tuple[list, int]:
    """The flow sequence starting at ``text[pos] == '['``."""
    items, i = [], pos + 1
    while True:
        while i < len(text) and text[i] in " \t":
            i += 1
        if i >= len(text) or (text[i] == "#" and text[i - 1] in " \t"):
            _fail(line, "a flow sequence that does not close on its line")
        c = text[i]
        if c == "]":
            return items, i + 1
        if c == "[":
            item, i = _flow_sequence(text, i, line)
        elif c in "'\"":
            item, i = _quoted(text, i, line)
        elif c in _NOT_PLAIN_START or c in ",?" or text.startswith("- ", i):
            _fail(line, f"{c!r} inside a flow sequence")
        else:
            end = _plain_end(text, i, flow=True)
            raw = text[i:end].rstrip()
            if ": " in raw or raw.endswith(":"):
                _fail(line, f"a mapping inside a flow sequence ({raw!r})")
            item, i = _resolve_plain(raw, line), end
        items.append(item)
        while i < len(text) and text[i] in " \t":
            i += 1
        if text[i:i + 1] == ",":
            i += 1
        elif text[i:i + 1] != "]":
            _fail(line, "expected ',' or ']' in a flow sequence")


def _value(text: str, line: _Line):
    """The value after ``key:`` on one line (not empty)."""
    c = text[0]
    if c in "'\"":
        v, end = _quoted(text, 0, line)
        _rest_is_comment(text, end, line)
        return v
    if c == "[":
        v, end = _flow_sequence(text, 0, line)
        _rest_is_comment(text, end, line)
        return v
    if c in _NOT_PLAIN_START or c in ",#" or text in ("-", "?") or text[:2] in ("- ", "? "):
        _fail(line, f"a value starting with {c!r}")
    raw = text[:_plain_end(text, 0, flow=False)].rstrip()
    if ": " in raw or raw.endswith(":"):
        _fail(line, f"a mapping value inside the plain scalar {raw!r}")
    return _resolve_plain(raw, line)


def _key(text: str, line: _Line) -> tuple[Any, str]:
    """Split ``key: rest`` into the key and the text after ``:``."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0, line)
        if text[end:end + 1] != ":" or text[end + 1:end + 2] not in ("", " ", "\t"):
            _fail(line, "a quoted key not followed by ':'")
        return key, text[end + 1:].strip()
    m = re.match(r"(.*?):(?:[ \t]+|$)", text)
    if m is None or not m.group(1):
        if text[:2] in ("- ", "? ") or text in ("-", "?"):
            _fail(line, "a block sequence or complex key")
        _fail(line, f"{text!r} is not a 'key: value' line")
    raw = m.group(1).rstrip()
    if raw[0] in _NOT_PLAIN_START or raw[0] in "[,#" or raw[:2] in ("- ", "? "):
        _fail(line, f"the key {raw!r}")
    if raw == "<<":
        _fail(line, "a merge key")
    return _resolve_plain(raw, line), text[m.end():]


def _lines(source: str) -> list[_Line]:
    out = []
    for n, raw in enumerate(source.splitlines(), start=1):
        body = raw.lstrip(" ")
        if not body.strip() or body.lstrip().startswith("#"):
            continue
        if "\t" in body:
            _fail(n, "a tab")
        if raw.startswith(("---", "...", "%")):
            _fail(n, "a document marker or directive")
        out.append(_Line(n, len(raw) - len(body), body.rstrip()))
    return out


def _mapping(lines: list[_Line], i: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i].indent == indent:
        line = lines[i]
        key, rest = _key(line.text, line)
        i += 1
        nested = i < len(lines) and lines[i].indent > indent
        if rest and not rest.startswith("#"):
            if nested:
                _fail(lines[i], "a line indented under a scalar value (a multi-line scalar)")
            out[key] = _value(rest, line)
        elif nested:
            out[key], i = _mapping(lines, i, lines[i].indent)
        else:
            out[key] = None
    if i < len(lines) and lines[i].indent > indent:
        _fail(lines[i], "indentation that matches no open mapping")
    return out, i


def safe_load(source: str):
    """``yaml.safe_load`` for the subset in the module docstring: a block
    mapping (or an empty document, None)."""
    lines = _lines(source)
    if not lines:
        return None
    out, i = _mapping(lines, 0, lines[0].indent)
    if i < len(lines):
        _fail(lines[i], "indentation that matches no open mapping")
    return out
