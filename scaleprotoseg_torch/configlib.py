"""Reader for the gin-style ``config.gin`` a run directory carries.

The subset of gin syntax the shipped configs use: ``a.b.Name.param =
value`` bindings, one per line or continued across unbalanced brackets,
``#`` comments, ``import``/``include`` lines ignored.  Keys resolve by
their final ``Name.param`` pair.  Values are Python literals; anything
else (gin macros, bare identifiers) is kept as its string.

Unlike the JAX package's registry, parsing returns the bindings as a
plain ``{name: {param: value}}`` dict that the caller passes on.
"""

from __future__ import annotations

import ast
from typing import Any, Dict

Bindings = Dict[str, Dict[str, Any]]


class ConfigError(RuntimeError):
    pass


def _parse_value(raw: str) -> Any:
    raw = raw.strip()
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def _strip_comment(line: str) -> str:
    out, in_str, quote = [], False, ""
    for ch in line:
        if in_str:
            out.append(ch)
            if ch == quote:
                in_str = False
        elif ch in ("'", '"'):
            in_str, quote = True, ch
            out.append(ch)
        elif ch == "#":
            break
        else:
            out.append(ch)
    return "".join(out)


def parse_config(text: str) -> Bindings:
    """Parse ``a.b.c.param = value`` lines into ``{name: {param: value}}``."""
    bindings: Bindings = {}
    buffered = ""
    for rawline in text.splitlines():
        line = _strip_comment(rawline).strip()
        if not line:
            continue
        buffered = f"{buffered} {line}" if buffered else line
        if buffered.count("(") > buffered.count(")") or \
           buffered.count("[") > buffered.count("]"):
            continue
        stmt, buffered = buffered, ""
        if stmt.startswith(("import ", "include ")):
            continue
        if "=" not in stmt:
            raise ConfigError(f"Cannot parse config line: {stmt!r}")
        key, _, raw_value = stmt.partition("=")
        parts = key.strip().split(".")
        if len(parts) < 2:
            raise ConfigError(f"Binding key needs name.param form: {key!r}")
        bindings.setdefault(parts[-2], {})[parts[-1]] = \
            _parse_value(raw_value)
    return bindings


def parse_config_file(path: str) -> Bindings:
    with open(path) as f:
        return parse_config(f.read())


def query(bindings: Bindings, name: str, param: str,
          default: Any = None) -> Any:
    return bindings.get(name, {}).get(param, default)


def flat_bindings(bindings: Bindings) -> Dict[str, Any]:
    """``{"Name.param": value}`` of every binding: the hyperparameters a
    metrics sink records (the JAX package records the bindings its calls
    read)."""
    return {f"{name}.{param}": value for name, params in bindings.items()
            for param, value in params.items()}
