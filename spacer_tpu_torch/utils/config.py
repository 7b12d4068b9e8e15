# Copied from spacer_tpu/utils/config.py (numpy / stdlib only; no JAX).
"""Minimal dataclass config system: yaml file + --key value argv overrides.

Replaces TRL's TrlParser usage (SG-RLVR.py:390-392) without the TRL
dependency: `parse_configs((A, B), argv)` fills multiple dataclasses from
one flat namespace (first dataclass owning a field wins).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Sequence, Type, get_args, get_origin


def _coerce(value: str, typ) -> Any:
    origin = get_origin(typ)
    if origin in (list, tuple):
        inner = get_args(typ)[0] if get_args(typ) else str
        parts = [p for p in value.split(",") if p != ""]
        out = [_coerce(p, inner) for p in parts]
        return tuple(out) if origin is tuple else out
    if typ is bool or str(typ) in ("bool", "typing.Optional[bool]"):
        return value.lower() in ("1", "true", "yes", "on")
    for t in (int, float):
        if typ is t:
            return t(value)
    if get_origin(typ) is None and isinstance(typ, type):
        try:
            return typ(value)
        except Exception:
            pass
    # Optional[int] etc.
    args = [a for a in get_args(typ) if a is not type(None)]
    if args:
        return _coerce(value, args[0])
    return value


def parse_configs(
    dataclass_types: Sequence[Type],
    argv: Sequence[str] | None = None,
):
    """Returns one instance per dataclass type, populated from an optional
    `--config file.yaml|file.json` plus `--field value` overrides."""
    argv = list(sys.argv[1:] if argv is None else argv)

    file_values: dict[str, Any] = {}
    if "--config" in argv:
        i = argv.index("--config")
        path = argv[i + 1]
        del argv[i : i + 2]
        if path.endswith((".yaml", ".yml")):
            import yaml

            with open(path) as f:
                file_values = yaml.safe_load(f) or {}
        else:
            with open(path) as f:
                file_values = json.load(f)

    cli_values: dict[str, Any] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"unexpected argument: {tok}")
        key = tok[2:].replace("-", "_")
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            cli_values[key] = argv[i + 1]
            i += 2
        else:
            cli_values[key] = "true"  # bare flag
            i += 1

    instances = []
    consumed = set()
    for dc in dataclass_types:
        fields = {f.name: f for f in dataclasses.fields(dc)}
        kwargs = {}
        for name, f in fields.items():
            if name in cli_values:
                kwargs[name] = _coerce(cli_values[name], f.type if not isinstance(f.type, str) else _resolve(dc, name))
                consumed.add(name)
            elif name in file_values:
                v = file_values[name]
                kwargs[name] = (
                    _coerce(str(v), _resolve(dc, name)) if isinstance(v, str)
                    else v
                )
                consumed.add(name)
        instances.append(dc(**kwargs))
    unknown = set(cli_values) - consumed
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return tuple(instances)


def _resolve(dc, name):
    import typing

    hints = typing.get_type_hints(dc)
    return hints.get(name, str)
