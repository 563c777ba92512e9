"""Minimal JSON-schema validation for exported traces.

The container has no ``jsonschema`` package, so this implements the
small subset the checked-in ``trace_schema.json`` uses — ``type``,
``required``, ``properties``, ``additionalProperties`` (schema form),
``items``, ``enum``, ``minItems`` — enough to pin the exporter's output
shape in tests and fail loudly on a malformed export.  It is not a
general validator and does not resolve ``$ref``.
"""
from __future__ import annotations

import json
import os
from typing import Any, List

__all__ = ["SchemaError", "load_schema", "validate", "validate_trace"]

_SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "trace_schema.json")

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "number": (int, float),
    "integer": int,
    "boolean": bool,
    "null": type(None),
}


class SchemaError(ValueError):
    """Raised when an instance does not match the schema."""


def load_schema() -> dict:
    with open(_SCHEMA_PATH) as fh:
        return json.load(fh)


def _check(obj: Any, schema: dict, path: str, errors: List[str]) -> None:
    typ = schema.get("type")
    if typ is not None:
        types = typ if isinstance(typ, list) else [typ]
        pytypes = tuple(t for name in types for t in (
            _TYPES[name] if isinstance(_TYPES[name], tuple)
            else (_TYPES[name],)
        ))
        ok = isinstance(obj, pytypes)
        # bool is an int subclass in Python; keep them distinct
        if ok and isinstance(obj, bool) and "boolean" not in types:
            ok = False
        if not ok:
            errors.append(f"{path}: expected {typ}, got {type(obj).__name__}")
            return
    if "enum" in schema and obj not in schema["enum"]:
        errors.append(f"{path}: {obj!r} not in enum {schema['enum']}")
    if isinstance(obj, dict):
        for key in schema.get("required", ()):
            if key not in obj:
                errors.append(f"{path}: missing required key {key!r}")
        props = schema.get("properties", {})
        for key, sub in props.items():
            if key in obj:
                _check(obj[key], sub, f"{path}.{key}", errors)
        extra = schema.get("additionalProperties")
        if isinstance(extra, dict):
            for key, val in obj.items():
                if key not in props:
                    _check(val, extra, f"{path}.{key}", errors)
        elif extra is False:
            for key in obj:
                if key not in props:
                    errors.append(f"{path}: unexpected key {key!r}")
    if isinstance(obj, list):
        if "minItems" in schema and len(obj) < schema["minItems"]:
            errors.append(
                f"{path}: {len(obj)} items < minItems {schema['minItems']}"
            )
        items = schema.get("items")
        if isinstance(items, dict):
            for i, val in enumerate(obj):
                _check(val, items, f"{path}[{i}]", errors)


def validate(obj: Any, schema: dict) -> None:
    """Raise :class:`SchemaError` (listing every mismatch) if ``obj``
    does not conform to ``schema``."""
    errors: List[str] = []
    _check(obj, schema, "$", errors)
    if errors:
        raise SchemaError(
            f"{len(errors)} schema violation(s):\n  " + "\n  ".join(errors[:20])
        )


def validate_trace(obj: Any) -> None:
    """Validate a Chrome-trace export against ``trace_schema.json``."""
    validate(obj, load_schema())
