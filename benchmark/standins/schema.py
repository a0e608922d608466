"""Structural-schema admission of a VariantAutoscaling: a frozen copy of
the port's `controller/schema.py` validator, reading the shipped CRD's
schema from `crd_schema.json` beside this file (converted once from
`deploy/crd/variantautoscaling-crd.yaml`, its storage version)."""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any

_SCHEMA = json.loads((Path(__file__).parent / "crd_schema.json").read_text())


def _type_name(value: Any) -> str:
    return {
        dict: "object", list: "array", str: "string", bool: "boolean",
        int: "integer", float: "number", type(None): "null",
    }.get(type(value), type(value).__name__)


def _fmt(value: Any) -> str:
    try:
        s = json.dumps(value)
    except (TypeError, ValueError):
        s = repr(value)
    return s if len(s) <= 60 else s[:57] + "..."


def _check_type(value: Any, typ: str) -> bool:
    if typ == "object":
        return isinstance(value, dict)
    if typ == "array":
        return isinstance(value, list)
    if typ == "string":
        return isinstance(value, str)
    if typ == "boolean":
        return isinstance(value, bool)
    if typ == "integer":
        # bool is an int in Python but not in OpenAPI; integral floats are
        # accepted the way the apiserver accepts `3.0` for an integer field
        if isinstance(value, bool):
            return False
        return isinstance(value, int) or (
            isinstance(value, float) and value.is_integer()
        )
    if typ == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    return True  # unknown/absent type constrains nothing


def validate(value: Any, schema: dict, path: str = "") -> list[str]:
    """All violations of `schema` by `value`, apiserver-message style.
    Unknown object fields are NOT errors (structural pruning drops them
    silently; see `prune`)."""
    errors: list[str] = []
    where = path or "<root>"

    typ = schema.get("type")
    if value is None:
        # a present-but-null field fails its type check unless nullable
        if typ and not schema.get("nullable"):
            errors.append(f"{where}: Invalid value: null: must be of type {typ}")
        return errors

    if typ and not _check_type(value, typ):
        errors.append(
            f"{where}: Invalid value: {_fmt(value)}: must be of type "
            f"{typ}, not {_type_name(value)}"
        )
        return errors  # deeper checks are meaningless on the wrong type

    if "enum" in schema and value not in schema["enum"]:
        allowed = ", ".join(_fmt(v) for v in schema["enum"])
        errors.append(
            f"{where}: Unsupported value: {_fmt(value)}: supported values: {allowed}"
        )

    if isinstance(value, str) and "pattern" in schema:
        if re.search(schema["pattern"], value) is None:
            errors.append(
                f"{where}: Invalid value: {_fmt(value)}: must match pattern "
                f"{schema['pattern']}"
            )

    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            errors.append(
                f"{where}: Invalid value: {_fmt(value)}: should be greater "
                f"than or equal to {schema['minimum']}"
            )
        if "maximum" in schema and value > schema["maximum"]:
            errors.append(
                f"{where}: Invalid value: {_fmt(value)}: should be less "
                f"than or equal to {schema['maximum']}"
            )

    if isinstance(value, dict):
        for req in schema.get("required", []):
            if req not in value:
                errors.append(f"{where + '.' if path else ''}{req}: Required value")
        props = schema.get("properties", {})
        addl = schema.get("additionalProperties")
        for key, sub in value.items():
            child_path = f"{path}.{key}" if path else key
            if key in props:
                errors.extend(validate(sub, props[key], child_path))
            elif isinstance(addl, dict):
                errors.extend(validate(sub, addl, child_path))
            # else: unknown field -> pruned, not an error

    if isinstance(value, list):
        if "minItems" in schema and len(value) < schema["minItems"]:
            errors.append(
                f"{where}: Invalid value: must have at least "
                f"{schema['minItems']} items"
            )
        items = schema.get("items")
        if isinstance(items, dict):
            for i, sub in enumerate(value):
                errors.extend(validate(sub, items, f"{path}[{i}]"))

    return errors



def validate_va_dict(obj: dict) -> list[str]:
    """Violations of a VariantAutoscaling in its wire form; metadata is
    object-meta validation's, so only the name's presence is checked."""
    errors: list[str] = []
    if not obj.get("metadata", {}).get("name", ""):
        errors.append("metadata.name: Required value")
    body = {k: v for k, v in obj.items()
            if k not in ("apiVersion", "kind", "metadata")}
    errors.extend(validate(body, _SCHEMA))
    return errors
