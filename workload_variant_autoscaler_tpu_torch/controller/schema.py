"""OpenAPI v3 structural-schema validation for the VariantAutoscaling CRD.

The reference gets CRD validation for free from a real API server in its
envtest tier (reference internal/controller/suite_test.go:56-93 applies
config/crd/bases before any controller test runs). This rebuild also has
an envtest tier (tests/test_envtest.py), but that tier needs external
binaries; to keep apiserver admission semantics exercised *everywhere*,
the in-memory fake API server enforces the very same structural schema —
loaded from the shipped CRD manifest (deploy/crd/variantautoscaling-crd.yaml),
not re-declared in Python — so an object the fake admits is an object the
real apiserver admits.

Implements the subset of OpenAPI v3 the structural-schema flavor allows
and the CRD uses: type, required, properties, items, additionalProperties,
minimum/maximum, enum, pattern, plus structural pruning of unknown fields
(apiextensions default when x-kubernetes-preserve-unknown-fields is off).
Error strings follow the apiserver's field-path style
(`spec.modelID: Required value`,
`spec...accCount: Invalid value: 0: should be greater than or equal to 1`).
"""

from __future__ import annotations

import json
import re
import threading
from pathlib import Path
from typing import Any, Optional

import yaml

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CRD_PATH = REPO_ROOT / "deploy" / "crd" / "variantautoscaling-crd.yaml"

_lock = threading.Lock()
_schema_cache: dict[str, dict] = {}


def load_crd_schema(path: Optional[str | Path] = None) -> dict:
    """Root openAPIV3Schema of the storage version of the shipped CRD."""
    p = str(path or DEFAULT_CRD_PATH)
    with _lock:
        if p in _schema_cache:
            return _schema_cache[p]
    with open(p) as f:
        crd = yaml.safe_load(f)
    versions = crd["spec"]["versions"]
    version = next(
        (v for v in versions if v.get("storage")), versions[0]
    )
    schema = version["schema"]["openAPIV3Schema"]
    with _lock:
        _schema_cache[p] = schema
    return schema


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


def prune(value: Any, schema: dict) -> Any:
    """Structural pruning: return a copy of `value` with fields not
    declared by the schema removed (apiextensions behavior for CRDs
    without x-kubernetes-preserve-unknown-fields)."""
    if isinstance(value, dict) and schema.get("type") == "object":
        props = schema.get("properties", {})
        addl = schema.get("additionalProperties")
        if schema.get("x-kubernetes-preserve-unknown-fields"):
            return {k: v for k, v in value.items()}
        out = {}
        for key, sub in value.items():
            if key in props:
                out[key] = prune(sub, props[key])
            elif addl is not None:
                out[key] = prune(sub, addl) if isinstance(addl, dict) else sub
        return out
    if isinstance(value, list) and schema.get("type") == "array":
        items = schema.get("items")
        if isinstance(items, dict):
            return [prune(v, items) for v in value]
        return list(value)
    return value


def validate_va_dict(obj: dict, schema: Optional[dict] = None) -> list[str]:
    """Validate a VariantAutoscaling object (wire/dict form) against the
    shipped CRD schema. `metadata` is handled by apiserver object-meta
    validation, not the CRD schema, so only name presence is checked."""
    schema = schema or load_crd_schema()
    errors: list[str] = []
    name = obj.get("metadata", {}).get("name", "")
    if not name:
        errors.append("metadata.name: Required value")
    body = {k: v for k, v in obj.items()
            if k not in ("apiVersion", "kind", "metadata")}
    errors.extend(validate(body, schema))
    return errors


def validate_manifest_file(path: str | Path) -> dict[str, list[str]]:
    """Validate every VariantAutoscaling document in a (multi-doc) YAML
    manifest. Returns {<doc name>: [errors]} for VA docs only — an offline
    `kubectl apply --dry-run=server` for this CRD."""
    results: dict[str, list[str]] = {}
    with open(path) as f:
        for doc in yaml.safe_load_all(f):
            if not isinstance(doc, dict) or doc.get("kind") != "VariantAutoscaling":
                continue
            name = doc.get("metadata", {}).get("name", "<unnamed>")
            results[name] = validate_va_dict(doc)
    return results


def main(argv: Optional[list[str]] = None) -> int:
    """CLI: `python -m workload_variant_autoscaler_tpu_torch.controller.schema
    <manifest.yaml>...` — exit nonzero if any VA document is invalid."""
    import sys

    args = sys.argv[1:] if argv is None else argv
    if not args:
        print("usage: schema <manifest.yaml> [...]", file=sys.stderr)
        return 2
    rc = 0
    for p in args:
        for name, errs in validate_manifest_file(p).items():
            if errs:
                rc = 1
                for e in errs:
                    print(f"{p}: VariantAutoscaling/{name}: {e}")
            else:
                print(f"{p}: VariantAutoscaling/{name}: OK")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
