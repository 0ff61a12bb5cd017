"""Minimal JSON-Schema-subset validator (stdlib-only).

Counterpart of ``repro.obs.schema``. The containers this repo targets do
not ship ``jsonschema``; the trace schema (``obs/trace_schema.json``)
only needs the core keywords (``type``, ``required``, ``properties``,
``items``, ``enum``), so a 30-line structural walk covers it. Unknown keywords are ignored, same
as full JSON Schema.
"""
from __future__ import annotations

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "number": (int, float),
    "integer": int,
    "boolean": bool,
    "null": type(None),
}


def validate(instance, schema: dict, path: str = "$") -> None:
    """Raise ``ValueError`` naming the offending path on mismatch."""
    t = schema.get("type")
    if t is not None:
        py = _TYPES[t]
        ok = isinstance(instance, py)
        if ok and t in ("number", "integer") and isinstance(instance, bool):
            ok = False  # bool is an int subclass; schemas mean numbers
        if not ok:
            raise ValueError(
                f"{path}: expected {t}, got {type(instance).__name__}")
    if "enum" in schema and instance not in schema["enum"]:
        raise ValueError(
            f"{path}: {instance!r} not in enum {schema['enum']!r}")
    if isinstance(instance, dict):
        for key in schema.get("required", ()):
            if key not in instance:
                raise ValueError(f"{path}: missing required key {key!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in instance:
                validate(instance[key], sub, f"{path}.{key}")
    if isinstance(instance, list) and "items" in schema:
        for i, item in enumerate(instance):
            validate(item, schema["items"], f"{path}[{i}]")
