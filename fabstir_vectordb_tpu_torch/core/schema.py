"""Optional metadata schema validation.

Behavioral parity with the reference schema layer (reference: src/core/schema.rs):
  - field types: string / number / boolean / array<T> / object{fields}
    validated recursively (:37-150);
  - null is always allowed for any declared type (:69-71);
  - required fields must be present and non-null (:181-207);
  - undeclared fields are allowed (validation only checks declared ones).

JSON schema declaration format (matches the Node SDK, bindings/node/index.d.ts
setSchema docs):

    {"fields": {"title": {"type": "string"},
                "views": {"type": "number"},
                "tags": {"type": "array", "items": {"type": "string"}},
                "author": {"type": "object", "fields": {...}}},
     "required": ["title"]}
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


class SchemaError(ValueError):
    """Schema declaration or metadata validation failure."""


def _type_name(value: Any) -> str:
    if value is None:
        return "Null"
    if isinstance(value, bool):
        return "Boolean"
    if isinstance(value, (int, float)):
        return "Number"
    if isinstance(value, str):
        return "String"
    if isinstance(value, list):
        return "Array"
    if isinstance(value, dict):
        return "Object"
    return type(value).__name__


@dataclass(frozen=True)
class FieldType:
    """A declared field type; kind in {string, number, boolean, array, object}."""

    kind: str
    items: "FieldType | None" = None  # for arrays
    fields: dict = field(default_factory=dict)  # for objects

    @classmethod
    def from_json(cls, decl: Any) -> "FieldType":
        if not isinstance(decl, dict) or "type" not in decl:
            raise SchemaError(f"invalid field declaration: {decl!r}")
        kind = str(decl["type"]).lower()
        if kind == "array":
            items = cls.from_json(decl["items"]) if "items" in decl else None
            return cls("array", items=items)
        if kind == "object":
            fields = {
                k: cls.from_json(v) for k, v in (decl.get("fields") or {}).items()
            }
            return cls("object", fields=fields)
        if kind in ("string", "number", "boolean"):
            return cls(kind)
        raise SchemaError(f"unknown field type: {decl['type']!r}")

    def to_json(self) -> dict:
        if self.kind == "array":
            out: dict = {"type": "array"}
            if self.items is not None:
                out["items"] = self.items.to_json()
            return out
        if self.kind == "object":
            return {
                "type": "object",
                "fields": {k: v.to_json() for k, v in self.fields.items()},
            }
        return {"type": self.kind}

    def type_name(self) -> str:
        if self.kind == "array":
            inner = self.items.type_name() if self.items else "Any"
            return f"Array<{inner}>"
        return self.kind.capitalize()

    def validate_value(self, field_name: str, value: Any) -> None:
        if value is None:  # null always allowed
            return
        if self.kind == "string":
            if not isinstance(value, str):
                self._fail(field_name, value)
        elif self.kind == "number":
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                self._fail(field_name, value)
        elif self.kind == "boolean":
            if not isinstance(value, bool):
                self._fail(field_name, value)
        elif self.kind == "array":
            if not isinstance(value, list):
                self._fail(field_name, value)
            if self.items is not None:
                for i, elem in enumerate(value):
                    if elem is not None:
                        self.items.validate_value(f"{field_name}[{i}]", elem)
        elif self.kind == "object":
            if not isinstance(value, dict):
                self._fail(field_name, value)
            for key, ftype in self.fields.items():
                if key in value:
                    ftype.validate_value(f"{field_name}.{key}", value[key])

    def _fail(self, field_name: str, value: Any):
        raise SchemaError(
            f"Invalid type for field '{field_name}': expected "
            f"{self.type_name()}, got {_type_name(value)}"
        )


@dataclass
class MetadataSchema:
    fields: dict  # name -> FieldType
    required: set

    @classmethod
    def from_json(cls, decl: Any) -> "MetadataSchema":
        if not isinstance(decl, dict):
            raise SchemaError("schema must be a JSON object")
        if decl and "fields" not in decl and "required" not in decl:
            # a non-empty declaration without the schema shape would parse
            # as an EMPTY schema that validates everything — reject the
            # silent misconfiguration (e.g. the flat {"name": "string"}
            # shorthand) instead of pretending to enforce it
            raise SchemaError(
                'schema must use {"fields": {name: {"type": ...}}, '
                '"required": [...]} — got a declaration with neither key'
            )
        fields = {
            name: FieldType.from_json(ft)
            for name, ft in (decl.get("fields") or {}).items()
        }
        required = set(decl.get("required") or [])
        unknown = required - set(fields)
        if unknown:
            raise SchemaError(f"required fields not declared: {sorted(unknown)}")
        return cls(fields=fields, required=required)

    def to_json(self) -> dict:
        return {
            "fields": {k: v.to_json() for k, v in self.fields.items()},
            "required": sorted(self.required),
        }

    def validate(self, metadata: Any) -> None:
        if metadata is None:
            metadata = {}
        if not isinstance(metadata, dict):
            raise SchemaError(f"metadata must be an object, got {_type_name(metadata)}")
        for name in self.required:
            if name not in metadata or metadata[name] is None:
                raise SchemaError(f"Missing required field: '{name}'")
        for name, ftype in self.fields.items():
            if name in metadata:
                ftype.validate_value(name, metadata[name])
