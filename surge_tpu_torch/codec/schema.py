"""Declarative schemas mapping domain dataclasses to fixed tensor layouts — a copy
of ``surge_tpu/codec/schema.py`` (``FieldSpec``, ``event_fields_from_dataclass``,
``EventSchema``, ``StateSchema``, ``SchemaRegistry``).

Every event type a model emits is registered under a small integer ``type_id``. The
registry derives the *union column layout* — the sorted set of (field name → dtype)
across all registered event types — so a heterogeneous event stream encodes as one
struct-of-arrays batch with a ``type_ids`` column.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np


_DTYPE_FOR_ANNOTATION = {
    int: np.dtype(np.int32),
    float: np.dtype(np.float32),
    bool: np.dtype(np.bool_),
}


@dataclass(frozen=True)
class FieldSpec:
    """A single numeric field of an event/state schema.

    ``bits`` (optional) declares the field's wire width for the bit-packed transfer
    format (surge_tpu_torch.codec.wire): an unsigned value in ``[0, 2**bits)``. Fields
    without ``bits`` ride the wire as full-width side columns. Only unsigned integer
    ranges can be packed; host→device transfer is the replay bottleneck
    (SURVEY.md §7 hard-part 2), so narrow event payloads should declare it.
    """

    name: str
    dtype: np.dtype
    bits: int | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        if self.bits is not None:
            if self.dtype.kind not in "iub":
                raise TypeError(f"field {self.name}: bits= requires an integer/bool "
                                f"dtype, got {self.dtype}")
            if not 0 < self.bits <= 30:
                raise ValueError(f"field {self.name}: bits must be in [1, 30]")


def event_fields_from_dataclass(cls: type, overrides: Mapping[str, Any] | None = None,
                                exclude: Iterable[str] = (),
                                bits: Mapping[str, int] | None = None) -> tuple[FieldSpec, ...]:
    """Derive FieldSpecs from a dataclass's annotations (int→i32, float→f32, bool→bool).

    ``bits`` maps field names to wire bit widths (see :class:`FieldSpec`)."""
    overrides = dict(overrides or {})
    bits = dict(bits or {})
    excluded = set(exclude)
    specs = []
    for f in dataclasses.fields(cls):
        if f.name in excluded:
            continue
        if f.name in overrides:
            specs.append(FieldSpec(f.name, np.dtype(overrides[f.name]),
                                   bits=bits.get(f.name)))
            continue
        dt = _DTYPE_FOR_ANNOTATION.get(f.type if isinstance(f.type, type) else None)
        if dt is None:
            # string annotations (PEP 563) — resolve the common builtins textually
            dt = {"int": np.dtype(np.int32), "float": np.dtype(np.float32),
                  "bool": np.dtype(np.bool_)}.get(str(f.type))
        if dt is None:
            raise TypeError(
                f"{cls.__name__}.{f.name}: unsupported tensor field type {f.type!r}; "
                f"exclude it or dictionary-encode it (Vocab) first")
        specs.append(FieldSpec(f.name, dt, bits=bits.get(f.name)))
    return tuple(specs)


@dataclass(frozen=True)
class EventSchema:
    """One event type's layout: its type_id and the numeric fields it carries."""

    cls: type
    type_id: int
    fields: tuple[FieldSpec, ...]
    # host-side extraction: event -> field value (defaults to getattr)
    getter: Callable[[Any, str], Any] = getattr

    @property
    def field_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.fields)


@dataclass(frozen=True)
class StateSchema:
    """Aggregate state layout: a flat record of numeric fields.

    The batched replay carry is a dict-of-arrays pytree ``{name: [B]}``; models' JAX folds
    read and write these columns. ``to_record``/``from_record`` bridge the scalar world.
    """

    cls: type
    fields: tuple[FieldSpec, ...]

    @property
    def field_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def to_record(self, state: Any) -> dict[str, Any]:
        return {f.name: getattr(state, f.name) for f in self.fields}

    def from_record(self, record: Mapping[str, Any]) -> Any:
        kwargs = {}
        for f in self.fields:
            v = record[f.name]
            if isinstance(v, (np.generic, np.ndarray)):
                v = v.item() if np.ndim(v) == 0 else v
            if f.dtype.kind == "b":
                v = bool(v)
            elif f.dtype.kind in "iu":
                v = int(v)
            elif f.dtype.kind == "f":
                v = float(v)
            kwargs[f.name] = v
        from surge_tpu_torch.codec.tensor import _construct

        return _construct(self.cls, kwargs)


class SchemaRegistry:
    """Registry of one model family's event types + state type.

    Equivalent role to the reference's read/write formatting bundle on
    ``SurgeGenericBusinessLogicTrait`` (commondsl/SurgeGenericBusinessLogicTrait.scala:16-64),
    extended with the tensor layout the replay engine consumes.
    """

    def __init__(self) -> None:
        self._by_cls: dict[type, EventSchema] = {}
        self._by_id: dict[int, EventSchema] = {}
        self._state: StateSchema | None = None

    # -- registration -----------------------------------------------------------------
    def register_event(self, cls: type, *, type_id: int | None = None,
                       fields: Sequence[FieldSpec] | None = None,
                       overrides: Mapping[str, Any] | None = None,
                       exclude: Iterable[str] = (),
                       bits: Mapping[str, int] | None = None) -> EventSchema:
        if cls in self._by_cls:
            raise ValueError(f"event type {cls.__name__} already registered")
        tid = type_id if type_id is not None else len(self._by_id)
        if tid in self._by_id:
            raise ValueError(f"type_id {tid} already taken by {self._by_id[tid].cls.__name__}")
        fs = tuple(fields) if fields is not None else event_fields_from_dataclass(
            cls, overrides=overrides, exclude=exclude, bits=bits)
        schema = EventSchema(cls=cls, type_id=tid, fields=fs)
        self._by_cls[cls] = schema
        self._by_id[tid] = schema
        return schema

    def register_state(self, cls: type, *, fields: Sequence[FieldSpec] | None = None,
                       overrides: Mapping[str, Any] | None = None,
                       exclude: Iterable[str] = ()) -> StateSchema:
        fs = tuple(fields) if fields is not None else event_fields_from_dataclass(
            cls, overrides=overrides, exclude=exclude)
        self._state = StateSchema(cls=cls, fields=fs)
        return self._state

    # -- lookup -----------------------------------------------------------------------
    @property
    def state(self) -> StateSchema:
        if self._state is None:
            raise ValueError("no state schema registered")
        return self._state

    def schema_for(self, event: Any) -> EventSchema:
        return self.schema_for_cls(type(event))

    def schema_for_cls(self, cls: type) -> EventSchema:
        s = self._by_cls.get(cls)
        if s is None:
            raise KeyError(f"unregistered event type {cls.__name__}")
        return s

    def schema_for_id(self, type_id: int) -> EventSchema:
        return self._by_id[type_id]

    @property
    def event_schemas(self) -> tuple[EventSchema, ...]:
        return tuple(self._by_id[k] for k in sorted(self._by_id))

    @property
    def num_event_types(self) -> int:
        return (max(self._by_id) + 1) if self._by_id else 0

    def union_columns(self) -> tuple[FieldSpec, ...]:
        """The union layout: one column per distinct field name, dtype-promoted.

        ``bits`` merges to the max declared width, but only when *every* event type
        carrying the field declares one — a single undeclared use forces the column
        to full width (packing a value that overflows its bits would corrupt
        neighbours)."""
        merged: dict[str, np.dtype] = {}
        merged_bits: dict[str, int | None] = {}
        for schema in self.event_schemas:
            for f in schema.fields:
                if f.name in merged:
                    merged[f.name] = np.promote_types(merged[f.name], f.dtype)
                    old = merged_bits[f.name]
                    merged_bits[f.name] = (max(old, f.bits)
                                           if (old is not None and f.bits is not None)
                                           else None)
                else:
                    merged[f.name] = f.dtype
                    merged_bits[f.name] = f.bits
        return tuple(FieldSpec(n, merged[n], bits=merged_bits[n]) for n in sorted(merged))
