"""Mixed aggregate-type replay: several model families folded in ONE batch —
the port's copy of ``surge_tpu/replay/mixed.py``.

:func:`combine_replay_specs` merges model families' ``ReplaySpec``\\ s into one:
event type ids get disjoint ranges (bases assigned in sorted model-name
order), event and state columns merge into one union layout (tagged-union
columns, dtype-promoted by name: each lane only ever reads its own family's
fields), and the select step's per-type dispatch does the rest. One
``ReplayEngine`` over the combined spec then folds counters, carts, bank
accounts and sagas side by side in the same batch.

Beyond the reference, the combined spec carries what the fold kernels need to
fold it: a :class:`~surge_tpu_torch.engine.model.MixedKernelStep` naming each
part's own ``kernel_step`` and its type-id range
(``surge_tpu_torch/csrc/fold_common.cuh``, ``MixedStep``).

Scalar-world bridges (:meth:`MixedReplay.encode_logs`,
:meth:`MixedReplay.init_carry`, :meth:`MixedReplay.decode_states`) keep each
lane's model identity so states decode back to their own dataclasses.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np

from surge_tpu_torch.codec.schema import FieldSpec, SchemaRegistry
from surge_tpu_torch.codec.tensor import ColumnarEvents, encode_events_columnar
from surge_tpu_torch.engine.model import (
    KernelPart,
    MixedKernelStep,
    ReplayHandlers,
    ReplaySpec,
)


@dataclass
class MixedReplay:
    """A combined spec plus the per-model bookkeeping to use it."""

    spec: ReplaySpec
    #: model name -> type_id offset of its events in the combined registry
    bases: dict[str, int]
    #: model name -> its original ReplaySpec
    parts: dict[str, ReplaySpec]

    def type_id(self, model: str, local_type_id: int) -> int:
        return self.bases[model] + local_type_id

    def encode_logs(self, tagged_logs: Sequence[tuple[str, Sequence[Any]]]
                    ) -> ColumnarEvents:
        """Columnar-encode per-aggregate logs tagged with their model name.
        Events must already be in their tensor form (bank_account's
        vocab-encoded ``EncodedCreated``); the merged registry maps each event
        class to its offset type id, and the tags are read later, by
        :meth:`init_carry` and :meth:`decode_states`."""
        return encode_events_columnar(self.spec.registry,
                                      [log for _, log in tagged_logs])

    def init_carry(self, models: Sequence[str]) -> dict[str, np.ndarray]:
        """Per-lane initial carry: each lane starts at ITS model's init record
        (models may disagree about a shared column's default)."""
        fields = self.spec.registry.state.fields
        models = np.asarray(models, dtype=object)
        out = {f.name: np.zeros((len(models),), dtype=f.dtype) for f in fields}
        for m, part in self.parts.items():
            lanes = models == m
            for name, v in part.init_state_tree().items():
                out[name][lanes] = v
        return out

    def decode_states(self, models: Sequence[str],
                      states: Mapping[str, np.ndarray]) -> list[Any]:
        """Decode the folded union columns lane by lane through each lane's own
        model state schema."""
        out = []
        for i, m in enumerate(models):
            schema = self.parts[m].registry.state
            out.append(schema.from_record(
                {f.name: states[f.name][i] for f in schema.fields}))
        return out


def combine_replay_specs(specs: Mapping[str, ReplaySpec]) -> MixedReplay:
    """Merge model families into one replayable spec (sorted by model name so
    type-id assignment is deterministic).

    Shared column names are legal (the union layout promotes dtypes and each
    lane's handlers only touch their own model's fields), but one event CLASS
    may not belong to two models.

    The combined spec's own ``init_record`` is empty (all-zero lanes), so
    models that declare a nonzero ``init_record`` are REFUSED here: use
    :func:`combine_replay_specs_with_init` to acknowledge that, and always
    supply ``init_carry=mixed.init_carry(models)`` to the fold."""
    return _combine(specs, allow_nonzero_init=False)


def combine_replay_specs_with_init(specs: Mapping[str, ReplaySpec]) -> MixedReplay:
    """:func:`combine_replay_specs` for model sets with nonzero init records —
    the caller promises to pass ``init_carry=mixed.init_carry(models)``."""
    return _combine(specs, allow_nonzero_init=True)


def _combine(specs: Mapping[str, ReplaySpec], *,
             allow_nonzero_init: bool) -> MixedReplay:
    merged = SchemaRegistry()
    bases: dict[str, int] = {}
    handlers: dict[int, Any] = {}
    state_fields: dict[str, np.dtype] = {}
    offset = 0
    for name in sorted(specs):
        spec = specs[name]
        if not allow_nonzero_init and any(
                np.any(np.asarray(v) != 0) for v in spec.init_record.values()):
            raise ValueError(
                f"model {name!r} declares a nonzero init_record, which a "
                "combined spec cannot honor per-lane; use "
                "combine_replay_specs_with_init and pass "
                "init_carry=mixed.init_carry(models) to the fold")
        bases[name] = offset
        for schema in spec.registry.event_schemas:
            merged.register_event(schema.cls,
                                  type_id=offset + schema.type_id,
                                  fields=schema.fields)
        for tid, h in spec.handlers.by_type_id.items():
            handlers[offset + tid] = h
        for f in spec.registry.state.fields:
            if f.name in state_fields:
                state_fields[f.name] = np.promote_types(state_fields[f.name],
                                                        f.dtype)
            else:
                state_fields[f.name] = f.dtype
        offset += spec.registry.num_event_types

    fields = tuple(FieldSpec(n, state_fields[n]) for n in sorted(state_fields))
    cls = dataclasses.make_dataclass(
        "MixedState", [(f.name, object) for f in fields])
    merged.register_state(cls, fields=fields)
    combined = ReplaySpec(registry=merged,
                          handlers=ReplayHandlers(by_type_id=handlers),
                          init_record={},
                          kernel_step=_kernel_parts(specs, bases))
    return MixedReplay(spec=combined, bases=bases, parts=dict(specs))


def _kernel_parts(specs: Mapping[str, ReplaySpec],
                  bases: Mapping[str, int]) -> MixedKernelStep:
    """Each part's kernel step and type-id range."""
    parts = []
    for name in sorted(specs):
        step = specs[name].kernel_step
        parts.append(KernelPart(
            model=name, step=step if isinstance(step, str) else None,
            base=bases[name], num_types=specs[name].registry.num_event_types))
    return MixedKernelStep(parts=tuple(parts))
