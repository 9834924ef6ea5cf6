"""Associative folds — the fold contract and law check of
``surge_tpu/replay/seqpar.py`` in torch.

A model whose fold is **associative** declares

- ``lift(event_fields) -> summary``  — per-event state-transform summary,
- ``combine(s1, s2) -> summary``     — associative (NOT necessarily
  commutative) composition of transforms,
- ``apply(state, summary) -> state`` — apply a composed transform,
- ``identity``                        — the no-op summary (padding lifts here),

as torch functions over lane batches. The replay engine's ``assoc`` tile
backend folds a tile by lifting every slot, combining adjacent pairs over time
and applying the result once (``surge_tpu_torch.replay.engine``), behind the
one-time law check :func:`ensure_validated`.

The time-sharded replay (``replay_time_sharded``: the time axis over a mesh
with one ordered all-gather) needs the mesh and waits for it (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

Summary = Dict[str, Any]


@dataclass(frozen=True)
class AssociativeFold:
    """An associative decomposition of a model's event fold."""

    lift: Callable[[Mapping[str, Any]], Summary]
    combine: Callable[[Summary, Summary], Summary]
    apply: Callable[[Dict[str, Any], Summary], Dict[str, Any]]
    identity: Summary


#: lanes, events per lane and trials of one law check
_LANES, _LENGTH, _TRIALS = 4, 48, 3


def check_associative_fold(afold: AssociativeFold, spec, *,
                           seed: int = 0) -> None:
    """Property-check a decomposition against the spec's step fold on
    randomized event streams (``type_id = -1`` padding included) on the CPU,
    and reject a wrong one loudly: a bad ``combine`` must never silently
    corrupt states.

    Laws checked, per trial:

    1. identity:       ``combine(e, x) == x == combine(x, e)`` and
                       ``apply(s, e) == s``
    2. homomorphism:   ``apply(s, fold_left(combine, lifts)) == step-fold(s)``
                       (the ground truth from ``make_step_fn``)
    3. associativity:  regrouping the combine tree at random cut points
                       changes nothing
    4. padding:        an all-padding stream leaves the state untouched

    Fields are small ints and quarters. Every comparison is byte for byte,
    floats included: a fold passes floats through or selects them, so a
    fold that changes a float's bits is wrong.
    """
    from surge_tpu_torch.replay.engine import make_step_fn

    rng = np.random.default_rng(seed)
    num_types = spec.registry.num_event_types
    step = make_step_fn(spec)  # lane-wise over the batch
    field_specs = [(f.name, np.dtype(f.dtype))
                   for f in spec.registry.union_columns()
                   if f.name != "type_id"]

    def sample(dtype, shape):
        if np.issubdtype(dtype, np.floating):
            return (rng.integers(0, 16, size=shape) * 0.25).astype(dtype)
        if dtype == np.bool_:
            return rng.integers(0, 2, size=shape).astype(dtype)
        return rng.integers(0, 4, size=shape).astype(dtype)

    def fail(law: str, field: str, got, want) -> None:
        raise ValueError(
            f"AssociativeFold violates the {law} law on field {field!r}: "
            f"got {np.asarray(got)!r}, expected {np.asarray(want)!r} — "
            "the decomposition would silently corrupt replays; fix "
            "lift/combine/apply or use the sequential tile backend")

    def eq(law: str, a: Mapping[str, Any], b: Mapping[str, Any]) -> None:
        for k in b:
            av, bv = _np(a[k]), _np(b[k])
            if (av.dtype, av.shape, av.tobytes()) != \
                    (bv.dtype, bv.shape, bv.tobytes()):
                fail(law, k, av, bv)

    ident = {k: _t(np.broadcast_to(np.asarray(v), (_LANES,)))
             for k, v in afold.identity.items()}
    for _ in range(_TRIALS):
        cols = {"type_id": rng.integers(
            -1, num_types, size=(_LENGTH, _LANES)).astype(np.int32)}
        for name, dtype in field_specs:
            cols[name] = sample(dtype, (_LENGTH, _LANES))
        state0 = {f.name: _t(sample(np.dtype(f.dtype), (_LANES,)))
                  for f in spec.registry.state.fields}
        tcols = {k: _t(v) for k, v in cols.items()}

        # ground truth: the spec's per-event step over the lanes
        truth = dict(state0)
        for t in range(_LENGTH):
            truth = step(truth, {k: v[t] for k, v in tcols.items()})

        lifts = [afold.lift({c: v[t] for c, v in tcols.items()})
                 for t in range(_LENGTH)]
        # 1. identity laws (on a representative lifted summary)
        eq("identity (left)", afold.combine(ident, lifts[0]), lifts[0])
        eq("identity (right)", afold.combine(lifts[0], ident), lifts[0])
        eq("identity (apply)", afold.apply(dict(state0), ident), state0)
        # 2. homomorphism vs the step fold
        acc = ident
        for s in lifts:
            acc = afold.combine(acc, s)
        eq("homomorphism (apply∘fold(lift) == step-fold)",
           afold.apply(dict(state0), acc), truth)
        # 3. associativity: random regrouping
        cuts = sorted(rng.choice(range(1, _LENGTH), size=3, replace=False))
        acc2 = ident
        for lo, hi in zip([0, *cuts], [*cuts, _LENGTH]):
            seg = ident
            for s in lifts[lo:hi]:
                seg = afold.combine(seg, s)
            acc2 = afold.combine(acc2, seg)
        eq("associativity (regrouped combine)",
           afold.apply(dict(state0), acc2), truth)
        # 4. padding lifts to a no-op
        pad = dict(tcols)
        pad["type_id"] = torch.full_like(tcols["type_id"], -1)
        pacc = ident
        for t in range(_LENGTH):
            pacc = afold.combine(pacc, afold.lift(
                {c: v[t] for c, v in pad.items()}))
        eq("padding (type_id=-1 is identity)",
           afold.apply(dict(state0), pacc), state0)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


#: structural (fold, spec) keys that already passed check_associative_fold
_VALIDATED: set = set()


def ensure_validated(afold: AssociativeFold, spec) -> None:
    """Law-check ``afold`` against ``spec`` once per structural (fold, spec)
    pair — keyed on the PAIR because the laws tie a decomposition to one
    spec's handlers; the same fold against a different spec is re-checked,
    not skipped. The engine's assoc tile backend runs it before its first
    fold."""
    vkey = (fold_key(afold), _spec_key(spec))
    if vkey not in _VALIDATED:
        check_associative_fold(afold, spec)
        _VALIDATED.add(vkey)


def _hash_or_id(v):
    try:
        hash(v)
        return v
    except TypeError:
        return ("id", id(v))


def _callable_key(fn) -> tuple:
    """Structural identity of a fold callable: its code object plus every
    captured input that parameterizes it — closure cells, default args, and a
    bound method's receiver (two folds differing only in a default-arg capture
    or in ``self`` must NOT collide). Hashables key by value, the rest by
    object id."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return ("obj", id(fn))
    cells = tuple(_hash_or_id(c.cell_contents)
                  for c in (getattr(fn, "__closure__", None) or ()))
    defaults = tuple(_hash_or_id(d)
                     for d in (getattr(fn, "__defaults__", None) or ()))
    kwdefaults = tuple(sorted(
        (k, _hash_or_id(v))
        for k, v in (getattr(fn, "__kwdefaults__", None) or {}).items()))
    receiver = getattr(fn, "__self__", None)
    return ("code", code, cells, defaults, kwdefaults,
            ("id", id(receiver)) if receiver is not None else None)


def _spec_key(spec) -> tuple:
    """Structural identity of a ReplaySpec for the validation cache: schema
    shape plus the handler callables' structural keys (handlers carry the
    semantics the laws are checked against)."""
    num_types = spec.registry.num_event_types
    return (num_types,
            tuple((f.name, str(f.dtype))
                  for f in spec.registry.state.fields),
            tuple(_callable_key(h)
                  for h in spec.handlers.ordered(num_types)))


def fold_key(afold: AssociativeFold) -> tuple:
    """Hashable structural key: two folds made by the same factory with equal
    captures compare equal."""
    ident = tuple(sorted(
        (k, np.asarray(v).dtype.str, np.asarray(v).item()
         if np.ndim(v) == 0 else tuple(np.asarray(v).ravel().tolist()))
        for k, v in afold.identity.items()))
    return (_callable_key(afold.lift), _callable_key(afold.combine),
            _callable_key(afold.apply), ident)
