"""ShoppingCart fixture, replay half — the counterpart of the tensor path of
``surge_tpu/models/shopping_cart.py``: the ``Cart`` state and event
dataclasses, ``make_registry``, ``make_replay_spec`` with torch handlers and
``make_associative_fold``.

Its int columns declare no wire width, so ``item_code``, ``quantity`` and
``unit_price_cents`` ride as int32 side columns (and ``sequence_number`` too
unless it is derived); ``checked_out`` is bool state. ``total_cents`` adds
``quantity * unit_price_cents``, an int32 product that wraps as the
reference's does.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from surge_tpu_torch.codec.schema import SchemaRegistry
from surge_tpu_torch.engine.model import ReplayHandlers, ReplaySpec


@dataclass(frozen=True)
class Cart:
    cart_id: str
    item_count: int
    total_cents: int
    checked_out: bool
    version: int


@dataclass(frozen=True)
class ItemAdded:
    cart_id: str
    item_code: int
    quantity: int
    unit_price_cents: int
    sequence_number: int


@dataclass(frozen=True)
class ItemRemoved:
    cart_id: str
    item_code: int
    quantity: int
    unit_price_cents: int
    sequence_number: int


@dataclass(frozen=True)
class CheckedOut:
    cart_id: str
    sequence_number: int


ADDED, REMOVED, CHECKED_OUT = 0, 1, 2


def make_registry() -> SchemaRegistry:
    reg = SchemaRegistry()
    reg.register_event(ItemAdded, type_id=ADDED, exclude=("cart_id",))
    reg.register_event(ItemRemoved, type_id=REMOVED, exclude=("cart_id",))
    reg.register_event(CheckedOut, type_id=CHECKED_OUT, exclude=("cart_id",))
    reg.register_state(Cart, exclude=("cart_id",))
    return reg


def make_replay_spec() -> ReplaySpec:
    def added(s, f):
        return {"item_count": s["item_count"] + f["quantity"],
                "total_cents": s["total_cents"] + f["quantity"] * f["unit_price_cents"],
                "checked_out": s["checked_out"],
                "version": f["sequence_number"]}

    def removed(s, f):
        return {"item_count": s["item_count"] - f["quantity"],
                "total_cents": s["total_cents"] - f["quantity"] * f["unit_price_cents"],
                "checked_out": s["checked_out"],
                "version": f["sequence_number"]}

    def checked_out(s, f):
        return {"item_count": s["item_count"], "total_cents": s["total_cents"],
                "checked_out": True, "version": f["sequence_number"]}

    return ReplaySpec(
        registry=make_registry(),
        handlers=ReplayHandlers({ADDED: added, REMOVED: removed,
                                 CHECKED_OUT: checked_out}),
        init_record={"item_count": 0, "total_cents": 0, "checked_out": False,
                     "version": 0},
        kernel_step="shopping_cart",
        associative=make_associative_fold(),
    )


@functools.cache
def make_associative_fold():
    """The cart fold as an associative transform monoid
    (surge_tpu_torch.replay.seqpar): item and total deltas are additive
    (int32, wrapping), checked_out is OR-monotone, version is right-biased on
    any real event. Repeated factory calls are structurally equal, sharing
    the one-time law check."""
    from surge_tpu_torch.replay.seqpar import AssociativeFold

    def lift(ev):
        tid = ev["type_id"]
        add = tid == ADDED
        rem = tid == REMOVED
        real = add | rem | (tid == CHECKED_OUT)
        signed_qty = (torch.where(add, ev["quantity"], 0)
                      - torch.where(rem, ev["quantity"], 0))
        return {
            "d_items": signed_qty.to(torch.int32),
            "d_cents": (signed_qty * ev["unit_price_cents"]).to(torch.int32),
            "checked": tid == CHECKED_OUT,
            "has": real,
            "last_seq": torch.where(real, ev["sequence_number"],
                                    0).to(torch.int32),
        }

    def combine(a, b):
        return {
            "d_items": a["d_items"] + b["d_items"],
            "d_cents": a["d_cents"] + b["d_cents"],
            "checked": a["checked"] | b["checked"],
            "has": a["has"] | b["has"],
            "last_seq": torch.where(b["has"], b["last_seq"], a["last_seq"]),
        }

    def apply(state, s):
        return {
            "item_count": (state["item_count"] + s["d_items"]).to(torch.int32),
            "total_cents": (state["total_cents"] + s["d_cents"]).to(torch.int32),
            "checked_out": state["checked_out"] | s["checked"],
            "version": torch.where(s["has"], s["last_seq"],
                                   state["version"]).to(torch.int32),
        }

    return AssociativeFold(
        lift=lift, combine=combine, apply=apply,
        identity={"d_items": np.int32(0), "d_cents": np.int32(0),
                  "checked": np.bool_(False), "has": np.bool_(False),
                  "last_seq": np.int32(0)})
