"""BankAccount fixture, replay half — the counterpart of the tensor path of
``surge_tpu/models/bank_account.py``: the vocab-encoded dataclasses, the registry
torch handlers and ``make_associative_fold``. Its wire has four side columns
(two i32, two f32) and its state a bool and an f32 field.

- BankAccountCreated replaces the state.
- BankAccountUpdated sets the balance only when the account exists
  (``aggregate.map(_.copy(balance = newBalance))``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from surge_tpu_torch.codec.schema import SchemaRegistry
from surge_tpu_torch.engine.model import ReplayHandlers, ReplaySpec

CREATED, UPDATED = 0, 1


@dataclass(frozen=True)
class EncodedAccountState:
    """Tensor-side state record (the scalar BankAccount with strings vocab-encoded)."""

    created: bool
    owner_code: int
    security_code_code: int
    balance: float


@dataclass(frozen=True)
class EncodedCreated:
    owner_code: int
    security_code_code: int
    balance: float


@dataclass(frozen=True)
class EncodedUpdated:
    new_balance: float


def make_registry() -> SchemaRegistry:
    reg = SchemaRegistry()
    reg.register_event(EncodedCreated, type_id=CREATED)
    reg.register_event(EncodedUpdated, type_id=UPDATED)
    reg.register_state(EncodedAccountState)
    return reg


def make_replay_spec() -> ReplaySpec:
    def created(s, f):
        return {"created": True,
                "owner_code": f["owner_code"],
                "security_code_code": f["security_code_code"],
                "balance": f["balance"]}

    def updated(s, f):
        # no-op when the account is absent
        return {"created": s["created"],
                "owner_code": s["owner_code"],
                "security_code_code": s["security_code_code"],
                "balance": torch.where(s["created"], f["new_balance"], s["balance"])}

    return ReplaySpec(
        registry=make_registry(),
        handlers=ReplayHandlers({CREATED: created, UPDATED: updated}),
        init_record={"created": False, "owner_code": 0, "security_code_code": 0,
                     "balance": 0.0},
        kernel_step="bank_account",
        associative=make_associative_fold(),
    )


@functools.cache
def make_associative_fold():
    """The bank fold as a last-writer-with-reset monoid
    (surge_tpu_torch.replay.seqpar): a Created RESETS the account (its values
    win over everything earlier), an Updated sets the balance only if an
    account exists at that point, orphan Updateds are no-ops. Summary =
    (has_create, create vals, last-update-after-last-create). Float fields
    are only selected, never summed, so every fold is bit-exact."""
    from surge_tpu_torch.replay.seqpar import AssociativeFold

    def lift(ev):
        tid = ev["type_id"]
        cr = tid == CREATED
        up = tid == UPDATED
        return {
            "hc": cr,
            "cr_owner": torch.where(cr, ev["owner_code"], 0).to(torch.int32),
            "cr_sec": torch.where(cr, ev["security_code_code"],
                                  0).to(torch.int32),
            "cr_bal": torch.where(cr, ev["balance"], 0.0).to(torch.float32),
            "upd_has": up,
            "upd_bal": torch.where(up, ev["new_balance"],
                                   0.0).to(torch.float32),
        }

    def combine(a, b):
        # updates after the combined slice's LAST create: b's own if b has a
        # create (reset) or any update; otherwise a's carry through
        upd_has = torch.where(b["hc"], b["upd_has"],
                              b["upd_has"] | a["upd_has"])
        upd_bal = torch.where(b["upd_has"], b["upd_bal"], a["upd_bal"])
        upd_bal = torch.where(b["hc"] & ~b["upd_has"], 0.0, upd_bal)
        return {
            "hc": a["hc"] | b["hc"],
            "cr_owner": torch.where(b["hc"], b["cr_owner"], a["cr_owner"]),
            "cr_sec": torch.where(b["hc"], b["cr_sec"], a["cr_sec"]),
            "cr_bal": torch.where(b["hc"], b["cr_bal"], a["cr_bal"]),
            "upd_has": upd_has,
            "upd_bal": upd_bal,
        }

    def apply(state, s):
        # with a create in the slice: its values, overridden by any later
        # update; without one: updates apply only if the account existed
        bal_with_create = torch.where(s["upd_has"], s["upd_bal"], s["cr_bal"])
        bal_no_create = torch.where(state["created"] & s["upd_has"],
                                    s["upd_bal"], state["balance"])
        return {
            "created": state["created"] | s["hc"],
            "owner_code": torch.where(s["hc"], s["cr_owner"],
                                      state["owner_code"]).to(torch.int32),
            "security_code_code": torch.where(
                s["hc"], s["cr_sec"],
                state["security_code_code"]).to(torch.int32),
            "balance": torch.where(s["hc"], bal_with_create,
                                   bal_no_create).to(torch.float32),
        }

    return AssociativeFold(
        lift=lift, combine=combine, apply=apply,
        identity={"hc": np.bool_(False), "cr_owner": np.int32(0),
                  "cr_sec": np.int32(0), "cr_bal": np.float32(0.0),
                  "upd_has": np.bool_(False), "upd_bal": np.float32(0.0)})
