"""BankAccount fixture, replay half — the counterpart of the tensor path of
``surge_tpu/models/bank_account.py``: the vocab-encoded dataclasses, the registry
and torch handlers. Its wire has four side columns (two i32, two f32) and its
state a bool and an f32 field.

- BankAccountCreated replaces the state.
- BankAccountUpdated sets the balance only when the account exists
  (``aggregate.map(_.copy(balance = newBalance))``).
"""

from __future__ import annotations

from dataclasses import dataclass

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
    )
