"""Round accounting helpers — a copy of ``waste_ratio`` and ``shard_skew`` from
``surge_tpu/replay/ledger.py``. The ledger itself (``ReplayLedger``) is not
ported: the resident state plane calls any duck-typed ``ledger`` it is given
(``record_round``, ``record_evict``, ``record_gather``)."""

from __future__ import annotations

from typing import Optional, Sequence


def waste_ratio(dispatched: float, occupied: float) -> float:
    """Dispatched/occupied event slots of a round (1.0 = zero padding). A
    round that folded nothing reports 0.0 — "no work" must be tellable apart
    from "perfectly packed work"."""
    if occupied <= 0:
        return 0.0
    return dispatched / occupied


def shard_skew(deal_sizes: Optional[Sequence[int]]) -> float:
    """Max/mean lane-deal imbalance across mesh shards (1.0 = balanced;
    single-device rounds and empty deals read 1.0)."""
    if not deal_sizes:
        return 1.0
    total = sum(deal_sizes)
    if total <= 0:
        return 1.0
    mean = total / len(deal_sizes)
    return max(deal_sizes) / mean
