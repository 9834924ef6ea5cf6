"""Synthetic replay corpora, generated columnar — a numpy copy of
``surge_tpu/replay/corpus.py`` (``CounterCorpus``, ``ragged_lengths``,
``synth_counter_corpus``). The same seed gives the same corpus as the reference.

The benchmark workload — 1M aggregates / 100M events of cold replay — is built as
:class:`~surge_tpu_torch.codec.tensor.ColumnarEvents` directly with vectorized NumPy,
along with a closed-form expected final state (per-aggregate segment sums) so the
full corpus can be verified without folding it scalar-side.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from surge_tpu_torch.codec.tensor import ColumnarEvents
from surge_tpu_torch.models import counter


@dataclass
class CounterCorpus:
    """A ragged counter-event corpus plus its closed-form expected fold result."""

    events: ColumnarEvents  # aggregate-sorted (time order within aggregate)
    lengths: np.ndarray  # [B] int64 events per aggregate
    expected_count: np.ndarray  # [B] int64: sum(inc) - sum(dec) per aggregate
    expected_version: np.ndarray  # [B] int32: last non-noop sequence number

    @property
    def num_aggregates(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def num_events(self) -> int:
        return int(self.events.num_events)


def ragged_lengths(num_aggregates: int, num_events: int, rng: np.random.Generator,
                   spread: float = 0.6) -> np.ndarray:
    """Ragged per-aggregate log lengths summing exactly to ``num_events``.

    Lognormal-shaped (most aggregates short, a long tail), mirroring real event-sourced
    populations; ``spread`` is the lognormal sigma.
    """
    if num_aggregates <= 0:
        return np.zeros(0, dtype=np.int64)
    w = rng.lognormal(mean=0.0, sigma=spread, size=num_aggregates)
    lengths = np.floor(w * (num_events / w.sum())).astype(np.int64)
    # distribute the rounding remainder one event at a time over the first aggregates
    deficit = num_events - int(lengths.sum())
    if deficit > 0:
        lengths[:deficit] += 1
    return lengths


def synth_counter_corpus(num_aggregates: int, num_events: int, seed: int = 0,
                         spread: float = 0.6,
                         sort_by_length: bool = False,
                         lengths: np.ndarray | None = None) -> CounterCorpus:
    """Counter-model corpus: Increment/Decrement/NoOp/Unserializable events.

    Event mix: 45% inc (by 1..3), 35% dec (by 1..2), 15% noop, 5% unserializable —
    exercising all four tensor-path event types of the TestBoundedContext parity fixture
    (reference TestBoundedContext.scala:17-82). ``sort_by_length`` orders aggregates by
    log length (what the replay engine's bucketing does anyway) so fixed-size B-chunks
    have homogeneous T and minimal padding. An explicit ``lengths`` array overrides the
    lognormal distribution (warm-up corpora that must hit specific window widths).
    """
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = ragged_lengths(num_aggregates, num_events, rng, spread)
    else:
        lengths = np.asarray(lengths, dtype=np.int64)
        num_aggregates = int(lengths.shape[0])
    if sort_by_length:
        order = np.argsort(lengths, kind="stable")
        lengths = lengths[order]
    n = int(lengths.sum())

    starts = np.zeros(num_aggregates + 1, dtype=np.int64)
    np.cumsum(lengths, out=starts[1:])
    agg_idx = np.repeat(np.arange(num_aggregates, dtype=np.int32), lengths)
    # within-aggregate ordinal, 1-based — this corpus stamps sequence_number as the
    # event's position in its aggregate's log, so the column is declared
    # device-derivable ("ordinal") and never stored or transferred (surge_tpu_torch/codec/wire.py)
    seq = (np.arange(n, dtype=np.int64) - starts[agg_idx] + 1).astype(np.int32)

    # threshold arithmetic instead of rng.choice(p=...): choice draws float64
    # per event (~5 s at 100M); a u16 draw + three comparisons is ~2 s. Relies
    # on INCREMENTED..UNSERIALIZABLE being 0..3 (models/counter.py).
    assert (counter.INCREMENTED, counter.DECREMENTED, counter.NOOP,
            counter.UNSERIALIZABLE) == (0, 1, 2, 3)
    draw = rng.integers(0, 10_000, size=n, dtype=np.uint16)
    type_ids = ((draw >= 4500).astype(np.int32)      # 45% inc
                + (draw >= 8000) + (draw >= 9500))   # 35% dec, 15% noop, 5% unser
    inc = np.where(type_ids == counter.INCREMENTED,
                   rng.integers(1, 4, size=n, dtype=np.int32), 0).astype(np.int32)
    dec = np.where(type_ids == counter.DECREMENTED,
                   rng.integers(1, 3, size=n, dtype=np.int32), 0).astype(np.int32)

    events = ColumnarEvents(
        num_aggregates=num_aggregates, agg_idx=agg_idx, type_ids=type_ids,
        cols={"increment_by": inc, "decrement_by": dec},
        derived_cols={"sequence_number": "ordinal"})

    # per-aggregate sums via segment reduceat (integer, one pass) — weighted
    # bincount converts through float64 and costs ~6 s/column at 100M.
    # reduceat over non-empty starts reduces each segment exactly (empty
    # segments in between have zero width and are scattered separately).
    nonempty = lengths > 0
    expected_count = np.zeros(num_aggregates, dtype=np.int64)
    expected_version = np.zeros(num_aggregates, dtype=np.int32)
    if n and nonempty.any():
        idx = starts[:-1][nonempty]
        expected_count[nonempty] = (
            np.add.reduceat(inc, idx, dtype=np.int64)
            - np.add.reduceat(dec, idx, dtype=np.int64))
        # version = sequence number of the last event whose handler writes
        # version (inc/dec/unserializable); NoOp carries it (counter.py)
        seq_masked = np.where(type_ids != counter.NOOP, seq, 0)
        expected_version[nonempty] = np.maximum.reduceat(
            seq_masked, idx).astype(np.int32)

    return CounterCorpus(events=events, lengths=lengths,
                         expected_count=expected_count,
                         expected_version=expected_version)
