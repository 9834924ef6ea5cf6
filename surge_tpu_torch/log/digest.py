"""Chained per-partition log digests — the cross-replica integrity sensor.

One :class:`DigestIndex` per log backend maintains, for every audited
``(topic, partition)``, a CRC-chained rolling digest over the canonical bytes
of each record (offset, key, value — timestamps are excluded: the eager
in-memory record and the segment-decoded read-back may round-trip a float
timestamp differently on the two replicas of a byte-identical log, and the
digest must only move when the *replicated* bytes do). Because the chain folds
record-by-record, batch boundaries don't matter: a leader that committed in
one batch and a follower that ingested the same records across three ships
compute the same digest at the same offset.

Maintenance is **hybrid eager + lazy**, and always incremental:

- *eager*: the backends call :meth:`DigestIndex.observe` from their append /
  verbatim-ingest finish paths (outside the log lock) with the just-landed
  records; records contiguous with the chain head fold immediately, anything
  else is skipped and left to catch-up — out-of-order delivery can only make
  the chain lazier, never wrong.
- *lazy*: :meth:`digest_at` reads ``[chained, upto)`` from the log and folds
  the delta forward. This covers the broker's native Transact path
  (``_append_batch_locked`` never materializes LogRecords) at the cost of one
  bounded read of *new* records per query — never a full-partition rescan.

Checkpoints — ``(offset, digest)`` pairs pushed every ``checkpoint_every``
records — bound the cost of a query *below* the chain head (a follower asked
at the leader's smaller high-watermark): re-chain from the nearest checkpoint
at or under ``upto`` instead of from the base.

Compaction resets the whole chain to the new clean frontier (retention-time
GC makes compacted prefixes replica-divergent by design; the replication
compaction barrier compacts the same prefix on leader and follower, so both
sides reset to the same ``base`` and stay comparable above it). Truncation
(KIP-101 divergent-tail drop) rolls the chain back to the best surviving
checkpoint. A digest query answers ``digest: None`` with its ``base`` when
``upto`` falls below the comparable region — the auditor treats unequal bases
as *incomparable*, never as a mismatch.
"""

from __future__ import annotations

import struct
import threading
import zlib
from bisect import bisect_right, insort
from typing import Dict, List, Optional, Tuple

__all__ = ["DigestIndex", "fold_record", "CHAIN_SEED"]

#: the chain seed — digest of the empty prefix ``[base, base)``
CHAIN_SEED = 0

_CANON = struct.Struct("<qII")  # offset, key-len, value-len


def fold_record(crc: int, record) -> int:
    """Fold one record's canonical bytes into the chain: a length-framed
    (offset, key, value) triple through ``zlib.crc32``. Headers and
    timestamps are deliberately outside the canon (module doc)."""
    key = record.key
    kb = key.encode("utf-8") if isinstance(key, str) else (key or b"")
    vb = record.value or b""
    crc = zlib.crc32(_CANON.pack(record.offset, len(kb), len(vb)), crc)
    crc = zlib.crc32(kb, crc)
    return zlib.crc32(vb, crc) & 0xFFFFFFFF


class _Chain:
    """One partition's rolling digest state."""

    __slots__ = ("base", "chained", "head", "checkpoints")

    def __init__(self, base: int) -> None:
        self.base = base          # offsets below are not digestable
        self.chained = base       # next offset to fold
        self.head = CHAIN_SEED    # digest over [base, chained)
        #: sorted (offset, digest-over-[base, offset)) pairs
        self.checkpoints: List[Tuple[int, int]] = []


class DigestIndex:
    """Per-partition chained digests over one log backend (module doc)."""

    def __init__(self, log, *, checkpoint_every: int = 256,
                 max_checkpoints: int = 64) -> None:
        self._log = log
        self._every = max(int(checkpoint_every), 1)
        self._max_cks = max(int(max_checkpoints), 1)
        self._chains: Dict[Tuple[str, int], _Chain] = {}
        self._lock = threading.Lock()
        self.stats = {"eager_records": 0, "catchup_records": 0,
                      "refold_records": 0, "resets": 0, "rollbacks": 0}

    # -- chain bookkeeping --------------------------------------------------------------

    def _chain(self, topic: str, partition: int) -> _Chain:
        key = (topic, partition)
        ch = self._chains.get(key)
        if ch is None:
            # a chain created over pre-existing records anchors at the clean
            # frontier: compacted prefixes are replica-divergent by design
            try:
                base = int(self._log.compaction_state(
                    topic, partition)["clean_end"])
            except Exception:  # noqa: BLE001 — backend without compaction
                base = 0
            ch = self._chains[key] = _Chain(base)
        return ch

    def _push_checkpoint(self, ch: _Chain, offset: int, digest: int) -> None:
        if ch.checkpoints and ch.checkpoints[-1][0] >= offset:
            if not any(c[0] == offset for c in ch.checkpoints):
                insort(ch.checkpoints, (offset, digest))
        else:
            ch.checkpoints.append((offset, digest))
        if len(ch.checkpoints) > self._max_cks:
            del ch.checkpoints[0: len(ch.checkpoints) - self._max_cks]

    def _fold_forward(self, ch: _Chain, records, counter: str) -> None:
        """Fold records (offset order, all >= ch.chained) into the head."""
        for r in records:
            ch.head = fold_record(ch.head, r)
            ch.chained = r.offset + 1
            self.stats[counter] += 1
            if ch.chained % self._every == 0:
                self._push_checkpoint(ch, ch.chained, ch.head)

    # -- eager maintenance (append/verbatim-ingest hooks) -------------------------------

    def observe(self, records) -> None:
        """Fold just-appended records. Only runs when a run is contiguous
        with its partition's chain head — anything else (out-of-order finish
        delivery, replica gap slices, records landed before the index
        existed) is left to the lazy catch-up in :meth:`digest_at`. Called
        OUTSIDE the log lock (digest-lock → log-lock is the one permitted
        ordering; see ``digest_at``)."""
        with self._lock:
            for r in records:
                ch = self._chain(r.topic, r.partition)
                if r.offset != ch.chained:
                    continue
                self._fold_forward(ch, (r,), "eager_records")

    # -- queries ------------------------------------------------------------------------

    def digest_at(self, topic: str, partition: int, upto: int) -> dict:
        """The digest over ``[base, upto)``. The caller must clamp ``upto``
        to the partition's durable end offset (``LogBase.partition_digest``
        does) — folding past the end would mark unseen records as chained.
        Returns ``{"topic", "partition", "upto", "base", "chained",
        "digest"}``; ``digest`` is None (with ``base`` for the caller's
        comparability check) when ``upto`` is below the chain base."""
        with self._lock:
            ch = self._chain(topic, partition)
            out = {"topic": topic, "partition": partition, "upto": upto,
                   "base": ch.base}
            if upto < ch.base:
                out.update(digest=None, chained=ch.chained)
                return out
            if upto >= ch.chained:
                if upto > ch.chained:  # lazy catch-up: fold the delta only
                    self._fold_forward(
                        ch, self._read_range(topic, partition, ch.chained,
                                             upto), "catchup_records")
                    ch.chained = upto
                digest = ch.head
                self._push_checkpoint(ch, upto, digest)
            else:
                digest = self._refold_below(ch, topic, partition, upto)
            out.update(digest=f"{digest:08x}", chained=ch.chained)
            return out

    def _refold_below(self, ch: _Chain, topic: str, partition: int,
                      upto: int) -> int:
        """Digest at an offset below the chain head: re-chain from the
        nearest checkpoint at/under ``upto`` (or the base). Does not move
        the chain; caches the answer as a checkpoint."""
        i = bisect_right(ch.checkpoints, (upto, 0xFFFFFFFF)) - 1
        if i >= 0:
            start, digest = ch.checkpoints[i]
        else:
            start, digest = ch.base, CHAIN_SEED
        if start < upto:
            for r in self._read_range(topic, partition, start, upto):
                digest = fold_record(digest, r)
                self.stats["refold_records"] += 1
        self._push_checkpoint(ch, upto, digest)
        return digest

    def _read_range(self, topic: str, partition: int, lo: int, hi: int):
        """Records with ``lo <= offset < hi`` in offset order, paged (the
        catch-up after a native-path burst must not materialize the whole
        delta at once)."""
        while lo < hi:
            page = self._log.read(topic, partition, from_offset=lo,
                                  max_records=min(hi - lo, 2048))
            if not page:
                return
            for r in page:
                if r.offset >= hi:
                    return
                yield r
            lo = page[-1].offset + 1

    # -- rewrite hooks ------------------------------------------------------------------

    def on_compact(self, topic: str, partition: int, frontier: int) -> None:
        """Compaction rewrote ``[.., frontier)``: reset the chain to the new
        clean base. Leader and follower run the compaction barrier over the
        same prefix, so both reset to the same base and digests above it
        stay comparable."""
        with self._lock:
            key = (topic, partition)
            if key in self._chains or frontier > 0:
                self._chains[key] = _Chain(max(frontier, 0))
                self.stats["resets"] += 1

    def on_truncate(self, topic: str, partition: int, to_offset: int) -> None:
        """Failover truncation dropped offsets >= ``to_offset``: roll the
        chain back to the best surviving checkpoint (or the base — a full
        re-chain from there is lazy and bounded by the surviving prefix)."""
        with self._lock:
            ch = self._chains.get((topic, partition))
            if ch is None or ch.chained <= to_offset:
                return
            ch.checkpoints = [c for c in ch.checkpoints if c[0] <= to_offset]
            if ch.checkpoints:
                ch.chained, ch.head = ch.checkpoints[-1]
            else:
                ch.chained, ch.head = ch.base, CHAIN_SEED
            self.stats["rollbacks"] += 1

    def snapshot(self) -> dict:
        """Counters + per-partition chain positions (observability)."""
        with self._lock:
            chains = {f"{t}[{p}]": {"base": c.base, "chained": c.chained,
                                    "checkpoints": len(c.checkpoints)}
                      for (t, p), c in self._chains.items()}
            return {"stats": dict(self.stats), "chains": chains}
