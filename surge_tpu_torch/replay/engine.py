"""Batched replay on the device — the resident path of
``surge_tpu/replay/engine.py`` in torch.

The counterpart of each reference function keeps its name:

- :func:`make_step_fn` / :func:`make_batch_fold`: the one-event step over a lane
  batch (``switch`` or ``select`` dispatch) and the plain time scan over it.
- :func:`_make_fold_body`, :func:`_make_assoc_body`, :func:`_make_densify`:
  the plain backend's tile-interior fold, the ``assoc`` backend's tree fold
  and the dense layout's one-time tile gather. A tile folds events
  ``[t_base, t_base + width)`` of lanes ``[i0, i0 + bs)``.
- :class:`ReplayEngine`: ``pack_resident`` → ``upload_resident`` →
  ``warm_resident`` → ``replay_resident``, the cold-replay main path;
  ``replay_resident_streamed``, the same in lane pieces whose uploads overlap
  the folds of earlier pieces; and the non-resident paths
  (``replay_encoded``, ``replay_columnar``, ``replay_ragged``,
  ``replay_columnar_chunks``, ``replay_stream``), which pack each
  ``[width, bs]`` time window of a B-chunk on the host and fold it into the
  chunk's carry.

Where the reference ran one ``fori_loop`` over a device-resident work list,
the kernel backend (``tile-backend = pallas``) folds each of the plan's two
work lists into the state slab in place with one launch of K1's list fold
(``surge_tpu_torch.replay.fold_kernels.tile_fold_list``); the plain backend
(``xla``) walks the same lists tile by tile through the list fold's plain
version (``fold_kernels.tile_fold_list_reference``) with its own time scan,
and the ``assoc`` backend walks them with its tree fold, in torch on the
engine's device. A non-resident window goes the same three ways: through K1
as a one-tile dense work list (``fold_kernels.tile_fold_list``), through the
tree fold, or through the plain time scan (:func:`make_batch_fold`). A
caller's ``init_carry`` is copied, never written to.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from surge_tpu_torch.codec.tensor import (
    ColumnarEvents,
    EncodedEvents,
    bucket_lengths,
    columnar_to_batch,
    encode_events,
    encode_states,
)
from surge_tpu_torch.codec.wire import WireFormat, torch_dtype
from surge_tpu_torch.config import Config, default_config
from surge_tpu_torch.engine.model import MixedKernelStep, ReplaySpec, StateTree
from surge_tpu_torch.replay import fold_kernels
from surge_tpu_torch.replay.fold_kernels import _lane_range, _slab_index


def make_step_fn(spec: ReplaySpec, dispatch: str = "switch"
                 ) -> Callable[[StateTree, Mapping[str, Any]], StateTree]:
    """One-event step over a lane batch: dispatch on type_id, mask padding.

    Any type_id outside ``[0, num_types)`` — padding (-1) or corrupt positive
    ids — carries state through unchanged. ``dispatch`` picks the lowering:

    - ``"switch"``: each handler runs on the lanes whose (clipped, real) type
      id selects it, and its results scatter back to those lanes.
    - ``"select"``: branchless — every handler runs on every lane and the
      results mask-combine with ``where``, field by field over the fields
      the handler returns (the others carry through, as the reference's
      normalized select gives them: a combined spec's handler touches only
      its own family's few fields of the union).
    """
    num_types = spec.registry.num_event_types
    handlers = spec.handlers.ordered(num_types)
    state_fields = spec.registry.state.field_names

    def pinned(v: Any, ref: torch.Tensor) -> torch.Tensor:
        # a handler's value at the schema dtype (the carry's) and lane shape
        v = torch.as_tensor(v, device=ref.device).to(ref.dtype)
        return v if v.shape == ref.shape else v.expand(ref.shape)

    def normalize(new: StateTree, old: StateTree) -> StateTree:
        # handlers may return partial dicts and scalars; missing columns carry
        # through, and dtypes are pinned to the schema (the carry's dtypes)
        return {name: pinned(new.get(name, old[name]), old[name])
                for name in state_fields}

    if dispatch == "select":
        def step(state: StateTree, event: Mapping[str, Any]) -> StateTree:
            tid = event["type_id"]
            fields = {k: v for k, v in event.items() if k != "type_id"}
            out = dict(state)
            for t, h in enumerate(handlers):
                new = h(state, fields)
                hit = tid == t
                for k in state_fields:
                    if k in new:
                        out[k] = torch.where(hit, pinned(new[k], state[k]), out[k])
            return out

        return step
    if dispatch != "switch":
        raise ValueError(f"unknown dispatch {dispatch!r} (switch|select)")

    def step(state: StateTree, event: Mapping[str, Any]) -> StateTree:
        tid = event["type_id"]
        branch = tid.clamp(0, num_types - 1)
        is_real = (tid >= 0) & (tid < num_types)
        fields = {k: v for k, v in event.items() if k != "type_id"}
        out = {k: v.clone() for k, v in state.items()}
        for t, h in enumerate(handlers):
            idx = torch.nonzero(is_real & (branch == t)).squeeze(1)
            sub = {k: v[idx] for k, v in state.items()}
            new = normalize(h(sub, {k: v[idx] for k, v in fields.items()}), sub)
            for k in out:
                out[k][idx] = new[k]
        return out

    return step


def make_batch_fold(spec: ReplaySpec, *, dispatch: str = "switch"):
    """Batched fold: ``(carry {name: [B]}, events {col: [T, B]}) -> carry`` — the
    plain time scan of the step over the lane batch."""
    step = make_step_fn(spec, dispatch)

    def fold(carry: StateTree, events: Mapping[str, torch.Tensor]) -> StateTree:
        steps = next(iter(events.values())).shape[0] if events else 0
        for t in range(steps):
            carry = step(carry, {k: v[t] for k, v in events.items()})
        return carry

    return fold


@dataclass
class ResidentCorpus:
    """A corpus uploaded once to the device for gather-based replay."""

    derived_key: dict
    flat_wire: torch.Tensor  # packed u8 [N, nbytes] on device
    flat_side: dict  # {name: [N]} on device
    starts: np.ndarray  # i32 [B] (length-sorted order, host copy for planning)
    lengths: np.ndarray  # i32 [B]
    perm: Optional[np.ndarray]  # sorted-rank -> original index (None = identity)
    starts_dev: torch.Tensor  # i32 [b_pad] on device
    lens_dev: torch.Tensor  # i32 [b_pad] on device
    b_pad: int  # lane count padded to the dispatch batch
    num_events: int
    wire_bytes: int  # bytes actually shipped to the device
    upload_s: float
    #: per-corpus caches (tile plan, dense tile buffers, inverse permutation),
    #: populated lazily by the engine, keyed by plan geometry
    cache: dict = dc_field(default_factory=dict)


#: minimum guard rows appended past the wire corpus, so a wire packed under a
#: small tile-width cap still satisfies engines configured with a larger one
_WIRE_GUARD_MIN = 8192

def _make_fold_body(spec: ReplaySpec, wire: WireFormat, width: int,
                    dispatch: str):
    """The plain backend's tile-interior fold, which it hands to
    ``fold_kernels.tile_fold_list_reference`` for both layouts: ``(carry
    {f: [bs]}, words [width, bs], sides {n: [width, bs]}, lens [bs], ord_base
    [bs], t_base) -> carry``, the plain torch time scan."""
    step = make_step_fn(spec, dispatch)

    def fold_body(carry, words, sides, lens, ord_base, t_base: int):
        for t in range(width):
            tt = t_base + t
            events = wire.decode_words(words[t], {n: s[t] for n, s in sides.items()},
                                       tt < lens, ord_base, tt)
            carry = step(carry, events)
        return carry

    return fold_body


def _make_assoc_body(spec: ReplaySpec, wire: WireFormat, width: int):
    """The ``assoc`` backend's tile-interior fold, with the plain backend's
    signature: no time scan at all. It lifts every slot of the ``[width,
    bs]`` tile at once, combines adjacent pairs over time ``log2(width)``
    times (combine is associative but not commutative: adjacent pairs keep
    the order), then applies the result once, as
    ``surge_tpu/replay/engine.py:_make_fold_body`` does. The spec carries
    an ``associative`` fold (``ReplayEngine.tile_backend`` checks it); this
    raises for a width that is not a power of two and law-checks the fold
    once (``seqpar.ensure_validated``)."""
    from surge_tpu_torch.replay.seqpar import ensure_validated

    afold = spec.associative
    if width & (width - 1):
        raise ValueError(
            f"assoc tile backend needs a power-of-two time width, got {width}")
    # a wrong combine must raise here, never silently corrupt a replay
    ensure_validated(afold, spec)

    def fold_body(carry, words, sides, lens, ord_base, t_base: int):
        ts = (torch.arange(width, dtype=torch.int32, device=words.device)
              + t_base)[:, None]
        events = wire.decode_words(words, sides, ts < lens[None, :],
                                   ord_base[None, :], ts)
        s = afold.lift(events)  # padding (type_id -1) lifts to identity
        w = width
        while w > 1:
            s = afold.combine({k: v[0::2] for k, v in s.items()},
                              {k: v[1::2] for k, v in s.items()})
            w //= 2
        out = afold.apply(carry, {k: v[0] for k, v in s.items()})
        return {k: out.get(k, carry[k]) for k in carry}

    return fold_body


def _make_densify(wire: WireFormat, width: int, bs: int):
    """One-time tile gather: ``(flat_wire u8 [N, nbytes], side_flat {n: [N]},
    starts_all, i0s [k_n], t_bases [k_n]) -> (dense_words u8
    [k_n, width, bs, nbytes], dense_sides {n: [k_n, width, bs]})``."""
    nbytes = wire.nbytes

    def densify(flat_wire, side_flat, starts_all, i0s, t_bases):
        k_n = len(i0s)
        dev = flat_wire.device
        dw = torch.empty((k_n, width, bs, nbytes), dtype=torch.uint8, device=dev)
        ds = {n: torch.empty((k_n, width, bs), dtype=arr.dtype, device=dev)
              for n, arr in side_flat.items()}
        for k, (i0, tb) in enumerate(zip(i0s.tolist(), t_bases.tolist())):
            lanes = _lane_range(i0, bs, starts_all.shape[0])
            idx = _slab_index(starts_all[lanes], tb, width, flat_wire.shape[0])
            dw[k] = flat_wire[idx]
            for n, arr in side_flat.items():
                ds[n][k] = arr[idx]
        return dw, ds

    return densify


def _apply_perm(perm: Optional[np.ndarray],
                init_carry: Mapping[str, Any] | None,
                ordinal_base: np.ndarray | None):
    """Reorder caller inputs (original aggregate order) into the wire's
    length-sorted lane order."""
    init_sorted = None
    if init_carry is not None:
        init_sorted = {k: (np.asarray(v)[perm] if perm is not None
                           else np.asarray(v))
                       for k, v in init_carry.items()}
    ord_sorted = None
    if ordinal_base is not None:
        src = np.asarray(ordinal_base)
        ord_sorted = src[perm] if perm is not None else src
    return init_sorted, ord_sorted


def _unapply_perm(perm: Optional[np.ndarray],
                  out_sorted: dict) -> dict:
    """Scatter sorted-order state columns back to the original order."""
    if perm is None:
        return out_sorted
    out = {name: np.empty_like(col) for name, col in out_sorted.items()}
    for name, col in out_sorted.items():
        out[name][perm] = col
    return out


def window_lens(type_ids: np.ndarray, num_types: int, bs: int) -> np.ndarray:
    """The lane lengths K1 folds one packed window with, int32 ``[bs]``:
    lane b's slots up to its last type id in ``[0, num_types)`` (0 for a
    lane with none and for the padding lanes past ``type_ids``' ``[b, w]``).
    The slots past it pack to the pad code and fold to nothing; an
    out-of-range id before it packs to the pad code too and decodes to a
    no-op step, so the lane folds what the reference's window folds."""
    lens = np.zeros((bs,), dtype=np.int32)
    real = (type_ids >= 0) & (type_ids < num_types)
    if real.size:
        last = real.shape[1] - np.argmax(real[:, ::-1], axis=1)
        lens[: real.shape[0]] = np.where(real.any(axis=1), last, 0)
    return lens


def _bucket_len(n: int) -> int:
    """Next power of two ≥ n (min 64Ki) — the bucketed buffer length."""
    target = 1 << 16
    while target < n:
        target <<= 1
    return target


def _bucket_rows(arr: np.ndarray, pow2: bool) -> np.ndarray:
    """Zero-pad the leading axis to the next power of two (min 64Ki rows);
    identity when bucketing is off or already sized."""
    if not pow2:
        return np.ascontiguousarray(arr)
    target = _bucket_len(arr.shape[0])
    if target == arr.shape[0]:
        return np.ascontiguousarray(arr)
    pad = [(0, target - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


#: lane counts pad to a multiple of 8 (one device; the reference multiplies by
#: its mesh size)
_LANE_MULTIPLE = 8


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m if m > 0 else n


def _to_device(arr: np.ndarray, device: torch.device,
               stream: Optional["torch.cuda.Stream"] = None) -> torch.Tensor:
    """Host array (possibly a read-only mmap) to a device tensor. With a
    ``stream`` (CUDA), the array is staged in pinned host memory and copied
    on that stream without blocking the host."""
    host = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if stream is None:
        return host.to(device)
    with torch.cuda.stream(stream):
        return host.pin_memory().to(device, non_blocking=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _resolve_device(device) -> torch.device:
    """``None`` means the card; without one that raises (pass
    ``device="cpu"`` to run on the host)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ReplayEngine runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ReplayEngine runs on cuda or cpu, not {dev}")
    return dev


@dataclass
class ResidentWire:
    """The host/disk wire form of a resident corpus (pure numpy, mmap-able).

    Produced by :meth:`ReplayEngine.pack_resident`; consumed by
    :meth:`ReplayEngine.upload_resident`. The saved form is the reference's
    (``surge_tpu.replay.engine.ResidentWire``), file for file, so a wire saved
    by either package loads in the other."""

    derived_key: dict
    packed: np.ndarray  # u8 [N+guard, nbytes]
    side: dict  # {name: np [N+guard]}
    starts: np.ndarray  # i32 [B] (length-sorted order)
    lengths: np.ndarray  # i32 [B]
    perm: Optional[np.ndarray]  # sorted-rank -> original index
    guard: int
    num_events: int
    #: WireFormat.layout_fingerprint() of the packing schema; None only for
    #: wires saved before fingerprints existed
    layout: Optional[dict] = None

    def save(self, root: str) -> None:
        import json
        import os

        os.makedirs(root, exist_ok=True)
        np.save(os.path.join(root, "packed.npy"), self.packed)
        np.save(os.path.join(root, "starts.npy"), self.starts)
        np.save(os.path.join(root, "lengths.npy"), self.lengths)
        if self.perm is not None:
            np.save(os.path.join(root, "perm.npy"), self.perm)
        for name, col in self.side.items():
            np.save(os.path.join(root, f"side_{name}.npy"), col)
        meta = {"derived_key": self.derived_key, "guard": self.guard,
                "num_events": self.num_events,
                "side_names": sorted(self.side),
                "has_perm": self.perm is not None,
                "nbytes": int(self.packed.shape[1]),
                "side_dtypes": {k: str(np.dtype(v.dtype))
                                for k, v in self.side.items()},
                "layout": self.layout}
        with open(os.path.join(root, "wire.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, root: str) -> "ResidentWire":
        import json
        import os

        with open(os.path.join(root, "wire.json")) as f:
            meta = json.load(f)
        mm = lambda name: np.load(os.path.join(root, name), mmap_mode="r")  # noqa: E731
        return cls(
            derived_key=dict(meta["derived_key"]),
            packed=mm("packed.npy"),
            side={name: mm(f"side_{name}.npy") for name in meta["side_names"]},
            starts=np.asarray(mm("starts.npy")),
            lengths=np.asarray(mm("lengths.npy")),
            perm=np.asarray(mm("perm.npy")) if meta["has_perm"] else None,
            guard=int(meta["guard"]), num_events=int(meta["num_events"]),
            layout=meta.get("layout"))


@dataclass
class ResidentPlan:
    """Tile schedule for one resident replay (two lane granularities)."""

    width: int
    bs_big: int
    bs_small: int
    big_i0: np.ndarray  # i32 [k_big]
    big_tb: np.ndarray  # i32 [k_big]
    small_i0: np.ndarray  # i32 [k_small]
    small_tb: np.ndarray  # i32 [k_small]

    @property
    def padded_slots(self) -> int:
        return (len(self.big_i0) * self.bs_big
                + len(self.small_i0) * self.bs_small) * self.width


@dataclass
class ReplayResult:
    """Folded states + accounting for throughput metrics."""

    states: dict[str, np.ndarray]  # {col: [B]} in the original aggregate order
    num_aggregates: int
    num_events: int
    padded_events: int  # slots actually scanned (padding overhead indicator)
    # aggregate-id strings aligned with the state columns, when the inputs carried
    # them (segment chunks) — lets callers write states back to the keyed store
    aggregate_ids: Optional[list] = None


class ReplayEngine:
    """Drives resident replay for one model family on one device.

    Parameters
    ----------
    spec: the model's ReplaySpec.
    config: the ``surge.replay.*`` knobs (surge_tpu_torch.config).
    device: where the corpus and the fold live; ``None`` is the CUDA card and
        raises when there is none.
    """

    def __init__(self, spec: ReplaySpec, config: Config | None = None,
                 device=None, profiler=None) -> None:
        self.spec = spec
        self.config = config or default_config()
        self.device = _resolve_device(device)
        # optional replay.profiler.ReplayProfiler: every hook below
        # short-circuits on one `is None` without it
        self.profiler = profiler
        self.time_chunk = self.config.get_int("surge.replay.time-chunk")
        self.min_time_window = self.config.get_int("surge.replay.min-time-window", 8)
        self.sort_by_length = self.config.get_bool("surge.replay.sort-by-length", True)
        lane = _LANE_MULTIPLE
        self.batch_size = _round_up(
            max(self.config.get_int("surge.replay.batch-size"), lane), lane)
        self._dispatch = self.config.get_str("surge.replay.dispatch", "switch")
        self._tile_backend = self.config.get_str("surge.replay.tile-backend", "auto")
        if self._tile_backend not in ("auto", "xla", "pallas", "assoc"):
            raise ValueError(
                f"unknown surge.replay.tile-backend "
                f"{self._tile_backend!r} (auto|xla|pallas|assoc)")
        self._resident_layout = self.config.get_str(
            "surge.replay.resident-layout", "auto")
        if self._resident_layout not in ("auto", "flat", "dense"):
            raise ValueError(
                f"unknown surge.replay.resident-layout "
                f"{self._resident_layout!r} (auto|flat|dense)")
        self._dense_cap_mb = self.config.get_int("surge.replay.dense-cap-mb", 2048)
        self.buckets = self.config.get_int_list("surge.replay.length-buckets",
                                                "64,256,1024,4096")
        # the wire format per derived key
        self._wires: dict = {}
        # distinct (derived key, window shape) signatures the non-resident
        # windows dispatched: the reference compiles one program per entry
        self._signatures: set = set()
        # the resident replays' shapes seen (list widths, lane batches,
        # buckets): a new one is a "compile" in the profiler's split, where
        # the reference compiles a program
        self._resident_sigs: set = set()
        # per-bs device constants of the one-tile window work list
        self._window_lists: dict = {}
        # host-side phase accounting: seconds spent packing, uploading and
        # densifying, tiles and windows dispatched, and a resident replay's
        # fold (dispatch to the device's finish) and state pull
        self.stats = {"pack_s": 0.0, "h2d_s": 0.0, "windows": 0,
                      "densify_s": 0.0, "fold_s": 0.0, "pull_s": 0.0}

    # -- helpers ------------------------------------------------------------------------

    def _fetch_stage(self):
        """Profiler context for a device→host state pull (the fetch that
        closes the chunk's device time); no-op without a profiler."""
        if self.profiler is None:
            return contextlib.nullcontext()
        return self.profiler.stage("fetch")

    def num_compiles(self) -> int:
        """The distinct window signatures (derived key, packed shape, side
        shapes) the non-resident paths dispatched: the reference compiles one
        program for each, and its tests count them."""
        return len(self._signatures)

    def init_carry_np(self, batch: int) -> dict[str, np.ndarray]:
        """Host-side initial carry columns ``{name: [batch]}``."""
        init = self.spec.init_state_tree()
        return {k: np.broadcast_to(np.asarray(v), (batch,)).copy()
                for k, v in init.items()}

    def init_carry(self, batch: int) -> dict[str, torch.Tensor]:
        """The initial carry ``{name: [batch]}`` on the engine's device."""
        return self._device_carry(self.init_carry_np(batch))

    def _device_carry(self, carry: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """Host carry columns on the device. The folds write their carry in
        place, and on the CPU the tensors share the arrays' memory, so
        callers pass buffers of their own, never a caller's."""
        return {k: _to_device(v, self.device) for k, v in carry.items()}

    def carry_from_states(self, states: Sequence[Any]) -> dict[str, np.ndarray]:
        """Resume from snapshots: the host carry columns of scalar states."""
        return encode_states(self.spec.registry.state, states)

    def _carry_slice(self, init_carry: Mapping[str, Any] | None,
                     start: int, stop: int, bp: int,
                     idxs: np.ndarray | None = None) -> dict[str, torch.Tensor]:
        """Fresh padded device carry for aggregates [start:stop) — or the
        explicit ``idxs`` gather when the batch was length-reordered. The
        caller's arrays are copied into host buffers first, never written."""
        if init_carry is None:
            return self.init_carry(bp)
        out = self.init_carry_np(bp)
        for k, full in init_carry.items():
            piece = (np.asarray(full)[idxs] if idxs is not None
                     else np.asarray(full)[start:stop])
            out[k][: len(piece)] = piece
        return self._device_carry(out)

    @property
    def tile_backend(self) -> str:
        """The resolved tile backend: ``auto`` is the kernel (``pallas``) on
        CUDA and the plain scan (``xla``) on the CPU. The kernel needs the
        spec's ``kernel_step`` (for a combined spec, one for every part:
        the kernels' mixed step folds them); without one this raises rather
        than run the plain scan on the card. An explicit ``assoc`` (the tree fold,
        :func:`_make_assoc_body`) needs the spec's ``associative`` and
        raises without one. Unlike the reference, ``auto`` never picks
        ``assoc``: on an NVIDIA H100 80GB HBM3 at 700 W the tree fold (torch
        eager ops) ran 75-320× slower than K1 (PERF.md)."""
        backend = self._tile_backend
        if backend == "auto":
            backend = "pallas" if self.device.type == "cuda" else "xla"
        if backend == "pallas" and self.spec.kernel_step is None:
            raise ValueError(
                "the tile-scan kernel needs ReplaySpec.kernel_step, and this "
                "spec has none; set surge.replay.tile-backend = xla to fold "
                "with the plain scan")
        if backend == "pallas" and isinstance(self.spec.kernel_step,
                                              MixedKernelStep):
            # raises naming the part without a kernel step, or the field
            # whose promoted dtype the kernels do not carry
            fold_kernels.mixed_parts(self.spec.kernel_step, self.spec.registry)
        if backend == "assoc" and self.spec.associative is None:
            raise ValueError(
                "surge.replay.tile-backend = assoc requires the ReplaySpec to "
                "carry an AssociativeFold (spec.associative) — this model "
                "only supports the sequential xla/pallas tile scan")
        return backend

    # -- resident-corpus path -----------------------------------------------------------

    def pack_resident(self, colev: ColumnarEvents) -> ResidentWire:
        """Host-side half of :meth:`prepare_resident`: length-sort, flat-pack
        and guard-pad the corpus into its device wire form (pure numpy,
        :meth:`ResidentWire.save`-able).

        An input whose events are already grouped per aggregate (``agg_idx``
        non-decreasing) is packed in its own event order and lanes point at
        their segments by indirection (``starts[k] = start of aggregate
        perm[k]``); only the O(B) length argsort is paid."""
        b = colev.num_aggregates
        agg = np.asarray(colev.agg_idx)
        lengths = np.bincount(agg, minlength=b).astype(np.int64)
        if self.sort_by_length and b > 1:
            # DESCENDING by length: the lanes still active after t events form a
            # prefix, so each tile round dispatches a contiguous lane range
            perm = np.argsort(-lengths, kind="stable").astype(np.int32)
            if np.array_equal(perm, np.arange(b, dtype=np.int32)):
                perm = None
        else:
            perm = None

        grouped = bool((np.diff(agg) >= 0).all()) if agg.size > 1 else True
        if grouped:
            to_pack = colev
        else:
            # ungrouped input: materialize the sorted order; lanes end up
            # buffer-contiguous
            if perm is not None:
                inv = np.empty_like(perm)
                inv[perm] = np.arange(b, dtype=np.int32)
                colev = ColumnarEvents(
                    num_aggregates=b, agg_idx=inv[colev.agg_idx],
                    type_ids=colev.type_ids, cols=colev.cols,
                    derived_cols=dict(colev.derived_cols))
                lengths = lengths[perm]
            to_pack = colev.sorted_by_aggregate()

        wire = WireFormat(self.spec.registry, dict(to_pack.derived_cols))
        t0 = time.perf_counter()
        packed, side_flat = wire.pack_flat(to_pack.type_ids, to_pack.cols)
        # tail padding so every live [start + t_base, width) slab stays in
        # bounds without clamping; content is irrelevant — slots past lens
        # decode to the pad sentinel
        guard = max(self.resident_tile_width(), _WIRE_GUARD_MIN)
        packed = np.pad(packed, ((0, guard), (0, 0)))
        side_flat = {k: np.pad(v, (0, guard)) for k, v in side_flat.items()}
        pack_elapsed = time.perf_counter() - t0
        self.stats["pack_s"] += pack_elapsed
        if self.profiler is not None:
            self.profiler.record("encode", pack_elapsed,
                                 events=to_pack.num_events, kind="pack_resident")
        # lengths/starts are in the PACKED stream's aggregate-id order; the
        # grouped path then permutes the lane VIEW only (indirection)
        starts = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(lengths, out=starts[1:])
        starts_lane, lens_lane = starts[:-1], lengths
        if grouped and perm is not None:
            starts_lane = starts_lane[perm]
            lens_lane = lengths[perm]
        return ResidentWire(
            derived_key=dict(to_pack.derived_cols), packed=packed,
            side=side_flat, starts=starts_lane.astype(np.int32),
            lengths=lens_lane.astype(np.int32), perm=perm, guard=guard,
            num_events=to_pack.num_events,
            layout=wire.layout_fingerprint())

    def check_wire(self, w: ResidentWire) -> WireFormat:
        """Validate a (possibly disk-loaded) wire against this engine: guard
        rows cover the tile width, and the packing layout matches the engine's
        schema bit for bit. Returns the engine's WireFormat for the wire."""
        if w.guard < self.resident_tile_width():
            raise ValueError(
                f"wire guard {w.guard} is smaller than the engine's tile width "
                f"{self.resident_tile_width()}; repack or lower "
                "surge.replay.time-chunk")
        wire = WireFormat(self.spec.registry, dict(w.derived_key))
        if w.layout is not None and w.layout != wire.layout_fingerprint():
            raise ValueError(
                f"wire layout mismatch: corpus was packed as {w.layout}, "
                f"engine schema packs {wire.layout_fingerprint()}; "
                "rebuild the wire with pack_resident")
        if wire.nbytes != w.packed.shape[1]:
            raise ValueError(
                f"wire layout mismatch: corpus packed {w.packed.shape[1]} "
                f"byte(s)/event but the engine's schema packs {wire.nbytes}; "
                "rebuild the wire with pack_resident")
        want_sides = {f.name: np.dtype(f.dtype) for f in wire.side_fields}
        got_sides = {k: np.dtype(v.dtype) for k, v in w.side.items()}
        if want_sides != got_sides:
            raise ValueError(
                f"wire side-column mismatch: corpus has {got_sides}, engine "
                f"schema expects {want_sides}; rebuild the wire")
        return wire

    def upload_resident(self, w: ResidentWire,
                        stream: Optional["torch.cuda.Stream"] = None
                        ) -> ResidentCorpus:
        """Device-side half of :meth:`prepare_resident`: copy a packed wire
        (fresh or mmapped from disk) to the device and return the replay
        handle. Buffer lengths bucket to powers of two unless
        ``surge.replay.resident-len-bucket = exact``.

        ``stream`` (a CUDA side stream) issues the copies on that stream from
        pinned staging and returns without waiting for them: the current
        stream waits on their event before anything it queues later, and
        each buffer is recorded on the current stream, so the caching
        allocator keeps it until the work queued there is done."""
        self.check_wire(w)
        if stream is not None and self.device.type != "cuda":
            raise ValueError("an upload stream needs a CUDA engine")
        b = w.lengths.shape[0]
        t0 = time.perf_counter()
        pow2 = self.config.get_str(
            "surge.replay.resident-len-bucket", "pow2") == "pow2"
        packed_b = _bucket_rows(w.packed, pow2)
        side_b = {k: _bucket_rows(v, pow2) for k, v in w.side.items()}
        up = lambda a: _to_device(a, self.device, stream)  # noqa: E731
        flat_wire = up(packed_b)
        flat_side = {k: up(v) for k, v in side_b.items()}
        bs = min(self.batch_size, _round_up(max(b, 1), _LANE_MULTIPLE))
        b_pad = _round_up(max(b, 1), bs)
        if pow2:
            chunks = 1
            while chunks * bs < b_pad:
                chunks *= 2
            b_pad = chunks * bs
        starts_p = np.zeros((b_pad,), dtype=np.int32)
        starts_p[:b] = w.starts
        lens_p = np.zeros((b_pad,), dtype=np.int32)
        lens_p[:b] = w.lengths
        starts_dev = up(starts_p)
        lens_dev = up(lens_p)
        if stream is None:
            _sync(self.device)
        else:
            main = torch.cuda.current_stream(self.device)
            main.wait_stream(stream)
            for t in (flat_wire, starts_dev, lens_dev, *flat_side.values()):
                t.record_stream(main)
        upload_s = time.perf_counter() - t0
        self.stats["h2d_s"] += upload_s
        wire_bytes = packed_b.nbytes + sum(v.nbytes for v in side_b.values())
        if self.profiler is not None:
            self.profiler.record("h2d", upload_s, kind="upload_resident",
                                 bytes=wire_bytes)
        return ResidentCorpus(
            derived_key=dict(w.derived_key), flat_wire=flat_wire,
            flat_side=flat_side, starts=w.starts, lengths=w.lengths, perm=w.perm,
            starts_dev=starts_dev, lens_dev=lens_dev, b_pad=b_pad,
            num_events=w.num_events, wire_bytes=wire_bytes, upload_s=upload_s)

    def prepare_resident(self, colev: ColumnarEvents) -> ResidentCorpus:
        """Pack and upload the whole corpus once; see :meth:`replay_resident`."""
        return self.upload_resident(self.pack_resident(colev))

    def _resident_plan(self, resident: ResidentCorpus) -> ResidentPlan:
        """Host-side tile schedule. Tile k of a granularity folds events
        ``[t_bases[k], t_bases[k]+width)`` of lanes ``[i0s[k], i0s[k]+bs)``.

        Lanes are length-sorted descending, so the lanes still active in round
        r form a shrinking prefix. Each round covers it with full-width
        ``bs_big`` tiles plus narrow ``bs_small`` tiles over the remainder. A
        lane only ever moves big→small as the prefix shrinks, so running ALL
        big tiles (in round order) before ALL small tiles (in round order)
        preserves per-lane event order."""
        b = resident.lengths.shape[0]
        lane = _LANE_MULTIPLE
        bs_big = min(self.batch_size, _round_up(max(b, 1), lane))
        bs_small = min(bs_big, max(lane, bs_big // 8))
        # bs_small MUST divide bs_big: the small-tile walk covers
        # [n_big*bs_big, active) in bs_small steps while the slab is only
        # padded to a bs_big multiple — a non-divisor's last tile would run
        # past b_pad (_lane_range raises on that)
        if bs_big % bs_small:
            bs_small = max(c for c in range(lane, bs_small + 1, lane)
                           if bs_big % c == 0)  # lane | bs_big, so non-empty
        if bs_big % bs_small:
            raise AssertionError((bs_big, bs_small))
        width = self.resident_tile_width()
        lens_host = resident.lengths
        max_len = int(lens_host.max(initial=0)) if b else 0
        sorted_desc = bool((np.diff(lens_host) <= 0).all()) if b > 1 else True
        big_i0: list[int] = []
        big_tb: list[int] = []
        small_i0: list[int] = []
        small_tb: list[int] = []
        if sorted_desc:
            lens_asc = lens_host[::-1]
            t_base = 0
            while t_base < max_len:
                active = b - int(np.searchsorted(lens_asc, t_base, side="right"))
                n_big = active // bs_big
                for k in range(n_big):
                    big_i0.append(k * bs_big)
                    big_tb.append(t_base)
                for i0 in range(n_big * bs_big, active, bs_small):
                    small_i0.append(i0)
                    small_tb.append(t_base)
                t_base += width
        else:
            # unsorted corpus: schedule each contiguous lane range only up to
            # its own local max length; lanes stay in one range, so ascending
            # t_base per range preserves per-lane event order
            for i0 in range(0, b, bs_big):
                local_max = int(lens_host[i0: i0 + bs_big].max(initial=0))
                for t_base in range(0, local_max, width):
                    big_i0.append(i0)
                    big_tb.append(t_base)
        return ResidentPlan(
            width=width, bs_big=bs_big, bs_small=bs_small,
            big_i0=np.asarray(big_i0, dtype=np.int32),
            big_tb=np.asarray(big_tb, dtype=np.int32),
            small_i0=np.asarray(small_i0, dtype=np.int32),
            small_tb=np.asarray(small_tb, dtype=np.int32))

    @staticmethod
    def _plan_cap(k: int) -> int:
        """The reference's work-list buffer length bucket (next power of two
        ≥ 64); kept for the dense-layout memory estimate."""
        cap = 64
        while cap < k:
            cap *= 2
        return cap

    def replay_resident(self, resident: ResidentCorpus,
                        init_carry: Mapping[str, Any] | None = None,
                        ordinal_base: np.ndarray | None = None) -> ReplayResult:
        """Fold a prepared resident corpus. Results are in the ORIGINAL
        aggregate order of the ColumnarEvents given to :meth:`pack_resident`.

        ``init_carry`` (``{field: [B]}``) resumes each aggregate from a state
        instead of the init record, and ``ordinal_base`` (``[B]``) continues its
        derived ordinals from the already-folded event count; both are numpy
        arrays in the original order and are never written to."""
        b = resident.lengths.shape[0]
        if b == 0:
            return ReplayResult(states={f.name: np.zeros((0,), dtype=f.dtype)
                                        for f in self.spec.registry.state.fields},
                                num_aggregates=0, num_events=0, padded_events=0)
        init_sorted, ord_sorted = _apply_perm(resident.perm, init_carry,
                                              ordinal_base)
        prof = self.profiler
        with (prof.replay_pass("replay.resident", aggregates=b,
                               events=resident.num_events)
              if prof is not None else contextlib.nullcontext()):
            t0 = time.perf_counter()
            if prof is None:
                slab, padded = self._dispatch_resident(resident, init_sorted,
                                                       ord_sorted)
            else:
                # a shape not seen before is the reference's compile; the
                # range wraps the kernels' launches in a torch.profiler trace
                sig = self._resident_signature(resident)
                fresh = sig not in self._resident_sigs
                self._resident_sigs.add(sig)
                with prof.stage("compile" if fresh else "dispatch",
                                aggregates=b):
                    slab, padded = self._dispatch_resident(
                        resident, init_sorted, ord_sorted)
            _sync(self.device)
            t1 = time.perf_counter()
            with self._fetch_stage():
                states = self._pull_states(slab, b, resident.perm,
                                           resident.cache)
        self.stats["fold_s"] += t1 - t0
        self.stats["pull_s"] += time.perf_counter() - t1
        return ReplayResult(states=states, num_aggregates=b,
                            num_events=resident.num_events, padded_events=padded)

    def fold_resident_slab(self, resident: ResidentCorpus,
                           init_carry: Mapping[str, Any] | None = None,
                           ordinal_base: np.ndarray | None = None
                           ) -> tuple[dict, int]:
        """Fold a prepared resident corpus and return the device state slab
        ``({field: [b_pad] tensor}, padded_slots)`` instead of pulling states
        to the host. Rows are in the corpus's SORTED lane order
        (``resident.perm`` maps sorted rank → original aggregate index) and rows
        past ``b`` are padding."""
        init_sorted, ord_sorted = _apply_perm(resident.perm, init_carry,
                                              ordinal_base)
        return self._dispatch_resident(resident, init_sorted, ord_sorted)

    def _resident_signature(self, resident: ResidentCorpus) -> tuple:
        """The shapes a resident replay's work lists run at (the reference
        compiles one program per such signature)."""
        plan = self._plan_for(resident)
        return (frozenset(resident.derived_key.items()), plan.width,
                plan.bs_big, self._plan_cap(len(plan.big_i0)), plan.bs_small,
                self._plan_cap(len(plan.small_i0)), resident.b_pad,
                self._use_dense(resident, plan),
                int(resident.flat_wire.shape[0]))

    def _pull_states(self, slab: Mapping[str, torch.Tensor], b: int,
                     perm: Optional[np.ndarray],
                     cache: Optional[dict] = None) -> dict[str, np.ndarray]:
        """Un-permute and truncate on the device (one gather per column), then
        copy each column to the host at its schema dtype. The reference packs
        narrow u16 columns to save its slow device→host link; this pulls wide.
        ``cache`` (a per-corpus dict) memoizes the device inverse permutation."""
        inv = cache.get("invperm") if cache is not None else None
        if inv is None:
            invp = np.arange(b, dtype=np.int64)
            if perm is not None:
                invp[perm] = np.arange(b, dtype=np.int64)
            inv = torch.from_numpy(invp).to(self.device)
            if cache is not None:
                cache["invperm"] = inv
        return {f.name: slab[f.name][inv].cpu().numpy()
                for f in self.spec.registry.state.fields}

    def _dispatch_resident(self, resident: ResidentCorpus,
                           init_sorted: Mapping[str, np.ndarray] | None,
                           ord_sorted: np.ndarray | None) -> tuple[dict, int]:
        """Fold one resident corpus without syncing: returns the (device)
        state slab and the padded-slot count. Inputs are already in the
        corpus's sorted lane order."""
        b = resident.lengths.shape[0]
        plan = self._plan_for(resident)
        b_pad = resident.b_pad
        if init_sorted is None and ord_sorted is None:
            slab, ord_d = self._fresh_slab(b_pad)
        else:
            ord_p = np.zeros((b_pad,), dtype=np.int32)
            if ord_sorted is not None:
                ord_p[:b] = np.asarray(ord_sorted).astype(np.int32)
            slab_np = self.init_carry_np(b_pad)
            if init_sorted is not None:
                for k, full in init_sorted.items():
                    slab_np[k][:b] = np.asarray(full)
            slab = {k: _to_device(v, self.device) for k, v in slab_np.items()}
            ord_d = _to_device(ord_p, self.device)
        self._run_tiles(resident, plan, slab, ord_d)
        return slab, plan.padded_slots

    def _run_tiles(self, resident: ResidentCorpus, plan: ResidentPlan,
                   slab: dict, ord_d: torch.Tensor, limit: int | None = None
                   ) -> None:
        """Fold the plan's tiles into ``slab`` in place: all big tiles, then
        all small ones (per-lane order holds because a lane only ever moves
        big→small as the active prefix shrinks). The kernel backend folds
        each list with one list-fold call; the plain backend walks each list
        tile by tile through the list fold's plain version with its own time
        scan. ``limit`` folds only the first tiles of each list (warm-up)."""
        key = frozenset(resident.derived_key.items())
        use_dense = self._use_dense(resident, plan)
        backend = self.tile_backend
        kernel = backend == "pallas"
        for bs, i0s, t_bases in ((plan.bs_big, plan.big_i0, plan.big_tb),
                                 (plan.bs_small, plan.small_i0, plan.small_tb)):
            k_n = len(i0s) if limit is None else min(limit, len(i0s))
            if k_n == 0:
                continue
            if limit is None:
                self.stats["windows"] += k_n
                if self.profiler is not None:
                    self.profiler.count_windows(k_n)
            if use_dense:
                words, sides = self._dense_tiles(resident, plan, bs, i0s, t_bases)
                starts = None
            else:
                words, sides = resident.flat_wire, resident.flat_side
                starts = resident.starts_dev
            wire = self._wire(key)
            if kernel:
                i0s_d, tb_d, schedule = self._work_list(resident, plan, bs, i0s,
                                                        t_bases)
                fold_kernels.tile_fold_list(
                    slab, words, sides, resident.lens_dev, ord_d, i0s_d, tb_d,
                    width=plan.width, bs=bs, spec=self.spec, wire=wire,
                    starts=starts, k_n=k_n, schedule=schedule)
            else:
                fold = (_make_assoc_body(self.spec, wire, plan.width)
                        if backend == "assoc" else
                        _make_fold_body(self.spec, wire, plan.width,
                                        self._dispatch))
                fold_kernels.tile_fold_list_reference(
                    slab, words, sides, resident.lens_dev, ord_d, i0s, t_bases,
                    width=plan.width, bs=bs, spec=self.spec, wire=wire,
                    starts=starts, k_n=k_n, fold=fold)

    def _wire(self, key: frozenset) -> WireFormat:
        """The wire format for one derived-column declaration (one per engine,
        so the kernels' cached decode arguments are found again)."""
        wire = self._wires.get(key)
        if wire is None:
            wire = self._wires[key] = WireFormat(self.spec.registry, dict(key))
        return wire

    def _work_list(self, resident: ResidentCorpus, plan: ResidentPlan, bs: int,
                   i0s: np.ndarray, t_bases: np.ndarray):
        """Build-or-fetch one work list on the device for the list fold:
        ``(i0s, t_bases, (blk_ids, blk_off, blk_tiles))``, the last its
        per-lane-block schedule (:func:`fold_kernels.list_schedule`); cached
        on the corpus beside the dense tiles."""
        ckey = ("list", plan.width, bs, np.asarray(i0s, np.int32).tobytes(),
                np.asarray(t_bases, np.int32).tobytes())
        hit = resident.cache.get(ckey)
        if hit is None:
            up = lambda a: _to_device(np.asarray(a, np.int32), self.device)  # noqa: E731
            sched = fold_kernels.list_schedule(i0s, bs, resident.b_pad)
            hit = resident.cache[ckey] = (up(i0s), up(t_bases),
                                          tuple(up(a) for a in sched))
        return hit

    def _plan_for(self, resident: ResidentCorpus) -> ResidentPlan:
        """The corpus's tile plan, cached on the corpus."""
        pkey = ("plan", self.resident_tile_width(), self.batch_size)
        plan = resident.cache.get(pkey)
        if plan is None:
            plan = self._resident_plan(resident)
            resident.cache[pkey] = plan
        return plan

    def _fresh_slab(self, b_pad: int):
        """Fresh init state slab + zero ordinal base, built on the device."""
        init = self.spec.init_state_tree()
        slab = {f.name: torch.full((b_pad,), init[f.name].item(),
                                   dtype=torch_dtype(f.dtype), device=self.device)
                for f in self.spec.registry.state.fields}
        return slab, torch.zeros((b_pad,), dtype=torch.int32, device=self.device)

    def _use_dense(self, resident: ResidentCorpus, plan: ResidentPlan) -> bool:
        if self._resident_layout == "flat":
            return False
        if resident.cache.get("oneshot"):
            # a corpus folded once pays the densify gather without ever
            # amortizing it — always gather per-pass
            return False
        if self._resident_layout == "dense":
            return True
        if self.device.type == "cpu":
            # dense trades memory (pad_ratio × corpus) for a per-pass gather
            # the host does fine
            return False
        if plan.padded_slots < 16_000_000:
            # below this scale the one-time gather never pays back
            return False
        return self._dense_bytes(resident, plan) <= self._dense_cap_mb * 1024 * 1024

    def _dense_bytes(self, resident: ResidentCorpus, plan: ResidentPlan) -> int:
        """Device memory the dense tile buffers would take, estimated as the
        reference does (work lists padded to their power-of-two cap)."""
        nbytes = int(resident.flat_wire.shape[1])
        per_slot = nbytes + sum(arr.element_size()
                                for arr in resident.flat_side.values())
        total = 0
        for bs, i0s in ((plan.bs_big, plan.big_i0),
                        (plan.bs_small, plan.small_i0)):
            if len(i0s):
                total += self._plan_cap(len(i0s)) * bs * plan.width * per_slot
        return total

    def _dense_tiles(self, resident: ResidentCorpus, plan: ResidentPlan,
                     bs: int, i0s: np.ndarray, t_bases: np.ndarray):
        """Build-or-fetch the dense tile buffers for one work list (cached on
        the corpus; the gather runs once per corpus, not once per pass)."""
        ckey = ("dense", plan.width, bs, np.asarray(i0s, np.int32).tobytes(),
                np.asarray(t_bases, np.int32).tobytes())
        hit = resident.cache.get(ckey)
        if hit is not None:
            return hit
        wire = self._wire(frozenset(resident.derived_key.items()))
        t0 = time.perf_counter()
        entry = _make_densify(wire, plan.width, bs)(
            resident.flat_wire, resident.flat_side, resident.starts_dev,
            i0s, t_bases)
        resident.cache[ckey] = entry
        self.stats["densify_s"] += time.perf_counter() - t0
        return entry

    def resident_cap_width(self) -> int:
        """Largest tile width the memory budget allows (pow2 multiple of the
        min window): one tile materializes a [batch, width] u32 slab and its
        transpose, so width is capped by resident-slab-cap-mb."""
        budget = self.config.get_int("surge.replay.resident-slab-cap-mb", 512)
        w = max(self.min_time_window, 1)
        while w * 2 * self.batch_size * 8 <= budget * 1_000_000:
            w *= 2
        return w

    def resident_tile_width(self) -> int:
        """The fixed tile width of :meth:`replay_resident` tiles: the
        time-chunk rounded up to a power of two, inside the memory cap."""
        w = max(self.min_time_window, 1)
        target = max(self.time_chunk, 1)
        cap = self.resident_cap_width()
        while w < target and w < cap:
            w *= 2
        return w

    def warm_resident(self, resident: ResidentCorpus) -> None:
        """Do the one-time work of a replay before it is timed: build and load
        the kernel (when the backend is the kernel), run the dense layout's
        tile gather, build each work list's schedule, and fold the first tile
        of each work list into a discarded slab."""
        b = resident.lengths.shape[0]
        if b == 0:
            return
        if self.tile_backend == "pallas" and self.device.type == "cuda":
            fold_kernels.load()
        plan = self._plan_for(resident)
        slab, ord_d = self._fresh_slab(resident.b_pad)
        self._run_tiles(resident, plan, slab, ord_d, limit=1)
        _sync(self.device)

    def replay_resident_streamed(self, w: ResidentWire, *,
                                 segments: int | None = None,
                                 init_carry: Mapping[str, Any] | None = None,
                                 ordinal_base: np.ndarray | None = None
                                 ) -> ReplayResult:
        """Upload AND fold a packed wire in lane pieces: piece s's tiles are
        queued right after its upload is issued, so the folds of earlier
        pieces hide the uploads of later ones. On CUDA each piece's upload
        runs on a side stream from pinned staging (:meth:`upload_resident`
        with ``stream``); on the CPU the pieces run one after another.

        Pieces split at event-count boundaries (balanced bytes) and each is a
        zero-copy contiguous slice of the buffer: for a contiguous wire the
        piece's lanes are a lane range; for an indirect wire (the
        grouped-input pack, whose lane slabs tile the buffer in buffer order,
        not lane order) the piece's lanes are the subset whose slabs fall in
        the slice, re-sorted by descending length for the tile plan, and the
        zero-length lanes go with the first piece. A wire whose slabs do not
        tile its buffer at all falls back to one upload and
        :meth:`replay_resident`. Every piece is folded once (``oneshot``:
        the flat list fold); one pull pass over every piece follows, then the
        global un-permute. Results are in the original aggregate order.

        ``segments`` defaults to ``surge.replay.upload-stream-segments``
        (0/1: one upload, then :meth:`replay_resident`)."""
        if segments is None:
            segments = self.config.get_int(
                "surge.replay.upload-stream-segments", 0)
        b = w.lengths.shape[0]

        def plain() -> ReplayResult:
            return self.replay_resident(self.upload_resident(w),
                                        init_carry=init_carry,
                                        ordinal_base=ordinal_base)

        if segments <= 1 or b == 0:
            return plain()
        self.check_wire(w)
        perm = w.perm
        init_sorted, ord_sorted = _apply_perm(perm, init_carry, ordinal_base)

        starts64 = w.starts.astype(np.int64)
        lens64 = w.lengths.astype(np.int64)
        cum = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(lens64, out=cum[1:])
        total = int(cum[-1])
        zero_lanes = np.array([], dtype=np.int64)
        if np.array_equal(starts64, cum[:-1]):
            # lanes tile the buffer in lane order: pieces are lane ranges
            lane_order = None
            piece_starts = cum
            n_lanes = b
        else:
            # indirect wire: walk the nonzero lanes by start so each piece is
            # still one contiguous slice; zero-length lanes occupy no rows
            nz = np.nonzero(lens64 > 0)[0]
            zero_lanes = np.nonzero(lens64 == 0)[0]
            if nz.size == 0:
                return plain()
            lane_order = nz[np.argsort(starts64[nz], kind="stable")]
            piece_starts = np.zeros(lane_order.size + 1, dtype=np.int64)
            np.cumsum(lens64[lane_order], out=piece_starts[1:])
            if not np.array_equal(starts64[lane_order], piece_starts[:-1]):
                return plain()  # slabs don't tile the buffer
            n_lanes = lane_order.size

        bounds = [0]
        for s in range(1, segments):
            cut = int(np.searchsorted(piece_starts, total * s // segments))
            bounds.append(min(max(cut, bounds[-1]), n_lanes))
        bounds.append(n_lanes)

        side = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                else None)
        t0 = time.perf_counter()
        pieces: list = []
        padded = 0
        first_piece = True
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if hi <= lo:
                continue
            base = int(piece_starts[lo])
            end = int(piece_starts[hi])
            if lane_order is None:
                lanes = np.arange(lo, hi)
                sub_starts = starts64[lo:hi] - base
                sub_lens = w.lengths[lo:hi]
            else:
                lanes = lane_order[lo:hi]
                if first_piece and zero_lanes.size:
                    lanes = np.concatenate([lanes, zero_lanes])
                # piece-local descending length order keeps the plan's
                # shrinking-prefix schedule (zero lanes last, folding nothing)
                lanes = lanes[np.argsort(-lens64[lanes], kind="stable")]
                sub_starts = np.where(lens64[lanes] > 0,
                                      starts64[lanes] - base, 0)
                sub_lens = w.lengths[lanes]
            first_piece = False
            sub = ResidentWire(
                derived_key=dict(w.derived_key),
                packed=w.packed[base: end + w.guard],
                side={k: v[base: end + w.guard] for k, v in w.side.items()},
                starts=sub_starts.astype(np.int32),
                lengths=sub_lens, perm=None, guard=w.guard,
                num_events=end - base, layout=w.layout)
            piece = self.upload_resident(sub, stream=side)
            # folded exactly once: the dense layout's gather never amortizes
            piece.cache["oneshot"] = True
            slab, pad = self._dispatch_resident(
                piece,
                None if init_sorted is None else
                {k: v[lanes] for k, v in init_sorted.items()},
                None if ord_sorted is None else ord_sorted[lanes])
            padded += pad
            # hold only what the pull needs, not the piece's wire buffers
            pieces.append((lanes, slab))
        _sync(self.device)
        t1 = time.perf_counter()
        out_sorted = {f.name: np.empty((b,), dtype=f.dtype)
                      for f in self.spec.registry.state.fields}
        for lanes, slab in pieces:
            with self._fetch_stage():
                piece_states = self._pull_states(slab, int(lanes.shape[0]), None)
            for name, col in piece_states.items():
                out_sorted[name][lanes] = col
        # fold_s spans the piece loop (uploads issued, folds queued) to the
        # device's finish
        self.stats["fold_s"] += t1 - t0
        self.stats["pull_s"] += time.perf_counter() - t1
        return ReplayResult(states=_unapply_perm(perm, out_sorted),
                            num_aggregates=b, num_events=w.num_events,
                            padded_events=padded)

    # -- non-resident paths: host-packed windows -----------------------------------------

    def replay_encoded(self, enc: EncodedEvents,
                       init_carry: Mapping[str, Any] | None = None,
                       ordinal_base: np.ndarray | None = None) -> ReplayResult:
        """Fold one encoded batch in B-chunks of ``surge.replay.batch-size``
        lanes, each through :meth:`_fold_window`'s time windows.

        When resuming (``init_carry`` from a snapshot) and the batch declares
        derived ordinal columns, ``ordinal_base`` carries each aggregate's
        already-folded event count ``[B]`` so the derived ordinals continue."""
        b = enc.batch_size
        bs = min(self.batch_size, _round_up(max(b, 1), _LANE_MULTIPLE))
        out = {f.name: np.zeros((b,), dtype=f.dtype)
               for f in self.spec.registry.state.fields}
        padded = 0
        for start in range(0, max(b, 1), bs):
            stop = min(start + bs, b)
            if stop <= start:
                break
            carry = self._carry_slice(init_carry, start, stop, bs)
            carry, scanned = self._fold_window(
                carry, enc.type_ids[start:stop],
                {k: v[start:stop] for k, v in enc.cols.items()}, bs,
                derived_cols=enc.derived_cols,
                ordinal_base=None if ordinal_base is None
                else ordinal_base[start:stop])
            with self._fetch_stage():
                for name in out:
                    out[name][start:stop] = carry[name].cpu().numpy()[: stop - start]
            padded += bs * scanned
        return ReplayResult(states=out, num_aggregates=b,
                            num_events=int(enc.lengths.sum()), padded_events=padded)

    def replay_columnar(self, colev: ColumnarEvents,
                        init_carry: Mapping[str, Any] | None = None,
                        ordinal_base: np.ndarray | None = None) -> ReplayResult:
        """Fold a flat columnar log (the segment storage layout) B-chunk by
        B-chunk: each chunk becomes a padded ``[bs, T]`` batch
        (``columnar_to_batch``) of its own max length only. With
        ``surge.replay.sort-by-length`` (default on) aggregates are ordered
        by length (ascending) before chunking; states are scattered back to
        the caller's aggregate order."""
        b = colev.num_aggregates
        bs = min(self.batch_size, _round_up(max(b, 1), _LANE_MULTIPLE))
        perm = None
        if self.sort_by_length and b > bs:
            lengths_all = np.bincount(colev.agg_idx, minlength=b).astype(np.int64)
            perm = np.argsort(lengths_all, kind="stable").astype(np.int32)
            if np.array_equal(perm, np.arange(b, dtype=np.int32)):
                perm = None  # already length-ordered: skip the relabel
            else:
                inv = np.empty_like(perm)
                inv[perm] = np.arange(b, dtype=np.int32)
                # relabel each event's aggregate to its length rank; the
                # stable sort below groups by rank keeping time order
                colev = ColumnarEvents(
                    num_aggregates=b, agg_idx=inv[colev.agg_idx],
                    type_ids=colev.type_ids, cols=colev.cols,
                    derived_cols=dict(colev.derived_cols))
        sorted_ev = colev.sorted_by_aggregate()
        out = {f.name: np.zeros((b,), dtype=f.dtype)
               for f in self.spec.registry.state.fields}
        padded = 0
        total_events = 0
        for start in range(0, max(b, 1), bs):
            stop = min(start + bs, b)
            if stop <= start:
                break
            idxs = None if perm is None else perm[start:stop]
            enc = columnar_to_batch(sorted_ev.slice_aggregates(start, stop))
            carry = self._carry_slice(init_carry, start, stop, bs, idxs=idxs)
            ob = (None if ordinal_base is None else
                  np.asarray(ordinal_base)[idxs] if idxs is not None
                  else ordinal_base[start:stop])
            carry, scanned = self._fold_window(carry, enc.type_ids, enc.cols, bs,
                                               derived_cols=enc.derived_cols,
                                               ordinal_base=ob)
            with self._fetch_stage():
                for name in out:
                    chunk_states = carry[name].cpu().numpy()[: stop - start]
                    if idxs is None:
                        out[name][start:stop] = chunk_states
                    else:
                        out[name][idxs] = chunk_states
            padded += bs * scanned
            total_events += int(enc.lengths.sum())
        return ReplayResult(states=out, num_aggregates=b,
                            num_events=total_events, padded_events=padded)

    def _window_plan(self, t: int) -> list[tuple[int, int]]:
        """Decompose a T-length window into ``(start, padded_width)`` pieces:
        full pieces are ``time-chunk`` wide; the tail descends the
        power-of-two :meth:`ladder_widths` down to ``min-time-window``
        (``min-time-window = 0``: one full-width tail)."""
        if t <= 0:
            return []
        chunk = self.time_chunk if self.time_chunk > 0 else t
        plan = []
        s = 0
        while t - s >= chunk:
            plan.append((s, chunk))
            s += chunk
        rem = t - s
        if rem > 0 and self.min_time_window <= 0:
            plan.append((s, chunk))
        elif rem > 0:
            ladder = self.ladder_widths()
            w = ladder[-1]
            while rem > 0:
                while w > ladder[0] and w > rem:
                    w //= 2
                plan.append((s, w))
                take = min(w, rem)
                s += take
                rem -= take
        return plan

    def ladder_widths(self) -> list[int]:
        """The tail-window widths :meth:`_window_plan` can dispatch
        (ascending): ``min-time-window × 2^k``, strictly below the
        time-chunk."""
        min_w = max(self.min_time_window, 1)
        chunk = self.time_chunk if self.time_chunk > 0 else min_w
        ladder = [min_w]
        while ladder[-1] * 2 < chunk:
            ladder.append(ladder[-1] * 2)
        return ladder

    def _fold_window(self, carry: dict, type_ids: np.ndarray,
                     cols: Mapping[str, np.ndarray], bs: int,
                     derived_cols: Mapping[str, str] | None = None,
                     t_base: int = 0,
                     ordinal_base: np.ndarray | None = None
                     ) -> tuple[dict, int]:
        """Fold one ``[b, T]`` batch (b ≤ bs) into ``carry`` ``{f: [bs]}``
        through :meth:`_window_plan`'s windows; returns ``(carry,
        scanned_t)``, the padded slots per lane dispatched.

        Each window is packed on the host (``WireFormat.pack_window``: u8
        ``[width, bs, nbytes]`` + side columns; a slot past a log's end or
        with an out-of-range type id packs as the pad code, which folds to
        nothing), uploaded and folded by :meth:`_fold_packed`. The derived
        ordinal of time step t is ``ordinal_base[b] + t_base + s + t + 1``:
        the resume base plus the window's global offset, folded into the
        per-lane base on the host."""
        wire = self._wire(frozenset(dict(derived_cols or {}).items()))
        b, t = type_ids.shape
        base = np.zeros((bs,), dtype=np.int32)
        if ordinal_base is not None:
            base[:b] = np.asarray(ordinal_base, dtype=np.int32)[:b]
        scanned = 0
        for s, width in self._window_plan(t):
            e = min(s + width, t)
            t0 = time.perf_counter()
            packed, side = wire.pack_window(type_ids, cols, s, e, width, bs)
            ord_base = base + np.int32(t_base + s)
            t1 = time.perf_counter()
            words = _to_device(packed, self.device)
            sides = {k: _to_device(v, self.device) for k, v in side.items()}
            t2 = time.perf_counter()
            self.stats["pack_s"] += t1 - t0
            self.stats["h2d_s"] += t2 - t1
            self.stats["windows"] += 1
            scanned += width
            sig = (frozenset(wire.derived.items()), packed.shape,
                   tuple((k, v.shape) for k, v in sorted(side.items())))
            first_dispatch = sig not in self._signatures
            self._signatures.add(sig)
            if self.profiler is None:
                carry = self._fold_packed(carry, wire, words, sides, ord_base,
                                          type_ids[:, s:e])
            else:
                self.profiler.count_windows()
                self.profiler.record("encode", t1 - t0, width=width)
                self.profiler.record("h2d", t2 - t1, width=width)
                with self.profiler.stage(
                        "compile" if first_dispatch else "dispatch",
                        width=width, batch=bs):
                    carry = self._fold_packed(carry, wire, words, sides,
                                              ord_base, type_ids[:, s:e])
        return carry, scanned

    def _fold_packed(self, carry: dict, wire: WireFormat, words: torch.Tensor,
                     sides: Mapping[str, torch.Tensor], ord_base: np.ndarray,
                     type_ids: np.ndarray) -> dict:
        """Fold one packed window (``words`` u8 ``[width, bs, nbytes]`` and
        ``sides`` ``{n: [width, bs]}`` on the device, ``ord_base`` int32
        ``[bs]``) into ``carry``, by the tile backend:

        - ``pallas``: K1's list fold over a one-tile dense work list (tile 0:
          lanes ``[0, bs)``, ``t_base`` 0), in place. A lane's length is its
          window slots up to its last in-range type id (padding lanes: 0):
          the slots past it pack to the pad code and fold to nothing, and an
          out-of-range id before it decodes to a no-op step, as the
          reference's window does.
        - ``assoc``: the tree fold (:func:`_make_assoc_body`).
        - ``xla``: the plain time scan (:func:`make_batch_fold`) of the
          decoded window."""
        backend = self.tile_backend
        width, bs = words.shape[0], words.shape[1]
        if backend == "pallas":
            lo = _to_device(np.stack([window_lens(type_ids, wire.num_types, bs),
                                      ord_base]), self.device)
            i0s, t_bases, schedule = self._window_list(bs)
            fold_kernels.tile_fold_list(
                carry, words[None], {k: v[None] for k, v in sides.items()},
                lo[0], lo[1], i0s, t_bases, width=width, bs=bs, spec=self.spec,
                wire=wire, schedule=schedule)
            return carry
        ord_d = _to_device(np.asarray(ord_base, np.int32), self.device)
        if backend == "assoc":
            flat = wire.expand_flat(words.reshape(width * bs, wire.nbytes))
            full = torch.full((bs,), width, dtype=torch.int32, device=self.device)
            return _make_assoc_body(self.spec, wire, width)(
                carry, flat.reshape(width, bs), sides, full, ord_d, 0)
        fold = make_batch_fold(self.spec, dispatch=self._dispatch)
        return fold(carry, wire.decode(words, sides, ord_d))

    def _window_list(self, bs: int):
        """The one-tile work list of a ``bs``-lane window on the device:
        ``(i0s [0], t_bases [0], schedule)``, built once per ``bs``."""
        hit = self._window_lists.get(bs)
        if hit is None:
            zero = np.zeros((1,), dtype=np.int32)
            up = lambda a: _to_device(np.asarray(a, np.int32), self.device)  # noqa: E731
            hit = self._window_lists[bs] = (
                up(zero), up(zero),
                tuple(up(a) for a in fold_kernels.list_schedule(zero, bs, bs)))
        return hit

    def replay_ragged(self, logs: Sequence[Sequence[Any]],
                      encode: Callable[[Any], Any] | None = None,
                      init_carry: Mapping[str, Any] | None = None) -> ReplayResult:
        """Length-bucketed replay of ragged logs: aggregates group by log
        length into ``surge.replay.length-buckets`` padded buckets, each
        folds through :meth:`replay_encoded`, and results scatter back to
        the original order. ``encode`` maps each raw event to its
        tensor-schema form first; ``init_carry`` (``{field: [len(logs)]}``)
        resumes each aggregate from a snapshot."""
        if encode is not None:
            logs = [[encode(e) for e in log] for log in logs]
        groups = bucket_lengths([len(l) for l in logs], self.buckets)
        out = {f.name: np.zeros((len(logs),), dtype=f.dtype)
               for f in self.spec.registry.state.fields}
        total_events = 0
        padded = 0
        for cap in sorted(groups):
            idxs = groups[cap]
            enc = encode_events(self.spec.registry, [logs[i] for i in idxs],
                                pad_to=cap)
            sub_init = (None if init_carry is None else
                        {k: np.asarray(v)[idxs] for k, v in init_carry.items()})
            res = self.replay_encoded(enc, init_carry=sub_init)
            for name in out:
                out[name][idxs] = res.states[name]
            total_events += res.num_events
            padded += res.padded_events
        return ReplayResult(states=out, num_aggregates=len(logs),
                            num_events=total_events, padded_events=padded)

    def replay_columnar_chunks(self, chunks: Iterable[ColumnarEvents]
                               ) -> ReplayResult:
        """Fold a stream of aggregate-range chunks (each a disjoint set of
        aggregates, as a columnar segment holds them): each chunk replays
        through :meth:`replay_columnar` and the state columns concatenate in
        order, with the chunks' aggregate ids when every chunk has them."""
        fields = self.spec.registry.state.fields
        parts: dict[str, list[np.ndarray]] = {f.name: [] for f in fields}
        total_aggregates = total_events = padded = 0
        ids: list = []
        saw_ids = True
        for colev in chunks:
            res = self.replay_columnar(colev)
            for name in parts:
                parts[name].append(res.states[name])
            total_aggregates += res.num_aggregates
            total_events += res.num_events
            padded += res.padded_events
            if colev.aggregate_ids is None:
                saw_ids = False
            elif saw_ids:
                ids.extend(colev.aggregate_ids)
        if total_aggregates == 0:
            return ReplayResult(states={f.name: np.zeros((0,), dtype=f.dtype)
                                        for f in fields},
                                num_aggregates=0, num_events=0, padded_events=0,
                                aggregate_ids=[] if saw_ids else None)
        return ReplayResult(
            states={name: np.concatenate(arrs) for name, arrs in parts.items()},
            num_aggregates=total_aggregates, num_events=total_events,
            padded_events=padded, aggregate_ids=ids if saw_ids else None)

    def replay_stream(self, chunks: Iterable[EncodedEvents], batch: int,
                      init_carry: Mapping[str, Any] | None = None,
                      ordinal_base: np.ndarray | None = None) -> ReplayResult:
        """Fold a stream of EncodedEvents chunks (the same ``batch`` lanes,
        consecutive time windows), carrying each B-chunk's state across
        chunks on the device. A chunk's derived ordinals continue from the
        cumulative width of the chunks before it."""
        bs = min(self.batch_size, _round_up(max(batch, 1), _LANE_MULTIPLE))
        n_bchunks = max((batch + bs - 1) // bs, 1)
        carries: list = [None] * n_bchunks
        total_events = 0
        padded = 0
        t_cursor = 0  # global time offset of the current chunk
        for enc in chunks:
            if enc.batch_size != batch:
                raise ValueError(f"stream chunk batch {enc.batch_size} != {batch}")
            for ci in range(n_bchunks):
                start, stop = ci * bs, min((ci + 1) * bs, batch)
                if carries[ci] is None:
                    carries[ci] = self._carry_slice(init_carry, start, stop, bs)
                carries[ci], scanned = self._fold_window(
                    carries[ci], enc.type_ids[start:stop],
                    {k: v[start:stop] for k, v in enc.cols.items()}, bs,
                    derived_cols=enc.derived_cols, t_base=t_cursor,
                    ordinal_base=None if ordinal_base is None
                    else ordinal_base[start:stop])
                padded += bs * scanned
            total_events += int(enc.lengths.sum())
            t_cursor += enc.max_len
        if carries[0] is None:
            raise ValueError("empty chunk stream")
        out = {f.name: np.zeros((batch,), dtype=f.dtype)
               for f in self.spec.registry.state.fields}
        for ci in range(n_bchunks):
            start, stop = ci * bs, min((ci + 1) * bs, batch)
            for name in out:
                out[name][start:stop] = carries[ci][name].cpu().numpy()[: stop - start]
        return ReplayResult(states=out, num_aggregates=batch,
                            num_events=total_events, padded_events=padded)
