"""The fold kernels K1 and K2: their wrappers and their plain torch versions.

``tile_fold_list(slab, words, sides, lens, ord, i0s, t_bases, *, width, bs,
...)`` folds a whole work list of the resident replay into the state slab in
place, in one launch (K1's list fold): tile ``k`` folds events
``[t_bases[k], t_bases[k] + width)`` of lanes ``[i0s[k], i0s[k] + bs)``, in
list order, from the dense tile buffers (``words u8 [k, width, bs, nbytes]``)
or from the flat corpus (``words u8 [rows, nbytes]`` and ``starts``). Its
tile-interior fold is :func:`tile_scan_reference`, what the Pallas kernel
``surge_tpu/replay/pallas_fold.py:make_tile_scan`` computes.

The resident state plane runs each refresh window as ONE call, against the
slab ``{field: [capacity + 1]}`` and its ordinals ``ords int32 [capacity +
1]`` by slot, in place: what the reference's window program computes
(``surge_tpu/replay/resident_state.py``: ``refresh``, ``_ragged_program``).
A window's lanes travel as one int32 lane table (:func:`window_table`): each
lane's slot (the scratch row ``capacity`` pads), its event count, its first
flat row and, on a plan's first window, its admission aligned to lanes.

- ``dense_window(slab, ords, table, words, sides, *, spec, wire)`` (K1's
  dense window): ``words u8 [width, lanes, nbytes]``, ``sides {name: [width,
  lanes]}``, time-major, as ``WireFormat.pack_window`` packs them.
- ``ragged_window(slab, ords, table, words, sides, *, width, spec, wire)``
  (K2): one bucket's events flat and lane-contiguous, ``words u8 [rows,
  nbytes]``, ``sides {name: [rows]}``; lane ``b`` at step ``t < width`` reads
  row ``clamp(start[b] + t, 0, rows - 1)``, valid while ``t < count[b]``,
  what ``surge_tpu/replay/pallas_fold.py:make_ragged_fold`` computes.

A combined spec (``surge_tpu_torch.replay.mixed``, its ``kernel_step`` a
``MixedKernelStep``) folds through the kernels' mixed step, C step id
``MIXED_STEP_ID``: one decode slot per name of ``MIXED_COLS`` and one state
slot per name of ``MIXED_STATE`` (the four families' union, sorted; absent
where the spec lacks a name), and each part's type-id range, so one launch
folds lanes of several families. The plain versions fold any spec.

On CPU tensors each wrapper runs its plain version
(:func:`tile_fold_list_reference`, :func:`dense_window_reference`,
:func:`ragged_window_reference`); on CUDA tensors it launches the
hand-written kernel (``surge_tpu_torch/csrc/tile_scan.cu``,
``csrc/ragged_fold.cu``) or raises. ``LAUNCHES[name]`` counts kernel
launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping

import numpy as np
import torch

from surge_tpu_torch.codec.schema import SchemaRegistry
from surge_tpu_torch.codec.wire import DERIVE_ORDINAL, WireFormat, torch_dtype
from surge_tpu_torch.engine.model import MixedKernelStep, ReplaySpec

#: the model steps the kernel carries, in the order of the C step ids:
#: name -> (state fields, union columns), each in the schema's order
KERNEL_STEPS: dict[str, tuple[tuple[str, ...], tuple[str, ...]]] = {
    "counter": (("count", "version"),
                ("decrement_by", "increment_by", "sequence_number")),
    "bank_account": (("created", "owner_code", "security_code_code", "balance"),
                     ("balance", "new_balance", "owner_code",
                      "security_code_code")),
    "shopping_cart": (("item_count", "total_cents", "checked_out", "version"),
                      ("item_code", "quantity", "sequence_number",
                       "unit_price_cents")),
    "saga": (("def_id", "num_steps", "status", "step", "committed",
              "compensated", "attempts", "c0", "c1", "c2", "c3", "version"),
             ("attempts", "c0", "c1", "c2", "c3", "def_id", "num_steps",
              "sequence_number", "step")),
}

#: the C step id of a combined spec's step (``MixedStep`` in
#: csrc/fold_common.cuh), after the single-family steps
MIXED_STEP_ID = len(KERNEL_STEPS)
#: MixedStep's column and state slots: every kernel step's union columns and
#: state fields, sorted by name (a combined spec's union is a subset of these,
#: in the same order)
MIXED_COLS = tuple(sorted({c for _, cols in KERNEL_STEPS.values() for c in cols}))
MIXED_STATE = tuple(sorted({f for fields, _ in KERNEL_STEPS.values() for f in fields}))

#: kernel launches per wrapper (reset by the caller; never by this module)
LAUNCHES: dict[str, int] = {"tile_fold_list": 0, "dense_window": 0,
                            "ragged_window": 0}

#: the rows of a window's lane table (``LaneRow`` in csrc/fold_common.cuh):
#: slot, count, first flat row, then, on a plan's first window, the admit
#: flag, the admitted ordinal and one row per state field of admitted values
LANE_SLOT, LANE_COUNT, LANE_START, LANE_ADMIT, LANE_ADMIT_ORD, LANE_ADMIT_VAL = range(6)

#: a window kernel block's path, as the launch reports it for each lane
#: (``WindowPath`` in csrc/fold_common.cuh): nothing to read (every lane
#: pads or folds no step), loads from device memory, staged through shared
#: memory
PATH_NONE, PATH_GLOBAL, PATH_STAGED = -1, 0, 1

#: lanes per block of the list fold (``kThreads`` in csrc/fold_common.cuh):
#: the granularity of its schedule
LIST_LANE_BLOCK = 256

#: t_base sentinel of the reference's dense work-list padding: past every real
#: lane length yet far from int32 overflow. The replay folds real tiles only,
#: but keeps the reference's clamp of t_base before the ordinal add
#: (``kNoopTileT`` in csrc/tile_scan.cu)
_NOOP_TILE_T = np.int32(1 << 29)

#: kMaxCols, kMaxState and kParts in csrc/fold_common.cuh
_MAX_COLS = 18
_MAX_STATE = 20
_PARTS = 4
#: kWireBytes<MixedStep> in csrc/fold_common.cuh: the wire bytes the mixed
#: step is built for
_MIXED_WIRE_BYTES = 2
#: ColKind and StateKind in csrc/fold_common.cuh (the absent kinds: a
#: MixedStep slot that the combined spec lacks)
_PACKED, _SIDE, _ORDINAL, _ABSENT_COL = 0, 1, 2, 3
_WORD, _BYTE, _ABSENT_FIELD = 0, 1, 2
_SIDE_DTYPES = (np.dtype(np.int32), np.dtype(np.float32))
_STATE_KINDS = {np.dtype(np.int32): _WORD, np.dtype(np.float32): _WORD,
                np.dtype(np.bool_): _BYTE}


class _DecodeArgs(ctypes.Structure):
    # mirrors struct DecodeArgs in csrc/fold_common.cuh
    _fields_ = [("type_bits", ctypes.c_int32), ("num_types", ctypes.c_int32),
                ("n_cols", ctypes.c_int32),
                ("kind", ctypes.c_int32 * _MAX_COLS),
                ("shift", ctypes.c_int32 * _MAX_COLS),
                ("mask", ctypes.c_uint32 * _MAX_COLS),
                ("side", ctypes.c_void_p * _MAX_COLS),
                ("part_base", ctypes.c_int32 * _PARTS),
                ("part_types", ctypes.c_int32 * _PARTS)]


class _StateArgs(ctypes.Structure):
    # mirrors struct StateArgs in csrc/fold_common.cuh
    _fields_ = [("n_state", ctypes.c_int32),
                ("kind", ctypes.c_int32 * _MAX_STATE),
                ("in_", ctypes.c_void_p * _MAX_STATE),
                ("out", ctypes.c_void_p * _MAX_STATE)]


class _SlabArgs(ctypes.Structure):
    # mirrors struct SlabArgs in csrc/fold_common.cuh
    _fields_ = [("n_state", ctypes.c_int32),
                ("kind", ctypes.c_int32 * _MAX_STATE),
                ("admit_row", ctypes.c_int32 * _MAX_STATE),
                ("col", ctypes.c_void_p * _MAX_STATE),
                ("ords", ctypes.c_void_p), ("table", ctypes.c_void_p),
                ("capacity", ctypes.c_int32), ("lanes", ctypes.c_int32),
                ("admit", ctypes.c_int32)]


#: the mirrored structs, by the index the C struct_size functions take
_STRUCTS = (_DecodeArgs, _StateArgs, _SlabArgs)


class _ListArgs(ctypes.Structure):
    # mirrors struct ListArgs in csrc/tile_scan.cu
    _fields_ = [(name, ctypes.c_int32) for name in (
        "width", "bs", "b_pad", "k_n", "n_blk", "nbytes", "dense", "aligned")
    ] + [("rows", ctypes.c_int64)] + [(name, ctypes.c_void_p) for name in (
        "i0s", "t_bases", "blk_ids", "blk_off", "blk_tiles", "lens", "ord",
        "starts", "words")]


def tile_scan_reference(carry: Mapping[str, torch.Tensor], words: torch.Tensor,
                        sides: Mapping[str, torch.Tensor], lens_rel: torch.Tensor,
                        ord_rel: torch.Tensor, *, spec: ReplaySpec,
                        wire: WireFormat) -> dict[str, torch.Tensor]:
    """The plain torch version of K1: the select step over ``width`` decoded
    rows, with relative time."""
    from surge_tpu_torch.replay.engine import make_step_fn

    step = make_step_fn(spec, "select")
    state = dict(carry)
    for t in range(words.shape[0]):
        events = wire.decode_words(words[t], {n: s[t] for n, s in sides.items()},
                                   t < lens_rel, ord_rel, t)
        state = step(state, events)
    return state


def _slab_index(starts: torch.Tensor, t_base: int, width: int, rows: int
                ) -> torch.Tensor:
    """Time-major row indices ``[width, bs]`` of each lane's slab
    ``[starts + t_base, starts + t_base + width)``. A start past ``rows - width``
    is clamped, exactly as ``jax.lax.dynamic_slice`` clamps it: only finished
    or padding lanes reach that far, and their slots decode under a False
    mask. Live lanes never clamp: their slab ends within the guard rows."""
    s0 = (starts.to(torch.int64) + t_base).clamp_(0, rows - width)
    return s0[None, :] + torch.arange(width, device=starts.device)[:, None]


def _lane_range(i0: int, bs: int, b_pad: int) -> slice:
    # a torch slice past b_pad would silently truncate where JAX clamped
    if i0 < 0 or i0 + bs > b_pad:
        raise ValueError(f"tile lanes [{i0}, {i0 + bs}) outside the slab [0, {b_pad})")
    return slice(i0, i0 + bs)


def list_schedule(i0s: np.ndarray, bs: int, b_pad: int
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The list fold's per-lane-block schedule, a CSR over the lane blocks
    (``LIST_LANE_BLOCK`` slab lanes each) that some tile covers:
    ``(blk_ids [n], blk_off [n + 1], blk_tiles [blk_off[n]])``, all int32.
    Block ``blk_ids[i]`` folds tiles ``blk_tiles[blk_off[i]:blk_off[i + 1]]``,
    ascending in list order (so each lane's tiles run in the list's order)."""
    i0s = np.asarray(i0s, dtype=np.int64)
    if len(i0s) and (i0s.min() < 0 or i0s.max() + bs > b_pad):
        raise ValueError(f"a tile of {bs} lanes lies outside the slab [0, {b_pad})")
    lb = LIST_LANE_BLOCK
    first = i0s // lb
    counts = (i0s + bs - 1) // lb - first + 1
    tiles = np.repeat(np.arange(len(i0s), dtype=np.int64), counts)
    ends = np.cumsum(counts)
    blks = np.repeat(first - (ends - counts), counts) + np.arange(len(tiles))
    order = np.argsort(blks, kind="stable")  # stable: list order per block
    blks, tiles = blks[order], tiles[order]
    ids, per_blk = np.unique(blks, return_counts=True)
    off = np.zeros(len(ids) + 1, dtype=np.int64)
    np.cumsum(per_blk, out=off[1:])
    return ids.astype(np.int32), off.astype(np.int32), tiles.astype(np.int32)


def tile_fold_list_reference(slab: Mapping[str, torch.Tensor],
                             words: torch.Tensor,
                             sides: Mapping[str, torch.Tensor],
                             lens: torch.Tensor, ord: torch.Tensor,
                             i0s: torch.Tensor, t_bases: torch.Tensor, *,
                             width: int, bs: int, spec: ReplaySpec,
                             wire: WireFormat, starts: torch.Tensor | None = None,
                             k_n: int | None = None, fold=None) -> None:
    """The plain torch version of the list fold: tiles ``[0, k_n)`` of the
    list one after another, each gathering its lanes' carry, folding it and
    writing it back into ``slab`` in place. Dense source: ``words u8 [k,
    width, bs, nbytes]``, ``sides {n: [k, width, bs]}``; flat source
    (``starts`` given): ``words u8 [rows, nbytes]``, ``sides {n: [rows]}``
    gathered through :func:`_slab_index`.

    ``fold(carry, words [width, bs], sides, lens, ord, t_base) -> carry`` is
    the tile-interior fold, over the tile's lanes. By default it is
    :func:`tile_scan_reference` with ``lens_rel = lens - t_base`` and the
    ordinal base ``ord + min(t_base, _NOOP_TILE_T - 1)``, what the kernel
    computes; the engine's plain backend passes its own time scan."""
    nbytes = wire.nbytes
    k_n = len(i0s) if k_n is None else k_n
    if fold is None:
        def fold(carry, tile_words, tile_sides, tile_lens, tile_ord, tb):
            return tile_scan_reference(
                carry, tile_words, tile_sides, tile_lens - tb,
                tile_ord + min(tb, int(_NOOP_TILE_T) - 1), spec=spec, wire=wire)
    for k, (i0, tb) in enumerate(zip(i0s[:k_n].tolist(), t_bases[:k_n].tolist())):
        lanes = _lane_range(i0, bs, lens.shape[0])
        if starts is None:
            tile_words = words[k].reshape(width * bs, nbytes)
            tile_sides = {n: s[k] for n, s in sides.items()}
        else:
            idx = _slab_index(starts[lanes], tb, width, words.shape[0])
            tile_words = words[idx.reshape(-1)].reshape(width * bs, nbytes)
            tile_sides = {n: s[idx] for n, s in sides.items()}
        carry = {f: v[lanes] for f, v in slab.items()}
        out = fold(carry, wire.expand_flat(tile_words).reshape(width, bs),
                   tile_sides, lens[lanes], ord[lanes], tb)
        for f, v in slab.items():
            v[lanes] = out[f]


def tile_fold_list(slab: Mapping[str, torch.Tensor], words: torch.Tensor,
                   sides: Mapping[str, torch.Tensor], lens: torch.Tensor,
                   ord: torch.Tensor, i0s: torch.Tensor, t_bases: torch.Tensor,
                   *, schedule: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                   width: int, bs: int, spec: ReplaySpec, wire: WireFormat,
                   starts: torch.Tensor | None = None, k_n: int | None = None
                   ) -> None:
    """Fold tiles ``[0, k_n)`` of one work list into ``slab`` in place: the
    plain version for CPU tensors, one kernel launch for CUDA tensors (see the
    module docstring). ``i0s``/``t_bases`` are int32 ``[k]`` on the slab's
    device; ``schedule`` is :func:`list_schedule` on that device (the kernel's
    blocks; the plain version walks the list itself)."""
    if words.device.type == "cpu":
        tile_fold_list_reference(slab, words, sides, lens, ord, i0s, t_bases,
                                 width=width, bs=bs, spec=spec, wire=wire,
                                 starts=starts, k_n=k_n)
        return
    if words.device.type != "cuda":
        raise ValueError(f"tile_fold_list runs on cpu or cuda tensors, got "
                         f"{words.device}")
    step_id, layout = _decode_args(spec.kernel_step, spec.registry, wire)
    b_pad, k_all = _check_list(slab, words, sides, lens, ord, i0s, t_bases,
                               starts, width, bs, spec, wire)
    k_n = k_all if k_n is None else int(k_n)
    if not 0 <= k_n <= k_all:
        raise ValueError(f"k_n {k_n} outside the list's {k_all} tiles")
    blk_ids, blk_off, blk_tiles = schedule
    for name, t in zip(("blk_ids", "blk_off", "blk_tiles"), schedule):
        _need(t, name, tuple(t.shape), torch.int32, words.device)
    if blk_off.shape != (blk_ids.shape[0] + 1,):
        raise ValueError("schedule: blk_off must hold one more entry than blk_ids")
    if k_n == 0 or blk_ids.shape[0] == 0:
        return
    dec, sa = _decode_with_sides(layout, sides, spec), _state_args(slab, slab, spec)
    la = _ListArgs(width=width, bs=bs, b_pad=b_pad, k_n=k_n,
                   n_blk=blk_ids.shape[0], nbytes=wire.nbytes,
                   dense=int(starts is None),
                   aligned=int(all(t.data_ptr() % 16 == 0 for t in
                                   (words, *sides.values()))),
                   rows=words.shape[0], i0s=i0s.data_ptr(),
                   t_bases=t_bases.data_ptr(), blk_ids=blk_ids.data_ptr(),
                   blk_off=blk_off.data_ptr(), blk_tiles=blk_tiles.data_ptr(),
                   lens=lens.data_ptr(), ord=ord.data_ptr(),
                   starts=0 if starts is None else starts.data_ptr(),
                   words=words.data_ptr())
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _library("tile_scan").surge_tile_fold_list(
        step_id, ctypes.byref(la), ctypes.byref(dec), ctypes.byref(sa), stream)
    if err != 0:
        raise RuntimeError(f"tile_fold_list kernel launch failed: cudaError_t {err}")
    LAUNCHES["tile_fold_list"] += 1


def ragged_fold_reference(carry: Mapping[str, torch.Tensor], words: torch.Tensor,
                          sides: Mapping[str, torch.Tensor], starts: torch.Tensor,
                          lens: torch.Tensor, ord: torch.Tensor, *, width: int,
                          spec: ReplaySpec, wire: WireFormat
                          ) -> dict[str, torch.Tensor]:
    """The plain torch version of K2: the select step over ``width`` steps,
    each gathering row ``min(starts + t, rows - 1)`` of the flat buffer."""
    from surge_tpu_torch.replay.engine import make_step_fn

    step = make_step_fn(spec, "select")
    rows = words.shape[0]
    state = dict(carry)
    for t in range(width):
        idx = (starts.to(torch.int64) + t).clamp_(0, rows - 1)
        events = wire.decode_words(words[idx], {n: s[idx] for n, s in sides.items()},
                                   t < lens, ord, t)
        state = step(state, events)
    return state


def window_table(slots: np.ndarray, counts: np.ndarray,
                 starts: np.ndarray | None = None, admission=None,
                 fields: tuple[str, ...] = ()) -> np.ndarray:
    """One refresh window's lane table, int32 ``[rows, lanes]`` (one upload):
    ``slots`` (the scratch row ``capacity`` pads), ``counts`` (events the
    window folds), ``starts`` (first flat row, ragged windows; zeros else)
    and, on a plan's first window, ``admission = (flag, ord, values)``: the
    lanes that start from an admitted row, their ordinals and
    ``values {field: [lanes]}``, stored in the order of ``fields`` as each
    value's 32-bit pattern (a bool as 0 or 1)."""
    lanes = len(slots)
    n_rows = LANE_ADMIT if admission is None else LANE_ADMIT_VAL + len(fields)
    table = np.zeros((n_rows, lanes), dtype=np.int32)
    table[LANE_SLOT] = slots
    table[LANE_COUNT] = counts
    if starts is not None:
        table[LANE_START] = starts
    if admission is not None:
        flag, ordv, values = admission
        table[LANE_ADMIT] = flag
        table[LANE_ADMIT_ORD] = ordv
        for i, name in enumerate(fields):
            v = np.asarray(values[name])
            if v.dtype == np.float32:
                v = v.view(np.int32)
            elif v.dtype.itemsize > 4 or v.dtype.kind == "f":
                raise ValueError(f"admitted field {name!r}: a lane table holds "
                                 f"32-bit values, not {v.dtype}")
            table[LANE_ADMIT_VAL + i] = v
    return table


def _from_row(row: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A lane-table row of 32-bit patterns as a column of ``dtype``."""
    if dtype == torch.float32:
        return row.view(torch.float32)
    if dtype == torch.bool:
        return row != 0
    return row.to(dtype)


def _plain_window(slab: Mapping[str, torch.Tensor], ords: torch.Tensor,
                  table: torch.Tensor, fold, spec: ReplaySpec) -> None:
    """The reference's window program in eager torch, in place: admission
    ``index_copy_`` (aligned to lanes: a lane that is not admitted writes the
    scratch row), the lanes' carry and ordinal ``index_select``, ``fold(carry,
    ord_lane) -> carry``, ``index_copy_`` back and the ordinals'
    ``index_add_`` (padding lanes all write the scratch row)."""
    capacity = ords.shape[0] - 1
    lanes = table[LANE_SLOT].to(torch.int64)
    if table.shape[0] > LANE_ADMIT:
        idx = torch.where(table[LANE_ADMIT] != 0, lanes, capacity)
        for i, f in enumerate(spec.registry.state.fields):
            v = slab[f.name]
            v.index_copy_(0, idx, _from_row(table[LANE_ADMIT_VAL + i], v.dtype))
        ords.index_copy_(0, idx, table[LANE_ADMIT_ORD])
    carry = {k: v.index_select(0, lanes) for k, v in slab.items()}
    out = fold(carry, ords.index_select(0, lanes))
    for k, v in slab.items():
        v.index_copy_(0, lanes, out[k])
    ords.index_add_(0, lanes, table[LANE_COUNT])


def dense_window_reference(slab: Mapping[str, torch.Tensor], ords: torch.Tensor,
                           table: torch.Tensor, words: torch.Tensor,
                           sides: Mapping[str, torch.Tensor], *,
                           spec: ReplaySpec, wire: WireFormat,
                           fold=None) -> None:
    """The plain version of K1's dense window: :func:`_plain_window` around
    the tile fold. ``fold(carry, words, sides, ord_lane) -> carry`` is the
    tile fold; by default it is :func:`tile_scan_reference` of the expanded
    words with ``lens_rel = counts`` (a slot past the count packs to the pad
    code, so it folds what the reference's decode and scan fold), what the
    kernel computes; the plane's plain backend passes its own decode and
    scan."""
    width, lanes = words.shape[0], words.shape[1]
    counts = table[LANE_COUNT]

    def tile(carry, ord_lane):
        if fold is not None:
            return fold(carry, words, sides, ord_lane)
        flat = wire.expand_flat(words.reshape(width * lanes, wire.nbytes))
        return tile_scan_reference(carry, flat.reshape(width, lanes), sides,
                                   counts, ord_lane, spec=spec, wire=wire)

    _plain_window(slab, ords, table, tile, spec)


def ragged_window_reference(slab: Mapping[str, torch.Tensor], ords: torch.Tensor,
                            table: torch.Tensor, words: torch.Tensor,
                            sides: Mapping[str, torch.Tensor], *, width: int,
                            spec: ReplaySpec, wire: WireFormat) -> None:
    """The plain version of K2's ragged window: :func:`_plain_window` around
    :func:`ragged_fold_reference` of the expanded flat words."""
    flat = wire.expand_flat(words)

    def fold(carry, ord_lane):
        return ragged_fold_reference(carry, flat, sides, table[LANE_START],
                                     table[LANE_COUNT], ord_lane, width=width,
                                     spec=spec, wire=wire)

    _plain_window(slab, ords, table, fold, spec)


def dense_window(slab: Mapping[str, torch.Tensor], ords: torch.Tensor,
                 table: torch.Tensor, words: torch.Tensor,
                 sides: Mapping[str, torch.Tensor], *, spec: ReplaySpec,
                 wire: WireFormat, paths: torch.Tensor | None = None) -> None:
    """Run one dense refresh window in place: the plain version for CPU
    tensors, one K1 window launch for CUDA tensors (see the module
    docstring). ``paths`` (the kernel only; int8 ``[lanes]``) receives each
    lane's block's path: ``PATH_STAGED``, ``PATH_GLOBAL`` or ``PATH_NONE``."""
    if words.device.type == "cpu":
        _no_paths(paths, "dense_window")
        dense_window_reference(slab, ords, table, words, sides, spec=spec,
                               wire=wire)
        return
    if words.device.type != "cuda":
        raise ValueError(f"dense_window runs on cpu or cuda tensors, got "
                         f"{words.device}")
    step_id, layout = _decode_args(spec.kernel_step, spec.registry, wire)
    lanes = _check_window(slab, ords, table, spec, words.device)
    if words.dim() != 3:
        raise ValueError(f"words must be uint8 [width, lanes, nbytes], got "
                         f"{tuple(words.shape)}")
    width = words.shape[0]
    _need(words, "words", (width, lanes, wire.nbytes), torch.uint8, words.device)
    _check_sides(sides, (width, lanes), wire, words.device)
    dec = _decode_with_sides(layout, sides, spec)
    sa = _slab_args(slab, ords, table, spec)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _library("tile_scan").surge_dense_window(
        step_id, ctypes.byref(sa), ctypes.byref(dec), words.data_ptr(),
        wire.nbytes, width, _paths_ptr(paths, lanes, words.device), stream)
    if err != 0:
        raise RuntimeError(f"dense_window kernel launch failed: cudaError_t {err}")
    LAUNCHES["dense_window"] += 1


def ragged_window(slab: Mapping[str, torch.Tensor], ords: torch.Tensor,
                  table: torch.Tensor, words: torch.Tensor,
                  sides: Mapping[str, torch.Tensor], *, width: int,
                  spec: ReplaySpec, wire: WireFormat,
                  paths: torch.Tensor | None = None) -> None:
    """Run one ragged refresh window in place: the plain version for CPU
    tensors, one K2 launch for CUDA tensors (see the module docstring).
    ``paths`` as for :func:`dense_window`."""
    if words.device.type == "cpu":
        _no_paths(paths, "ragged_window")
        ragged_window_reference(slab, ords, table, words, sides, width=width,
                                spec=spec, wire=wire)
        return
    if words.device.type != "cuda":
        raise ValueError(f"ragged_window runs on cpu or cuda tensors, got "
                         f"{words.device}")
    step_id, layout = _decode_args(spec.kernel_step, spec.registry, wire)
    lanes = _check_window(slab, ords, table, spec, words.device)
    if int(width) < 0:
        raise ValueError(f"width must be >= 0, got {width}")
    if words.dim() != 2 or words.shape[0] < 1:
        raise ValueError(f"words must be uint8 [rows >= 1, nbytes], got "
                         f"{tuple(words.shape)}")
    rows = words.shape[0]
    _need(words, "words", (rows, wire.nbytes), torch.uint8, words.device)
    _check_sides(sides, (rows,), wire, words.device)
    if any(t.data_ptr() % 16 for t in (words, *sides.values())):
        raise ValueError("ragged_window: words and side columns must start on "
                         "16 bytes")
    dec = _decode_with_sides(layout, sides, spec)
    sa = _slab_args(slab, ords, table, spec)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _library("ragged_fold").surge_ragged_window(
        step_id, ctypes.byref(sa), ctypes.byref(dec), words.data_ptr(),
        wire.nbytes, int(width), rows, _paths_ptr(paths, lanes, words.device),
        stream)
    if err != 0:
        raise RuntimeError(f"ragged_window kernel launch failed: cudaError_t {err}")
    LAUNCHES["ragged_window"] += 1


def _no_paths(paths: torch.Tensor | None, what: str) -> None:
    if paths is not None:
        raise ValueError(f"{what}: paths reports the kernel's blocks; the "
                         f"plain version that CPU tensors run has none")


def _paths_ptr(paths: torch.Tensor | None, lanes: int, dev: torch.device) -> int:
    """The kernel's per-lane path buffer (int8 ``[lanes]``), or null."""
    if paths is None:
        return 0
    _need(paths, "paths", (lanes,), torch.int8, dev)
    return paths.data_ptr()


def _slab_args(slab: Mapping[str, torch.Tensor], ords: torch.Tensor,
               table: torch.Tensor, spec: ReplaySpec) -> "_SlabArgs":
    """The slab, its ordinals and the lane table, for a window kernel."""
    fields = _kernel_fields(spec)
    rows = {f.name: LANE_ADMIT_VAL + i
            for i, f in enumerate(spec.registry.state.fields)}
    sa = _SlabArgs()
    sa.n_state = len(fields)
    for i, f in enumerate(fields):
        if f is None:
            sa.kind[i] = _ABSENT_FIELD
            continue
        sa.kind[i] = _STATE_KINDS[np.dtype(f.dtype)]
        sa.admit_row[i] = rows[f.name]
        sa.col[i] = slab[f.name].data_ptr()
    sa.ords = ords.data_ptr()
    sa.table = table.data_ptr()
    sa.capacity = ords.shape[0] - 1
    sa.lanes = table.shape[1]
    sa.admit = int(table.shape[0] > LANE_ADMIT)
    return sa


def _decode_with_sides(layout: "_DecodeArgs", sides: Mapping[str, torch.Tensor],
                       spec: ReplaySpec) -> "_DecodeArgs":
    """A per-call copy of the cached decode layout with the side pointers set."""
    dec = _DecodeArgs.from_buffer_copy(layout)
    for c, name in enumerate(_kernel_cols(spec.kernel_step)):
        if dec.kind[c] == _SIDE:
            dec.side[c] = sides[name].data_ptr()
    return dec


def _state_args(carry: Mapping[str, torch.Tensor], out: Mapping[str, torch.Tensor],
                spec: ReplaySpec) -> "_StateArgs":
    """The state pointers: read from ``carry``, written to ``out`` (the same
    tensors for a fold in place)."""
    fields = _kernel_fields(spec)
    sa = _StateArgs()
    sa.n_state = len(fields)
    for i, f in enumerate(fields):
        if f is None:
            sa.kind[i] = _ABSENT_FIELD
            continue
        sa.kind[i] = _STATE_KINDS[np.dtype(f.dtype)]
        sa.in_[i] = carry[f.name].data_ptr()
        sa.out[i] = out[f.name].data_ptr()
    return sa


def _kernel_cols(step) -> tuple[str, ...]:
    """The union column of each decode slot of the kernel's step."""
    return MIXED_COLS if isinstance(step, MixedKernelStep) else KERNEL_STEPS[step][1]


def _kernel_fields(spec: ReplaySpec) -> tuple:
    """The state field (a ``FieldSpec``) of each state slot of the kernel's
    step; None for a MixedStep slot that the combined spec lacks."""
    fields = spec.registry.state.fields
    if not isinstance(spec.kernel_step, MixedKernelStep):
        return fields
    by_name = {f.name: f for f in fields}
    return tuple(by_name.get(n) for n in MIXED_STATE)


@functools.lru_cache(maxsize=64)
def _decode_args(name: "str | MixedKernelStep | None", reg: SchemaRegistry,
                 wire: WireFormat) -> tuple[int, _DecodeArgs]:
    """The kernel's step id and decode arguments (side pointers unset) for
    ``wire``. Raises unless ``name`` is a kernel step whose schema ``reg``
    matches (for a combined spec, :func:`mixed_parts`) and the arguments
    describe the wire's exact layout (its ``layout_fingerprint()``). Cached
    per (step, registry, wire): the check costs more host time than a launch,
    and registries are complete once built."""
    if isinstance(name, MixedKernelStep):
        return _mixed_decode_args(name, reg, wire)
    if name not in KERNEL_STEPS:
        raise ValueError(
            f"the tile-scan kernel has no step for kernel_step={name!r} "
            f"(known: {sorted(KERNEL_STEPS)}); use surge.replay.tile-backend = xla")
    state_names, col_names = KERNEL_STEPS[name]
    if reg.state.field_names != state_names:
        raise ValueError(f"kernel step {name!r} folds state {state_names}, "
                         f"the spec has {reg.state.field_names}")
    for f in reg.state.fields:
        if np.dtype(f.dtype) not in _STATE_KINDS:
            raise ValueError(f"state field {f.name!r}: the kernel carries "
                             f"i32/f32/bool, not {f.dtype}")
    union = {f.name: f for f in reg.union_columns()}
    if tuple(union) != col_names:
        raise ValueError(f"kernel step {name!r} decodes columns {col_names}, "
                         f"the spec has {tuple(union)}")
    return list(KERNEL_STEPS).index(name), _wire_layout(col_names, union, wire)


@functools.lru_cache(maxsize=64)
def mixed_parts(step: MixedKernelStep, reg: SchemaRegistry) -> dict:
    """The parts of a combined spec by their kernel step, checked by name:
    every part has a step the kernel carries (once), its type ids lie in the
    registry in ascending, disjoint ranges, its events' columns are its
    step's, the union's state fields are its steps' and every one is a field
    the kernel carries (a promoted dtype, such as int32 with float32, is
    not). Raises a ValueError naming the part or the field; cached per
    (step, registry)."""
    by_step, end, fields = {}, 0, set()
    for part in step.parts:
        if part.step is None:
            raise ValueError(
                f"the tile-scan kernel needs a kernel_step for every part of a "
                f"combined spec, and part {part.model!r} has none; use "
                f"surge.replay.tile-backend = xla")
        if part.step not in KERNEL_STEPS:
            raise ValueError(f"part {part.model!r}: the tile-scan kernel has no "
                             f"step {part.step!r} (known: {sorted(KERNEL_STEPS)})")
        if part.step in by_step:
            raise ValueError(f"parts {by_step[part.step].model!r} and "
                             f"{part.model!r} both fold with step {part.step!r}")
        if part.base < end or part.num_types < 0:
            raise ValueError(f"part {part.model!r}: type ids from {part.base} "
                             f"overlap the previous part's (to {end})")
        end = part.base + part.num_types
        state_names, col_names = KERNEL_STEPS[part.step]
        cols = sorted({f.name for s in reg.event_schemas
                       if part.base <= s.type_id < end for f in s.fields})
        if tuple(cols) != col_names:
            raise ValueError(f"part {part.model!r}: the {part.step!r} step "
                             f"decodes columns {col_names}, its events have "
                             f"{tuple(cols)}")
        fields.update(state_names)
        by_step[part.step] = part
    if end > reg.num_event_types:
        raise ValueError(f"the parts' type ids run to {end}, the registry has "
                         f"{reg.num_event_types}")
    if set(reg.state.field_names) != fields:
        raise ValueError(f"the parts' steps fold state {sorted(fields)}, the "
                         f"combined spec has {sorted(reg.state.field_names)}")
    for f in reg.state.fields:
        if np.dtype(f.dtype) not in _STATE_KINDS:
            raise ValueError(f"state field {f.name!r}: the kernel carries "
                             f"i32/f32/bool, not {f.dtype}")
    return by_step


def _mixed_decode_args(step: MixedKernelStep, reg: SchemaRegistry,
                       wire: WireFormat) -> tuple[int, _DecodeArgs]:
    """MixedStep's decode arguments: one slot per name of ``MIXED_COLS``
    (absent where the union lacks it) and each part's type-id range."""
    by_step = mixed_parts(step, reg)
    if wire.nbytes > _MIXED_WIRE_BYTES:
        raise ValueError(f"the mixed step reads wires of at most "
                         f"{_MIXED_WIRE_BYTES} bytes an event, this one has "
                         f"{wire.nbytes}")
    union = {f.name: f for f in reg.union_columns()}
    dec = _wire_layout(MIXED_COLS, union, wire)
    for p, name in enumerate(KERNEL_STEPS):
        if name in by_step:
            dec.part_base[p] = by_step[name].base
            dec.part_types[p] = by_step[name].num_types
    return MIXED_STEP_ID, dec


def _wire_layout(col_names, union, wire: WireFormat) -> _DecodeArgs:
    """The decode arguments of decode slots ``col_names`` (a name the union
    ``{name: FieldSpec}`` lacks is an absent slot): each column packed,
    side or the derived ordinal, as ``wire`` lays it out; raises unless they
    describe the wire's exact layout (its ``layout_fingerprint()``)."""
    packed = {pf.name: pf for pf in wire.packed_fields}
    sides = {f.name for f in wire.side_fields}
    dec = _DecodeArgs()
    dec.type_bits = wire.type_bits
    dec.num_types = wire.num_types
    dec.n_cols = len(col_names)
    for c, col in enumerate(col_names):
        if col not in union:
            dec.kind[c] = _ABSENT_COL
            continue
        dt = np.dtype(union[col].dtype)
        if col in packed:
            if dt != np.dtype(np.int32):
                raise ValueError(f"packed column {col!r}: the kernel decodes "
                                 f"int32, not {dt}")
            dec.kind[c] = _PACKED
            dec.shift[c] = packed[col].shift
            dec.mask[c] = packed[col].mask
        elif col in sides:
            if dt not in _SIDE_DTYPES:
                raise ValueError(f"side column {col!r}: the kernel reads "
                                 f"i32/f32, not {dt}")
            dec.kind[c] = _SIDE
        else:
            if wire.derived.get(col) != DERIVE_ORDINAL or dt != np.dtype(np.int32):
                raise ValueError(f"column {col!r} is neither packed, side nor "
                                 f"an int32 ordinal")
            dec.kind[c] = _ORDINAL
    if _describe(dec, col_names, union) != wire.layout_fingerprint():
        raise ValueError(
            f"kernel decode arguments describe {_describe(dec, col_names, union)}, "
            f"the wire is {wire.layout_fingerprint()}")
    return dec


def _describe(dec: _DecodeArgs, col_names, union) -> dict:
    """The layout fingerprint (``WireFormat.layout_fingerprint``) that the
    decode arguments ``dec`` read."""
    packed = sorted(
        ([col, str(np.dtype(union[col].dtype)), int(dec.mask[c]).bit_length(),
          dec.shift[c]] for c, col in enumerate(col_names)
         if dec.kind[c] == _PACKED), key=lambda p: p[3])
    total = max([dec.type_bits] + [p[2] + p[3] for p in packed])
    return {
        "num_types": dec.num_types,
        "type_bits": dec.type_bits,
        "nbytes": (total + 7) // 8,
        "packed": packed,
        "side": [[col, str(np.dtype(union[col].dtype))]
                 for c, col in enumerate(col_names) if dec.kind[c] == _SIDE],
        "derived": sorted([col, DERIVE_ORDINAL] for c, col in enumerate(col_names)
                          if dec.kind[c] == _ORDINAL),
    }


def _need(t: torch.Tensor, what: str, shape: tuple, dtype: torch.dtype,
          dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{what} is on {t.device}, words on {dev}")
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype} {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_sides(sides, side_shape: tuple, wire, dev) -> None:
    if set(sides) != {f.name for f in wire.side_fields}:
        raise ValueError(f"sides {sorted(sides)} != the wire's side columns "
                         f"{sorted(f.name for f in wire.side_fields)}")
    for f in wire.side_fields:
        _need(sides[f.name], f"sides[{f.name!r}]", side_shape,
              torch_dtype(f.dtype), dev)


def _check_carry_and_sides(carry, sides, bs: int, side_shape: tuple, spec,
                           wire, dev) -> None:
    for f in spec.registry.state.fields:
        _need(carry[f.name], f"carry[{f.name!r}]", (bs,), torch_dtype(f.dtype), dev)
    _check_sides(sides, side_shape, wire, dev)


def _check_list(slab, words, sides, lens, ord, i0s, t_bases, starts, width,
                bs, spec, wire) -> tuple[int, int]:
    """Device, dtype, shape and contiguity of every list-fold input; returns
    ``(b_pad, k)``."""
    dev = words.device
    nbytes = wire.nbytes
    if int(width) < 1 or int(bs) < 1:
        raise ValueError(f"width and bs must be >= 1, got {width}, {bs}")
    if lens.dim() != 1:
        raise ValueError(f"lens must be int32 [b_pad], got {tuple(lens.shape)}")
    b_pad = lens.shape[0]
    if i0s.dim() != 1:
        raise ValueError(f"i0s must be int32 [k], got {tuple(i0s.shape)}")
    k = i0s.shape[0]
    _need(i0s, "i0s", (k,), torch.int32, dev)
    _need(t_bases, "t_bases", (k,), torch.int32, dev)
    _need(lens, "lens", (b_pad,), torch.int32, dev)
    _need(ord, "ord", (b_pad,), torch.int32, dev)
    if starts is None:  # dense: the tile buffers of this list
        _need(words, "words", (k, width, bs, nbytes), torch.uint8, dev)
        side_shape = (k, width, bs)
    else:
        if words.dim() != 2 or words.shape[0] < width:
            raise ValueError(f"flat words must be uint8 [rows >= width, "
                             f"{nbytes}], got {tuple(words.shape)}")
        _need(words, "words", (words.shape[0], nbytes), torch.uint8, dev)
        _need(starts, "starts", (b_pad,), torch.int32, dev)
        side_shape = (words.shape[0],)
    _check_carry_and_sides(slab, sides, b_pad, side_shape, spec, wire, dev)
    return b_pad, k


def _check_window(slab, ords, table, spec, dev) -> int:
    """Device, dtype, shape and contiguity of the slab, its ordinals and a
    window's lane table; returns the window's lanes."""
    if ords.dim() != 1 or ords.shape[0] < 1:
        raise ValueError(f"ords must be int32 [capacity + 1], got "
                         f"{tuple(ords.shape)}")
    _need(ords, "ords", tuple(ords.shape), torch.int32, dev)
    for f in spec.registry.state.fields:
        _need(slab[f.name], f"slab[{f.name!r}]", tuple(ords.shape),
              torch_dtype(f.dtype), dev)
    n_state = len(spec.registry.state.fields)
    if table.dim() != 2 or table.shape[0] not in (LANE_ADMIT,
                                                  LANE_ADMIT_VAL + n_state):
        raise ValueError(f"table must be int32 [{LANE_ADMIT} or "
                         f"{LANE_ADMIT_VAL + n_state}, lanes], got "
                         f"{tuple(table.shape)}")
    lanes = table.shape[1]
    if lanes < 1:
        raise ValueError("a window needs at least one lane")
    _need(table, "table", tuple(table.shape), torch.int32, dev)
    return lanes


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load the kernel library ``csrc/<name>.cu``
    (``tile_scan`` or ``ragged_fold``); checks that the C step functors fold
    the schemas KERNEL_STEPS names."""
    from surge_tpu_torch._build import library

    lib = ctypes.CDLL(str(library(name)))
    # step, slab and lane table, decode, words, nbytes, width
    window = [ctypes.c_int, ctypes.POINTER(_SlabArgs), ctypes.POINTER(_DecodeArgs),
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    if name == "tile_scan":
        # + paths, stream
        lib.surge_dense_window.argtypes = window + [ctypes.c_void_p,
                                                    ctypes.c_void_p]
        lib.surge_dense_window.restype = ctypes.c_int
        lib.surge_tile_fold_list.argtypes = [
            ctypes.c_int, ctypes.POINTER(_ListArgs), ctypes.POINTER(_DecodeArgs),
            ctypes.POINTER(_StateArgs), ctypes.c_void_p]
        lib.surge_tile_fold_list.restype = ctypes.c_int
        lib.surge_tile_fold_list_args_size.restype = ctypes.c_int
        if lib.surge_tile_fold_list_args_size() != ctypes.sizeof(_ListArgs):
            raise RuntimeError("struct ListArgs in csrc/tile_scan.cu and "
                               "_ListArgs differ in size")
    elif name == "ragged_fold":
        # + rows, paths, stream
        lib.surge_ragged_window.argtypes = window + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.surge_ragged_window.restype = ctypes.c_int
    else:
        raise ValueError(f"no kernel library {name!r}")
    sizes = getattr(lib, f"surge_{name}_struct_size")
    sizes.argtypes = [ctypes.c_int]
    sizes.restype = ctypes.c_int
    for which, struct in enumerate(_STRUCTS):
        if sizes(which) != ctypes.sizeof(struct):
            raise RuntimeError(f"csrc/fold_common.cuh and {struct.__name__} "
                               f"differ in size ({sizes(which)} != "
                               f"{ctypes.sizeof(struct)} bytes)")
    shape = getattr(lib, f"surge_{name}_shape")
    shape.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_int)]
    shape.restype = ctypes.c_int
    part_map = getattr(lib, f"surge_{name}_part_map")
    part_map.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                         ctypes.POINTER(ctypes.c_int)]
    part_map.restype = ctypes.c_int
    steps = list(KERNEL_STEPS.items()) + [
        ("mixed", (MIXED_STATE, MIXED_COLS))]
    for step_id, (step, (state, cols)) in enumerate(steps):
        n_cols, n_state = ctypes.c_int(), ctypes.c_int()
        if (shape(step_id, ctypes.byref(n_cols), ctypes.byref(n_state)) != 0
                or (n_cols.value, n_state.value) != (len(cols), len(state))):
            raise RuntimeError(f"{name} step {step_id} does not fold {step!r} "
                               f"({len(cols)} columns, {len(state)} state fields)")
        if step_id == MIXED_STEP_ID:
            continue
        c_cols, c_fields = (ctypes.c_int * _MAX_COLS)(), (ctypes.c_int * _MAX_STATE)()
        if part_map(step_id, c_cols, c_fields) != 0 or \
                (list(c_cols[:len(cols)]), list(c_fields[:len(state)])) != \
                mixed_part_map(step):
            raise RuntimeError(f"{name}: MixedStep's part {step_id} does not "
                               f"map {step!r} onto MIXED_COLS and MIXED_STATE")
    return lib


def mixed_part_map(step: str) -> tuple[list[int], list[int]]:
    """MixedStep's slot of each column and state field of kernel step
    ``step`` (``MixedPart`` in csrc/fold_common.cuh)."""
    state, cols = KERNEL_STEPS[step]
    return ([MIXED_COLS.index(c) for c in cols],
            [MIXED_STATE.index(f) for f in state])


def load() -> None:
    """Build and load every kernel library now (the first launch would)."""
    from surge_tpu_torch._build import build_all

    build_all(["tile_scan", "ragged_fold"])
    _library("tile_scan")
    _library("ragged_fold")
