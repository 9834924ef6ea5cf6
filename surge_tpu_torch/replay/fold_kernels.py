"""The fold kernels K1 (the resident tile scan) and K2 (the ragged refresh
fold): their wrappers and their plain torch versions.

``tile_scan(carry, words, sides, lens_rel, ord_rel, *, spec, wire)`` folds one
time-major tile: ``carry {field: [bs]}``, ``words [width, bs]`` (the u32 wire
words as int32 bit patterns), ``sides {name: [width, bs]}``, ``lens_rel [bs]``
(each lane's remaining length within the tile) and ``ord_rel [bs]`` (the
lane's ordinal base shifted by the tile offset, so the derived ordinal of
local step t is ``ord_rel + t + 1``). It computes what the Pallas kernel
``surge_tpu/replay/pallas_fold.py:make_tile_scan`` computes.

``ragged_fold(carry, words, sides, starts, lens, ord, *, width, spec, wire)``
folds one refresh bucket from a FLAT event buffer: ``words [rows]``, ``sides
{name: [rows]}``; lane ``b`` at step ``t < width`` reads row
``min(starts[b] + t, rows - 1)``, valid while ``t < lens[b]``, with the derived
ordinal ``ord[b] + t + 1``. It computes what the Pallas kernel
``surge_tpu/replay/pallas_fold.py:make_ragged_fold`` computes (``starts`` are
never negative there; a negative start clamps to row 0 here).

``tile_fold_list(slab, words, sides, lens, ord, i0s, t_bases, *, width, bs,
...)`` folds a whole work list of the resident replay into the state slab in
place, in one launch (K1's second entry): tile ``k`` folds events
``[t_bases[k], t_bases[k] + width)`` of lanes ``[i0s[k], i0s[k] + bs)``, in
list order, from the dense tile buffers (``words u8 [k, width, bs, nbytes]``)
or from the flat corpus (``words u8 [rows, nbytes]`` and ``starts``).

On CPU tensors each wrapper runs its plain version (:func:`tile_scan_reference`,
:func:`tile_fold_list_reference`, :func:`ragged_fold_reference`); on CUDA
tensors it launches the hand-written kernel (``surge_tpu_torch/csrc/tile_scan.cu``,
``csrc/ragged_fold.cu``) or raises. ``LAUNCHES[name]`` counts kernel launches,
and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping

import numpy as np
import torch

from surge_tpu_torch.codec.schema import SchemaRegistry
from surge_tpu_torch.codec.wire import DERIVE_ORDINAL, WireFormat, torch_dtype
from surge_tpu_torch.engine.model import ReplaySpec

#: the model steps the kernel carries, in the order of the C step ids:
#: name -> (state fields, union columns), each in the schema's order
KERNEL_STEPS: dict[str, tuple[tuple[str, ...], tuple[str, ...]]] = {
    "counter": (("count", "version"),
                ("decrement_by", "increment_by", "sequence_number")),
    "bank_account": (("created", "owner_code", "security_code_code", "balance"),
                     ("balance", "new_balance", "owner_code",
                      "security_code_code")),
}

#: kernel launches per wrapper (reset by the caller; never by this module)
LAUNCHES: dict[str, int] = {"tile_scan": 0, "tile_fold_list": 0,
                            "ragged_fold": 0}

#: lanes per block of the list fold (``kThreads`` in csrc/fold_common.cuh):
#: the granularity of its schedule
LIST_LANE_BLOCK = 256

#: t_base sentinel of the reference's dense work-list padding: past every real
#: lane length yet far from int32 overflow. The replay folds real tiles only,
#: but keeps the reference's clamp of t_base before the ordinal add
#: (``kNoopTileT`` in csrc/tile_scan.cu)
_NOOP_TILE_T = np.int32(1 << 29)

_MAX_COLS = 8
_MAX_STATE = 8
_PACKED, _SIDE, _ORDINAL = 0, 1, 2
_WORD, _BYTE = 0, 1
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
                ("side", ctypes.c_void_p * _MAX_COLS)]


class _StateArgs(ctypes.Structure):
    # mirrors struct StateArgs in csrc/fold_common.cuh
    _fields_ = [("n_state", ctypes.c_int32),
                ("kind", ctypes.c_int32 * _MAX_STATE),
                ("in_", ctypes.c_void_p * _MAX_STATE),
                ("out", ctypes.c_void_p * _MAX_STATE)]


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


def tile_scan(carry: Mapping[str, torch.Tensor], words: torch.Tensor,
              sides: Mapping[str, torch.Tensor], lens_rel: torch.Tensor,
              ord_rel: torch.Tensor, *, spec: ReplaySpec,
              wire: WireFormat) -> dict[str, torch.Tensor]:
    """Fold one tile: the plain version for CPU tensors, the kernel for CUDA
    tensors (see the module docstring)."""
    if words.device.type == "cpu":
        return tile_scan_reference(carry, words, sides, lens_rel, ord_rel,
                                   spec=spec, wire=wire)
    if words.device.type != "cuda":
        raise ValueError(f"tile_scan runs on cpu or cuda tensors, got "
                         f"{words.device}")
    step_id, layout = _decode_args(spec.kernel_step, spec.registry, wire)
    width, bs = _check_tile(carry, words, sides, lens_rel, ord_rel, spec, wire)
    out, dec, sa = _kernel_args(layout, carry, sides, spec)
    if bs == 0:
        return out
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _library("tile_scan").surge_tile_scan(
        step_id, width, bs, words.data_ptr(), lens_rel.data_ptr(),
        ord_rel.data_ptr(), ctypes.byref(dec), ctypes.byref(sa), stream)
    if err != 0:
        raise RuntimeError(f"tile_scan kernel launch failed: cudaError_t {err}")
    LAUNCHES["tile_scan"] += 1
    return out


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


def ragged_fold(carry: Mapping[str, torch.Tensor], words: torch.Tensor,
                sides: Mapping[str, torch.Tensor], starts: torch.Tensor,
                lens: torch.Tensor, ord: torch.Tensor, *, width: int,
                spec: ReplaySpec, wire: WireFormat) -> dict[str, torch.Tensor]:
    """Fold one ragged refresh bucket: the plain version for CPU tensors, the
    kernel for CUDA tensors (see the module docstring)."""
    if words.device.type == "cpu":
        return ragged_fold_reference(carry, words, sides, starts, lens, ord,
                                     width=width, spec=spec, wire=wire)
    if words.device.type != "cuda":
        raise ValueError(f"ragged_fold runs on cpu or cuda tensors, got "
                         f"{words.device}")
    step_id, layout = _decode_args(spec.kernel_step, spec.registry, wire)
    rows, bs = _check_ragged(carry, words, sides, starts, lens, ord, width,
                             spec, wire)
    out, dec, sa = _kernel_args(layout, carry, sides, spec)
    if bs == 0:
        return out
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _library("ragged_fold").surge_ragged_fold(
        step_id, width, rows, bs, words.data_ptr(), starts.data_ptr(),
        lens.data_ptr(), ord.data_ptr(), ctypes.byref(dec), ctypes.byref(sa),
        stream)
    if err != 0:
        raise RuntimeError(f"ragged_fold kernel launch failed: cudaError_t {err}")
    LAUNCHES["ragged_fold"] += 1
    return out


def _kernel_args(layout: "_DecodeArgs", carry: Mapping[str, torch.Tensor],
                 sides: Mapping[str, torch.Tensor], spec: ReplaySpec):
    """The output carry (allocated here) and the kernel's argument structs."""
    out = {f.name: torch.empty_like(carry[f.name])
           for f in spec.registry.state.fields}
    return (out, _decode_with_sides(layout, sides, spec),
            _state_args(carry, out, spec))


def _decode_with_sides(layout: "_DecodeArgs", sides: Mapping[str, torch.Tensor],
                       spec: ReplaySpec) -> "_DecodeArgs":
    """A per-call copy of the cached decode layout with the side pointers set."""
    dec = _DecodeArgs.from_buffer_copy(layout)
    for c, name in enumerate(KERNEL_STEPS[spec.kernel_step][1]):
        if dec.kind[c] == _SIDE:
            dec.side[c] = sides[name].data_ptr()
    return dec


def _state_args(carry: Mapping[str, torch.Tensor], out: Mapping[str, torch.Tensor],
                spec: ReplaySpec) -> "_StateArgs":
    """The state pointers: read from ``carry``, written to ``out`` (the same
    tensors for a fold in place)."""
    fields = spec.registry.state.fields
    sa = _StateArgs()
    sa.n_state = len(fields)
    for i, f in enumerate(fields):
        sa.kind[i] = _STATE_KINDS[np.dtype(f.dtype)]
        sa.in_[i] = carry[f.name].data_ptr()
        sa.out[i] = out[f.name].data_ptr()
    return sa


@functools.lru_cache(maxsize=64)
def _decode_args(name: str | None, reg: SchemaRegistry, wire: WireFormat
                 ) -> tuple[int, _DecodeArgs]:
    """The kernel's step id and decode arguments (side pointers unset) for
    ``wire``. Raises unless ``name`` is a kernel step whose schema ``reg``
    matches and the arguments describe the wire's exact layout (its
    ``layout_fingerprint()``). Cached per (step, registry, wire): the check
    costs more host time than a launch, and registries are complete once
    built."""
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
    packed = {pf.name: pf for pf in wire.packed_fields}
    sides = {f.name for f in wire.side_fields}
    dec = _DecodeArgs()
    dec.type_bits = wire.type_bits
    dec.num_types = wire.num_types
    dec.n_cols = len(col_names)
    for c, col in enumerate(col_names):
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
    return list(KERNEL_STEPS).index(name), dec


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


def _check_carry_and_sides(carry, sides, bs: int, side_shape: tuple, spec,
                           wire, dev) -> None:
    for f in spec.registry.state.fields:
        _need(carry[f.name], f"carry[{f.name!r}]", (bs,), torch_dtype(f.dtype), dev)
    if set(sides) != {f.name for f in wire.side_fields}:
        raise ValueError(f"sides {sorted(sides)} != the wire's side columns "
                         f"{sorted(f.name for f in wire.side_fields)}")
    for f in wire.side_fields:
        _need(sides[f.name], f"sides[{f.name!r}]", side_shape,
              torch_dtype(f.dtype), dev)


def _check_tile(carry, words, sides, lens_rel, ord_rel, spec, wire
                ) -> tuple[int, int]:
    """Device, dtype, shape and contiguity of every K1 input; returns
    ``(width, bs)``."""
    dev = words.device
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"words must be int32 [width, bs], got {words.dtype} "
                         f"{tuple(words.shape)}")
    width, bs = words.shape
    _need(words, "words", (width, bs), torch.int32, dev)
    _need(lens_rel, "lens_rel", (bs,), torch.int32, dev)
    _need(ord_rel, "ord_rel", (bs,), torch.int32, dev)
    _check_carry_and_sides(carry, sides, bs, (width, bs), spec, wire, dev)
    return width, bs


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


def _check_ragged(carry, words, sides, starts, lens, ord, width, spec, wire
                  ) -> tuple[int, int]:
    """Device, dtype, shape and contiguity of every K2 input; returns
    ``(rows, bs)``."""
    dev = words.device
    if words.dtype != torch.int32 or words.dim() != 1 or words.shape[0] < 1:
        raise ValueError(f"words must be int32 [rows] with rows >= 1, got "
                         f"{words.dtype} {tuple(words.shape)}")
    if int(width) < 0:
        raise ValueError(f"width must be >= 0, got {width}")
    rows = words.shape[0]
    if starts.dim() != 1:
        raise ValueError(f"starts must be int32 [bs], got {tuple(starts.shape)}")
    bs = starts.shape[0]
    _need(words, "words", (rows,), torch.int32, dev)
    _need(starts, "starts", (bs,), torch.int32, dev)
    _need(lens, "lens", (bs,), torch.int32, dev)
    _need(ord, "ord", (bs,), torch.int32, dev)
    _check_carry_and_sides(carry, sides, bs, (rows,), spec, wire, dev)
    return rows, bs


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load the kernel library ``csrc/<name>.cu``
    (``tile_scan`` or ``ragged_fold``); checks that the C step functors fold
    the schemas KERNEL_STEPS names."""
    from surge_tpu_torch._build import library

    lib = ctypes.CDLL(str(library(name)))
    if name == "tile_scan":
        lib.surge_tile_scan.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_DecodeArgs),
            ctypes.POINTER(_StateArgs), ctypes.c_void_p]
        lib.surge_tile_scan.restype = ctypes.c_int
        lib.surge_tile_fold_list.argtypes = [
            ctypes.c_int, ctypes.POINTER(_ListArgs), ctypes.POINTER(_DecodeArgs),
            ctypes.POINTER(_StateArgs), ctypes.c_void_p]
        lib.surge_tile_fold_list.restype = ctypes.c_int
        lib.surge_tile_fold_list_args_size.restype = ctypes.c_int
        if lib.surge_tile_fold_list_args_size() != ctypes.sizeof(_ListArgs):
            raise RuntimeError("struct ListArgs in csrc/tile_scan.cu and "
                               "_ListArgs differ in size")
    elif name == "ragged_fold":
        lib.surge_ragged_fold.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(_DecodeArgs), ctypes.POINTER(_StateArgs),
            ctypes.c_void_p]
        lib.surge_ragged_fold.restype = ctypes.c_int
    else:
        raise ValueError(f"no kernel library {name!r}")
    shape = getattr(lib, f"surge_{name}_shape")
    shape.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_int)]
    shape.restype = ctypes.c_int
    for step_id, (step, (state, cols)) in enumerate(KERNEL_STEPS.items()):
        n_cols, n_state = ctypes.c_int(), ctypes.c_int()
        if (shape(step_id, ctypes.byref(n_cols), ctypes.byref(n_state)) != 0
                or (n_cols.value, n_state.value) != (len(cols), len(state))):
            raise RuntimeError(f"{name} step {step_id} does not fold {step!r} "
                               f"({len(cols)} columns, {len(state)} state fields)")
    return lib


def load() -> None:
    """Build and load every kernel library now (the first launch would)."""
    from surge_tpu_torch._build import build_all

    build_all(["tile_scan", "ragged_fold"])
    _library("tile_scan")
    _library("ragged_fold")
