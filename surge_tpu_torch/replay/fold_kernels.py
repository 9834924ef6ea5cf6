"""K1, the resident tile scan: its wrapper and its plain torch version.

``tile_scan(carry, words, sides, lens_rel, ord_rel, *, spec, wire)`` folds one
time-major tile: ``carry {field: [bs]}``, ``words [width, bs]`` (the u32 wire
words as int32 bit patterns), ``sides {name: [width, bs]}``, ``lens_rel [bs]``
(each lane's remaining length within the tile) and ``ord_rel [bs]`` (the
lane's ordinal base shifted by the tile offset, so the derived ordinal of
local step t is ``ord_rel + t + 1``). It computes what the Pallas kernel
``surge_tpu/replay/pallas_fold.py:make_tile_scan`` computes.

On CPU tensors the wrapper runs :func:`tile_scan_reference`; on CUDA tensors it
launches the hand-written kernel (``surge_tpu_torch/csrc/tile_scan.cu``) or
raises. ``LAUNCHES["tile_scan"]`` counts kernel launches, and nothing else.
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
LAUNCHES: dict[str, int] = {"tile_scan": 0}

_MAX_COLS = 8
_MAX_STATE = 8
_PACKED, _SIDE, _ORDINAL = 0, 1, 2
_WORD, _BYTE = 0, 1
_SIDE_DTYPES = (np.dtype(np.int32), np.dtype(np.float32))
_STATE_KINDS = {np.dtype(np.int32): _WORD, np.dtype(np.float32): _WORD,
                np.dtype(np.bool_): _BYTE}


class _DecodeArgs(ctypes.Structure):
    # mirrors struct DecodeArgs in csrc/tile_scan.cu
    _fields_ = [("type_bits", ctypes.c_int32), ("num_types", ctypes.c_int32),
                ("n_cols", ctypes.c_int32),
                ("kind", ctypes.c_int32 * _MAX_COLS),
                ("shift", ctypes.c_int32 * _MAX_COLS),
                ("mask", ctypes.c_uint32 * _MAX_COLS),
                ("side", ctypes.c_void_p * _MAX_COLS)]


class _StateArgs(ctypes.Structure):
    # mirrors struct StateArgs in csrc/tile_scan.cu
    _fields_ = [("n_state", ctypes.c_int32),
                ("kind", ctypes.c_int32 * _MAX_STATE),
                ("in_", ctypes.c_void_p * _MAX_STATE),
                ("out", ctypes.c_void_p * _MAX_STATE)]


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
    dec = _DecodeArgs.from_buffer_copy(layout)  # side pointers are per call
    width, bs = _check_tile(carry, words, sides, lens_rel, ord_rel, spec, wire)
    fields = spec.registry.state.fields
    out = {f.name: torch.empty_like(carry[f.name]) for f in fields}
    sa = _StateArgs()
    sa.n_state = len(fields)
    for i, f in enumerate(fields):
        sa.kind[i] = _STATE_KINDS[np.dtype(f.dtype)]
        sa.in_[i] = carry[f.name].data_ptr()
        sa.out[i] = out[f.name].data_ptr()
    cols = KERNEL_STEPS[spec.kernel_step][1]
    for c, name in enumerate(cols):
        if dec.kind[c] == _SIDE:
            dec.side[c] = sides[name].data_ptr()
    if bs == 0:
        return out
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _library().surge_tile_scan(step_id, width, bs, words.data_ptr(),
                                     lens_rel.data_ptr(), ord_rel.data_ptr(),
                                     ctypes.byref(dec), ctypes.byref(sa), stream)
    if err != 0:
        raise RuntimeError(f"tile_scan kernel launch failed: cudaError_t {err}")
    LAUNCHES["tile_scan"] += 1
    return out


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


def _check_tile(carry, words, sides, lens_rel, ord_rel, spec, wire
                ) -> tuple[int, int]:
    """Device, dtype, shape and contiguity of every kernel input; returns
    ``(width, bs)``."""
    dev = words.device
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"words must be int32 [width, bs], got {words.dtype} "
                         f"{tuple(words.shape)}")
    width, bs = words.shape

    def need(t: torch.Tensor, what: str, shape: tuple, dtype: torch.dtype):
        if t.device != dev:
            raise ValueError(f"{what} is on {t.device}, words on {dev}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{what} must be {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")

    need(words, "words", (width, bs), torch.int32)
    need(lens_rel, "lens_rel", (bs,), torch.int32)
    need(ord_rel, "ord_rel", (bs,), torch.int32)
    for f in spec.registry.state.fields:
        need(carry[f.name], f"carry[{f.name!r}]", (bs,), torch_dtype(f.dtype))
    if set(sides) != {f.name for f in wire.side_fields}:
        raise ValueError(f"sides {sorted(sides)} != the wire's side columns "
                         f"{sorted(f.name for f in wire.side_fields)}")
    for f in wire.side_fields:
        need(sides[f.name], f"sides[{f.name!r}]", (width, bs), torch_dtype(f.dtype))
    return width, bs


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; checks that the C
    step functors fold the schemas KERNEL_STEPS names."""
    from surge_tpu_torch._build import library

    lib = ctypes.CDLL(str(library("tile_scan")))
    lib.surge_tile_scan.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_DecodeArgs),
        ctypes.POINTER(_StateArgs), ctypes.c_void_p]
    lib.surge_tile_scan.restype = ctypes.c_int
    lib.surge_tile_scan_shape.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.surge_tile_scan_shape.restype = ctypes.c_int
    for step_id, (name, (state, cols)) in enumerate(KERNEL_STEPS.items()):
        n_cols, n_state = ctypes.c_int(), ctypes.c_int()
        if (lib.surge_tile_scan_shape(step_id, ctypes.byref(n_cols),
                                      ctypes.byref(n_state)) != 0
                or (n_cols.value, n_state.value) != (len(cols), len(state))):
            raise RuntimeError(f"kernel step {step_id} does not fold {name!r} "
                               f"({len(cols)} columns, {len(state)} state fields)")
    return lib


def load() -> None:
    """Build and load the kernel library now (the first launch would)."""
    _library()
