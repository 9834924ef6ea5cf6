"""The scan engine's grouped reduction: its wrapper, its plain torch twin and
the CSR that feeds both.

``scan_reduce(mask, cols, ops, offsets, order)`` computes, for each group
``g`` of a CSR (``offsets int32 [G + 1]``; ``order int32 [offsets[G]]`` maps a
span position to an event, ``None`` is the identity), the count of its
matched events (``mask bool [n]``) and, for each ``(column, op)`` pair, the
sum, min or max of the column over them, in event order: what the reference
scan's ``.at[agg_idx].add/min/max`` scatters compute on the CPU
(``surge_tpu/replay/query.py:549-570``), float sums, NaN payloads and signed
zeros included, bit for bit.

On CPU tensors it runs :func:`scan_reduce_reference`, on CUDA tensors the
hand-written kernel ``surge_tpu_torch/csrc/scan_reduce.cu`` (four launches,
one a pass, each counted under its name in ``LAUNCHES``: :data:`PASSES`),
or raises. The kernel replaces no
Pallas kernel (the reference's reduction is an XLA scatter); it exists
because CUDA's scatters add float32 in atomic order, which changes the last
bits of a sum from run to run.

Semantics, shared by the kernel and the twin (the kernel's note gives the
rules in full): a masked-out event adds +0.0 to a sum and the sentinel to min
and max; float sums add in event order under flush-to-zero and
denormals-are-zero, a NaN sum carrying the group's last matched NaN's
payload, quieted, or x86's default NaN; integer sums wrap in 32 bits; float
min and max follow x86's lowering of LLVM's minimum and maximum on flushed
inputs (:func:`_fmin_rule`, :func:`_fmax_rule`); an empty group keeps the
sentinel (:func:`sentinel`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

#: kernel launches, by kernel (reset by the caller; never by this module)
LAUNCHES: dict[str, int] = {"scan_reduce_plan": 0, "scan_reduce": 0,
                            "scan_reduce_spans": 0, "scan_reduce_long": 0,
                            "fadd_chain": 0}
#: the kernel's passes, in launch order (``LAUNCHES`` keys)
PASSES = ("scan_reduce_plan", "scan_reduce", "scan_reduce_spans", "scan_reduce_long")

#: ``kMaxOut`` in csrc/scan_reduce.cu: output columns of one call
MAX_OUT = 16
#: ``kTile`` in csrc/scan_reduce.cu: the span positions of one tile
TILE = 4096
#: ``kMaxRegions`` in csrc/scan_reduce.cu: distinct columns of one call (each
#: staged in a tile's shared memory)
MAX_COLUMNS = 11
_OPS = {"sum": 0, "min": 1, "max": 2}
_DTYPES = {torch.int32: 0, torch.float32: 1}
_SIGN = -(1 << 31)            # 0x80000000 as int32
_QUIET = 1 << 22              # a float32 NaN's quiet bit
_DEFAULT_NAN = -(1 << 22)     # 0xffc00000: x86's NaN for inf - inf


class _ScanArgs(ctypes.Structure):
    # mirrors struct ScanArgs in csrc/scan_reduce.cu
    _fields_ = [("n_groups", ctypes.c_int32), ("n_out", ctypes.c_int32),
                ("n_tiles", ctypes.c_int32), ("n_regions", ctypes.c_int32),
                ("op", ctypes.c_int32 * MAX_OUT),
                ("dtype", ctypes.c_int32 * MAX_OUT),
                ("region", ctypes.c_int32 * MAX_OUT),
                ("region_src", ctypes.c_int32 * MAX_OUT),
                ("mask", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
                ("order", ctypes.c_void_p), ("count", ctypes.c_void_p),
                ("col", ctypes.c_void_p * MAX_OUT),
                ("out", ctypes.c_void_p * MAX_OUT),
                ("part", ctypes.c_void_p), ("tail_group", ctypes.c_void_p),
                ("tile_first", ctypes.c_void_p), ("tile_ga", ctypes.c_void_p),
                ("tile_in_end", ctypes.c_void_p), ("long_list", ctypes.c_void_p),
                ("n_long", ctypes.c_void_p)]


def sentinel(op: str, dtype: torch.dtype):
    """The identity a min/max partial starts from (the dtype's max for min,
    its lowest value for max), 0 for a sum."""
    if op == "sum":
        return 0
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def group_csr(groups: np.ndarray, n_groups: int, device: torch.device
              ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(offsets int32 [n_groups + 1], order int32 [n] | None)`` on
    ``device`` for the group index of each event (``groups``, host int32).
    Non-decreasing groups (a segment chunk's ``agg_idx``) keep the event
    order: ``order`` is None and the offsets come from a bincount and a
    cumsum; otherwise a stable sort by group gives ``order``, each group's
    events staying in event order."""
    groups = np.asarray(groups)
    g = torch.from_numpy(np.array(groups, dtype=np.int32)).to(device)
    grouped = groups.size < 2 or bool(np.all(groups[1:] >= groups[:-1]))
    order = None
    if not grouped:
        order = torch.sort(g, stable=True).indices.to(torch.int32)
    counts = torch.bincount(g, minlength=n_groups)
    offsets = torch.zeros(n_groups + 1, dtype=torch.int32, device=device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets, order


# -- the twin: the kernel's decomposition in torch ----------------------------------


def daz(x: torch.Tensor) -> torch.Tensor:
    """Denormals-are-zero: a float32 denormal becomes the zero of its sign."""
    b = x.view(torch.int32)
    return torch.where((b & 0x7F800000) == 0, (b & _SIGN).view(torch.float32), x)


def _fmin_rule(acc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x86's minimum of (earlier, later): -0 < +0; a NaN wins; of two NaNs
    the earlier unless it is negative."""
    neg = torch.signbit(acc)
    x, y = torch.where(neg, v, acc), torch.where(neg, acc, v)
    return torch.where((x < y) | torch.isnan(x), x, y)


def _fmax_rule(acc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x86's maximum of (earlier, later): +0 > -0; a NaN wins; of two NaNs
    the earlier if it is negative, else the later."""
    neg = torch.signbit(acc)
    x, y = torch.where(neg, acc, v), torch.where(neg, v, acc)
    return torch.where((x > y) | torch.isnan(x), x, y)


def _combine(kind: str, e: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The order-free combine of earlier partials ``e`` and later ``l``."""
    if kind == "sum":
        return e + l
    if kind == "min":
        return _fmin_rule(e, l) if e.dtype.is_floating_point else torch.minimum(e, l)
    return _fmax_rule(e, l) if e.dtype.is_floating_point else torch.maximum(e, l)


def _segmented_scan(x: torch.Tensor, first: torch.Tensor, kind: str
                    ) -> torch.Tensor:
    """Inclusive scan in position order inside segments: ``x[i]`` becomes the
    ordered combine of ``x[first[i]] .. x[i]`` (log-step doubling, each step
    combining an earlier stretch with a later one)."""
    idx = torch.arange(x.shape[0], device=x.device)
    span = int((idx - first).max()) + 1 if x.shape[0] else 0
    d = 1
    while d < span:
        src = idx - d
        ok = src >= first
        x = torch.where(ok, _combine(kind, x[src.clamp(min=0)], x), x)
        d *= 2
    return x


def _float_chains(vals: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor
                  ) -> torch.Tensor:
    """Each group's float sum in span order from +0.0, under flush-to-zero
    and denormals-are-zero: ``vals`` per span position (+0.0 where
    unmatched), the groups' ``starts`` and ``lens`` (each > 0). A NaN sum
    takes the last NaN input's payload, quieted, else x86's default NaN."""
    dev = vals.device
    lens_sorted, rank = torch.sort(lens, descending=True, stable=True)
    starts_sorted = starts[rank]
    n = lens.shape[0]
    acc = torch.zeros(n, dtype=torch.float32, device=dev)
    last_nan = torch.zeros(n, dtype=torch.int32, device=dev)
    had_nan = torch.zeros(n, dtype=torch.bool, device=dev)
    longest = int(lens_sorted[0]) if n else 0
    # live[t]: the groups longer than t (a prefix of the sorted order)
    live = (n - torch.searchsorted(lens_sorted.flip(0).cpu(),
                                   torch.arange(longest), right=True)).tolist()
    for t, k in enumerate(live):
        v = vals[starts_sorted[:k] + t]
        acc[:k] = daz(acc[:k] + daz(v))
        nan = torch.isnan(v)
        last_nan[:k] = torch.where(nan, v.view(torch.int32), last_nan[:k])
        had_nan[:k] |= nan
    fixed = torch.where(had_nan, last_nan | _QUIET,
                        torch.full_like(last_nan, _DEFAULT_NAN))
    acc = torch.where(torch.isnan(acc), fixed.view(torch.float32), acc)
    out = torch.empty_like(acc)
    out[rank] = acc
    return out


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def scan_reduce_reference(mask: torch.Tensor, cols: Sequence[torch.Tensor],
                          ops: Sequence[str], offsets: torch.Tensor,
                          order: Optional[torch.Tensor] = None,
                          tile: int = TILE
                          ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The plain twin of the kernel, in its decomposition: span positions
    cut into tiles of ``tile``; each (tile, group) run reduced to a partial
    in position order (the order-free outputs); a group's partials combined
    in tile order; each float sum one chain over its group's span. The CPU
    path, and the kernel's yardstick on the card."""
    dev = mask.device
    g_n = offsets.shape[0] - 1
    off = offsets.to(torch.int64)
    lens = off[1:] - off[:-1]
    n_pos = int(off[-1]) if g_n > 0 else 0
    if n_pos == 0:
        return (torch.zeros(g_n, dtype=torch.int32, device=dev),
                [torch.full((g_n,), sentinel(op, c.dtype), dtype=c.dtype, device=dev)
                 for c, op in zip(cols, ops)])
    pos = torch.arange(n_pos, device=dev)
    ev = pos if order is None else order[:n_pos].to(torch.int64)
    m = mask[ev]
    grp = torch.repeat_interleave(torch.arange(g_n, device=dev), lens)
    # runs: the stretch of one group inside one tile
    run_head = torch.ones(n_pos, dtype=torch.bool, device=dev)
    run_head[1:] = (grp[1:] != grp[:-1]) | (pos[1:] % tile == 0)
    run_start = pos[run_head]
    run_of = torch.cumsum(run_head, 0) - 1
    n_runs = run_start.shape[0]
    run_end = torch.cat([run_start[1:], pos.new_tensor([n_pos])]) - 1
    run_grp = grp[run_start]
    # a group's runs are consecutive
    g_head = torch.ones(n_runs, dtype=torch.bool, device=dev)
    g_head[1:] = run_grp[1:] != run_grp[:-1]
    runs = torch.arange(n_runs, device=dev)
    g_first_run = runs[g_head][torch.cumsum(g_head, 0) - 1]
    g_last = torch.ones(n_runs, dtype=torch.bool, device=dev)
    g_last[:-1] = g_head[1:]
    done_runs, done_grp = runs[g_last], run_grp[g_last]

    def reduce(x: torch.Tensor, kind: str, fill) -> torch.Tensor:
        partial = _segmented_scan(x, run_start[run_of], kind)[run_end]
        total = _segmented_scan(partial, g_first_run, kind)[done_runs]
        out = torch.full((g_n,), fill, dtype=x.dtype, device=dev)
        out[done_grp] = total
        return out

    count = reduce(m.to(torch.int64), "sum", 0).to(torch.int32)
    outs = []
    for col, op in zip(cols, ops):
        v = col[ev]
        if not col.dtype.is_floating_point:
            if op == "sum":
                outs.append(_wrap32(reduce(torch.where(m, v.to(torch.int64), 0),
                                           "sum", 0)))
            else:
                sent = sentinel(op, col.dtype)
                outs.append(reduce(torch.where(m, v, sent), op, sent))
        elif op == "sum":
            out = torch.zeros(g_n, dtype=col.dtype, device=dev)
            live = lens > 0
            out[live] = _float_chains(torch.where(m, v, 0.0), off[:-1][live],
                                      lens[live])
            outs.append(out)
        else:
            # each position folded onto the sentinel first, as the kernel's
            # folds start from it (+inf never passes FLT_MAX)
            sent = sentinel(op, col.dtype)
            x = _combine(op, torch.full_like(v, sent), torch.where(m, daz(v), sent))
            outs.append(reduce(x, op, sent))
    return count, outs


# -- the kernel ----------------------------------------------------------------------


def scan_reduce(mask: torch.Tensor, cols: Sequence[torch.Tensor],
                ops: Sequence[str], offsets: torch.Tensor,
                order: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Per group: the matched count (int32 ``[G]``) and one output per
    ``(cols[k], ops[k])`` in the column's dtype (``ops`` of ``sum``, ``min``,
    ``max``; columns int32 or float32, as long as ``mask``). The twin for CPU
    tensors, the kernel's four passes for CUDA tensors (module doc)."""
    if len(cols) != len(ops):
        raise ValueError(f"{len(cols)} columns for {len(ops)} ops")
    for op in ops:
        if op not in _OPS:
            raise ValueError(f"unknown reduction {op!r} (sum|min|max)")
    if mask.device.type == "cpu":
        return scan_reduce_reference(mask, cols, ops, offsets, order)
    if mask.device.type != "cuda":
        raise ValueError(f"scan_reduce runs on cpu or cuda tensors, got "
                         f"{mask.device}")
    dev = mask.device
    n = mask.shape[0]
    g_n = offsets.shape[0] - 1
    _need(mask, "mask", (n,), torch.bool, dev)
    _need(offsets, "offsets", (g_n + 1,), torch.int32, dev)
    if order is not None:
        _need(order, "order", (order.shape[0],), torch.int32, dev)
    if len(cols) > MAX_OUT:
        raise ValueError(f"scan_reduce takes at most {MAX_OUT} outputs, "
                         f"got {len(cols)}")
    if len({c.data_ptr() for c in cols}) > MAX_COLUMNS:
        raise ValueError(f"scan_reduce takes at most {MAX_COLUMNS} distinct "
                         f"columns on the card, got {len({c.data_ptr() for c in cols})}")
    for k, c in enumerate(cols):
        if c.dtype not in _DTYPES:
            raise ValueError(f"cols[{k}] is {c.dtype}; the kernel reduces "
                             f"int32 and float32")
        _need(c, f"cols[{k}]", (n,), c.dtype, dev)
    count = torch.empty(g_n, dtype=torch.int32, device=dev)
    outs = [torch.empty(g_n, dtype=c.dtype, device=dev) for c in cols]
    if g_n == 0:
        return count, outs
    # the span's length is offsets[-1], on the card: the tiles cover what it
    # can be at most (order's length, else mask's), and the tiles past it exit
    n_tiles = (order.shape[0] if order is not None else n) // TILE + 1
    part = torch.empty(n_tiles * 2 * (len(cols) + 1), dtype=torch.int32, device=dev)
    plan = torch.empty(5 * n_tiles + 1, dtype=torch.int32, device=dev)
    args = _ScanArgs(n_groups=g_n, n_out=len(cols), n_tiles=n_tiles,
                     mask=mask.data_ptr(), offsets=offsets.data_ptr(),
                     order=0 if order is None else order.data_ptr(),
                     count=count.data_ptr(), part=part.data_ptr(),
                     tail_group=plan[:n_tiles].data_ptr(),
                     tile_first=plan[n_tiles:2 * n_tiles].data_ptr(),
                     tile_ga=plan[2 * n_tiles:3 * n_tiles].data_ptr(),
                     tile_in_end=plan[3 * n_tiles:4 * n_tiles].data_ptr(),
                     long_list=plan[4 * n_tiles:5 * n_tiles].data_ptr(),
                     n_long=plan[5 * n_tiles:].data_ptr())
    regions: dict[int, int] = {}  # a column's address: its staged region
    for k, (c, op) in enumerate(zip(cols, ops)):
        args.op[k] = _OPS[op]
        args.dtype[k] = _DTYPES[c.dtype]
        args.col[k] = c.data_ptr()
        args.out[k] = outs[k].data_ptr()
        if c.data_ptr() not in regions:
            args.region_src[len(regions)] = k
            regions[c.data_ptr()] = len(regions)
        args.region[k] = regions[c.data_ptr()]
    args.n_regions = len(regions)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _library()
    for name in PASSES:
        err = getattr(lib, f"surge_{name}")(ctypes.byref(args), stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
        LAUNCHES[name] += 1
    return count, outs


def fadd_chain(steps: int, device: torch.device) -> torch.Tensor:
    """Launch ``steps`` dependent float adds on one thread of the card (the
    result, 1.0 added ``steps`` times, is returned): timed, it gives the
    latency of one add, which bounds a float sum's chain."""
    out = torch.empty(1, dtype=torch.float32, device=device)
    err = _library().surge_fadd_chain(steps, out.data_ptr(),
                                      torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fadd_chain kernel launch failed: cudaError_t {err}")
    LAUNCHES["fadd_chain"] += 1
    return out


def _need(t: torch.Tensor, what: str, shape: tuple, dtype: torch.dtype,
          dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{what} is on {t.device}, mask on {dev}")
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype} {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/scan_reduce.cu``; checks that
    ``ScanArgs`` and ``_ScanArgs``, and the constants, agree."""
    from surge_tpu_torch._build import library

    lib = ctypes.CDLL(str(library("scan_reduce")))
    for fn in (getattr(lib, f"surge_{name}") for name in PASSES):
        fn.argtypes = [ctypes.POINTER(_ScanArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.surge_fadd_chain.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.surge_fadd_chain.restype = ctypes.c_int
    for fn in (lib.surge_scan_reduce_args_size, lib.surge_scan_reduce_max_out,
               lib.surge_scan_reduce_tile, lib.surge_scan_reduce_max_columns):
        fn.restype = ctypes.c_int
    if (lib.surge_scan_reduce_args_size() != ctypes.sizeof(_ScanArgs)
            or lib.surge_scan_reduce_max_out() != MAX_OUT
            or lib.surge_scan_reduce_tile() != TILE
            or lib.surge_scan_reduce_max_columns() != MAX_COLUMNS):
        raise RuntimeError("struct ScanArgs or the constants in "
                           "csrc/scan_reduce.cu and _ScanArgs differ")
    return lib


def load() -> None:
    """Build and load the kernel library now (the first launch would)."""
    _library()
