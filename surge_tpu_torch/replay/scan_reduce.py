"""The scan engine's grouped reduction: its wrapper, its plain torch version
and the CSR that feeds both.

``scan_reduce(mask, cols, ops, offsets, order)`` computes, for each group
``g`` of a CSR (``offsets int32 [G + 1]``; ``order int32 [offsets[G]]`` maps a
span position to an event, ``None`` is the identity), the count of its
matched events (``mask bool [n]``) and, for each ``(column, op)`` pair, the
sum, min or max of the column over them, in event order: what the reference
scan's ``.at[agg_idx].add/min/max`` scatters compute
(``surge_tpu/replay/query.py:549-570``), float sums included bit for bit.

On CPU tensors it runs :func:`scan_reduce_reference`, on CUDA tensors the
hand-written kernel ``surge_tpu_torch/csrc/scan_reduce.cu`` (one launch;
``LAUNCHES["scan_reduce"]`` counts them), or raises. The kernel replaces no
Pallas kernel (the reference's reduction is an XLA scatter); it exists
because CUDA's scatters add float32 in atomic order, which changes the last
bits of a sum from run to run.

Semantics, shared by the kernel and the plain version: a masked-out event
contributes nothing (the scatter's +0 and sentinel are identities, see the
kernel's note); float sums add in order, rounded to nearest; integer sums
wrap in 32 bits; min and max follow numpy's NaN rule, ``acc = (acc < v or
isnan(acc)) ? acc : v``; an empty group keeps the sentinel
(:func:`sentinel`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

#: kernel launches (reset by the caller; never by this module)
LAUNCHES: dict[str, int] = {"scan_reduce": 0}

#: ``kMaxOut`` in csrc/scan_reduce.cu: output columns of one launch
MAX_OUT = 16
_OPS = {"sum": 0, "min": 1, "max": 2}
_DTYPES = {torch.int32: 0, torch.float32: 1}
#: the plain version's time blocks hold at most this many [T, G] elements
_BLOCK_ELEMS = 1 << 24


class _ScanArgs(ctypes.Structure):
    # mirrors struct ScanArgs in csrc/scan_reduce.cu
    _fields_ = [("n_groups", ctypes.c_int32), ("n_out", ctypes.c_int32),
                ("op", ctypes.c_int32 * MAX_OUT),
                ("dtype", ctypes.c_int32 * MAX_OUT),
                ("mask", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
                ("order", ctypes.c_void_p), ("count", ctypes.c_void_p),
                ("col", ctypes.c_void_p * MAX_OUT),
                ("out", ctypes.c_void_p * MAX_OUT)]


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


def scan_reduce_reference(mask: torch.Tensor, cols: Sequence[torch.Tensor],
                          ops: Sequence[str], offsets: torch.Tensor,
                          order: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The plain torch version: the same walk, time-major over a ``[max_len,
    G]`` layout (step ``t`` reads each group's ``t``-th event), in blocks of
    time steps. Order-free reductions (the count, integer sums, integer min
    and max) reduce a block at once; float sums, mins and maxes step through
    its rows one at a time, so they see each group's events in event
    order."""
    dev = mask.device
    g_n = offsets.shape[0] - 1
    starts = offsets[:-1].to(torch.int64)
    lens = (offsets[1:] - offsets[:-1]).to(torch.int64)
    count = torch.zeros(g_n, dtype=torch.int32, device=dev)
    accs = [torch.full((g_n,), sentinel(op, c.dtype), dtype=c.dtype, device=dev)
            for c, op in zip(cols, ops)]
    max_len = int(lens.max()) if g_n else 0
    step = max(1, _BLOCK_ELEMS // max(g_n, 1))
    for t0 in range(0, max_len, step):
        t = torch.arange(t0, min(t0 + step, max_len), device=dev)
        live = t[:, None] < lens[None, :]
        pos = torch.where(live, starts[None, :] + t[:, None], 0)
        e = pos if order is None else order.to(torch.int64)[pos]
        m = mask[e] & live
        count += m.sum(0, dtype=torch.int32)
        for k, (col, op) in enumerate(zip(cols, ops)):
            v = col[e]
            acc = accs[k]
            if not col.dtype.is_floating_point:
                if op == "sum":
                    acc += torch.where(m, v, 0).sum(0, dtype=col.dtype)
                elif op == "min":
                    torch.minimum(acc, torch.where(m, v, sentinel(op, col.dtype))
                                  .amin(0), out=acc)
                else:
                    torch.maximum(acc, torch.where(m, v, sentinel(op, col.dtype))
                                  .amax(0), out=acc)
                continue
            for r in range(v.shape[0]):
                x, mr = v[r], m[r]
                if op == "sum":
                    acc.copy_(torch.where(mr, acc + x, acc))
                elif op == "min":
                    keep = (acc < x) | torch.isnan(acc) | ~mr
                    acc.copy_(torch.where(keep, acc, x))
                else:
                    keep = (acc > x) | torch.isnan(acc) | ~mr
                    acc.copy_(torch.where(keep, acc, x))
    return count, accs


def scan_reduce(mask: torch.Tensor, cols: Sequence[torch.Tensor],
                ops: Sequence[str], offsets: torch.Tensor,
                order: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Per group: the matched count (int32 ``[G]``) and one output per
    ``(cols[k], ops[k])`` in the column's dtype (``ops`` of ``sum``, ``min``,
    ``max``; columns int32 or float32, as long as ``mask``). The plain version
    for CPU tensors, one kernel launch for CUDA tensors (module doc)."""
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
    for k, c in enumerate(cols):
        if c.dtype not in _DTYPES:
            raise ValueError(f"cols[{k}] is {c.dtype}; the kernel reduces "
                             f"int32 and float32")
        _need(c, f"cols[{k}]", (n,), c.dtype, dev)
    count = torch.empty(g_n, dtype=torch.int32, device=dev)
    outs = [torch.empty(g_n, dtype=c.dtype, device=dev) for c in cols]
    if g_n == 0:
        return count, outs
    args = _ScanArgs(n_groups=g_n, n_out=len(cols), mask=mask.data_ptr(),
                     offsets=offsets.data_ptr(),
                     order=0 if order is None else order.data_ptr(),
                     count=count.data_ptr())
    for k, (c, op) in enumerate(zip(cols, ops)):
        args.op[k] = _OPS[op]
        args.dtype[k] = _DTYPES[c.dtype]
        args.col[k] = c.data_ptr()
        args.out[k] = outs[k].data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().surge_scan_reduce(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"scan_reduce kernel launch failed: cudaError_t {err}")
    LAUNCHES["scan_reduce"] += 1
    return count, outs


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
    ``ScanArgs`` and ``_ScanArgs`` agree."""
    from surge_tpu_torch._build import library

    lib = ctypes.CDLL(str(library("scan_reduce")))
    lib.surge_scan_reduce.argtypes = [ctypes.POINTER(_ScanArgs), ctypes.c_void_p]
    lib.surge_scan_reduce.restype = ctypes.c_int
    lib.surge_scan_reduce_args_size.restype = ctypes.c_int
    lib.surge_scan_reduce_max_out.restype = ctypes.c_int
    if (lib.surge_scan_reduce_args_size() != ctypes.sizeof(_ScanArgs)
            or lib.surge_scan_reduce_max_out() != MAX_OUT):
        raise RuntimeError("struct ScanArgs in csrc/scan_reduce.cu and "
                           "_ScanArgs differ")
    return lib


def load() -> None:
    """Build and load the kernel library now (the first launch would)."""
    _library()
