// K2 — the ragged refresh window, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// surge_tpu/replay/pallas_fold.py:make_ragged_fold (its pl.pallas_call at
// pallas_fold.py:170) together with the rest of the reference's bucketed
// window program (surge_tpu/replay/resident_state.py:_ragged_program): one
// launch runs a whole refresh window against the resident slab, by slot.
// Lane b of the window (its lane table, fold_common.cuh LaneRow):
// 1. starts from its admitted values and ordinal when the table admits it
//    (a plan's first window), else from slab[slot[b]] and ords[slot[b]];
// 2. folds steps t < min(count[b], width), step t reading flat row
//    clamp(start[b] + t, 0, rows - 1) of the packed wire words[rows, NB]
//    (and side[c][rows]), with the derived ordinal base + t + 1; a step past
//    the count is padding, which carries the state through, so the lane stops;
// 3. stores its carry to slab[slot[b]] and sets ords[slot[b]] = base + count
//    (wrapping). Padding lanes (slot == capacity, the scratch row no gather
//    reads) load and store nothing.
//
// Design. The plane packs a bucket lane-contiguous (starts are the exclusive
// cumsum of the lane lengths, shifted by the window's offset), so the rows a
// block's lanes read form one span [lo, hi] of the flat buffer. The block
// reduces lo and hi over its lanes, stages the span's wire bytes and side
// values into shared memory with 16-byte loads (adjacent threads on adjacent
// addresses), and then every lane folds out of shared memory: the reads of
// adjacent lanes, a lane's length apart, no longer go to device memory one
// uncoalesced word at a time. A span larger than the launch's shared memory
// (a chained window of long lanes: the rows between two lanes' windows are
// in the span too) takes the in-kernel global path instead: each lane loads
// its rows from device memory, kPrefetch ahead of its dependent steps. The
// path is chosen per block, uniformly; both read the same clamped rows, and
// the launch reports each block's choice when the caller asks. Blocks are
// kWindowLanes (64) lanes, so a steady bucket of 4,096 lanes spreads over 64
// SMs.
//
// Bound. A launch needs the wire bytes and side values of the rows its lanes
// fold, every lane's slot, each live lane's count, start (and admit flag),
// an admitted lane's ordinal and values, and each live lane's carry and
// ordinal in and out by slot (chip_smoke.py window_work counts them); the
// launch's latency and the longest lane's dependent steps set its time.
//
// Interface: a plain C function (surge_ragged_window) that launches on the
// given stream and returns the cudaError_t of the launch; loaded with ctypes
// by surge_tpu_torch/replay/fold_kernels.py, which checks every argument
// (the words and side columns start on 16 bytes).

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "fold_common.cuh"

namespace surge_k2 {

using namespace surge_fold;

// the most shared memory a block stages its span into; a larger span takes
// the global-read path
constexpr int64_t kSpanCap = 96 * 1024;

__host__ __device__ __forceinline__ int64_t pad16(int64_t n) {
  return (n + 15) & ~int64_t{15};
}

__device__ __forceinline__ int64_t clamp_row(int64_t r, int rows) {
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// copy nbytes from the 16-byte aligned src to dst, all threads of the block:
// 16-byte loads, then the odd tail (only at the buffer's end) byte by byte
__device__ __forceinline__ void stage_bytes(unsigned char* dst,
                                            const unsigned char* src,
                                            int64_t nbytes) {
  const int64_t n16 = nbytes / 16;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < n16; i += kWindowLanes) {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
  for (int64_t i = n16 * 16 + threadIdx.x; i < nbytes; i += kWindowLanes) {
    dst[i] = src[i];
  }
}

template <class Step, int NB>
__global__ void __launch_bounds__(kWindowLanes)
ragged_window_kernel(const SlabArgs sa, const DecodeArgs dec,
                     const uint8_t* __restrict__ words, int width, int rows,
                     int span_bytes, int8_t* paths) {
  extern __shared__ __align__(16) unsigned char span_mem[];
  __shared__ int32_t warp_lo[kWindowLanes / 32], warp_hi[kWindowLanes / 32];

  const int j = threadIdx.x;
  const int lane = blockIdx.x * kWindowLanes + j;
  Lane l{0, 0, false, false};
  int64_t start = 0;
  if (lane < sa.lanes) {
    l = lane_of(sa, lane);
    if (l.live) start = table_at(sa, kRowStart, lane);
  }
  if (!__syncthreads_or(l.live)) {  // every lane pads
    report_path(paths, lane, sa.lanes, kPathNone);
    return;
  }

  const int n = l.live ? min(max(l.count, 0), width) : 0;
  uint32_t st[Step::kState];
  uint32_t base = 0;
  if (l.live) base = load_slot<Step>(sa, lane, l, st);

  // the rows the block reads: clamp(start + t) for t < n lies in
  // [clamp(start), clamp(start + n - 1)], clamp being monotone
  int lo = INT_MAX, hi = -1;
  if (n > 0) {
    lo = static_cast<int>(clamp_row(start, rows));
    hi = static_cast<int>(clamp_row(start + n - 1, rows));
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((j & 31) == 0) {
    warp_lo[j >> 5] = lo;
    warp_hi[j >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWindowLanes / 32; ++w) {
    lo = min(lo, warp_lo[w]);
    hi = max(hi, warp_hi[w]);
  }

  // the staged regions: the words' bytes [b0, b0 + wlen) and each side
  // column's rows [s0, s0 + slen), widened to 16 bytes (within the buffer)
  // so the copies are aligned; each region starts on 16 bytes
  int n_side = 0;
#pragma unroll
  for (int c = 0; c < Step::kCols; ++c) n_side += dec.kind[c] == kSide;
  bool staged = false;
  int64_t b0 = 0, s0 = 0, wlen = 0, slen = 0;
  if (hi >= lo) {
    b0 = (static_cast<int64_t>(lo) * NB) & ~int64_t{15};
    wlen = min64(pad16((static_cast<int64_t>(hi) + 1) * NB),
                 static_cast<int64_t>(rows) * NB) - b0;
    s0 = static_cast<int64_t>(lo) & ~int64_t{3};
    slen = min64((static_cast<int64_t>(hi) + 4) & ~int64_t{3},
                 static_cast<int64_t>(rows)) - s0;
    staged = pad16(wlen) + n_side * pad16(slen * 4) <= span_bytes;
  }
  report_path(paths, lane, sa.lanes,
              hi < lo ? kPathNone : (staged ? kPathStaged : kPathGlobal));
  const unsigned char* side_mem[Step::kCols];
  if (staged) {
    stage_bytes(span_mem, words + b0, wlen);
    unsigned char* p = span_mem + pad16(wlen);
#pragma unroll
    for (int c = 0; c < Step::kCols; ++c) {
      side_mem[c] = p;
      if (dec.kind[c] == kSide) {
        stage_bytes(p, reinterpret_cast<const unsigned char*>(dec.side[c] + s0),
                    slen * 4);
        p += pad16(slen * 4);
      }
    }
    __syncthreads();
  }
  if (!l.live) return;

  if (staged) {
    DecodeArgs d = dec;  // side values read from the staged span
#pragma unroll
    for (int c = 0; c < Step::kCols; ++c) {
      if (dec.kind[c] == kSide) {
        d.side[c] = reinterpret_cast<const uint32_t*>(side_mem[c]);
      }
    }
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const int64_t r = clamp_row(start + t, rows);
      fold_word<Step>(d, st, load_word<NB>(span_mem + (r * NB - b0)),
                      static_cast<size_t>(r - s0), true,
                      base + static_cast<uint32_t>(t) + 1u);
    }
  } else {
    fold_rows_global<Step, NB>(
        dec, st, words, 0, n, [&](int t) { return clamp_row(start + t, rows); },
        base);
  }
  store_slot<Step>(sa, l, st, base);
}

template <class Step, int NB>
int launch_nb(const SlabArgs* sa, const DecodeArgs* dec, const uint8_t* words,
              int width, int rows, int8_t* paths, cudaStream_t stream) {
  // a block's shared memory: its lanes' rows when they lie back to back
  // (kWindowLanes x width rows of wire bytes and side values, plus each
  // region's 16-byte widening), at most kSpanCap
  int n_side = 0;
  for (int c = 0; c < dec->n_cols; ++c) n_side += dec->kind[c] == kSide;
  const int64_t rows_b = static_cast<int64_t>(kWindowLanes) * width;
  int64_t need = pad16(rows_b * NB + 32) + n_side * pad16(rows_b * 4 + 48);
  const int span_bytes = static_cast<int>(need < kSpanCap ? need : kSpanCap);
  auto kernel = ragged_window_kernel<Step, NB>;
  if (span_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, span_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((sa->lanes + kWindowLanes - 1) / kWindowLanes);
  kernel<<<grid, kWindowLanes, span_bytes, stream>>>(*sa, *dec, words, width,
                                                     rows, span_bytes, paths);
  return static_cast<int>(cudaGetLastError());
}

template <class Step>
int launch(const SlabArgs* sa, const DecodeArgs* dec, const uint8_t* words,
           int nbytes, int width, int rows, int8_t* paths, cudaStream_t stream) {
  if (dec->n_cols != Step::kCols || sa->n_state != Step::kState) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return with_wire_bytes<Step>(nbytes, [&](auto nb) {
    return launch_nb<Step, decltype(nb)::value>(sa, dec, words, width, rows,
                                                paths, stream);
  });
}

}  // namespace surge_k2

using surge_fold::DecodeArgs;
using surge_fold::SlabArgs;

// the C interface: the parameter types live in a named namespace, so these
// keep external linkage
extern "C" {

// step ids, in the order of fold_kernels.KERNEL_STEPS, then 4 for MixedStep
// (surge_fold::with_step)
int surge_ragged_fold_shape(int step, int* n_cols, int* n_state) {
  return surge_fold::step_shape(step, n_cols, n_state);
}

int surge_ragged_fold_struct_size(int which) {
  return surge_fold::struct_size(which);
}

// MixedStep's maps of part `part` (surge_fold::part_map)
int surge_ragged_fold_part_map(int part, int* cols, int* fields) {
  return surge_fold::part_map(part, cols, fields);
}

// one ragged refresh window: words u8 [rows, nbytes]; paths, when not null,
// int8 [lanes]: each lane's block's path (WindowPath)
int surge_ragged_window(int step, const SlabArgs* sa, const DecodeArgs* dec,
                        const uint8_t* words, int nbytes, int width, int rows,
                        int8_t* paths, void* stream) {
  if (sa->lanes <= 0 || rows <= 0 || width < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return surge_fold::with_step(step, [&](auto st) {
    return surge_k2::launch<decltype(st)>(sa, dec, words, nbytes, width, rows,
                                          paths, s);
  });
}

}  // extern "C"
