// The scan engine's grouped reduction: per group, in event order, the count
// of matched events and the sum, min and max of any number of columns over
// them (surge_tpu_torch/replay/scan_reduce.py is its wrapper and holds the
// plain torch version).
//
// It replaces no Pallas kernel: the JAX package's scan
// (surge_tpu/replay/query.py:549-570, `.at[agg_idx].add/min/max`) is an XLA
// scatter. On the CPU that scatter adds each group's events in event order,
// and the reference's tests hold float sums bit for bit against a numpy
// oracle that does the same (`np.add.at`). CUDA's scatter and index_add_
// accumulate float32 with atomics, whose order, and so the last bits of a
// sum, changes from run to run. So this kernel walks each group's events in
// order: one thread per group, its span given by a CSR (`offsets`, and
// `order` mapping a span position to an event; null is the identity).
//
// Bound on this card: bytes (a mask byte and 4 bytes a column an event,
// read once); a thread's walk is serial, so a group's length bounds its
// time, and few large groups (a `group_by` over a column with few values)
// leave most of the card idle. A design that splits a large group across a
// warp while keeping the sequential float order is left for later.
//
// Semantics, as the reference's scan computes them:
// - a masked-out event adds nothing: the scatter adds 0 to a sum (a sum
//   that starts at +0.0 is never -0.0, so +0.0 changes nothing) and the
//   sentinel to min and max (a partial never passes its sentinel);
// - float sums are added in order, rounded to nearest, never contracted
//   (`__fadd_rn`); integer sums wrap in 32 bits;
// - min and max propagate NaN the way numpy's `minimum`/`maximum` do:
//   `acc = (acc < v || acc != acc) ? acc : v` (CUDA's fminf/fmaxf drop it);
// - an empty group keeps the sentinel: the dtype's max for min, its lowest
//   value for max.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <climits>

constexpr int kMaxOut = 16;
constexpr int kThreads = 128;

enum ScanOp : int32_t { kSum = 0, kMin = 1, kMax = 2 };
enum ScanDtype : int32_t { kI32 = 0, kF32 = 1 };

// mirrored by _ScanArgs in surge_tpu_torch/replay/scan_reduce.py
struct ScanArgs {
  int32_t n_groups;
  int32_t n_out;
  int32_t op[kMaxOut];
  int32_t dtype[kMaxOut];
  const uint8_t* mask;     // [n] bool
  const int32_t* offsets;  // [n_groups + 1]
  const int32_t* order;    // [offsets[n_groups]] or null (identity)
  int32_t* count;          // [n_groups]
  const void* col[kMaxOut];
  void* out[kMaxOut];
};

union Acc {
  float f;
  int32_t i;
};

__device__ __forceinline__ Acc init_acc(int32_t op, int32_t dtype) {
  Acc a;
  if (dtype == kF32) {
    a.f = op == kSum ? 0.0f : op == kMin ? FLT_MAX : -FLT_MAX;
  } else {
    a.i = op == kSum ? 0 : op == kMin ? INT_MAX : INT_MIN;
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
scan_reduce_kernel(const ScanArgs a) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= a.n_groups) return;
  const int lo = a.offsets[g];
  const int hi = a.offsets[g + 1];
  Acc acc[kMaxOut];
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    if (k < a.n_out) acc[k] = init_acc(a.op[k], a.dtype[k]);
  }
  int32_t cnt = 0;
  for (int i = lo; i < hi; ++i) {
    const int e = a.order != nullptr ? a.order[i] : i;
    if (!a.mask[e]) continue;
    ++cnt;
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      if (k >= a.n_out) break;
      const int32_t op = a.op[k];
      if (a.dtype[k] == kF32) {
        const float v = static_cast<const float*>(a.col[k])[e];
        const float s = acc[k].f;
        if (op == kSum) {
          acc[k].f = __fadd_rn(s, v);
        } else if (op == kMin) {
          acc[k].f = (s < v || s != s) ? s : v;
        } else {
          acc[k].f = (s > v || s != s) ? s : v;
        }
      } else {
        const int32_t v = static_cast<const int32_t*>(a.col[k])[e];
        const int32_t s = acc[k].i;
        if (op == kSum) {
          acc[k].i = static_cast<int32_t>(static_cast<uint32_t>(s) +
                                          static_cast<uint32_t>(v));
        } else if (op == kMin) {
          acc[k].i = s < v ? s : v;
        } else {
          acc[k].i = s > v ? s : v;
        }
      }
    }
  }
  a.count[g] = cnt;
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    if (k >= a.n_out) break;
    if (a.dtype[k] == kF32) {
      static_cast<float*>(a.out[k])[g] = acc[k].f;
    } else {
      static_cast<int32_t*>(a.out[k])[g] = acc[k].i;
    }
  }
}

extern "C" {

int surge_scan_reduce_args_size() { return static_cast<int>(sizeof(ScanArgs)); }

int surge_scan_reduce_max_out() { return kMaxOut; }

// One launch: every group's count and outputs. Returns cudaGetLastError()
// of the launch (0 on success).
int surge_scan_reduce(const ScanArgs* args, cudaStream_t stream) {
  if (args->n_groups <= 0) return 0;
  if (args->n_out < 0 || args->n_out > kMaxOut) return cudaErrorInvalidValue;
  const int blocks = (args->n_groups + kThreads - 1) / kThreads;
  scan_reduce_kernel<<<blocks, kThreads, 0, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
