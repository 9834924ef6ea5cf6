// K1 — the resident tile scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel surge_tpu/replay/pallas_fold.py:make_tile_scan
// (its pl.pallas_call at pallas_fold.py:86): for each lane b and each step
// t < width it decodes words[t, b] (type bits, bit-packed fields, side values,
// the derived ordinal ord_rel[b] + t + 1; padding when t >= lens_rel[b]) and
// applies the model's branchless select step to the lane's carry.
//
// Design. One thread per lane, blocks of kThreads lanes, a grid of
// ceil(bs / kThreads); the ragged edge is masked here, so bs needs no
// power-of-two divisor. The carry lives in registers for all width steps.
// The input is time-major, so step t reads words[t * bs + lane] and each row
// is read coalesced across a warp. Decode is generic and follows the wire's
// layout, passed in DecodeArgs; the step is a per-model device functor chosen
// by the spec's kernel_step. Integer sums use unsigned arithmetic (wrapping,
// as int32 wraps in the reference); f32 state is carried as its bit pattern,
// so a copy is exact; a bool state is one byte.
//
// Bound. At the bench tile (width 64, bs 8192) one launch moves about 2.3 MB
// (u32 words 2.1 MB, plus lens, ordinals and the carry in and out) and does a
// few integer operations per byte: memory-bound, about 0.7 us at 3.35 TB/s.
// So the launch latency and the host loop over a few hundred tiles are the
// real limit; fusing the gather, CUDA graphs or reading the 1-byte wire
// directly are the answers, left for later work.
//
// Interface: a plain C function (surge_tile_scan) that launches on the given
// stream and returns the cudaError_t of the launch; loaded with ctypes by
// surge_tpu_torch/replay/fold_kernels.py.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace surge_k1 {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;
constexpr int kMaxState = 8;

// where a union column's value comes from
enum ColKind : int32_t { kPacked = 0, kSide = 1, kOrdinal = 2 };
// how a state column is stored: 4-byte word (i32 or f32 bits) or 1-byte bool
enum StateKind : int32_t { kWord = 0, kByte = 1 };

// the wire layout, one entry per union column in the model's column order
// (mirrored by a ctypes.Structure in fold_kernels.py — keep both in step)
struct DecodeArgs {
  int32_t type_bits;
  int32_t num_types;
  int32_t n_cols;
  int32_t kind[kMaxCols];
  int32_t shift[kMaxCols];
  uint32_t mask[kMaxCols];
  const uint32_t* side[kMaxCols];  // [width, bs] 4-byte columns, time-major
};

struct StateArgs {
  int32_t n_state;
  int32_t kind[kMaxState];
  const void* in[kMaxState];  // [bs]
  void* out[kMaxState];       // [bs]
};

// counter (surge_tpu_torch/models/counter.py): columns decrement_by,
// increment_by, sequence_number; state count, version
struct CounterStep {
  static constexpr int kCols = 3;
  static constexpr int kState = 2;
  __device__ static void apply(uint32_t (&st)[kState], int tid,
                               const uint32_t (&ev)[kCols]) {
    if (tid == 0) {         // CountIncremented
      st[0] = st[0] + ev[1];
      st[1] = ev[2];
    } else if (tid == 1) {  // CountDecremented
      st[0] = st[0] - ev[0];
      st[1] = ev[2];
    } else if (tid == 3) {  // UnserializableEvent: version only
      st[1] = ev[2];
    }                       // NoOpEvent (2) and padding (-1): carry through
  }
};

// bank_account (surge_tpu_torch/models/bank_account.py): columns balance,
// new_balance, owner_code, security_code_code; state created, owner_code,
// security_code_code, balance
struct BankAccountStep {
  static constexpr int kCols = 4;
  static constexpr int kState = 4;
  __device__ static void apply(uint32_t (&st)[kState], int tid,
                               const uint32_t (&ev)[kCols]) {
    if (tid == 0) {         // EncodedCreated replaces the state
      st[0] = 1u;
      st[1] = ev[2];
      st[2] = ev[3];
      st[3] = ev[0];
    } else if (tid == 1) {  // EncodedUpdated: balance, only if created
      if (st[0] != 0u) st[3] = ev[1];
    }
  }
};

template <class Step>
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const DecodeArgs dec, const StateArgs sa,
                 const uint32_t* __restrict__ words,
                 const int32_t* __restrict__ lens_rel,
                 const int32_t* __restrict__ ord_rel, int width, int bs) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= bs) return;

  uint32_t st[Step::kState];
#pragma unroll
  for (int i = 0; i < Step::kState; ++i) {
    st[i] = sa.kind[i] == kByte
                ? static_cast<uint32_t>(
                      static_cast<const uint8_t*>(sa.in[i])[lane] != 0)
                : static_cast<const uint32_t*>(sa.in[i])[lane];
  }
  const int32_t len = lens_rel[lane];
  const uint32_t ord = static_cast<uint32_t>(ord_rel[lane]);
  const uint32_t type_mask = (1u << dec.type_bits) - 1u;

  for (int t = 0; t < width; ++t) {
    const size_t row = static_cast<size_t>(t) * bs + lane;
    const uint32_t w = words[row];
    int tid = static_cast<int>(w & type_mask);
    if (tid >= dec.num_types || t >= len) tid = -1;
    uint32_t ev[Step::kCols];
#pragma unroll
    for (int c = 0; c < Step::kCols; ++c) {
      const int32_t k = dec.kind[c];
      ev[c] = k == kPacked ? (w >> dec.shift[c]) & dec.mask[c]
            : k == kSide   ? dec.side[c][row]
                           : ord + static_cast<uint32_t>(t) + 1u;
    }
    Step::apply(st, tid, ev);
  }

#pragma unroll
  for (int i = 0; i < Step::kState; ++i) {
    if (sa.kind[i] == kByte) {
      static_cast<uint8_t*>(sa.out[i])[lane] = st[i] != 0u ? 1 : 0;
    } else {
      static_cast<uint32_t*>(sa.out[i])[lane] = st[i];
    }
  }
}

template <class Step>
int launch(const DecodeArgs* dec, const StateArgs* sa, const uint32_t* words,
           const int32_t* lens_rel, const int32_t* ord_rel, int width, int bs,
           cudaStream_t stream) {
  if (dec->n_cols != Step::kCols || sa->n_state != Step::kState) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((bs + kThreads - 1) / kThreads);
  tile_scan_kernel<Step><<<grid, kThreads, 0, stream>>>(
      *dec, *sa, words, lens_rel, ord_rel, width, bs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace surge_k1

using surge_k1::BankAccountStep;
using surge_k1::CounterStep;
using surge_k1::DecodeArgs;
using surge_k1::StateArgs;

// the C interface: the parameter types live in a named namespace, so these
// keep external linkage
extern "C" {

// step ids, in the order of fold_kernels.KERNEL_STEPS: 0 counter, 1 bank_account
int surge_tile_scan_shape(int step, int* n_cols, int* n_state) {
  switch (step) {
    case 0: *n_cols = CounterStep::kCols; *n_state = CounterStep::kState; return 0;
    case 1: *n_cols = BankAccountStep::kCols; *n_state = BankAccountStep::kState; return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int surge_tile_scan(int step, int width, int bs, const uint32_t* words,
                    const int32_t* lens_rel, const int32_t* ord_rel,
                    const DecodeArgs* dec, const StateArgs* sa, void* stream) {
  if (bs <= 0 || width < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (step) {
    case 0:
      return surge_k1::launch<CounterStep>(dec, sa, words, lens_rel, ord_rel, width, bs, s);
    case 1:
      return surge_k1::launch<BankAccountStep>(dec, sa, words, lens_rel, ord_rel, width, bs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
