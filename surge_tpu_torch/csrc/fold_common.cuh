// The decode and the model steps shared by the fold kernels K1
// (tile_scan.cu) and K2 (ragged_fold.cu).
//
// Both kernels decode one packed u32 wire word per event (type bits,
// bit-packed fields, side values, the derived ordinal) and apply the model's
// branchless select step to a lane's carry held in registers. The wire layout
// arrives as DecodeArgs; the step is a per-model device functor chosen by
// ReplaySpec.kernel_step. Integer sums use unsigned arithmetic (wrapping, as
// int32 wraps in the reference); f32 state is carried as its bit pattern, so
// a copy is exact; a bool state is one byte.
//
// DecodeArgs and StateArgs are mirrored by ctypes.Structures in
// surge_tpu_torch/replay/fold_kernels.py: keep both in step. They live in a
// named namespace so the extern "C" entry points that take them keep
// external linkage.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace surge_fold {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;
constexpr int kMaxState = 8;

// where a union column's value comes from
enum ColKind : int32_t { kPacked = 0, kSide = 1, kOrdinal = 2 };
// how a state column is stored: 4-byte word (i32 or f32 bits) or 1-byte bool
enum StateKind : int32_t { kWord = 0, kByte = 1 };

// the wire layout, one entry per union column in the model's column order.
// side[c] is a 4-byte column; each kernel says how it is indexed (K1: the
// time-major tile [width, bs]; K2: the flat event rows [rows]).
struct DecodeArgs {
  int32_t type_bits;
  int32_t num_types;
  int32_t n_cols;
  int32_t kind[kMaxCols];
  int32_t shift[kMaxCols];
  uint32_t mask[kMaxCols];
  const uint32_t* side[kMaxCols];
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
__device__ __forceinline__ void load_carry(const StateArgs& sa, int lane,
                                           uint32_t (&st)[Step::kState]) {
#pragma unroll
  for (int i = 0; i < Step::kState; ++i) {
    st[i] = sa.kind[i] == kByte
                ? static_cast<uint32_t>(
                      static_cast<const uint8_t*>(sa.in[i])[lane] != 0)
                : static_cast<const uint32_t*>(sa.in[i])[lane];
  }
}

template <class Step>
__device__ __forceinline__ void store_carry(const StateArgs& sa, int lane,
                                            const uint32_t (&st)[Step::kState]) {
#pragma unroll
  for (int i = 0; i < Step::kState; ++i) {
    if (sa.kind[i] == kByte) {
      static_cast<uint8_t*>(sa.out[i])[lane] = st[i] != 0u ? 1 : 0;
    } else {
      static_cast<uint32_t*>(sa.out[i])[lane] = st[i];
    }
  }
}

// Decode one event word and apply the step. side_row indexes the side
// columns; valid false (a slot past the lane's length) and type ids at or
// above num_types decode to padding (-1), which carries the state through.
// ordinal is the derived ordinal of this step (wrapping u32).
template <class Step>
__device__ __forceinline__ void fold_word(const DecodeArgs& dec,
                                          uint32_t (&st)[Step::kState],
                                          uint32_t w, size_t side_row,
                                          bool valid, uint32_t ordinal) {
  const uint32_t type_mask = (1u << dec.type_bits) - 1u;
  int tid = static_cast<int>(w & type_mask);
  if (tid >= dec.num_types || !valid) tid = -1;
  uint32_t ev[Step::kCols];
#pragma unroll
  for (int c = 0; c < Step::kCols; ++c) {
    const int32_t k = dec.kind[c];
    ev[c] = k == kPacked ? (w >> dec.shift[c]) & dec.mask[c]
          : k == kSide   ? dec.side[c][side_row]
                         : ordinal;
  }
  Step::apply(st, tid, ev);
}

// the step ids of the C interfaces, in the order of
// fold_kernels.KERNEL_STEPS: 0 counter, 1 bank_account
inline int step_shape(int step, int* n_cols, int* n_state) {
  switch (step) {
    case 0: *n_cols = CounterStep::kCols; *n_state = CounterStep::kState; return 0;
    case 1: *n_cols = BankAccountStep::kCols; *n_state = BankAccountStep::kState; return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace surge_fold
