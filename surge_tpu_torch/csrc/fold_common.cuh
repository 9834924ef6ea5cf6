// The decode, the model steps and the slab-by-slot window helpers shared by
// the fold kernels K1 (tile_scan.cu) and K2 (ragged_fold.cu).
//
// Every kernel decodes one packed wire word per event (type bits, bit-packed
// fields, side values, the derived ordinal) and applies the model's
// branchless select step to a lane's carry held in registers. The wire layout
// arrives as DecodeArgs; the step is a per-model device functor chosen by
// ReplaySpec.kernel_step. Integer sums use unsigned arithmetic (wrapping, as
// int32 wraps in the reference); f32 state is carried as its bit pattern, so
// a copy is exact; a bool state is one byte.
//
// The two refresh-window kernels (K1's dense window, K2's ragged window) read
// and write the resident state slab by slot: SlabArgs carries the slab, its
// per-slot ordinals and one window's lane table (LaneRow), and load_slot /
// store_slot do the admission select, the slot-indexed carry load and store,
// and the ordinal update of the reference's window program.
//
// DecodeArgs, StateArgs and SlabArgs are mirrored by ctypes.Structures in
// surge_tpu_torch/replay/fold_kernels.py, whose loader checks their sizes
// (struct_size): keep both in step. They live in a named namespace so the
// extern "C" entry points that take them keep external linkage.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace surge_fold {

constexpr int kThreads = 256;
// union columns and state fields a model may have (saga: 9 and 12)
constexpr int kMaxCols = 12;
constexpr int kMaxState = 12;
// lanes per block of the two refresh-window kernels: 64 timed fastest of 64,
// 128 and 256 at the plane's windows on an H100 (PERF.md, Findings: the
// block-size sweep)
constexpr int kWindowLanes = 64;
// rows a lane loads from device memory ahead of the dependent steps
constexpr int kPrefetch = 8;

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

// shopping_cart (surge_tpu_torch/models/shopping_cart.py): columns
// item_code, quantity, sequence_number, unit_price_cents; state item_count,
// total_cents, checked_out (bool), version. quantity * unit_price_cents is
// the u32 product, which wraps as the reference's int32 product does
struct ShoppingCartStep {
  static constexpr int kCols = 4;
  static constexpr int kState = 4;
  __device__ static void apply(uint32_t (&st)[kState], int tid,
                               const uint32_t (&ev)[kCols]) {
    if (tid == 0) {         // ItemAdded
      st[0] = st[0] + ev[1];
      st[1] = st[1] + ev[1] * ev[3];
      st[3] = ev[2];
    } else if (tid == 1) {  // ItemRemoved
      st[0] = st[0] - ev[1];
      st[1] = st[1] - ev[1] * ev[3];
      st[3] = ev[2];
    } else if (tid == 2) {  // CheckedOut
      st[2] = 1u;
      st[3] = ev[2];
    }
  }
};

// 1 << n as the reference's jnp.left_shift gives it for an int32 n: 0 for a
// shift outside [0, 32) (a negative n is a large u32 here), where C++'s own
// shift would be undefined
__device__ __forceinline__ uint32_t shl1(uint32_t n) {
  return n < 32u ? 1u << n : 0u;
}

// saga (surge_tpu_torch/saga/model.py): columns attempts, c0, c1, c2, c3,
// def_id, num_steps, sequence_number, step; state def_id, num_steps, status,
// step, committed, compensated, attempts, c0, c1, c2, c3, version. The
// float32 context slots c0..c3 are copied as bit patterns
struct SagaStep {
  static constexpr int kCols = 9;
  static constexpr int kState = 12;
  // the status enum (surge_tpu_torch/saga/model.py)
  enum : uint32_t {
    kRunning = 0, kCompensating = 1, kCompleted = 2, kCompensated = 3,
    kDeadLetter = 4
  };
  __device__ static void apply(uint32_t (&st)[kState], int tid,
                               const uint32_t (&ev)[kCols]) {
    if (tid == 0) {         // SagaStarted replaces the state
      st[0] = ev[5];
      st[1] = ev[6];
      st[2] = kRunning;
      st[3] = st[4] = st[5] = st[6] = 0u;
      st[7] = ev[1];
      st[8] = ev[2];
      st[9] = ev[3];
      st[10] = ev[4];
      st[11] = ev[7];
    } else if (tid == 1) {  // SagaStepCommitted
      const uint32_t committed = st[4] | shl1(ev[8]);
      st[2] = committed == shl1(st[1]) - 1u ? kCompleted : kRunning;
      st[3] = ev[8] + 1u;
      st[4] = committed;
      st[6] = 0u;
      st[11] = ev[7];
    } else if (tid == 2) {  // SagaStepFailed
      st[2] = st[4] == 0u ? kCompensated : kCompensating;
      st[6] = ev[0];
      st[11] = ev[7];
    } else if (tid == 3) {  // SagaStepCompensated
      const uint32_t compensated = st[5] | shl1(ev[8]);
      st[2] = compensated == st[4] ? kCompensated : kCompensating;
      st[5] = compensated;
      st[11] = ev[7];
    } else if (tid == 4) {  // SagaDeadLettered
      st[2] = kDeadLetter;
      st[11] = ev[7];
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

// the rows of a refresh window's lane table: int32 [rows, lanes], one upload
// per window (fold_kernels.window_table). The admission rows follow only on
// a plan's first window (SlabArgs.admit); each admitted value is its field's
// 32-bit pattern (a bool as 0 or 1).
enum LaneRow : int32_t {
  kRowSlot = 0,      // the lane's slab slot; the scratch row `capacity` pads
  kRowCount = 1,     // events the window folds into the lane
  kRowStart = 2,     // first flat row of the lane's window (ragged)
  kRowAdmit = 3,     // 1: the lane starts from its admitted row
  kRowAdmitOrd = 4,  // the admitted ordinal base
  kRowAdmitVal = 5,  // the admitted values, one row per state field
};

// the resident slab and one refresh window's lane table
struct SlabArgs {
  int32_t n_state;
  int32_t kind[kMaxState];
  void* col[kMaxState];   // slab columns [capacity + 1], read and written by slot
  int32_t* ords;          // [capacity + 1] per-slot ordinal bases
  const int32_t* table;   // [kRowAdmitVal + n_state (admit) or kRowAdmit, lanes]
  int32_t capacity;       // the scratch row's slot: a lane there is padding
  int32_t lanes;          // lanes in the window
  int32_t admit;          // 1: the table holds the admission rows
};

// one lane of a refresh window
struct Lane {
  int32_t slot;
  int32_t count;
  bool admitted;
  bool live;  // not padding: padding lanes target the scratch row, which no
              // gather reads, so they load and store nothing
};

// the path a window kernel's block took, reported for each of its lanes
// into the caller's int8 buffer when it passes one
enum WindowPath : int8_t { kPathNone = -1, kPathGlobal = 0, kPathStaged = 1 };

__device__ __forceinline__ void report_path(int8_t* paths, int lane, int lanes,
                                            WindowPath path) {
  if (paths != nullptr && lane < lanes) paths[lane] = path;
}

__device__ __forceinline__ int32_t table_at(const SlabArgs& sa, int row,
                                            int lane) {
  return sa.table[static_cast<size_t>(row) * sa.lanes + lane];
}

// the lane's slot; a live lane's count and admit flag (a padding lane's
// are never read)
__device__ __forceinline__ Lane lane_of(const SlabArgs& sa, int lane) {
  Lane l{table_at(sa, kRowSlot, lane), 0, false, false};
  l.live = l.slot != sa.capacity;
  if (l.live) {
    l.count = table_at(sa, kRowCount, lane);
    l.admitted = sa.admit != 0 && table_at(sa, kRowAdmit, lane) != 0;
  }
  return l;
}

// The lane's carry and ordinal base (returned). An admitted lane starts from
// its admitted values and ordinal: the reference scatters the admission into
// the slab and then gathers the lanes' slots, which is the same because every
// admitted slot is a lane of its plan. Any other lane starts from its slot.
template <class Step>
__device__ __forceinline__ uint32_t load_slot(const SlabArgs& sa, int lane,
                                              const Lane& l,
                                              uint32_t (&st)[Step::kState]) {
  if (l.admitted) {
#pragma unroll
    for (int i = 0; i < Step::kState; ++i) {
      const uint32_t v = static_cast<uint32_t>(table_at(sa, kRowAdmitVal + i, lane));
      st[i] = sa.kind[i] == kByte ? static_cast<uint32_t>(v != 0u) : v;
    }
    return static_cast<uint32_t>(table_at(sa, kRowAdmitOrd, lane));
  }
#pragma unroll
  for (int i = 0; i < Step::kState; ++i) {
    st[i] = sa.kind[i] == kByte
                ? static_cast<uint32_t>(
                      static_cast<const uint8_t*>(sa.col[i])[l.slot] != 0)
                : static_cast<const uint32_t*>(sa.col[i])[l.slot];
  }
  return static_cast<uint32_t>(sa.ords[l.slot]);
}

// The folded carry back into the lane's slot, and the slot's ordinal base
// advanced by the window's count (wrapping, as the reference's int32 add).
template <class Step>
__device__ __forceinline__ void store_slot(const SlabArgs& sa, const Lane& l,
                                           const uint32_t (&st)[Step::kState],
                                           uint32_t base) {
#pragma unroll
  for (int i = 0; i < Step::kState; ++i) {
    if (sa.kind[i] == kByte) {
      static_cast<uint8_t*>(sa.col[i])[l.slot] = st[i] != 0u ? 1 : 0;
    } else {
      static_cast<uint32_t*>(sa.col[i])[l.slot] = st[i];
    }
  }
  sa.ords[l.slot] = static_cast<int32_t>(base + static_cast<uint32_t>(l.count));
}

// the little-endian u32 word of NB wire bytes (NB a compile-time constant:
// a runtime byte loop doubles a fold's time on the card)
template <int NB>
__device__ __forceinline__ uint32_t load_word(const uint8_t* p) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < NB; ++b) w |= static_cast<uint32_t>(p[b]) << (8 * b);
  return w;
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

// Fold steps t in [t0, t1) of one lane straight from device memory: step t
// decodes the NB wire bytes of row row_of(t) (its side values at the same
// row) with the derived ordinal ob + t + 1. The loads of kPrefetch rows are
// issued before the dependent steps use them.
template <class Step, int NB, class RowOf>
__device__ __forceinline__ void fold_rows_global(const DecodeArgs& dec,
                                                 uint32_t (&st)[Step::kState],
                                                 const uint8_t* words, int t0,
                                                 int t1, RowOf row_of,
                                                 uint32_t ob) {
  for (int t = t0; t < t1; t += kPrefetch) {
    uint32_t w[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      w[u] = t + u < t1
                 ? load_word<NB>(words + static_cast<size_t>(row_of(t + u)) * NB)
                 : 0u;
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      if (t + u < t1) {
        fold_word<Step>(dec, st, w[u], static_cast<size_t>(row_of(t + u)), true,
                        ob + static_cast<uint32_t>(t + u) + 1u);
      }
    }
  }
}

// The step ids of the C interfaces, in the order of
// fold_kernels.KERNEL_STEPS: 0 counter, 1 bank_account, 2 shopping_cart,
// 3 saga. Returns f(Step{}) for the id's step functor, or
// cudaErrorInvalidValue for an unknown id.
template <class F>
inline int with_step(int step, F&& f) {
  switch (step) {
    case 0: return f(CounterStep{});
    case 1: return f(BankAccountStep{});
    case 2: return f(ShoppingCartStep{});
    case 3: return f(SagaStep{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline int step_shape(int step, int* n_cols, int* n_state) {
  return with_step(step, [&](auto s) {
    *n_cols = decltype(s)::kCols;
    *n_state = decltype(s)::kState;
    return 0;
  });
}

// the size of each mirrored struct (0 DecodeArgs, 1 StateArgs, 2 SlabArgs),
// so the ctypes mirrors can be checked against them
inline int struct_size(int which) {
  switch (which) {
    case 0: return static_cast<int>(sizeof(DecodeArgs));
    case 1: return static_cast<int>(sizeof(StateArgs));
    case 2: return static_cast<int>(sizeof(SlabArgs));
    default: return -1;
  }
}

}  // namespace surge_fold
