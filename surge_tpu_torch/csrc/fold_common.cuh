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
// A combined spec (surge_tpu_torch/replay/mixed.py) folds through MixedStep,
// C step id 4: its columns and state fields are those of the four-family
// union, sorted by name (fold_kernels.MIXED_COLS, MIXED_STATE), each slot
// absent where the spec's own union lacks it. The event's type id picks the
// part by its range (DecodeArgs.part_base, part_types, launch parameters);
// the part's own step is applied to its columns and fields, gathered from the
// union slots and written back through maps fixed at compile time (MixedPart),
// so no register array is indexed at run time.
//
// DecodeArgs, StateArgs and SlabArgs are mirrored by ctypes.Structures in
// surge_tpu_torch/replay/fold_kernels.py, whose loader checks their sizes
// (struct_size): keep both in step. They live in a named namespace so the
// extern "C" entry points that take them keep external linkage.

#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace surge_fold {

constexpr int kThreads = 256;
// union columns and state fields a step may have: MixedStep's, the union of
// the four families (the saga alone has 9 and 12)
constexpr int kMaxCols = 18;
constexpr int kMaxState = 20;
// the families MixedStep carries, in the order of the step ids 0-3
constexpr int kParts = 4;
// lanes per block of the two refresh-window kernels: 64 timed fastest of 64,
// 128 and 256 at the plane's windows on an H100 (PERF.md, Findings: the
// block-size sweep)
constexpr int kWindowLanes = 64;
// rows a lane loads from device memory ahead of the dependent steps
constexpr int kPrefetch = 8;

// where a union column's value comes from (kAbsentCol: a MixedStep slot the
// spec's union lacks; it decodes to 0)
enum ColKind : int32_t { kPacked = 0, kSide = 1, kOrdinal = 2, kAbsentCol = 3 };
// how a state column is stored: 4-byte word (i32 or f32 bits) or 1-byte bool
// (kAbsentField: a MixedStep slot the spec lacks; loaded as 0, never stored)
enum StateKind : int32_t { kWord = 0, kByte = 1, kAbsentField = 2 };

// the wire layout, one entry per union column in the model's column order.
// side[c] is a 4-byte column; each kernel says how it is indexed (K1: the
// time-major tile [width, bs]; K2: the flat event rows [rows]). MixedStep
// reads part p's events at type ids [part_base[p], part_base[p] +
// part_types[p]) (0 types: the part is not in the spec).
struct DecodeArgs {
  int32_t type_bits;
  int32_t num_types;
  int32_t n_cols;
  int32_t kind[kMaxCols];
  int32_t shift[kMaxCols];
  uint32_t mask[kMaxCols];
  const uint32_t* side[kMaxCols];
  int32_t part_base[kParts];
  int32_t part_types[kParts];
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

// The combined spec's step: the union of the four families. Column slots
// (sorted names): 0 attempts, 1 balance, 2-5 c0-c3, 6 decrement_by, 7 def_id,
// 8 increment_by, 9 item_code, 10 new_balance, 11 num_steps, 12 owner_code,
// 13 quantity, 14 security_code_code, 15 sequence_number, 16 step,
// 17 unit_price_cents. State slots: 0 attempts, 1 balance, 2-5 c0-c3,
// 6 checked_out, 7 committed, 8 compensated, 9 count, 10 created, 11 def_id,
// 12 item_count, 13 num_steps, 14 owner_code, 15 security_code_code,
// 16 status, 17 step, 18 total_cents, 19 version.
struct MixedStep {
  static constexpr int kCols = kMaxCols;
  static constexpr int kState = kMaxState;
};

template <class Step>
constexpr bool kIsMixed = false;
template <>
constexpr bool kIsMixed<MixedStep> = true;

// part p of MixedStep: its step functor and the union slot of each of its
// columns and state fields (in the functor's order)
template <int P>
struct MixedPart;
template <>
struct MixedPart<0> {
  using Step = CounterStep;
  __host__ __device__ static constexpr int col(int c) {
    constexpr int m[] = {6, 8, 15};
    return m[c];
  }
  __host__ __device__ static constexpr int field(int i) {
    constexpr int m[] = {9, 19};
    return m[i];
  }
};
template <>
struct MixedPart<1> {
  using Step = BankAccountStep;
  __host__ __device__ static constexpr int col(int c) {
    constexpr int m[] = {1, 10, 12, 14};
    return m[c];
  }
  __host__ __device__ static constexpr int field(int i) {
    constexpr int m[] = {10, 14, 15, 1};
    return m[i];
  }
};
template <>
struct MixedPart<2> {
  using Step = ShoppingCartStep;
  __host__ __device__ static constexpr int col(int c) {
    constexpr int m[] = {9, 13, 15, 17};
    return m[c];
  }
  __host__ __device__ static constexpr int field(int i) {
    constexpr int m[] = {12, 18, 6, 19};
    return m[i];
  }
};
template <>
struct MixedPart<3> {
  using Step = SagaStep;
  __host__ __device__ static constexpr int col(int c) {
    constexpr int m[] = {0, 2, 3, 4, 5, 7, 11, 15, 16};
    return m[c];
  }
  __host__ __device__ static constexpr int field(int i) {
    constexpr int m[] = {11, 13, 16, 17, 7, 8, 0, 2, 3, 4, 5, 19};
    return m[i];
  }
};

// f(std::integral_constant<int, I>) for I in [0, N): each index a
// compile-time constant
template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

// Part P's step on the union carry, when the event's type id lies in its
// range: its fields and columns gathered from their union slots, its step
// applied with the local type id, its fields written back
template <int P>
__device__ __forceinline__ void apply_part(const DecodeArgs& dec,
                                           uint32_t (&st)[kMaxState], int tid,
                                           const uint32_t (&ev)[kMaxCols]) {
  using Part = MixedPart<P>;
  using Step = typename Part::Step;
  const uint32_t local = static_cast<uint32_t>(tid - dec.part_base[P]);
  if (local >= static_cast<uint32_t>(dec.part_types[P])) return;
  uint32_t s[Step::kState];
  uint32_t e[Step::kCols];
  static_for<0, Step::kState>([&](auto i) {
    constexpr int u = Part::field(decltype(i)::value);
    s[decltype(i)::value] = st[u];
  });
  static_for<0, Step::kCols>([&](auto c) {
    constexpr int u = Part::col(decltype(c)::value);
    e[decltype(c)::value] = ev[u];
  });
  Step::apply(s, static_cast<int>(local), e);
  static_for<0, Step::kState>([&](auto i) {
    constexpr int u = Part::field(decltype(i)::value);
    st[u] = s[decltype(i)::value];
  });
}

// a state slot's value: its 4-byte word, its bool byte as 0 or 1, or 0 for
// a MixedStep slot the spec lacks
template <class Step>
__device__ __forceinline__ uint32_t load_field(int32_t kind, const void* col,
                                               size_t i) {
  if (kIsMixed<Step> && kind == kAbsentField) return 0u;
  return kind == kByte
             ? static_cast<uint32_t>(static_cast<const uint8_t*>(col)[i] != 0)
             : static_cast<const uint32_t*>(col)[i];
}

template <class Step>
__device__ __forceinline__ void store_field(int32_t kind, void* col, size_t i,
                                            uint32_t v) {
  if (kIsMixed<Step> && kind == kAbsentField) return;
  if (kind == kByte) {
    static_cast<uint8_t*>(col)[i] = v != 0u ? 1 : 0;
  } else {
    static_cast<uint32_t*>(col)[i] = v;
  }
}

template <class Step>
__device__ __forceinline__ void load_carry(const StateArgs& sa, int lane,
                                           uint32_t (&st)[Step::kState]) {
#pragma unroll
  for (int i = 0; i < Step::kState; ++i) {
    st[i] = load_field<Step>(sa.kind[i], sa.in[i], lane);
  }
}

template <class Step>
__device__ __forceinline__ void store_carry(const StateArgs& sa, int lane,
                                            const uint32_t (&st)[Step::kState]) {
#pragma unroll
  for (int i = 0; i < Step::kState; ++i) {
    store_field<Step>(sa.kind[i], sa.out[i], lane, st[i]);
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

// the resident slab and one refresh window's lane table. The table's
// admission rows follow the spec's state order; admit_row[i] is the row of
// state slot i (MixedStep's slots are the union's, in another order)
struct SlabArgs {
  int32_t n_state;
  int32_t kind[kMaxState];
  int32_t admit_row[kMaxState];
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
      if constexpr (kIsMixed<Step>) {
        if (sa.kind[i] == kAbsentField) {
          st[i] = 0u;
          continue;
        }
      }
      const int row = kIsMixed<Step> ? sa.admit_row[i] : kRowAdmitVal + i;
      const uint32_t v = static_cast<uint32_t>(table_at(sa, row, lane));
      st[i] = sa.kind[i] == kByte ? static_cast<uint32_t>(v != 0u) : v;
    }
    return static_cast<uint32_t>(table_at(sa, kRowAdmitOrd, lane));
  }
#pragma unroll
  for (int i = 0; i < Step::kState; ++i) {
    st[i] = load_field<Step>(sa.kind[i], sa.col[i], l.slot);
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
    store_field<Step>(sa.kind[i], sa.col[i], l.slot, st[i]);
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
    if (kIsMixed<Step> && k == kAbsentCol) {
      ev[c] = 0u;
      continue;
    }
    ev[c] = k == kPacked ? (w >> dec.shift[c]) & dec.mask[c]
          : k == kSide   ? dec.side[c][side_row]
                         : ordinal;
  }
  if constexpr (kIsMixed<Step>) {  // the part whose range holds tid
    static_for<0, kParts>([&](auto p) {
      apply_part<decltype(p)::value>(dec, st, tid, ev);
    });
  } else {
    Step::apply(st, tid, ev);
  }
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
// 3 saga, then 4 MixedStep (fold_kernels.MIXED_STEP_ID). Returns f(Step{})
// for the id's step functor, or cudaErrorInvalidValue for an unknown id.
template <class F>
inline int with_step(int step, F&& f) {
  switch (step) {
    case 0: return f(CounterStep{});
    case 1: return f(BankAccountStep{});
    case 2: return f(ShoppingCartStep{});
    case 3: return f(SagaStep{});
    case 4: return f(MixedStep{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The wire bytes a step's kernels are built for: a combined spec of the four
// families packs at most 13 bits (4 type bits, the counter's two 2-bit
// fields, the saga's 5-bit step), so MixedStep is built for 1 and 2 bytes
// only, which keeps its instantiations, the build's longest, to half
template <class Step>
constexpr int kWireBytes = 4;
template <>
constexpr int kWireBytes<MixedStep> = 2;

// f(std::integral_constant<int, NB>{}) for the wire's byte count NB, or
// cudaErrorInvalidValue past 4 or past kWireBytes<Step>
template <class Step, class F>
inline int with_wire_bytes(int nbytes, F&& f) {
  switch (nbytes) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3:
      if constexpr (kWireBytes<Step> >= 3) return f(std::integral_constant<int, 3>{});
      break;
    case 4:
      if constexpr (kWireBytes<Step> >= 4) return f(std::integral_constant<int, 4>{});
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// MixedStep's part p (a step id 0-3): the union slot of each of its columns
// and state fields, into cols[kMaxCols] and fields[kMaxState] (-1 past its
// own), so the ctypes side can check its maps against these
inline int part_map(int part, int* cols, int* fields) {
  for (int c = 0; c < kMaxCols; ++c) cols[c] = -1;
  for (int i = 0; i < kMaxState; ++i) fields[i] = -1;
  auto fill = [&](auto p) {
    using Part = MixedPart<decltype(p)::value>;
    for (int c = 0; c < Part::Step::kCols; ++c) cols[c] = Part::col(c);
    for (int i = 0; i < Part::Step::kState; ++i) fields[i] = Part::field(i);
  };
  switch (part) {
    case 0: fill(std::integral_constant<int, 0>{}); return 0;
    case 1: fill(std::integral_constant<int, 1>{}); return 0;
    case 2: fill(std::integral_constant<int, 2>{}); return 0;
    case 3: fill(std::integral_constant<int, 3>{}); return 0;
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
