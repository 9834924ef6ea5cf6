// The scan engine's grouped reduction: per group of a CSR (`offsets`, and
// `order` mapping a span position to an event; null is the identity), the
// count of matched events and the sum, min and max of up to 16 int32 or
// float32 columns over them, with the semantics of the JAX package's CPU
// scatter (surge_tpu_torch/replay/scan_reduce.py is its wrapper and holds the
// plain torch twin of this design).
//
// It replaces no Pallas kernel: the JAX package's scan
// (surge_tpu/replay/query.py:549-570, `.at[agg_idx].add/min/max`) is an XLA
// scatter. On the CPU that scatter walks the events in order, one update at a
// time, with x86 scalar arithmetic under flush-to-zero and
// denormals-are-zero; the reference's tests hold float sums bit for bit
// against that order. CUDA's scatters and index_add_ add float32 in atomic
// order, which changes a sum's last bits from run to run.
//
// Design (four launches on the caller's stream, no host synchronisation):
// - `scan_plan`: one warp per tile finds the group holding the tile's first
//   position (a 32-way search of `offsets`), the first group starting at or
//   after it and where the first one ends.
// - `scan_tiles`: one block per tile of kTile (4,096) span positions,
//   whatever the groups' sizes. Each thread takes 16 contiguous positions:
//   their mask bytes (and `order`) in registers, and each distinct column's
//   values copied once to shared memory with `cp.async` (16-byte copies, or
//   4-byte gathers through `order`; padded so the lanes' reads hit distinct
//   banks), in flight while the block finds the tile's groups. The
//   order-free outputs (the count,
//   int32 sums wrapping, int32 min and max, float32 min and max) reduce as a
//   segmented scan in position order: within a thread, across a warp with
//   shuffles, across warps through shared memory. A group that starts and
//   ends inside the tile is written there; the partials of the (at most
//   two) groups that cross the tile's edges go to `part`. Float sums of the
//   groups inside the tile are one chain a group, walked by one thread over
//   values staged in shared memory.
// - `scan_spans`: one warp per tile finishes the group crossing out of it
//   when that group ends in the next tile (the common case: many small
//   groups). Its two partials combine, and each float sum is one chain that
//   every lane adds in order from shuffles of what the warp loaded. Empty
//   groups are written here (count 0, the sentinels), grid-stride.
// - `scan_long`: a group spanning three tiles or more (listed by
//   `scan_spans`) gets a block: its tiles' partials combine in tile order
//   (an ordered fold, then an ordered tree), and each float sum is one
//   chain over the whole span, run by a lane of warp 0 from a
//   double-buffered stage in shared memory that the other seven warps fill
//   ahead of it, so a step costs the add and never a global load.
//
// Bounds on this card: the order-free outputs are bound by bytes (a mask
// byte, 4 bytes a column and, for unsorted groups, 4 bytes of `order` an
// event, each read once). A float sum cannot split: its floor is the longest
// float-summed group's span times the latency of one dependent
// `add.rn.ftz.f32` (~2.3 ns; the chains run many groups at once, on many
// SMs, but each chain is serial). Measured (PERF.md), the tile pass is
// bound by its instructions and its per-tile latency, not yet by bytes: a
// segmented scan costs each channel a fold, five shuffles and a barrier per
// tile. The float rules below are written in integer arithmetic for a
// reason given where they are defined.
//
// Semantics, as the reference's CPU scatter computes them (the tests hold
// each rule against it, pair by pair and on random draws):
// - a masked-out event adds +0.0 to a sum (branch-free, as the reference's
//   `where(mask, col, 0)`) and the sentinel to min and max;
// - float32 sums add in event order from +0.0 with flush-to-zero and
//   denormals-are-zero (`add.rn.ftz.f32`); a NaN result takes the payload
//   of the group's last matched NaN, quieted (x86 returns the later
//   operand's NaN), or the x86 default NaN 0xffc00000 (inf - inf); integer
//   sums wrap in 32 bits;
// - float min and max flush denormal inputs to a zero of their sign and
//   apply x86's lowering of LLVM's minimum/maximum to (acc, v): for min,
//   `(x, y) = signbit(acc) ? (v, acc) : (acc, v); acc = (x < y || x != x) ?
//   x : y`, for max the pair swapped and `>`. So -0 < +0, a NaN wins, and of
//   several NaNs min keeps the first positive one (else the last) and max
//   the first negative one (else the last). The same rule applied to
//   (earlier partial, later partial) gives the sequential result, which is
//   what lets the partials combine as a scan and a tree in position order;
// - an empty group keeps the sentinel: the dtype's max for min, its lowest
//   value for max, 0 for count and sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

constexpr int kMaxOut = 16;
constexpr int kChannels = kMaxOut + 1;  // the count, then the outputs
constexpr int kTile = 4096;             // span positions a tile block reduces
constexpr int kThreads = 256;
constexpr int kPer = kTile / kThreads;  // contiguous positions a thread loads
constexpr int kWarps = kThreads / 32;
constexpr int kSpanStageBytes = 64 * 1024;  // the long pass's two stages
constexpr int kMaxStage = 2048;
// A tile's staged column: 4 words of padding after every 32, so the 32
// lanes' 16-byte reads of their 16 contiguous values fall on distinct banks
// (unpadded, a thread's values start 16 words from its neighbour's: a
// 4-way conflict on every read).
constexpr int kRegion = kTile + kTile / 8;
__host__ __device__ constexpr int pidx(int p) { return p + ((p >> 5) << 2); }
// distinct columns a call may reduce: each staged once (kRegion * 4 bytes),
// beside ~17 KB of the tile's own, within a block's 227 KB
constexpr int kMaxRegions = 11;
constexpr int kLoaders = kThreads - 32;  // the long pass's warps 1-7
constexpr int kFillPer = (kMaxStage + kLoaders - 1) / kLoaders;

enum ScanOp : int32_t { kSum = 0, kMin = 1, kMax = 2 };
enum ScanDtype : int32_t { kI32 = 0, kF32 = 1 };
// what a channel does: the order-free kinds, and kFSum (a chain)
enum Kind : int32_t { kISum = 0, kIMin = 1, kIMax = 2, kFSum = 3, kFMin = 4, kFMax = 5 };

// mirrored by _ScanArgs in surge_tpu_torch/replay/scan_reduce.py
struct ScanArgs {
  int32_t n_groups;
  int32_t n_out;
  int32_t n_tiles;  // tiles of kTile positions covering offsets[n_groups]
  int32_t n_regions;  // distinct columns, each staged once in a tile's shared memory
  int32_t op[kMaxOut];
  int32_t dtype[kMaxOut];
  int32_t region[kMaxOut];      // the staged column output k reads
  int32_t region_src[kMaxOut];  // an output whose column region r holds
  const uint8_t* mask;     // [n] bool
  const int32_t* offsets;  // [n_groups + 1]
  const int32_t* order;    // [offsets[n_groups]] or null (identity)
  int32_t* count;          // [n_groups]
  const void* col[kMaxOut];
  void* out[kMaxOut];
  uint32_t* part;          // [n_tiles][2][n_out + 1]: a tile's head, tail partials
  int32_t* tail_group;     // [n_tiles]: the group crossing out of a tile, or -1
  int32_t* tile_first;     // [n_tiles]: the group holding a tile's first position
  int32_t* tile_ga;        // [n_tiles]: the first group starting at or after it
  int32_t* tile_in_end;    // [n_tiles]: where the group holding it ends
  int32_t* long_list;      // [n_tiles]: tiles whose tail group spans 3+ tiles
  int32_t* n_long;         // [1]
};

__device__ __forceinline__ int kind_of(const ScanArgs& a, int k) {
  return a.dtype[k] == kI32 ? a.op[k] : 3 + a.op[k];
}

// the kind of channel c: 0 is the count (an int32 sum), 1 + k output k
__device__ __forceinline__ int channel_kind(const ScanArgs& a, int c) {
  return c == 0 ? kISum : kind_of(a, c - 1);
}

template <int Kind>
__device__ __forceinline__ uint32_t identity() {
  if constexpr (Kind == kIMin) return 0x7fffffffu;  // INT_MAX
  if constexpr (Kind == kIMax) return 0x80000000u;  // INT_MIN
  if constexpr (Kind == kFMin) return 0x7f7fffffu;  // FLT_MAX
  if constexpr (Kind == kFMax) return 0xff7fffffu;  // -FLT_MAX
  return 0u;                                         // 0, +0.0
}

__device__ __forceinline__ bool is_nan(uint32_t b) { return (b & 0x7fffffffu) > 0x7f800000u; }

// denormals-are-zero: a denormal becomes the zero of its sign
__device__ __forceinline__ uint32_t daz(uint32_t b) {
  return (b & 0x7f800000u) == 0 ? (b & 0x80000000u) : b;
}

__device__ __forceinline__ float add_ftz(float x, float y) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

// The float rules in integer arithmetic on the bits. Written as float
// compares and a select, the compiler turns a compare against the FLT_MAX
// sentinel into a min/max instruction, which returns the canonical NaN and
// loses the payload. Without a NaN the rule is the min (max) of the float
// order with -0 < +0: the order of signed_key(). With a NaN, from the rule:
// min keeps a positive NaN acc, replaces a negative one by a NaN v, and
// takes a NaN v over a number; max the same with the signs swapped.
__device__ __forceinline__ int32_t signed_key(uint32_t b) {
  return static_cast<int32_t>(b ^ ((static_cast<int32_t>(b) >> 31) & 0x7fffffff));
}

__device__ __forceinline__ uint32_t fmin_rule(uint32_t acc, uint32_t v) {
  const bool an = is_nan(acc), vn = is_nan(v);
  if (!(an || vn)) return signed_key(v) < signed_key(acc) ? v : acc;
  return an ? ((static_cast<int32_t>(acc) < 0 && vn) ? v : acc) : v;
}

__device__ __forceinline__ uint32_t fmax_rule(uint32_t acc, uint32_t v) {
  const bool an = is_nan(acc), vn = is_nan(v);
  if (!(an || vn)) return signed_key(v) > signed_key(acc) ? v : acc;
  return an ? ((static_cast<int32_t>(acc) >= 0 && vn) ? v : acc) : v;
}

// the order-free combine of an earlier partial `e` and a later one `l`
template <int Kind>
__device__ __forceinline__ uint32_t combine(uint32_t e, uint32_t l) {
  if constexpr (Kind == kISum) return e + l;
  if constexpr (Kind == kIMin) return static_cast<int32_t>(e) < static_cast<int32_t>(l) ? e : l;
  if constexpr (Kind == kIMax) return static_cast<int32_t>(e) > static_cast<int32_t>(l) ? e : l;
  if constexpr (Kind == kFMin) return fmin_rule(e, l);
  if constexpr (Kind == kFMax) return fmax_rule(e, l);
  return e;  // float sums are chains, never combined
}

// what a position gives a channel: its value (floats' min and max flushed)
// when matched, else the identity
template <int Kind>
__device__ __forceinline__ uint32_t contribution(bool m, uint32_t v) {
  if (!m) return identity<Kind>();
  return (Kind == kFMin || Kind == kFMax) ? daz(v) : v;
}

// the same, for a kind known only at run time (the passes off the hot path)
template <typename F>
__device__ __forceinline__ auto by_kind(int kind, F f) {
  switch (kind) {
    case kIMin: return f(std::integral_constant<int, kIMin>());
    case kIMax: return f(std::integral_constant<int, kIMax>());
    case kFMin: return f(std::integral_constant<int, kFMin>());
    case kFMax: return f(std::integral_constant<int, kFMax>());
    case kFSum: return f(std::integral_constant<int, kFSum>());
    default: return f(std::integral_constant<int, kISum>());
  }
}

__device__ __forceinline__ uint32_t identity(int kind) {
  return by_kind(kind, [](auto k) { return identity<decltype(k)::value>(); });
}

__device__ __forceinline__ uint32_t combine(int kind, uint32_t e, uint32_t l) {
  return by_kind(kind, [=](auto k) { return combine<decltype(k)::value>(e, l); });
}

// a float sum's NaN as the reference leaves it: the last matched NaN's
// payload, quieted, or x86's default NaN when no input was NaN (inf - inf)
__device__ __forceinline__ uint32_t fix_nan(float acc, int32_t last_nan_bits, bool had_nan) {
  const uint32_t b = __float_as_uint(acc);
  if (!is_nan(b)) return b;
  return had_nan ? (static_cast<uint32_t>(last_nan_bits) | 0x00400000u) : 0xffc00000u;
}

__device__ __forceinline__ void write_out(const ScanArgs& a, int c, int g, uint32_t v) {
  if (c == 0) {
    a.count[g] = static_cast<int32_t>(v);
  } else {
    static_cast<uint32_t*>(a.out[c - 1])[g] = v;
  }
}

// first i in [0, n) with offs[i] >= x (n if none); every lane of the warp
// takes part and gets the answer. 32 probes a round: 4 dependent loads for
// half a million groups.
__device__ int warp_lower_bound(const int32_t* offs, int n, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + lane * step;
    const bool ge = q < hi ? offs[q] >= x : true;
    const unsigned ball = __ballot_sync(0xffffffffu, ge);
    const int f = ball ? __ffs(ball) - 1 : 32;
    if (f == 0) return lo;
    const int nlo = lo + (f - 1) * step + 1;
    hi = f < 32 ? min(lo + f * step, hi) : hi;
    lo = nlo;
  }
  const int q = lo + lane;
  const bool ge = q < hi ? offs[q] >= x : false;
  const unsigned ball = __ballot_sync(0xffffffffu, ge);
  return ball ? lo + __ffs(ball) - 1 : hi;
}

// the float sum of a staged region's positions s .. e - 1 in order from
// +0.0: each 8 values load while the 8 before them add, so a step costs
// the add
__device__ __forceinline__ float chain(const uint32_t* region, int s, int e) {
  float acc = 0.0f;
  int i = s;
  if (e - i >= 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = __uint_as_float(region[pidx(i + u)]);
    for (; i + 16 <= e; i += 8) {
      float y[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) y[u] = __uint_as_float(region[pidx(i + 8 + u)]);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = add_ftz(acc, x[u]);
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = y[u];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = add_ftz(acc, x[u]);
    i += 8;
  }
  for (; i < e; ++i) acc = add_ftz(acc, __uint_as_float(region[pidx(i)]));
  return acc;
}

// a thread's kPer staged values (contiguous, 16-byte aligned) into registers
__device__ __forceinline__ void load_staged(const uint32_t* vals, uint32_t (&v)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; j += 4) {
    const uint4 w = *reinterpret_cast<const uint4*>(vals + j);
    v[j] = w.x; v[j + 1] = w.y; v[j + 2] = w.z; v[j + 3] = w.w;
  }
}

// -- pass 0: the plan ------------------------------------------------------------------

// one warp per tile: the group holding the tile's first position (n_groups
// past the span's end), the first group starting at or after it and where
// the first one ends, so a tile block reads them at once; also zeroes the
// long groups' count
__global__ void __launch_bounds__(kThreads)
scan_plan(const ScanArgs a) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.n_long = 0;
  const int t = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (t >= a.n_tiles) return;
  const int p = t * kTile;
  int g = a.n_groups;
  if (p < a.offsets[a.n_groups]) g = warp_lower_bound(a.offsets, a.n_groups, p + 1) - 1;
  if ((threadIdx.x & 31) == 0) {
    a.tile_first[t] = g;
    if (g < a.n_groups) {
      a.tile_ga[t] = a.offsets[g] == p ? g : g + 1;
      a.tile_in_end[t] = a.offsets[g + 1];
    }
  }
}

// -- pass 1: tiles -------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(uint32_t* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(uint32_t* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// what a tile's thread knows when it scans its channels
struct TileThread {
  int tid, lane, warp, nv;
  uint32_t hb, mbits, take;      // heads, matched bits, the flags' scan steps
  bool ex_flag, cflag;           // a head before this lane / this thread
  int cgid;                      // the group open at this thread's start
  bool closes_first, closes_tile, any_head, tail_started;
  int tail_gid, tail_end, p1;
  uint32_t* part_head;
  uint32_t* part_tail;
};

// One order-free channel of a tile: the local segmented fold (groups inside
// the thread written at once), the warp's inclusive scan with shuffles, the
// carry across warps through shared memory, then the segments this thread
// closes: complete groups written, the tile's edge groups' partials kept.
template <int Kind, bool Count>
__device__ __forceinline__ void tile_channel(const ScanArgs& a, int c, const TileThread& t,
                                             const uint32_t* vals, const int32_t* gid,
                                             uint32_t* wval, const int32_t* wflag) {
  uint32_t x[kPer];
  if (!Count) load_staged(vals, x);
  uint32_t acc = identity<Kind>(), first = identity<Kind>();
  int gcur = -1;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j < t.nv) {
      if ((t.hb >> j) & 1) {
        if (gcur >= 0) write_out(a, c, gcur, acc);  // a group inside this thread
        else first = acc;
        acc = identity<Kind>();
        gcur = gid[t.tid * kPer + j];
      }
      acc = combine<Kind>(acc, contribution<Kind>((t.mbits >> j) & 1, Count ? 1u : x[j]));
    }
  }
  if (gcur < 0) first = acc;
  uint32_t v = acc;  // this thread's open tail: from its last head, or all of it
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const uint32_t vp = __shfl_up_sync(0xffffffffu, v, 1 << s);
    if ((t.take >> s) & 1) v = combine<Kind>(vp, v);
  }
  const uint32_t ex = __shfl_up_sync(0xffffffffu, v, 1);
  if (t.lane == 31) wval[t.warp] = v;
  __syncthreads();
  uint32_t cv = identity<Kind>();
  for (int w = 0; w < t.warp; ++w) cv = wflag[w] ? wval[w] : combine<Kind>(cv, wval[w]);
  if (t.lane > 0) cv = t.ex_flag ? ex : combine<Kind>(cv, ex);
  if (t.closes_first) {  // the segment that ends at this thread's first head
    const uint32_t x = combine<Kind>(cv, first);
    if (t.cflag) write_out(a, c, t.cgid, x);
    else t.part_head[c] = x;
  }
  if (t.closes_tile) {  // the segment open at the tile's end
    const uint32_t x = t.any_head ? acc : combine<Kind>(cv, first);
    if (!t.tail_started) t.part_head[c] = x;
    else if (t.tail_end > t.p1) t.part_tail[c] = x;
    else write_out(a, c, t.tail_gid, x);
  }
}

__global__ void __launch_bounds__(kThreads, 4)
scan_tiles(const ScanArgs a) {
  extern __shared__ uint32_t s_cols[];       // [n_regions][kRegion]: the tile's columns
  __shared__ uint32_t s_head[kTile / 32];    // a bit per position: a group starts
  __shared__ int32_t s_gid[kTile];           // the group starting at a head
  __shared__ uint32_t s_wval[2][kWarps];     // the warps' scan totals, double-buffered
  __shared__ int32_t s_wflag[kWarps], s_wgid[kWarps];
  __shared__ int32_t s_tail_end;             // the end of the last group starting here

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int n_groups = a.n_groups, n_ch = a.n_out + 1;
  const int n_pos = a.offsets[n_groups];
  const int p0 = tile * kTile;
  if (p0 >= n_pos) {
    if (tid == 0) a.tail_group[tile] = -1;
    return;
  }
  const int p1 = min(p0 + kTile, n_pos);
  const int g_in = a.tile_first[tile];  // holds p0; crosses in unless it starts there
  const int ga = a.tile_ga[tile];
  const int g_in_end = a.tile_in_end[tile];
  // the groups starting in the tile lie in [ga, g_last]
  const int g_last = min(tile + 1 < a.n_tiles ? a.tile_first[tile + 1] : n_groups, n_groups - 1);

  // this thread's positions q .. q + nv - 1: matched bits in registers;
  // each distinct column's values copied to shared memory asynchronously,
  // in flight while the tile's groups are found
  const int q = p0 + tid * kPer;
  const int nv = max(0, min(kPer, p1 - q));
  uint32_t mbits = 0;
  if (a.order == nullptr) {
    if (nv == kPer && (reinterpret_cast<uintptr_t>(a.mask) & 15) == 0) {
      const uint4 w = *reinterpret_cast<const uint4*>(a.mask + q);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < kPer; ++j) mbits |= (((words[j >> 2] >> (8 * (j & 3))) & 0xffu) != 0) << j;
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (j < nv) mbits |= (a.mask[q + j] != 0) << j;
      }
    }
    for (int r = 0; r < a.n_regions; ++r) {
      const uint32_t* col = static_cast<const uint32_t*>(a.col[a.region_src[r]]);
      uint32_t* dst = s_cols + r * kRegion + pidx(tid * kPer);
      if (nv == kPer && (reinterpret_cast<uintptr_t>(col) & 15) == 0) {
#pragma unroll
        for (int j = 0; j < kPer; j += 4) cp_async16(dst + j, col + q + j);
      } else {
        for (int j = 0; j < nv; ++j) cp_async4(dst + j, col + q + j);
      }
    }
  } else {
    // four positions at a time: their events, then the mask bytes and every
    // column's values gathered (the values with 4-byte cp.async)
    const bool vec = nv == kPer && (reinterpret_cast<uintptr_t>(a.order) & 15) == 0;
#pragma unroll
    for (int j0 = 0; j0 < kPer; j0 += 4) {
      int e4[4];
      if (vec) {
        const int4 w = *reinterpret_cast<const int4*>(a.order + q + j0);
        e4[0] = w.x; e4[1] = w.y; e4[2] = w.z; e4[3] = w.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) e4[u] = j0 + u < nv ? a.order[q + j0 + u] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j0 + u < nv) mbits |= (a.mask[e4[u]] != 0) << (j0 + u);
      }
      for (int r = 0; r < a.n_regions; ++r) {
        const uint32_t* col = static_cast<const uint32_t*>(a.col[a.region_src[r]]);
        uint32_t* dst = s_cols + r * kRegion + pidx(tid * kPer) + j0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j0 + u < nv) cp_async4(dst + u, col + e4[u]);
        }
      }
    }
  }
  if (tid < kTile / 32) s_head[tid] = 0;
  __syncthreads();

  // heads: every non-empty group starting in [p0, p1)
  for (int g = ga + tid; g <= g_last; g += kThreads) {
    const int s = a.offsets[g];
    if (s >= p1) break;
    const int e = a.offsets[g + 1];
    if (e > s) {
      s_gid[s - p0] = g;
      atomicOr(&s_head[(s - p0) >> 5], 1u << ((s - p0) & 31));
      if (e >= p1) s_tail_end = e;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const uint32_t hb = (s_head[(tid * kPer) >> 5] >> ((tid * kPer) & 31)) & ((1u << kPer) - 1);
  const bool any_head = hb != 0;
  const int first_j = any_head ? __ffs(hb) - 1 : kPer;
  const int my_gid = any_head ? s_gid[tid * kPer + 31 - __clz(hb)] : -1;

  // the flags' scan across the warp, once for every channel: `take` bit s
  // says this lane combines with lane - 2^s at step s
  bool flag = any_head;
  int fgid = my_gid;
  uint32_t take = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int d = 1 << s;
    const bool fp = __shfl_up_sync(0xffffffffu, flag, d);
    const int gp = __shfl_up_sync(0xffffffffu, fgid, d);
    if (lane >= d && !flag) {
      take |= 1u << s;
      flag = fp;
      fgid = gp;
    }
  }
  bool ex_flag = __shfl_up_sync(0xffffffffu, flag, 1);
  int ex_gid = __shfl_up_sync(0xffffffffu, fgid, 1);
  if (lane == 0) { ex_flag = false; ex_gid = -1; }
  if (lane == 31) { s_wflag[warp] = flag; s_wgid[warp] = fgid; }
  __syncthreads();
  // the segment open at this thread's start: begun at a head of this tile
  // (cflag, group cgid), or the group crossing in
  bool cflag = false;
  int cgid = -1;
  for (int w = 0; w < warp; ++w) {
    if (s_wflag[w]) { cflag = true; cgid = s_wgid[w]; }
  }
  if (ex_flag) { cflag = true; cgid = ex_gid; }
  const bool closes_first = any_head && (tid > 0 || first_j > 0);
  const bool closes_tile = tid == (p1 - p0 - 1) / kPer;
  int tail_gid = -1, tail_end = 0;
  bool tail_started = false;
  if (closes_tile) {
    tail_started = any_head || cflag;
    tail_gid = any_head ? my_gid : (cflag ? cgid : g_in);
    tail_end = tail_started ? s_tail_end : g_in_end;
    a.tail_group[tile] = (tail_started && tail_end > p1) ? tail_gid : -1;
  }
  uint32_t* part_head = a.part + static_cast<size_t>(tile) * 2 * n_ch;
  // per channel: a scan (its kind a template parameter); float sums'
  // values are masked in place for the chains
  const TileThread t{tid, lane, warp, nv, hb, mbits, take, ex_flag, cflag, cgid,
                     closes_first, closes_tile, any_head, tail_started, tail_gid,
                     tail_end, p1, part_head, part_head + n_ch};
  int n_scanned = 0;
  bool any_chain = false;
  for (int c = 0; c < n_ch; ++c) {
    const int kind = channel_kind(a, c);
    // outputs of one column share its staged values: masking a float sum's
    // unmatched values to +0.0 in place changes nothing the others read
    uint32_t* vals = s_cols + (c > 0 ? a.region[c - 1] * kRegion : 0) + pidx(tid * kPer);
    if (kind == kFSum) {
#pragma unroll
      for (int j = 0; j < kPer; j += 4) {
        uint4 w = *reinterpret_cast<uint4*>(vals + j);
        if (!((mbits >> j) & 1)) w.x = 0u;
        if (!((mbits >> (j + 1)) & 1)) w.y = 0u;
        if (!((mbits >> (j + 2)) & 1)) w.z = 0u;
        if (!((mbits >> (j + 3)) & 1)) w.w = 0u;
        *reinterpret_cast<uint4*>(vals + j) = w;
      }
      any_chain = true;
      continue;
    }
    uint32_t* wval = s_wval[n_scanned++ & 1];
    if (c == 0) {
      tile_channel<kISum, true>(a, c, t, vals, s_gid, wval, s_wflag);
    } else {
      by_kind(kind, [&](auto k) {
        tile_channel<decltype(k)::value, false>(a, c, t, vals, s_gid, wval, s_wflag);
      });
    }
  }

  // float sums: one chain a group that starts and ends in this tile, the
  // tile's groups dealt round-robin to the threads
  if (!any_chain) return;
  __syncthreads();
  for (int g = ga + tid; g <= g_last; g += kThreads) {
    const int s = a.offsets[g] - p0;
    if (s >= p1 - p0) break;
    const int e = a.offsets[g + 1] - p0;
    if (e == s || e > p1 - p0) continue;  // empty, or crosses out: a later pass
    for (int k = 0; k < a.n_out; ++k) {
      if (kind_of(a, k) != kFSum) continue;
      const uint32_t* vals = s_cols + a.region[k] * kRegion;
      const float acc = chain(vals, s, e);
      int32_t last_nan = 0;
      bool had_nan = false;
      if (acc != acc) {  // the last NaN input's payload, looked up only then
        for (int i = e - 1; i >= s && !had_nan; --i) {
          const uint32_t v = vals[pidx(i)];
          if (is_nan(v)) { last_nan = static_cast<int32_t>(v); had_nan = true; }
        }
      }
      static_cast<uint32_t*>(a.out[k])[g] = fix_nan(acc, last_nan, had_nan);
    }
  }
}

// -- pass 2: groups that cross one tile edge; empty groups ----------------------------

// One warp per tile: the group crossing out of it, when it ends in the next
// tile, combines its two partials (lane c channel c) and chains its float
// sums, every lane adding the same values in order from shuffles of what
// the 32 lanes loaded (one load of 32 * kPer positions). A group spanning
// three tiles or more, or with float sums longer than that load, goes to
// the long list. Empty groups are written grid-stride.
__global__ void __launch_bounds__(kThreads)
scan_spans(const ScanArgs a) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_groups = a.n_groups, n_ch = a.n_out + 1;
  for (int g = blockIdx.x * kThreads + tid; g < n_groups; g += gridDim.x * kThreads) {
    if (a.offsets[g] != a.offsets[g + 1]) continue;
    for (int c = 0; c < n_ch; ++c) write_out(a, c, g, identity(channel_kind(a, c)));
  }
  const int t = (blockIdx.x * kThreads + tid) >> 5;
  if (t >= a.n_tiles) return;
  const int g = a.tail_group[t];
  if (g < 0) return;
  const int lo = a.offsets[g], hi = a.offsets[g + 1];
  bool chains = false;
  for (int k = 0; k < a.n_out; ++k) chains |= kind_of(a, k) == kFSum;
  // a float sum longer than one warp's load goes to a block's staged chain
  if ((hi - 1) / kTile > t + 1 || (chains && hi - lo > 32 * kPer)) {
    if (lane == 0) a.long_list[atomicAdd(a.n_long, 1)] = t;
    return;
  }
  if (lane < n_ch) {
    const int kind = channel_kind(a, lane);
    if (kind != kFSum) {
      const uint32_t e = a.part[(static_cast<size_t>(t) * 2 + 1) * n_ch + lane];
      const uint32_t l = a.part[(static_cast<size_t>(t) + 1) * 2 * n_ch + lane];
      write_out(a, lane, g, combine(kind, e, l));
    }
  }
  for (int k = 0; k < a.n_out; ++k) {
    if (kind_of(a, k) != kFSum) continue;
    const uint32_t* col = static_cast<const uint32_t*>(a.col[k]);
    float acc = 0.0f;
    int32_t last_nan = 0;
    bool had_nan = false;
    for (int base = lo; base < hi; base += 32 * kPer) {
      uint32_t v[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int p = base + lane * kPer + j;
        const int e = p < hi ? (a.order == nullptr ? p : a.order[p]) : -1;
        v[j] = (e >= 0 && a.mask[e]) ? col[e] : 0u;
      }
      const int n_valid = min(32 * kPer, hi - base);
      for (int src = 0; src * kPer < n_valid; ++src) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const uint32_t x = __shfl_sync(0xffffffffu, v[j], src);
          if (src * kPer + j < n_valid) {
            acc = add_ftz(acc, __uint_as_float(x));
            if (is_nan(x)) { last_nan = static_cast<int32_t>(x); had_nan = true; }
          }
        }
      }
    }
    if (lane == 0) static_cast<uint32_t*>(a.out[k])[g] = fix_nan(acc, last_nan, had_nan);
  }
}

// -- pass 3: groups that span three tiles or more ------------------------------------

// One block per listed group: its tiles' partials combine in tile order (an
// ordered fold, then an ordered tree), and lane kc of warp 0 chains float
// sum column kc over the whole span while warps 1-7 stage the next `stage`
// positions in shared memory.
__global__ void __launch_bounds__(kThreads)
scan_long(const ScanArgs a, int n_chain, int stage) {
  extern __shared__ uint32_t s_stage[];  // [2][stage][n_chain]
  __shared__ uint32_t s_red[kWarps][kChannels];
  __shared__ int32_t s_last_nan[kMaxOut];
  __shared__ int8_t s_chain_col[kMaxOut];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_ch = a.n_out + 1;
  const int n_long = *a.n_long;
  if (tid == 0) {
    int kc = 0;
    for (int k = 0; k < a.n_out; ++k) {
      if (kind_of(a, k) == kFSum) s_chain_col[kc++] = static_cast<int8_t>(k);
    }
  }
  for (int item = blockIdx.x; item < n_long; item += gridDim.x) {
    const int t0 = a.long_list[item];
    const int g = a.tail_group[t0];
    const int lo = a.offsets[g], hi = a.offsets[g + 1];
    const int n_parts = (hi - 1) / kTile - t0 + 1;  // t0's tail, then heads to the last tile
    const int per = (n_parts + kThreads - 1) / kThreads;
    for (int c = 0; c < n_ch; ++c) {
      const int kind = channel_kind(a, c);
      if (kind == kFSum) continue;
      uint32_t v = identity(kind);
      for (int i = tid * per; i < min((tid + 1) * per, n_parts); ++i) {
        const size_t slot = i == 0 ? static_cast<size_t>(t0) * 2 + 1
                                   : static_cast<size_t>(t0 + i) * 2;
        v = combine(kind, v, a.part[slot * n_ch + c]);
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t o = __shfl_down_sync(0xffffffffu, v, d);
        if ((lane & (2 * d - 1)) == 0) v = combine(kind, v, o);
      }
      if (lane == 0) s_red[warp][c] = v;
    }
    if (tid < kMaxOut) s_last_nan[tid] = -1;
    __syncthreads();
    if (tid == 0) {
      for (int c = 0; c < n_ch; ++c) {
        const int kind = channel_kind(a, c);
        if (kind == kFSum) continue;
        uint32_t v = s_red[0][c];
        for (int w = 1; w < kWarps; ++w) v = combine(kind, v, s_red[w][c]);
        write_out(a, c, g, v);
      }
    }
    if (n_chain == 0) {
      __syncthreads();  // s_red is read above before the next group writes it
      continue;
    }

    const int n_stages = (hi - lo + stage - 1) / stage;
    // a loader's positions of one stage: each phase's loads (order, mask,
    // values) all in flight at once
    auto fill = [&](int st) {
      uint32_t* buf = s_stage + (st & 1) * stage * n_chain;
      const int base = lo + st * stage;
      const int len = min(stage, hi - base);
      int ev[kFillPer];
      uint32_t mbits = 0;
#pragma unroll
      for (int r = 0; r < kFillPer; ++r) {
        const int i = tid - 32 + r * kLoaders;
        ev[r] = i < len ? (a.order == nullptr ? base + i : a.order[base + i]) : 0;
      }
#pragma unroll
      for (int r = 0; r < kFillPer; ++r) {
        const int i = tid - 32 + r * kLoaders;
        if (i < len) mbits |= (a.mask[ev[r]] != 0) << r;
      }
      for (int kc = 0; kc < n_chain; ++kc) {
        const uint32_t* col = static_cast<const uint32_t*>(a.col[s_chain_col[kc]]);
        uint32_t v[kFillPer];
#pragma unroll
        for (int r = 0; r < kFillPer; ++r) v[r] = ((mbits >> r) & 1) ? col[ev[r]] : 0u;
#pragma unroll
        for (int r = 0; r < kFillPer; ++r) {
          const int i = tid - 32 + r * kLoaders;
          if (i >= len) continue;
          buf[i * n_chain + kc] = v[r];
          if (is_nan(v[r])) atomicMax(&s_last_nan[kc], base + i);
        }
      }
    };
    if (warp > 0) fill(0);
    __syncthreads();
    float acc = 0.0f;
    for (int st = 0; st < n_stages; ++st) {
      if (warp > 0) {
        if (st + 1 < n_stages) fill(st + 1);
      } else if (lane < n_chain) {
        // software-pipelined: the next 16 values load while 16 add
        const uint32_t* b = s_stage + (st & 1) * stage * n_chain + lane;
        const int len = min(stage, hi - (lo + st * stage));
        int i = 0;
        float x[16];
        if (len >= 16) {
#pragma unroll
          for (int u = 0; u < 16; ++u) x[u] = __uint_as_float(b[u * n_chain]);
          for (; i + 32 <= len; i += 16) {
            float y[16];
#pragma unroll
            for (int u = 0; u < 16; ++u) y[u] = __uint_as_float(b[(i + 16 + u) * n_chain]);
#pragma unroll
            for (int u = 0; u < 16; ++u) acc = add_ftz(acc, x[u]);
#pragma unroll
            for (int u = 0; u < 16; ++u) x[u] = y[u];
          }
#pragma unroll
          for (int u = 0; u < 16; ++u) acc = add_ftz(acc, x[u]);
          i += 16;
        }
        for (; i < len; ++i) acc = add_ftz(acc, __uint_as_float(b[i * n_chain]));
      }
      __syncthreads();
    }
    if (warp == 0 && lane < n_chain) {
      const int k = s_chain_col[lane];
      const int p = s_last_nan[lane];
      int32_t nan_bits = 0;
      if (p >= 0) {
        const int e = a.order == nullptr ? p : a.order[p];
        nan_bits = static_cast<const int32_t*>(a.col[k])[e];
      }
      static_cast<uint32_t*>(a.out[k])[g] = fix_nan(acc, nan_bits, p >= 0);
    }
    __syncthreads();
  }
}

// one thread, `steps` dependent adds: the latency that bounds a float chain
__global__ void fadd_chain(int steps, float x, float* out) {
  float acc = 0.0f;
#pragma unroll 16
  for (int i = 0; i < steps; ++i) acc = add_ftz(acc, x);
  *out = acc;
}

static int n_chains(const ScanArgs* a) {
  int n = 0;
  for (int k = 0; k < a->n_out; ++k) n += a->dtype[k] == kF32 && a->op[k] == kSum;
  return n;
}

static int span_stage(int n_chain) {
  return n_chain == 0 ? 0 : min(kMaxStage, kSpanStageBytes / (2 * 4 * n_chain));
}

static bool valid(const ScanArgs* a) {
  if (a->n_out < 0 || a->n_out > kMaxOut || a->n_tiles <= 0) return false;
  if (a->n_regions < 0 || a->n_regions > kMaxRegions || a->n_regions > a->n_out) return false;
  for (int k = 0; k < a->n_out; ++k) {
    if (a->op[k] < kSum || a->op[k] > kMax || a->dtype[k] < kI32 || a->dtype[k] > kF32 ||
        a->region[k] < 0 || a->region[k] >= a->n_regions) {
      return false;
    }
  }
  for (int r = 0; r < a->n_regions; ++r) {
    if (a->region_src[r] < 0 || a->region_src[r] >= a->n_out) return false;
  }
  return true;
}

extern "C" {

int surge_scan_reduce_args_size() { return static_cast<int>(sizeof(ScanArgs)); }

int surge_scan_reduce_max_out() { return kMaxOut; }

int surge_scan_reduce_tile() { return kTile; }

int surge_scan_reduce_max_columns() { return kMaxRegions; }

// The four passes, in this order on one stream; each returns
// cudaGetLastError() of its launch (0 on success).

// Pass 0: each tile's first group; zeroes the long groups' count.
int surge_scan_reduce_plan(const ScanArgs* args, cudaStream_t stream) {
  if (args->n_groups <= 0) return 0;
  if (!valid(args)) return cudaErrorInvalidValue;
  scan_plan<<<(args->n_tiles + kWarps - 1) / kWarps, kThreads, 0, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1: one block per tile.
int surge_scan_reduce(const ScanArgs* args, cudaStream_t stream) {
  if (args->n_groups <= 0) return 0;
  if (!valid(args)) return cudaErrorInvalidValue;
  // the static shared memory counts against the default 48 KB too: raise
  // the limit whenever the dynamic part grows past what was last allowed
  const int smem = args->n_regions * kRegion * 4;
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  scan_tiles<<<args->n_tiles, kThreads, smem, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: one warp per tile (the groups crossing one tile edge), and the
// empty groups.
int surge_scan_reduce_spans(const ScanArgs* args, cudaStream_t stream) {
  if (args->n_groups <= 0) return 0;
  if (!valid(args)) return cudaErrorInvalidValue;
  const int blocks = max((args->n_tiles + kWarps - 1) / kWarps,
                         (args->n_groups + 4 * kThreads - 1) / (4 * kThreads));
  scan_spans<<<blocks, kThreads, 0, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3: two blocks an SM walk the list of groups spanning three tiles or
// more (read on the card; empty, every block exits at once).
int surge_scan_reduce_long(const ScanArgs* args, cudaStream_t stream) {
  if (args->n_groups <= 0) return 0;
  if (!valid(args)) return cudaErrorInvalidValue;
  const int n_chain = n_chains(args);
  const int stage = span_stage(n_chain);
  const int smem = 2 * stage * n_chain * 4;
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_long, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 132;
    }
  }
  scan_long<<<min(args->n_tiles, 2 * sms), kThreads, smem, stream>>>(*args, n_chain, stage);
  return static_cast<int>(cudaGetLastError());
}

// `steps` dependent float adds on one thread (time it to get one add's latency)
int surge_fadd_chain(int steps, float* out, cudaStream_t stream) {
  fadd_chain<<<1, 1, 0, stream>>>(steps, 1.0f, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
