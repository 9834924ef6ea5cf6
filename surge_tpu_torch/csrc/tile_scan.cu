// K1 — the resident tile scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel surge_tpu/replay/pallas_fold.py:make_tile_scan
// (its pl.pallas_call at pallas_fold.py:86): for each lane b and each step
// t < width it decodes words[t, b] (type bits, bit-packed fields, side values,
// the derived ordinal ord_rel[b] + t + 1; padding when t >= lens_rel[b]) and
// applies the model's branchless select step to the lane's carry. The decode
// and the model steps are the ones K2 uses (fold_common.cuh). Two entries:
//
// surge_tile_scan — one tile. One thread per lane, blocks of kThreads lanes,
// a grid of ceil(bs / kThreads), the ragged edge masked; the carry lives in
// registers for all width steps and step t reads the time-major
// words[t * bs + lane], coalesced across a warp. Its one caller is the
// plane's dense refresh window, once per window: 32,768 lanes (128 blocks,
// under one an SM) of width 256 or 512, most lanes holding a few events, yet
// every thread walks all width steps and waits one memory latency a step.
//
// surge_tile_fold_list — a whole work list of the resident replay (all big
// tiles, or all small tiles, of a plan) folded into the state slab in place,
// in one launch. Tile k folds events [t_bases[k], t_bases[k] + width) of
// lanes [i0s[k], i0s[k] + bs): lens_rel = lens - t_base, the ordinal base
// ord + min(t_base, 2^29 - 1) (the fold body's clamp, wrapping u32), the
// little-endian expansion of the nbytes wire bytes into the u32 word done in
// registers. Design:
// - One block per lane block of kThreads consecutive slab lanes that some
//   tile of the list covers. A host-built CSR schedule (blk_ids, blk_off,
//   blk_tiles) lists, per lane block, the tiles covering it in list order, so
//   each lane's tiles run in ascending t_base with its carry in registers from
//   the first tile to the last; the carry is read and written once. At the
//   bench plan (1M lanes, 301 tiles) that is ~3,900 blocks where a per-tile
//   launch had 32. A lane past its length, a padding lane and a lane block
//   at a tile's ragged edge carry their state through.
// - A lane stops at min(lens_rel, width): a slot past its length decodes to
//   padding, which carries the state through, so skipping it is exact.
// - The fold is bound by the dependent steps of the longest lanes, not by
//   bytes: the small list's ~150 blocks hold the longest lanes' last tiles
//   and take about as long as the big list's ~3,900. So the byte count is a
//   template parameter (a runtime byte loop doubled the time on the card) and
//   the scan is unrolled kUnroll times, so the loads and decodes of later
//   steps overlap the carry's chain.
// - Dense source (dense_words u8 [k, width, bs, nbytes], sides [k, width, bs]):
//   the block stages its lanes' rows of each tile through shared memory in
//   chunks of `chunk` rows (a stage of at most kStageBytes), a ring of
//   kStages stages. Warp 0 issues one cp.async.bulk (TMA) copy per row and
//   per side row, completing on the stage's mbarrier, so chunk c + 1 is in
//   flight while chunk c is scanned; rows past the block's longest lane are
//   not copied. Then every thread walks its lane column out of shared memory.
//   Where a copy would break TMA's 16-byte rules (bs * nbytes not a multiple
//   of 16: bs 8 at one byte a word) the chunk takes the plain-load path inside
//   the kernel: each thread reads its slots from global memory.
// - Flat source (flat_wire u8 [rows, nbytes], sides [rows], starts): lane b's
//   tile row t is clamp(starts[b] + t_base, 0, rows - width) + t, exactly as
//   the slab index clamps. Adjacent lanes' rows lie a lane's length apart, so
//   nothing is staged: each thread issues the loads of kPrefetch rows before
//   the dependent steps use them (their redesign joins K2's).
// Bound: every input byte the list needs read once — the wire bytes and side
// values of each slot some lane folds (t < lens_rel), each touched lane's
// length, ordinal (and start) and its carry in and out. At the bench plan
// (1M lanes, 100M events, one wire byte an event) that is ~124 MB, ~37 us at
// 3.35 TB/s; the longest lane walks 1,428 dependent steps.
//
// Interface: plain C functions that launch on the given stream and return
// the cudaError_t of the launch; loaded with ctypes by
// surge_tpu_torch/replay/fold_kernels.py (which mirrors ListArgs).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "fold_common.cuh"

namespace surge_k1 {

using namespace surge_fold;

// the list fold's work list, source and slab; mirrored by _ListArgs in
// fold_kernels.py
struct ListArgs {
  int32_t width;   // tile width
  int32_t bs;      // lanes per tile
  int32_t b_pad;   // slab lanes
  int32_t k_n;     // fold list entries [0, k_n)
  int32_t n_blk;   // CUDA blocks: entries of blk_ids
  int32_t nbytes;  // wire bytes per event, 1-4
  int32_t dense;   // 1: words [k, width, bs, nbytes]; 0: flat words [rows, nbytes]
  int32_t aligned; // 1: words and every side column start on 16 bytes
  int64_t rows;    // flat rows (flat source)
  const int32_t* i0s;        // [k] first lane of each tile
  const int32_t* t_bases;    // [k] first event of each tile
  const int32_t* blk_ids;    // [n_blk] lane block of each CUDA block
  const int32_t* blk_off;    // [n_blk + 1] CSR offsets into blk_tiles
  const int32_t* blk_tiles;  // tiles covering each lane block, in list order
  const int32_t* lens;       // [b_pad] lane lengths
  const int32_t* ord;        // [b_pad] ordinal bases
  const int32_t* starts;     // [b_pad] first flat row (flat source)
  const uint8_t* words;      // the wire bytes
};

// the reference work list's t_base sentinel: the ordinal add clamps t_base
// below it (engine.py _NOOP_TILE_T)
constexpr int32_t kNoopTileT = 1 << 29;
constexpr int kStages = 2;
constexpr int kStageBytes = 16384;
constexpr int kPrefetch = 8;
constexpr int kUnroll = 4;

// the little-endian u32 word of NB wire bytes (NB a compile-time constant:
// a runtime byte loop doubles the fold's time on the card)
template <int NB>
__device__ __forceinline__ uint32_t load_word(const uint8_t* p) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < NB; ++b) w |= static_cast<uint32_t>(p[b]) << (8 * b);
  return w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// one TMA bulk copy global -> shared, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

// one chunk of the block's walk: rows [r0, r0 + rows) of list entry e (tile k)
struct Chunk {
  int e, k, r0, rows;
};

// the first chunk at or after row r0 of entry e that holds a row some lane
// of the block folds; e == e1 when the walk is over
__device__ __forceinline__ Chunk settle(const ListArgs& la, int e, int r0,
                                        int e1, int blk_len, int chunk) {
  for (; e < e1; ++e, r0 = 0) {
    const int k = la.blk_tiles[e];
    if (k >= la.k_n) break;  // entries ascend in list order
    const int need = min(blk_len - la.t_bases[k], la.width);
    if (r0 < need) return {e, k, r0, min(chunk, need - r0)};
  }
  return {e1, 0, 0, 0};
}

// the part of tile k that lane block [lane0, lane0 + kThreads) covers:
// lanes [lo, lo + n), tile column col = lo - i0, block column dst = lo - lane0
struct Span {
  int n, col, dst;
  bool bulk;  // every copy keeps TMA's 16-byte alignment and size rules
};

__device__ __forceinline__ Span span_of(const ListArgs& la, int i0,
                                        int lane0) {
  const int lo = max(lane0, i0);
  const int hi = min(lane0 + kThreads, i0 + la.bs);
  Span s{hi - lo, lo - i0, lo - lane0, false};
  // side columns are 4-byte and every one of these lanes is a multiple of 8,
  // so the word bytes' rule implies theirs
  const int nb = la.nbytes;
  s.bulk = la.aligned && (la.bs * nb) % 16 == 0 && (s.col * nb) % 16 == 0 &&
           (s.n * nb) % 16 == 0 && (s.dst * nb) % 16 == 0;
  return s;
}

template <class Step, int NB>
__global__ void __launch_bounds__(kThreads)
list_fold_dense_kernel(const ListArgs la, const DecodeArgs dec,
                       const StateArgs sa, int chunk) {
  extern __shared__ __align__(128) unsigned char stage_mem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int32_t warp_max[kThreads / 32];

  const int j = threadIdx.x;
  const int lane0 = la.blk_ids[blockIdx.x] * kThreads;
  const int lane = lane0 + j;
  const bool live = lane < la.b_pad;
  const int e0 = la.blk_off[blockIdx.x];
  const int e1 = la.blk_off[blockIdx.x + 1];
  constexpr int nb = NB;

  uint32_t st[Step::kState];
  int32_t len = 0;
  uint32_t ord = 0;
  if (live) {
    load_carry<Step>(sa, lane, st);
    len = la.lens[lane];
    ord = static_cast<uint32_t>(la.ord[lane]);
  }
  // the block's longest lane bounds the rows any tile stages
  const int m = __reduce_max_sync(0xffffffffu, live ? len : 0);
  if ((j & 31) == 0) warp_max[j >> 5] = m;
  if (j == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int blk_len = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) blk_len = max(blk_len, warp_max[w]);

  // a stage: words [chunk][kThreads][nbytes], then one [chunk][kThreads] u32
  // region per side column
  int slot[Step::kCols];
  int n_side = 0;
#pragma unroll
  for (int c = 0; c < Step::kCols; ++c) slot[c] = dec.kind[c] == kSide ? n_side++ : -1;
  const size_t word_bytes = static_cast<size_t>(chunk) * kThreads * nb;
  const size_t stage_bytes = word_bytes + static_cast<size_t>(chunk) * kThreads * 4 * n_side;

  // warp 0 stages chunk c into stage s (or, off the bulk path, only arrives)
  auto issue = [&](const Chunk& c, int s) {
    const Span sp = span_of(la, la.i0s[c.k], lane0);
    if (!sp.bulk) {
      if (j == 0) mbar_arrive(&full[s]);
      return;
    }
    unsigned char* base = stage_mem + s * stage_bytes;
    if (j == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive_tx(&full[s], static_cast<uint32_t>(c.rows) * sp.n * (nb + 4 * n_side));
    }
    __syncwarp();
    for (int r = j; r < c.rows; r += 32) {
      const size_t g = (static_cast<size_t>(c.k) * la.width + c.r0 + r) * la.bs + sp.col;
      const size_t d = static_cast<size_t>(r) * kThreads + sp.dst;
      bulk_copy(base + d * nb, la.words + g * nb, sp.n * nb, &full[s]);
#pragma unroll
      for (int cc = 0; cc < Step::kCols; ++cc) {
        if (slot[cc] >= 0) {
          bulk_copy(base + word_bytes + (static_cast<size_t>(slot[cc]) * chunk * kThreads + d) * 4,
                    dec.side[cc] + g, sp.n * 4, &full[s]);
        }
      }
    }
  };

  Chunk prod = settle(la, e0, 0, e1, blk_len, chunk);
  Chunk cons = prod;
  for (int s = 0; s < kStages && prod.e < e1; ++s) {
    if (j < 32) issue(prod, s);
    prod = settle(la, prod.e, prod.r0 + chunk, e1, blk_len, chunk);
  }
  for (int q = 0; cons.e < e1; ++q) {
    const int s = q % kStages;
    mbar_wait(&full[s], (q / kStages) & 1);
    const int i0 = la.i0s[cons.k];
    if (live && lane >= i0 && lane < i0 + la.bs) {
      const int32_t tb = la.t_bases[cons.k];
      const int r_end = min(cons.r0 + cons.rows, min(len - tb, la.width));
      const uint32_t ob = ord + static_cast<uint32_t>(min(tb, kNoopTileT - 1));
      if (span_of(la, i0, lane0).bulk) {
        const unsigned char* base = stage_mem + s * stage_bytes;
        DecodeArgs d = dec;  // side values read from the stage
#pragma unroll
        for (int cc = 0; cc < Step::kCols; ++cc) {
          if (slot[cc] >= 0) {
            d.side[cc] = reinterpret_cast<const uint32_t*>(
                base + word_bytes + static_cast<size_t>(slot[cc]) * chunk * kThreads * 4);
          }
        }
#pragma unroll kUnroll
        for (int r = cons.r0; r < r_end; ++r) {
          const size_t row = static_cast<size_t>(r - cons.r0) * kThreads + j;
          fold_word<Step>(d, st, load_word<NB>(base + row * nb), row, true,
                          ob + static_cast<uint32_t>(r) + 1u);
        }
      } else {
        const size_t col = static_cast<size_t>(cons.k) * la.width * la.bs + (lane - i0);
#pragma unroll kUnroll
        for (int r = cons.r0; r < r_end; ++r) {
          const size_t g = col + static_cast<size_t>(r) * la.bs;
          fold_word<Step>(dec, st, load_word<NB>(la.words + g * nb), g, true,
                          ob + static_cast<uint32_t>(r) + 1u);
        }
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (prod.e < e1) {
      if (j < 32) issue(prod, s);
      prod = settle(la, prod.e, prod.r0 + chunk, e1, blk_len, chunk);
    }
    cons = settle(la, cons.e, cons.r0 + chunk, e1, blk_len, chunk);
  }
  if (live) store_carry<Step>(sa, lane, st);
}

template <class Step, int NB>
__global__ void __launch_bounds__(kThreads)
list_fold_flat_kernel(const ListArgs la, const DecodeArgs dec,
                      const StateArgs sa) {
  const int lane = la.blk_ids[blockIdx.x] * kThreads + threadIdx.x;
  if (lane >= la.b_pad) return;
  const int e0 = la.blk_off[blockIdx.x];
  const int e1 = la.blk_off[blockIdx.x + 1];
  constexpr int nb = NB;

  uint32_t st[Step::kState];
  load_carry<Step>(sa, lane, st);
  const int32_t len = la.lens[lane];
  const uint32_t ord = static_cast<uint32_t>(la.ord[lane]);
  const int64_t start = la.starts[lane];
  const int64_t last = la.rows - la.width;
  for (int e = e0; e < e1; ++e) {
    const int k = la.blk_tiles[e];
    if (k >= la.k_n) break;
    const int i0 = la.i0s[k];
    if (lane < i0 || lane >= i0 + la.bs) continue;
    const int32_t tb = la.t_bases[k];
    const int n = min(len - tb, la.width);
    if (n <= 0) continue;
    int64_t s0 = start + tb;
    s0 = s0 < 0 ? 0 : (s0 > last ? last : s0);
    const uint32_t ob = ord + static_cast<uint32_t>(min(tb, kNoopTileT - 1));
    for (int r = 0; r < n; r += kPrefetch) {
      uint32_t w[kPrefetch];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        w[u] = r + u < n ? load_word<NB>(la.words + (s0 + r + u) * nb) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        if (r + u < n) {
          fold_word<Step>(dec, st, w[u], static_cast<size_t>(s0 + r + u), true,
                          ob + static_cast<uint32_t>(r + u) + 1u);
        }
      }
    }
  }
  store_carry<Step>(sa, lane, st);
}

template <class Step>
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const DecodeArgs dec, const StateArgs sa,
                 const uint32_t* __restrict__ words,
                 const int32_t* __restrict__ lens_rel,
                 const int32_t* __restrict__ ord_rel, int width, int bs) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= bs) return;

  uint32_t st[Step::kState];
  load_carry<Step>(sa, lane, st);
  const int32_t len = lens_rel[lane];
  const uint32_t ord = static_cast<uint32_t>(ord_rel[lane]);
  for (int t = 0; t < width; ++t) {
    const size_t row = static_cast<size_t>(t) * bs + lane;
    fold_word<Step>(dec, st, words[row], row, t < len,
                    ord + static_cast<uint32_t>(t) + 1u);
  }
  store_carry<Step>(sa, lane, st);
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

template <class Step, int NB>
int launch_list(const ListArgs* la, const DecodeArgs* dec, const StateArgs* sa,
                cudaStream_t stream) {
  if (!la->dense) {
    list_fold_flat_kernel<Step, NB><<<la->n_blk, kThreads, 0, stream>>>(*la, *dec, *sa);
    return static_cast<int>(cudaGetLastError());
  }
  int n_side = 0;
  for (int c = 0; c < dec->n_cols; ++c) n_side += dec->kind[c] == kSide;
  const int per_row = kThreads * (la->nbytes + 4 * n_side);
  int chunk = kStageBytes / per_row;
  chunk = chunk < 1 ? 1 : (chunk > la->width ? la->width : chunk);
  const size_t smem = static_cast<size_t>(kStages) * chunk * per_row;
  list_fold_dense_kernel<Step, NB><<<la->n_blk, kThreads, smem, stream>>>(
      *la, *dec, *sa, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <class Step>
int launch_list(const ListArgs* la, const DecodeArgs* dec, const StateArgs* sa,
                cudaStream_t stream) {
  if (dec->n_cols != Step::kCols || sa->n_state != Step::kState) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (la->n_blk == 0) return 0;
  switch (la->nbytes) {
    case 1: return launch_list<Step, 1>(la, dec, sa, stream);
    case 2: return launch_list<Step, 2>(la, dec, sa, stream);
    case 3: return launch_list<Step, 3>(la, dec, sa, stream);
    case 4: return launch_list<Step, 4>(la, dec, sa, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace surge_k1

using surge_fold::BankAccountStep;
using surge_fold::CounterStep;
using surge_fold::DecodeArgs;
using surge_fold::StateArgs;
using surge_k1::ListArgs;

// the C interface: the parameter types live in a named namespace, so these
// keep external linkage
extern "C" {

// step ids, in the order of fold_kernels.KERNEL_STEPS: 0 counter, 1 bank_account
int surge_tile_scan_shape(int step, int* n_cols, int* n_state) {
  return surge_fold::step_shape(step, n_cols, n_state);
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

// the size of ListArgs, so the ctypes mirror can be checked against it
int surge_tile_fold_list_args_size() { return static_cast<int>(sizeof(ListArgs)); }

int surge_tile_fold_list(int step, const ListArgs* la, const DecodeArgs* dec,
                         const StateArgs* sa, void* stream) {
  if (la->width <= 0 || la->bs <= 0 || la->b_pad <= 0 || la->k_n < 0 ||
      la->n_blk < 0 || la->nbytes < 1 || la->nbytes > 4 ||
      (!la->dense && la->rows < la->width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (step) {
    case 0:
      return surge_k1::launch_list<CounterStep>(la, dec, sa, s);
    case 1:
      return surge_k1::launch_list<BankAccountStep>(la, dec, sa, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
