// K1 — the resident tile scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel surge_tpu/replay/pallas_fold.py:make_tile_scan
// (its pl.pallas_call at pallas_fold.py:86): for each lane b and each step
// t < width it decodes words[t, b] (type bits, bit-packed fields, side values,
// the derived ordinal ord_rel[b] + t + 1; padding when t >= lens_rel[b]) and
// applies the model's branchless select step to the lane's carry. The decode
// and the model steps are the ones K2 uses (fold_common.cuh). Two entries:
//
// surge_dense_window — one refresh window of the resident state plane's
// dense dispatch, run against the slab by slot: the K1 tile fold together
// with the rest of the reference's window program
// (surge_tpu/replay/resident_state.py:435-453, `refresh`). Lane b of the
// window (its lane table, fold_common.cuh LaneRow) starts from its admitted
// row on a plan's first window, else from slab[slot[b]]; folds the
// time-major wire bytes words[t, b] (u8 [width, lanes, nbytes]) for
// t < min(count[b], width), with the derived ordinal base + t + 1; stores
// its carry back by slot and advances ords[slot] by the count. Padding lanes
// (slot == capacity) load and store nothing, and a block whose lanes all pad
// exits at once (live lanes come first). Design: a window holds ~8,000 live
// lanes of 32,768, most with a few events and a tail of up to 512, so the
// block's longest lane bounds the rows it stages. The block stages its lanes'
// rows [0, longest) through the two-stage shared-memory ring the list fold
// uses (Ring: one cp.async.bulk per row and per side row, issued by warp 0
// and completing on the stage's mbarrier), and each lane stops at its count;
// off TMA's 16-byte rules the block's lanes read their slots from device
// memory (fold_column). Blocks are kWindowLanes (64) lanes; the launch
// reports each block's path when the caller asks.
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
//   the kernel: each thread reads its slots from global memory
//   (fold_column). The ring and both paths are the dense window's.
// - Flat source (flat_wire u8 [rows, nbytes], sides [rows], starts): lane b's
//   tile row t is clamp(starts[b] + t_base, 0, rows - width) + t, exactly as
//   the slab index clamps. Adjacent lanes' rows lie a lane's length apart, so
//   nothing is staged: each thread issues the loads of kPrefetch rows before
//   the dependent steps use them (fold_rows_global, as K2's global path).
// Bound of the dense window: the wire bytes and side values of each slot a
// lane folds, every lane's slot, each live lane's count (and admit flag), an
// admitted lane's ordinal and values, each live lane's carry and ordinal in
// and out by slot (chip_smoke.py window_work counts them); the longest
// lane's dependent steps set its time.
// Bound of the list fold: every input byte the list needs read once — the
// wire bytes and side values of each slot some lane folds (t < lens_rel),
// each touched lane's length, ordinal (and start) and its carry in and out. At the bench plan
// (1M lanes, 100M events, one wire byte an event) that is ~124 MB, ~37 us at
// 3.35 TB/s; the longest lane walks 1,428 dependent steps.
//
// Interface: plain C functions that launch on the given stream and return
// the cudaError_t of the launch; loaded with ctypes by
// surge_tpu_torch/replay/fold_kernels.py (which mirrors ListArgs and
// SlabArgs).

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
constexpr int kUnroll = 4;

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

// The two-stage ring both dense kernels stage time rows through. A stage
// holds `chunk` rows of the block's kLanes lanes: the wire bytes
// [chunk][kLanes][NB], then one [chunk][kLanes] u32 region per side column.
// Warp 0 issues one cp.async.bulk (TMA) copy per row and per side row,
// completing on the stage's mbarrier; every thread then folds its lane
// column out of the stage.
// The stages live in the launch's dynamic shared memory, ring_mem; stage s
// completes on the mbarrier ring_full[s].
extern __shared__ __align__(128) unsigned char ring_mem[];
__shared__ __align__(8) uint64_t ring_full[kStages];

template <class Step, int NB, int kLanes>
struct Ring {
  int chunk;
  int n_side;
  int slot[Step::kCols];  // each column's side region; -1: not a side column
  size_t word_bytes, stage_bytes;

  __device__ __forceinline__ Ring(const DecodeArgs& dec, int chunk_)
      : chunk(chunk_), n_side(0) {
#pragma unroll
    for (int c = 0; c < Step::kCols; ++c) {
      slot[c] = dec.kind[c] == kSide ? n_side++ : -1;
    }
    word_bytes = static_cast<size_t>(chunk) * kLanes * NB;
    stage_bytes = word_bytes + static_cast<size_t>(chunk) * kLanes * 4 * n_side;
  }

  // warp 0: stage rows [row0, row0 + rows) of n lanes into stage s from
  // block column dst on; row t's lanes start at element t * stride + col of
  // the words and of each side column. The list fold writes these steps out
  // in its own loop (see there): change both together.
  __device__ __forceinline__ void issue(const DecodeArgs& dec,
                                        const uint8_t* words, int s,
                                        size_t row0, size_t stride, size_t col,
                                        int rows, int n, int dst) const {
    const int j = threadIdx.x;
    unsigned char* base = ring_mem + s * stage_bytes;
    if (j == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive_tx(&ring_full[s], static_cast<uint32_t>(rows) * n * (NB + 4 * n_side));
    }
    __syncwarp();
    for (int r = j; r < rows; r += 32) {
      const size_t g = (row0 + r) * stride + col;
      const size_t d = static_cast<size_t>(r) * kLanes + dst;
      bulk_copy(base + d * NB, words + g * NB, n * NB, &ring_full[s]);
#pragma unroll
      for (int c = 0; c < Step::kCols; ++c) {
        if (slot[c] >= 0) {
          bulk_copy(base + word_bytes + (static_cast<size_t>(slot[c]) * chunk * kLanes + d) * 4,
                    dec.side[c] + g, n * 4, &ring_full[s]);
        }
      }
    }
  }

  // warp 0: stage s receives no copy this turn; complete its phase
  __device__ __forceinline__ void skip(int s) const {
    if (threadIdx.x == 0) mbar_arrive(&ring_full[s]);
  }

  // wait for the q-th fill of the ring (its stage q % kStages)
  __device__ __forceinline__ void wait(int q) const {
    mbar_wait(&ring_full[q % kStages], (q / kStages) & 1);
  }

  // fold rows [r_first, r_end) of stage s, which holds rows from r_first
  // on, into block column col's carry, with the derived ordinal ob + r + 1
  __device__ __forceinline__ void fold(const DecodeArgs& dec,
                                       uint32_t (&st)[Step::kState], int s,
                                       int r_first, int r_end, int col,
                                       uint32_t ob) const {
    const unsigned char* base = ring_mem + s * stage_bytes;
    DecodeArgs d = dec;  // side values read from the stage
#pragma unroll
    for (int c = 0; c < Step::kCols; ++c) {
      if (slot[c] >= 0) {
        d.side[c] = reinterpret_cast<const uint32_t*>(
            base + word_bytes + static_cast<size_t>(slot[c]) * chunk * kLanes * 4);
      }
    }
#pragma unroll kUnroll
    for (int r = r_first; r < r_end; ++r) {
      const size_t row = static_cast<size_t>(r - r_first) * kLanes + col;
      fold_word<Step>(d, st, load_word<NB>(base + row * NB), row, true,
                      ob + static_cast<uint32_t>(r) + 1u);
    }
  }
};

// every thread of a block of kLanes: the block's largest v, with the ring's
// barriers set up (ends on __syncthreads)
template <int kLanes>
__device__ __forceinline__ int ring_setup(int32_t* warp_max, int v) {
  const int m = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&ring_full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int r = warp_max[0];
#pragma unroll
  for (int w = 1; w < kLanes / 32; ++w) r = max(r, warp_max[w]);
  return r;
}

// rows a stage of kLanes lanes holds (at most kStageBytes, at most width)
// and the ring's shared memory
inline int ring_chunk(const DecodeArgs* dec, int lanes, int nbytes, int width,
                      size_t* smem) {
  int n_side = 0;
  for (int c = 0; c < dec->n_cols; ++c) n_side += dec->kind[c] == kSide;
  const int per_row = lanes * (nbytes + 4 * n_side);
  int chunk = kStageBytes / per_row;
  chunk = chunk < 1 ? 1 : (chunk > width ? width : chunk);
  *smem = static_cast<size_t>(kStages) * chunk * per_row;
  return chunk;
}

// Fold rows [r0, r_end) of one lane column straight from device memory:
// row r at element col + r * stride of the words and of each side column,
// with the derived ordinal ob + r + 1 (the dense kernels' path off TMA's
// rules)
template <class Step, int NB>
__device__ __forceinline__ void fold_column(const DecodeArgs& dec,
                                            uint32_t (&st)[Step::kState],
                                            const uint8_t* words, size_t col,
                                            size_t stride, int r0, int r_end,
                                            uint32_t ob) {
#pragma unroll kUnroll
  for (int r = r0; r < r_end; ++r) {
    const size_t g = col + static_cast<size_t>(r) * stride;
    fold_word<Step>(dec, st, load_word<NB>(words + g * NB), g, true,
                    ob + static_cast<uint32_t>(r) + 1u);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  __shared__ int32_t warp_max[kThreads / 32];

  const int j = threadIdx.x;
  const int lane0 = la.blk_ids[blockIdx.x] * kThreads;
  const int lane = lane0 + j;
  const bool live = lane < la.b_pad;
  const int e0 = la.blk_off[blockIdx.x];
  const int e1 = la.blk_off[blockIdx.x + 1];

  uint32_t st[Step::kState];
  int32_t len = 0;
  uint32_t ord = 0;
  if (live) {
    load_carry<Step>(sa, lane, st);
    len = la.lens[lane];
    ord = static_cast<uint32_t>(la.ord[lane]);
  }
  // the block's longest lane bounds the rows any tile stages
  const int blk_len = ring_setup<kThreads>(warp_max, live ? len : 0);
  const Ring<Step, NB, kThreads> ring(dec, chunk);

  // warp 0 stages chunk c into stage s (or, off the bulk path, only
  // arrives). These are Ring::issue's steps written out: as a call, nvcc
  // gives the one-byte counter kernel 62 registers instead of 48, and the
  // bench plan's big list ran 8% slower on an H100 (chip_smoke.py phase 1)
  auto issue = [&](const Chunk& c, int s) {
    const Span sp = span_of(la, la.i0s[c.k], lane0);
    if (!sp.bulk) {
      ring.skip(s);
      return;
    }
    unsigned char* base = ring_mem + s * ring.stage_bytes;
    if (j == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive_tx(&ring_full[s], static_cast<uint32_t>(c.rows) * sp.n * (NB + 4 * ring.n_side));
    }
    __syncwarp();
    for (int r = j; r < c.rows; r += 32) {
      const size_t g = (static_cast<size_t>(c.k) * la.width + c.r0 + r) * la.bs + sp.col;
      const size_t d = static_cast<size_t>(r) * kThreads + sp.dst;
      bulk_copy(base + d * NB, la.words + g * NB, sp.n * NB, &ring_full[s]);
#pragma unroll
      for (int cc = 0; cc < Step::kCols; ++cc) {
        if (ring.slot[cc] >= 0) {
          bulk_copy(base + ring.word_bytes + (static_cast<size_t>(ring.slot[cc]) * chunk * kThreads + d) * 4,
                    dec.side[cc] + g, sp.n * 4, &ring_full[s]);
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
    ring.wait(q);
    const int i0 = la.i0s[cons.k];
    if (live && lane >= i0 && lane < i0 + la.bs) {
      const int32_t tb = la.t_bases[cons.k];
      const int r_end = min(cons.r0 + cons.rows, min(len - tb, la.width));
      const uint32_t ob = ord + static_cast<uint32_t>(min(tb, kNoopTileT - 1));
      if (span_of(la, i0, lane0).bulk) {
        ring.fold(dec, st, s, cons.r0, r_end, j, ob);
      } else {
        fold_column<Step, NB>(
            dec, st, la.words,
            static_cast<size_t>(cons.k) * la.width * la.bs + (lane - i0), la.bs,
            cons.r0, r_end, ob);
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
    fold_rows_global<Step, NB>(dec, st, la.words, 0, n,
                               [&](int r) { return s0 + r; }, ob);
  }
  store_carry<Step>(sa, lane, st);
}

// K1's dense refresh window (see the head of this file): blocks of
// kWindowLanes lanes; chunk rows a stage. A block stages through the ring
// when every row copy keeps TMA's 16-byte rules (the words and side columns
// start on 16 bytes, a time row's bytes and the block's are multiples of
// 16), else its lanes load from device memory
template <class Step, int NB>
__global__ void __launch_bounds__(kWindowLanes)
dense_window_kernel(const SlabArgs sa, const DecodeArgs dec,
                    const uint8_t* __restrict__ words, int width, int chunk,
                    int8_t* paths) {
  __shared__ int32_t warp_max[kWindowLanes / 32];

  const int j = threadIdx.x;
  const int lane0 = blockIdx.x * kWindowLanes;
  const int lane = lane0 + j;
  Lane l{0, 0, false, false};
  if (lane < sa.lanes) l = lane_of(sa, lane);
  if (!__syncthreads_or(l.live)) {  // every lane pads
    report_path(paths, lane, sa.lanes, kPathNone);
    return;
  }

  const int n = l.live ? min(max(l.count, 0), width) : 0;
  uint32_t st[Step::kState];
  uint32_t base = 0;
  if (l.live) base = load_slot<Step>(sa, lane, l, st);

  // side rows are 4-byte, so the word bytes' rule implies theirs
  const int n_lanes = min(kWindowLanes, sa.lanes - lane0);
  bool bulk = aligned16(words) && (static_cast<int64_t>(sa.lanes) * NB) % 16 == 0 &&
              (n_lanes * NB) % 16 == 0;
#pragma unroll
  for (int c = 0; c < Step::kCols; ++c) {
    if (dec.kind[c] == kSide) bulk = bulk && aligned16(dec.side[c]);
  }
  report_path(paths, lane, sa.lanes, bulk ? kPathStaged : kPathGlobal);
  if (!bulk) {
    if (l.live) {
      fold_column<Step, NB>(dec, st, words, lane, sa.lanes, 0, n, base);
      store_slot<Step>(sa, l, st, base);
    }
    return;
  }

  // the block's longest lane bounds the rows it stages
  const int blk_len = ring_setup<kWindowLanes>(warp_max, n);
  const Ring<Step, NB, kWindowLanes> ring(dec, chunk);
  const int n_chunks = (blk_len + chunk - 1) / chunk;
  // warp 0 stages rows [q * chunk, ...) of the block's lanes into stage s
  auto issue = [&](int q, int s) {
    const int r0 = q * chunk;
    ring.issue(dec, words, s, r0, sa.lanes, lane0, min(chunk, blk_len - r0),
               n_lanes, 0);
  };
  for (int q = 0; q < kStages && q < n_chunks; ++q) {
    if (j < 32) issue(q, q);
  }
  for (int q = 0; q < n_chunks; ++q) {
    const int s = q % kStages;
    ring.wait(q);
    const int r0 = q * chunk;
    ring.fold(dec, st, s, r0, min(r0 + chunk, n), j, base);
    __syncthreads();  // every thread is done with stage s
    if (q + kStages < n_chunks && j < 32) issue(q + kStages, s);
  }
  if (l.live) store_slot<Step>(sa, l, st, base);
}

template <class Step, int NB>
int launch_window_nb(const SlabArgs* sa, const DecodeArgs* dec,
                     const uint8_t* words, int width, int8_t* paths,
                     cudaStream_t stream) {
  size_t smem = 0;
  const int chunk = ring_chunk(dec, kWindowLanes, NB, width, &smem);
  const dim3 grid((sa->lanes + kWindowLanes - 1) / kWindowLanes);
  dense_window_kernel<Step, NB><<<grid, kWindowLanes, smem, stream>>>(
      *sa, *dec, words, width, chunk, paths);
  return static_cast<int>(cudaGetLastError());
}

template <class Step>
int launch_window(const SlabArgs* sa, const DecodeArgs* dec,
                  const uint8_t* words, int nbytes, int width, int8_t* paths,
                  cudaStream_t stream) {
  if (dec->n_cols != Step::kCols || sa->n_state != Step::kState) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return with_wire_bytes<Step>(nbytes, [&](auto nb) {
    return launch_window_nb<Step, decltype(nb)::value>(sa, dec, words, width,
                                                       paths, stream);
  });
}

template <class Step, int NB>
int launch_list(const ListArgs* la, const DecodeArgs* dec, const StateArgs* sa,
                cudaStream_t stream) {
  if (!la->dense) {
    list_fold_flat_kernel<Step, NB><<<la->n_blk, kThreads, 0, stream>>>(*la, *dec, *sa);
    return static_cast<int>(cudaGetLastError());
  }
  size_t smem = 0;
  const int chunk = ring_chunk(dec, kThreads, NB, la->width, &smem);
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
  return with_wire_bytes<Step>(la->nbytes, [&](auto nb) {
    return launch_list<Step, decltype(nb)::value>(la, dec, sa, stream);
  });
}

}  // namespace surge_k1

using surge_fold::DecodeArgs;
using surge_fold::SlabArgs;
using surge_fold::StateArgs;
using surge_k1::ListArgs;

// the C interface: the parameter types live in a named namespace, so these
// keep external linkage
extern "C" {

// step ids, in the order of fold_kernels.KERNEL_STEPS, then 4 for MixedStep
// (surge_fold::with_step)
int surge_tile_scan_shape(int step, int* n_cols, int* n_state) {
  return surge_fold::step_shape(step, n_cols, n_state);
}

int surge_tile_scan_struct_size(int which) {
  return surge_fold::struct_size(which);
}

// MixedStep's maps of part `part` (surge_fold::part_map)
int surge_tile_scan_part_map(int part, int* cols, int* fields) {
  return surge_fold::part_map(part, cols, fields);
}

// one dense refresh window: words u8 [width, lanes, nbytes]; paths, when
// not null, int8 [lanes]: each lane's block's path (WindowPath)
int surge_dense_window(int step, const SlabArgs* sa, const DecodeArgs* dec,
                       const uint8_t* words, int nbytes, int width,
                       int8_t* paths, void* stream) {
  if (sa->lanes <= 0 || width < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return surge_fold::with_step(step, [&](auto st) {
    return surge_k1::launch_window<decltype(st)>(sa, dec, words, nbytes, width,
                                                 paths, s);
  });
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
  return surge_fold::with_step(step, [&](auto st) {
    return surge_k1::launch_list<decltype(st)>(la, dec, sa, s);
  });
}

}  // extern "C"
