// K2 — the ragged refresh fold, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// surge_tpu/replay/pallas_fold.py:make_ragged_fold (its pl.pallas_call at
// pallas_fold.py:170). One refresh bucket's events lie lane-contiguous in one
// flat packed buffer words[rows] (with side columns side[c][rows]); lane b at
// step t < width reads row min(starts[b] + t, rows - 1), valid while
// t < lens[b], with the derived ordinal ord[b] + t + 1 (wrapping u32). The
// decode and the model steps are K1's (fold_common.cuh); a side column is
// indexed by the flat row. A clipped read lands in another lane's events or
// in the pad rows; only the valid mask keeps the result right.
//
// Design. One thread per lane, blocks of kThreads lanes, a grid of
// ceil(bs / kThreads); the ragged edge is masked, so bs needs no divisor. The
// carry stays in registers for all width steps. Unlike the Pallas kernel,
// which staged the whole flat buffer into each grid cell's VMEM, every step
// reads its row straight from global memory. Adjacent lanes read rows that
// lie a lane's length apart, so a warp's reads are not coalesced; for the
// short refresh buckets (widths 2-8) that is accepted here. One warp per lane
// group staging the bucket's contiguous rows through shared memory is the
// later redesign.
//
// Bound. One launch moves rows x (4 + 4 x side columns) bytes of words and
// sides plus bs x (12 + carry in and out) bytes. At a steady bucket (bs 4096,
// width 8, rows 32768, counter with a derived ordinal) that is about 0.2 MB,
// about 0.06 us at 3.35 TB/s: far below a launch's latency, so the launch and
// the host round around it set the pace, not the kernel's memory traffic.
//
// Interface: a plain C function (surge_ragged_fold) that launches on the
// given stream and returns the cudaError_t of the launch; loaded with ctypes
// by surge_tpu_torch/replay/fold_kernels.py. Preconditions the wrapper
// checks: rows >= 1, bs >= 1, width >= 0. starts[b] >= 0 is the caller's
// contract (a negative start clamps to row 0, as the plain version does).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "fold_common.cuh"

namespace surge_k2 {

using namespace surge_fold;

template <class Step>
__global__ void __launch_bounds__(kThreads)
ragged_fold_kernel(const DecodeArgs dec, const StateArgs sa,
                   const uint32_t* __restrict__ words,
                   const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ ord, int width, int rows,
                   int bs) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= bs) return;

  uint32_t st[Step::kState];
  load_carry<Step>(sa, lane, st);
  const int64_t start = starts[lane];
  const int32_t len = lens[lane];
  const uint32_t base = static_cast<uint32_t>(ord[lane]);
  const int64_t last = static_cast<int64_t>(rows) - 1;
  for (int t = 0; t < width; ++t) {
    int64_t r = start + t;
    r = r < 0 ? 0 : (r > last ? last : r);
    const size_t row = static_cast<size_t>(r);
    fold_word<Step>(dec, st, words[row], row, t < len,
                    base + static_cast<uint32_t>(t) + 1u);
  }
  store_carry<Step>(sa, lane, st);
}

template <class Step>
int launch(const DecodeArgs* dec, const StateArgs* sa, const uint32_t* words,
           const int32_t* starts, const int32_t* lens, const int32_t* ord,
           int width, int rows, int bs, cudaStream_t stream) {
  if (dec->n_cols != Step::kCols || sa->n_state != Step::kState) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((bs + kThreads - 1) / kThreads);
  ragged_fold_kernel<Step><<<grid, kThreads, 0, stream>>>(
      *dec, *sa, words, starts, lens, ord, width, rows, bs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace surge_k2

using surge_fold::BankAccountStep;
using surge_fold::CounterStep;
using surge_fold::DecodeArgs;
using surge_fold::StateArgs;

// the C interface: the parameter types live in a named namespace, so these
// keep external linkage
extern "C" {

// step ids, in the order of fold_kernels.KERNEL_STEPS: 0 counter, 1 bank_account
int surge_ragged_fold_shape(int step, int* n_cols, int* n_state) {
  return surge_fold::step_shape(step, n_cols, n_state);
}

int surge_ragged_fold(int step, int width, int rows, int bs,
                      const uint32_t* words, const int32_t* starts,
                      const int32_t* lens, const int32_t* ord,
                      const DecodeArgs* dec, const StateArgs* sa,
                      void* stream) {
  if (bs <= 0 || rows <= 0 || width < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (step) {
    case 0:
      return surge_k2::launch<CounterStep>(dec, sa, words, starts, lens, ord,
                                           width, rows, bs, s);
    case 1:
      return surge_k2::launch<BankAccountStep>(dec, sa, words, starts, lens,
                                               ord, width, rows, bs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
