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
// is read coalesced across a warp. The decode and the model steps are the
// ones K2 uses (fold_common.cuh).
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

#include "fold_common.cuh"

namespace surge_k1 {

using namespace surge_fold;

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

}  // namespace surge_k1

using surge_fold::BankAccountStep;
using surge_fold::CounterStep;
using surge_fold::DecodeArgs;
using surge_fold::StateArgs;

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

}  // extern "C"
