// K1: minimizer extraction and per-row compaction (select_compact).
//
// Replaces the TPU kernel select_compact_packed in
// deacon_tpu/ops/pallas_kernels.py (body _select_compact_kernel_body).
// For k <= 32 it selects each row's minimizers into the slot grid: slot
// j < Br gets (wp, 64-bit canonical value at wp) of the row's j-th
// flagged window, and the row total is written whatever Br is. The
// function, its bound and the design are select_rows.cuh's (shared with
// K3, csrc/values_select.cu).
//
// What bounds it on an H100: integer instruction throughput (a few dozen
// operations per base against ~1.9 bytes per base of traffic at w = 15).
// The first version of this kernel missed it by ~50x: it rebuilt every
// k-mer from k shared-memory bytes, rescanned k validity bytes and w keys
// per column, kept 9 bytes of shared memory per base and synchronised its
// block twice per blockDim columns of the compaction.

#include <cstdint>
#include <cuda_runtime.h>

#include "select_rows.cuh"

namespace {

template <int N, bool kWarpRow>
__global__ void __launch_bounds__(kWarpRow ? kWarpRows * 32 : kMaxThreads)
select_compact_kernel(
    const uint8_t* __restrict__ pc, const uint8_t* __restrict__ pv,
    const int32_t* __restrict__ mlen, const uint8_t* __restrict__ allow,
    int32_t* __restrict__ pos_out, int64_t* __restrict__ val_out,
    int32_t* __restrict__ tot_out, int R, int L, int k, int w, int Br,
    bool vec) {
  extern __shared__ __align__(16) uint64_t smem[];
  select_rows<N, kWarpRow, false>(smem, pc, pv, mlen, allow, pos_out,
                                  val_out, nullptr, tot_out, R, L, k, w, Br,
                                  vec);
}

template <int N, bool kWarpRow>
cudaError_t launch(const void* pc, const void* pv, const void* mlen,
                   const void* allow, void* pos, void* val, void* tot, int R,
                   int L, int k, int w, int Br, cudaStream_t stream) {
  static size_t limit[kMaxDevices] = {};
  const int T = row_threads<N, kWarpRow>(L);
  const int rows = kWarpRow ? kWarpRows : 1;
  const size_t smem = 8u * row_words(T, N, L, false) * rows;
  auto kernel = select_compact_kernel<N, kWarpRow>;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), smem, limit);
  if (err != cudaSuccess) return err;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(pc) | reinterpret_cast<uintptr_t>(pv)) &
       15u) == 0;
  kernel<<<(R + rows - 1) / rows, rows * T, smem, stream>>>(
      static_cast<const uint8_t*>(pc), static_cast<const uint8_t*>(pv),
      static_cast<const int32_t*>(mlen), static_cast<const uint8_t*>(allow),
      static_cast<int32_t*>(pos), static_cast<int64_t*>(val),
      static_cast<int32_t*>(tot), R, L, k, w, Br, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dx_select_compact(const void* pc, const void* pv,
                                 const void* mlen, const void* allow,
                                 void* pos, void* val, void* tot, int R,
                                 int L, int k, int w, int Br, void* stream) {
  if (R <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (L <= 256)
    err = launch<8, true>(pc, pv, mlen, allow, pos, val, tot, R, L, k, w,
                          Br, s);
  else if (L <= 4096)
    err = launch<8, false>(pc, pv, mlen, allow, pos, val, tot, R, L, k, w,
                           Br, s);
  else
    err = launch<16, false>(pc, pv, mlen, allow, pos, val, tot, R, L, k, w,
                            Br, s);
  return static_cast<int>(err);
}
