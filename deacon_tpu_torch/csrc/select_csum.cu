// K4: minimizer selection of arch-3 tiles into the slot grid
// (select_csum).
//
// Replaces the TPU kernel select_csum_packed in
// deacon_tpu/ops/pallas_kernels.py (body _select_csum_kernel_body), the
// JAX package's "arch 3": tiles whose L is a multiple of 128 but not a
// power of two, or any eligible tile under DEACON_ENGINE=3. The TPU kernel
// writes a dense (R, L) plane, the in-row cumsum of the window flags with
// wp beside it, from which the JAX package finds each slot's window by a
// batch-wide compaction and rebuilds the value at wp. Here the compaction
// is part of the kernel: for k <= 32 and any L with 128 | L <= 16384 the
// route's function is K1's, so this kernel writes the slot grid as K1
// does (slot j < Br of a row gets wp and the 64-bit canonical value at wp
// of the row's j-th flagged window; the row total whatever Br is) with
// K1's 64-bit instantiation of select_rows.cuh, under its own name.
//
// What bounds it on an H100: integer instruction throughput (~40
// operations per base against L/4 + L/8 bytes read per row and 12 bytes
// written per selected window). The first version of this kernel wrote
// 4 bytes per base and rebuilt each k-mer from k shared-memory codes and
// rescanned w keys per column, and the slot grid cost ~20 torch kernels
// after it (a per-row searchsorted, gathers, the value rebuilt at wp).

#include <cstdint>
#include <cuda_runtime.h>

#include "select_rows.cuh"

namespace {

template <int N, bool kWarpRow>
__global__ void __launch_bounds__(kWarpRow ? kWarpRows * 32 : kMaxThreads)
select_csum_kernel(
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
  auto kernel = select_csum_kernel<N, kWarpRow>;
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

extern "C" int dx_select_csum(const void* pc, const void* pv,
                              const void* mlen, const void* allow, void* pos,
                              void* val, void* tot, int R, int L, int k,
                              int w, int Br, void* stream) {
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
