// K5: minimizer selection of the forced v1 path into the slot grid
// (values_argmin).
//
// Replaces the TPU kernel values_argmin_fused in
// deacon_tpu/ops/pallas_kernels.py (body _values_kernel_body), the JAX
// package's forced v1 path (DEACON_PALLAS=1, on every arch). The TPU
// kernel writes dense (R, L) planes, the canonical value of the k-mer at
// every column and the window argmin wp, for a flag mask, a gather at wp
// and a compaction after it. Here all of that is the kernel: for
// 1 <= k <= 56 on any tile (any R, 128 | L <= 16384) the route's
// function is K3's, so this kernel writes the slot grid as K3 does (slot
// j < Br of a row gets wp and the canonical value at wp of the row's j-th
// flagged window, int64 lo, and hi for k > 32: the 128-bit value's
// halves; the row total whatever Br is) with select_rows.cuh's 64-bit
// instantiation for k <= 32 and its 128-bit one above, under its own
// name. Unlike the TPU kernel it takes the validity bits and allow_short:
// the flag mask that followed it read them.
//
// What bounds it on an H100: integer instruction throughput, ~40
// operations per base for k <= 32 and ~80 for 128-bit values, against
// L/4 + L/8 bytes read per row and 12 bytes (20 for k > 32) written per
// selected window. The first version of this kernel wrote 12-20 bytes
// per base, rebuilt each k-mer from k shared-memory codes and rescanned
// w keys per column; the flag mask, gather and compaction after it cost
// more than the kernel.

#include <cstdint>
#include <cuda_runtime.h>

#include "select_rows.cuh"

namespace {

template <int N, bool kWarpRow, bool kWide>
__global__ void __launch_bounds__(kWarpRow ? kWarpRows * 32 : kMaxThreads)
values_argmin_kernel(
    const uint8_t* __restrict__ pc, const uint8_t* __restrict__ pv,
    const int32_t* __restrict__ mlen, const uint8_t* __restrict__ allow,
    int32_t* __restrict__ pos_out, int64_t* __restrict__ lo_out,
    int64_t* __restrict__ hi_out, int32_t* __restrict__ tot_out, int R,
    int L, int k, int w, int Br, bool vec) {
  extern __shared__ __align__(16) uint64_t smem[];
  select_rows<N, kWarpRow, kWide>(smem, pc, pv, mlen, allow, pos_out,
                                  lo_out, hi_out, tot_out, R, L, k, w, Br,
                                  vec);
}

template <int N, bool kWarpRow, bool kWide>
cudaError_t launch(const void* pc, const void* pv, const void* mlen,
                   const void* allow, void* pos, void* lo, void* hi,
                   void* tot, int R, int L, int k, int w, int Br,
                   cudaStream_t stream) {
  static size_t limit[kMaxDevices] = {};
  const int T = row_threads<N, kWarpRow>(L);
  const int rows = kWarpRow ? kWarpRows : 1;
  const size_t smem = 8u * row_words(T, N, L, kWide) * rows;
  auto kernel = values_argmin_kernel<N, kWarpRow, kWide>;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), smem, limit);
  if (err != cudaSuccess) return err;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(pc) | reinterpret_cast<uintptr_t>(pv)) &
       15u) == 0;
  kernel<<<(R + rows - 1) / rows, rows * T, smem, stream>>>(
      static_cast<const uint8_t*>(pc), static_cast<const uint8_t*>(pv),
      static_cast<const int32_t*>(mlen), static_cast<const uint8_t*>(allow),
      static_cast<int32_t*>(pos), static_cast<int64_t*>(lo),
      static_cast<int64_t*>(hi), static_cast<int32_t*>(tot), R, L, k, w, Br,
      vec);
  return cudaGetLastError();
}

template <bool kWide>
cudaError_t dispatch(const void* pc, const void* pv, const void* mlen,
                     const void* allow, void* pos, void* lo, void* hi,
                     void* tot, int R, int L, int k, int w, int Br,
                     cudaStream_t s) {
  if (L <= 256)
    return launch<8, true, kWide>(pc, pv, mlen, allow, pos, lo, hi, tot, R,
                                  L, k, w, Br, s);
  if (L <= 4096)
    return launch<8, false, kWide>(pc, pv, mlen, allow, pos, lo, hi, tot,
                                   R, L, k, w, Br, s);
  return launch<16, false, kWide>(pc, pv, mlen, allow, pos, lo, hi, tot, R,
                                  L, k, w, Br, s);
}

}  // namespace

// hi may be null for k <= 32 (it is not written there).
extern "C" int dx_values_argmin(const void* pc, const void* pv,
                                const void* mlen, const void* allow,
                                void* pos, void* lo, void* hi, void* tot,
                                int R, int L, int k, int w, int Br,
                                void* stream) {
  if (R <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      k <= 32 ? dispatch<false>(pc, pv, mlen, allow, pos, lo, hi, tot, R, L,
                                k, w, Br, s)
              : dispatch<true>(pc, pv, mlen, allow, pos, lo, hi, tot, R, L,
                               k, w, Br, s);
  return static_cast<int>(err);
}
