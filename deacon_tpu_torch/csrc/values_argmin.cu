// K5: canonical values at every position and the window argmin
// (values_argmin).
//
// Replaces the TPU kernel values_argmin_fused in
// deacon_tpu/ops/pallas_kernels.py (body _values_kernel_body), the JAX
// package's forced v1 path (DEACON_PALLAS=1, on every arch). For every row
// of a tile (L bases as packed 2-bit codes) it computes, at each column p:
//   * the canonical value min(fwd, revcomp) of the k-mer AT p (not at its
//     window's minimum), as a 64-bit integer for k <= 32 or a 128-bit one
//     (two uint64_t halves) for 33 <= k <= 56; bases past L count as code 0
//     on both strands;
//   * wp, the leftmost minimum over [p, p+w) (clipped at L) of the keys
//     (fmix32(xor of the value's 32-bit limbs) & 0xFFFF0000) | p, or
//     0xFFFF0000 | p past the row's k-mer count mlen.
// It takes no validity input and sets no flag: the caller applies the
// flag mask (ops/kernels.flag_mask) and gathers the values at wp. The TPU
// kernel reads one byte per base because the JAX package's unpack stage
// hands it that; this kernel reads the port's packed codes, which carry
// the same bases.
//
// What bounds it on an H100: bytes. A row reads L/4 bytes of packed codes
// and writes 12 bytes per base at k <= 32 (the 8-byte value and the 4-byte
// wp), 20 above (a second 8-byte half): 102.8 MB at the (16384, 512) tile
// at k = 31, 31 us at 3.35 TB/s. This first version rebuilds each k-mer
// from k shared-memory codes and rescans w keys for the minimum, so its
// shared-memory loops, not its stores, set its time.
//
// Design: K3's (csrc/values_select.cu). One block per row; the row's codes
// and keys in shared memory (5 bytes per base, 80 KB at L = 16384, above
// the 48 KB default, hence cudaFuncAttributeMaxDynamicSharedMemorySize).
// Threads take columns in stride, so neighbouring threads write
// neighbouring output words (coalesced stores). The value at p is written
// in the same pass that computes its key; the 64-bit case is a template
// instance of its own, so k <= 32 pays for no 128-bit arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Canonical value of the k-mer at column c as (lo, hi); codes past L
// count as 0 on both strands (the TPU kernel's zero-filled column shifts).
template <bool kWide>
__device__ __forceinline__ void canonical_at(const uint8_t* code, int c,
                                             int L, int k, uint64_t* lo,
                                             uint64_t* hi) {
  uint64_t flo = 0, fhi = 0, rlo = 0, rhi = 0;
  for (int i = 0; i < k; ++i) {
    const int j = c + i;
    const uint64_t cf = j < L ? code[j] : 0u;
    const uint64_t cr = j < L ? (code[j] ^ 2u) : 0u;
    if (!kWide || i < 32) {
      flo |= cf << (2 * i);
    } else {
      fhi |= cf << (2 * (i - 32));
    }
    if (kWide) rhi = (rhi << 2) | (rlo >> 62);
    rlo = (rlo << 2) | cr;
  }
  const bool take_f = fhi < rhi || (fhi == rhi && flo <= rlo);
  *lo = take_f ? flo : rlo;
  *hi = take_f ? fhi : rhi;
}

template <bool kWide>
__global__ void values_argmin_kernel(const uint8_t* __restrict__ pc,
                                     const int32_t* __restrict__ mlen,
                                     int64_t* __restrict__ lo_out,
                                     int64_t* __restrict__ hi_out,
                                     int32_t* __restrict__ wp_out, int L,
                                     int k, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* key = smem;                                // L words
  uint8_t* code = reinterpret_cast<uint8_t*>(key + L);  // L bytes

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int m = mlen[row];
  const uint8_t* pcr = pc + static_cast<size_t>(row) * (L / 4);
  const size_t base = static_cast<size_t>(row) * L;

  for (int i = tid; i < L / 4; i += nthreads) {
    const uint8_t b = pcr[i];
    code[4 * i + 0] = b & 3u;
    code[4 * i + 1] = (b >> 2) & 3u;
    code[4 * i + 2] = (b >> 4) & 3u;
    code[4 * i + 3] = (b >> 6) & 3u;
  }
  __syncthreads();

  // the value at every column, and its key
  for (int c = tid; c < L; c += nthreads) {
    uint64_t lo, hi;
    canonical_at<kWide>(code, c, L, k, &lo, &hi);
    lo_out[base + c] = static_cast<int64_t>(lo);
    if (kWide) hi_out[base + c] = static_cast<int64_t>(hi);
    const uint32_t fold =
        static_cast<uint32_t>(lo) ^ static_cast<uint32_t>(lo >> 32) ^
        static_cast<uint32_t>(hi) ^ static_cast<uint32_t>(hi >> 32);
    const uint32_t pr = c < m ? (fmix32(fold) & 0xFFFF0000u) : 0xFFFF0000u;
    key[c] = pr | static_cast<uint32_t>(c);
  }
  __syncthreads();

  // leftmost window minimum (keys are distinct: the column is in the low bits)
  for (int c = tid; c < L; c += nthreads) {
    const int end = min(c + w, L);
    uint32_t best = key[c];
    for (int j = c + 1; j < end; ++j) best = min(best, key[j]);
    wp_out[base + c] = static_cast<int32_t>(best & 0xFFFFu);
  }
}

template <bool kWide>
int launch(const void* pc, const void* mlen, void* lo, void* hi, void* wp,
           int R, int L, int k, int w, cudaStream_t stream) {
  const int threads = L < kMaxThreads ? L : kMaxThreads;
  const size_t smem = static_cast<size_t>(L) * 5;
  cudaError_t err = cudaFuncSetAttribute(
      values_argmin_kernel<kWide>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  values_argmin_kernel<kWide><<<R, threads, smem, stream>>>(
      static_cast<const uint8_t*>(pc), static_cast<const int32_t*>(mlen),
      static_cast<int64_t*>(lo), static_cast<int64_t*>(hi),
      static_cast<int32_t*>(wp), L, k, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hi is written only for k > 32 (it may be null otherwise).
extern "C" int dx_values_argmin(const void* pc, const void* mlen, void* lo,
                                void* hi, void* wp, int R, int L, int k,
                                int w, void* stream) {
  if (R <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return k > 32 ? launch<true>(pc, mlen, lo, hi, wp, R, L, k, w, s)
                : launch<false>(pc, mlen, lo, hi, wp, R, L, k, w, s);
}
