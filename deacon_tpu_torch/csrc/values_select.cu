// K3: wide-k minimizer selection with dense value planes (values_select).
//
// Replaces the TPU kernel values_select_fused in
// deacon_tpu/ops/pallas_kernels.py (body _values_select_kernel_body).
// For every row of a tile (L bases, 2-bit codes plus a validity bitmask)
// it computes, at each column c:
//   * the canonical k-mer value min(fwd, revcomp) as a 128-bit integer
//     (two uint64_t halves; 1 <= k <= 57; bases past L count as code 0 on
//     both strands) and its selection key
//     (fmix32(xor of the four 32-bit limbs) & 0xFFFF0000) | c, or
//     0xFFFF0000 | c past the row's k-mer count mlen;
//   * k-mer validity: every base of [c, c+k) inside the row and ACGT;
//   * the leftmost minimum wp of the keys over [c, c+w) (clipped at L);
//   * the flag: window valid (c <= mlen - w, or c == 0 for a short read
//     with allow_short and mlen >= 1), a new minimum (c == 0 or
//     wp(c) != wp(c-1)) and a valid k-mer at wp.
// It writes, at every column, the canonical value at wp (lo and hi
// planes, int64) and wpf = wp | flag << 16 (int32). The caller compacts
// the flagged windows (ops/kernels.compact_rows).
//
// What bounds it on an H100: bytes. A row reads L/4 + L/8 bytes of
// packed input but writes 20 bytes per base of dense output (two 8-byte
// value planes and the 4-byte wpf), ~20.4 bytes per base: 171 MB at the
// (16384, 512) tile, 0.051 ms at 3.35 TB/s. Its integer work (a few
// dozen operations per base for the 128-bit values by span doubling)
// bounds it well below that. This first version does more: each column
// rebuilds its k-mer from k shared-memory codes twice (for its key and
// for the value at its window minimum) and rescans w keys for the
// minimum, so it is bound by shared-memory loops, not by its stores.
//
// Design: K1's (csrc/extract.cu). One block per row, the whole row in
// shared memory (codes, validity, k-mer validity, keys, window minima:
// 9 bytes per base, 144 KB at L = 16384, above the 48 KB default, hence
// cudaFuncAttributeMaxDynamicSharedMemorySize). Threads take columns in
// stride, so neighbouring threads touch neighbouring shared-memory words
// and write neighbouring output words (coalesced stores).

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
__device__ __forceinline__ void canonical128_at(const uint8_t* code, int c,
                                                int L, int k, uint64_t* lo,
                                                uint64_t* hi) {
  uint64_t flo = 0, fhi = 0, rlo = 0, rhi = 0;
  for (int i = 0; i < k; ++i) {
    const int j = c + i;
    const uint64_t cf = j < L ? code[j] : 0u;
    const uint64_t cr = j < L ? (code[j] ^ 2u) : 0u;
    if (i < 32) {
      flo |= cf << (2 * i);
    } else {
      fhi |= cf << (2 * (i - 32));
    }
    rhi = (rhi << 2) | (rlo >> 62);
    rlo = (rlo << 2) | cr;
  }
  const bool take_f = fhi < rhi || (fhi == rhi && flo <= rlo);
  *lo = take_f ? flo : rlo;
  *hi = take_f ? fhi : rhi;
}

__global__ void values_select_kernel(
    const uint8_t* __restrict__ pc, const uint8_t* __restrict__ pv,
    const int32_t* __restrict__ mlen, const uint8_t* __restrict__ allow,
    int64_t* __restrict__ lo_out, int64_t* __restrict__ hi_out,
    int32_t* __restrict__ wpf_out, int L, int k, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* key = smem;                                   // L words
  uint16_t* wpos = reinterpret_cast<uint16_t*>(key + L);  // L halfwords
  uint8_t* code = reinterpret_cast<uint8_t*>(wpos + L);   // L bytes
  uint8_t* vld = code + L;                                // L bytes
  uint8_t* kv = vld + L;                                  // L bytes

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int m = mlen[row];
  const bool short_ok = allow[row] != 0;
  const uint8_t* pcr = pc + static_cast<size_t>(row) * (L / 4);
  const uint8_t* pvr = pv + static_cast<size_t>(row) * (L / 8);

  for (int i = tid; i < L / 4; i += nthreads) {
    const uint8_t b = pcr[i];
    code[4 * i + 0] = b & 3u;
    code[4 * i + 1] = (b >> 2) & 3u;
    code[4 * i + 2] = (b >> 4) & 3u;
    code[4 * i + 3] = (b >> 6) & 3u;
  }
  for (int i = tid; i < L / 8; i += nthreads) {
    const uint8_t b = pvr[i];
    for (int j = 0; j < 8; ++j) vld[8 * i + j] = (b >> j) & 1u;
  }
  __syncthreads();

  // keys and k-mer validity
  for (int c = tid; c < L; c += nthreads) {
    const bool in_row = c < m;
    uint64_t lo, hi;
    canonical128_at(code, c, L, k, &lo, &hi);
    const uint32_t fold =
        static_cast<uint32_t>(lo) ^ static_cast<uint32_t>(lo >> 32) ^
        static_cast<uint32_t>(hi) ^ static_cast<uint32_t>(hi >> 32);
    const uint32_t pr = in_row ? (fmix32(fold) & 0xFFFF0000u) : 0xFFFF0000u;
    key[c] = pr | static_cast<uint32_t>(c);
    bool ok = in_row && c + k <= L;
    for (int i = 0; ok && i < k; ++i) ok = vld[c + i] != 0;
    kv[c] = ok ? 1u : 0u;
  }
  __syncthreads();

  // leftmost window minimum (keys are distinct: the column is in the low bits)
  for (int c = tid; c < L; c += nthreads) {
    const int end = min(c + w, L);
    uint32_t best = key[c];
    for (int j = c + 1; j < end; ++j) best = min(best, key[j]);
    wpos[c] = static_cast<uint16_t>(best & 0xFFFFu);
  }
  __syncthreads();

  // dense outputs: the value at wp and the packed word, every column
  const size_t base = static_cast<size_t>(row) * L;
  for (int c = tid; c < L; c += nthreads) {
    const int wp = wpos[c];
    const bool win_valid = (c <= m - w) || (c == 0 && short_ok && m >= 1);
    const bool new_min = (c == 0) || (wp != wpos[c - 1]);
    const bool flag = win_valid && new_min && kv[wp] != 0;
    uint64_t lo, hi;
    canonical128_at(code, wp, L, k, &lo, &hi);
    lo_out[base + c] = static_cast<int64_t>(lo);
    hi_out[base + c] = static_cast<int64_t>(hi);
    wpf_out[base + c] = wp | (flag ? (1 << 16) : 0);
  }
}

}  // namespace

extern "C" int dx_values_select(const void* pc, const void* pv,
                                const void* mlen, const void* allow,
                                void* lo, void* hi, void* wpf, int R, int L,
                                int k, int w, void* stream) {
  if (R <= 0) return 0;
  const int threads = L < kMaxThreads ? L : kMaxThreads;
  const size_t smem = static_cast<size_t>(L) * 9;
  cudaError_t err = cudaFuncSetAttribute(
      values_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  values_select_kernel<<<R, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pc), static_cast<const uint8_t*>(pv),
      static_cast<const int32_t*>(mlen), static_cast<const uint8_t*>(allow),
      static_cast<int64_t*>(lo), static_cast<int64_t*>(hi),
      static_cast<int32_t*>(wpf), L, k, w);
  return static_cast<int>(cudaGetLastError());
}
