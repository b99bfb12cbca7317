// K4: minimizer selection into a flag-cumsum plane (select_csum).
//
// Replaces the TPU kernel select_csum_packed in
// deacon_tpu/ops/pallas_kernels.py (body _select_csum_kernel_body), the
// JAX package's "arch 3": tiles whose L is a multiple of 128 but not a
// power of two, or any eligible tile under DEACON_ENGINE=3. For every row
// of a tile (L bases, 2-bit codes plus a validity bitmask, both packed) it
// computes, at each column c, exactly what K1 (csrc/extract.cu) computes:
//   * the canonical k-mer value (k <= 32; bases past L count as code 0 on
//     both strands) and the key (fmix32(lo ^ hi) & 0xFFFF0000) | c, or
//     0xFFFF0000 | c past the row's k-mer count mlen;
//   * k-mer validity, the leftmost window minimum wp over [c, c+w), and
//     the flag: window valid, a new minimum, a valid k-mer at wp.
// It writes, at every column, plane[c] = (inclusive in-row cumsum of the
// flag << 16) | wp, and the row's flag total. No values and no
// compaction: the caller finds slot t's column by a per-row binary search
// for t + 1 in plane >> 16 and rebuilds the canonical value at wp from the
// packed codes (ops/engine.csum_slots). 128 | L <= 16384 keeps wp in 14
// bits and the cumsum in bits 16-30.
//
// The TPU kernel reads quarter-interleaved packed bytes because Mosaic's
// repeat is a tile repeat; this kernel reads the port's linear packed
// planes (code j of a row at bits 2(j % 4) of byte j / 4, validity bit j
// at bit j % 8 of byte j / 8), which carry the same bases.
//
// What bounds it on an H100: bytes. A row reads L/4 + L/8 bytes and
// writes 4 bytes per base plus 4 per row (~4.4 bytes per base): 10.3 MB
// at the (1152, 2048) tile, 3.1 us at 3.35 TB/s. Like K1, this first
// version is bound by its shared-memory loops instead: each column
// rebuilds its k-mer from k codes and rescans w keys for the minimum.
//
// Design: K1's. One block per row, the whole row in shared memory (codes,
// validity, k-mer validity, keys, window minima: 9 bytes per base, 144 KB
// at L = 16384, above the 48 KB default, hence
// cudaFuncAttributeMaxDynamicSharedMemorySize). Threads take columns in
// stride. The cumsum is K1's block-wide ballot scan over blockDim-wide
// column tiles (warp ballots, one shared array of warp counts), kept as an
// inclusive count and written at every column: neighbouring threads write
// neighbouring words, so the dense store is coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Canonical value of the k-mer at column c; codes past L count as 0 on
// both strands (the TPU kernel's zero-filled column shifts).
__device__ __forceinline__ uint64_t canonical_at(const uint8_t* code, int c,
                                                 int L, int k) {
  uint64_t f = 0, r = 0;
  for (int i = 0; i < k; ++i) {
    const int j = c + i;
    const uint64_t cf = j < L ? code[j] : 0u;
    const uint64_t cr = j < L ? (code[j] ^ 2u) : 0u;
    f |= cf << (2 * i);
    r = (r << 2) | cr;
  }
  return f <= r ? f : r;
}

__global__ void select_csum_kernel(
    const uint8_t* __restrict__ pc, const uint8_t* __restrict__ pv,
    const int32_t* __restrict__ mlen, const uint8_t* __restrict__ allow,
    int32_t* __restrict__ plane_out, int32_t* __restrict__ tot_out, int L,
    int k, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* key = smem;                                   // L words
  uint16_t* wpos = reinterpret_cast<uint16_t*>(key + L);  // L halfwords
  uint8_t* code = reinterpret_cast<uint8_t*>(wpos + L);   // L bytes
  uint8_t* vld = code + L;                                // L bytes
  uint8_t* kv = vld + L;                                  // L bytes
  __shared__ int warp_count[kMaxWarps];

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
    const uint64_t v = canonical_at(code, c, L, k);
    const uint32_t fold =
        static_cast<uint32_t>(v) ^ static_cast<uint32_t>(v >> 32);
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

  // flags and their inclusive in-row cumsum, one column tile at a time
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthreads + 31) >> 5;
  const unsigned lanes_upto = lane == 31 ? 0xFFFFFFFFu : (2u << lane) - 1u;
  int base = 0;
  int32_t* plane_row = plane_out + static_cast<size_t>(row) * L;
  for (int t0 = 0; t0 < L; t0 += nthreads) {
    const int c = t0 + tid;
    bool flag = false;
    int wp = 0;
    if (c < L) {
      wp = wpos[c];
      const bool win_valid =
          (c <= m - w) || (c == 0 && short_ok && m >= 1);
      const bool new_min = (c == 0) || (wp != wpos[c - 1]);
      flag = win_valid && new_min && kv[wp] != 0;
    }
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, flag);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, tile_total = 0;
    for (int i = 0; i < nwarps; ++i) {
      const int n = warp_count[i];
      before += i < warp ? n : 0;
      tile_total += n;
    }
    if (c < L) {
      const int cs = base + before + __popc(ballot & lanes_upto);
      plane_row[c] = (cs << 16) | wp;
    }
    base += tile_total;
    __syncthreads();  // warp_count is rewritten by the next tile
  }
  if (tid == 0) tot_out[row] = base;
}

}  // namespace

extern "C" int dx_select_csum(const void* pc, const void* pv,
                              const void* mlen, const void* allow,
                              void* plane, void* tot, int R, int L, int k,
                              int w, void* stream) {
  if (R <= 0) return 0;
  const int threads = L < kMaxThreads ? L : kMaxThreads;
  const size_t smem = static_cast<size_t>(L) * 9;
  cudaError_t err = cudaFuncSetAttribute(
      select_csum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  select_csum_kernel<<<R, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pc), static_cast<const uint8_t*>(pv),
      static_cast<const int32_t*>(mlen), static_cast<const uint8_t*>(allow),
      static_cast<int32_t*>(plane), static_cast<int32_t*>(tot), L, k, w);
  return static_cast<int>(cudaGetLastError());
}
