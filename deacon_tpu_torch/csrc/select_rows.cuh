// Minimizer selection of a tile's rows into the slot grid: the device code
// that K1 (csrc/extract.cu, k <= 32, 64-bit values), K3
// (csrc/values_select.cu, k <= 57, 128-bit values), K4
// (csrc/select_csum.cu, K1's instantiation) and K5 (csrc/values_argmin.cu,
// K3's instantiations, k <= 56) share.
//
// For every row (L bases, 2-bit codes plus a validity bitmask) it computes,
// at each column c:
//   * the canonical k-mer value min(fwd, revcomp), unsigned (bases past
//     the row's end count as code 0 on both strands): a 64-bit value for
//     k <= 32, a 128-bit one (two uint64_t halves, ties to the forward
//     strand) with kWide;
//   * the selection key (fmix32(f) & 0xFFFF0000) | c, f the xor of the
//     value's 32-bit limbs, or 0xFFFF0000 | c past the row's k-mer count
//     mlen (for k <= 32 the two wide limbs are zero, so both widths give
//     the same key);
//   * k-mer validity: every base of [c, c+k) inside the row and ACGT;
//   * the leftmost minimum wp of the keys over [c, c+w) (clipped at L);
//   * the flag: window valid (c <= mlen - w, or c == 0 for a short read
//     with allow_short and mlen >= 1), a new minimum (c == 0 or
//     wp(c) != wp(c-1)) and a valid k-mer at wp.
// Flagged windows are compacted in column order to the front of the row:
// slot j < Br gets wp and the canonical value at wp (its high half too
// with kWide); the row total is written whatever Br is (the caller reruns
// the row's read with a larger Br when the total exceeds it). Slots at or
// past a row's total are left as they were.
//
// What bounds it on an H100: integer instruction throughput. A row reads
// L/4 + L/8 bytes and writes 12 bytes (20 with kWide) per selected window
// (~1.9-2.9 bytes per base at w = 15); the arithmetic is a few dozen
// integer operations per base (~80 for 128-bit values), so the operation
// bound is the larger one.
//
// Design: O(1) work per base, independent of k and w.
//   * Each thread owns a contiguous run of N columns (N divides L). The
//     row's packed codes and validity bits are staged in shared memory as
//     they are (16-byte loads, neighbouring threads on neighbouring
//     addresses; bytes where an input is not 16-byte aligned) with zero
//     words past the row, so bases past L read as code 0.
//   * A thread reads the bases from its first column as one window of
//     packed words: 64 bases (128 bits) for 64-bit values, 96 (192 bits,
//     three words) with kWide, where a run's k-mers span up to
//     N + 56 bases. The forward k-mer of each column is a constant-offset
//     slice of it. The reverse complement of the window (XOR 0xAA..,
//     __brevll, bit pairs swapped back, bases past L complemented to 0)
//     gives each column's reverse k-mer the same way. k-mer validity of
//     the run's columns is a k-bit field of a validity window (64 bits,
//     128 where N + k - 1 passes 64), published as a bitmask (one ballot
//     per column of the run) for the lookups at wp.
//   * Window minimum: van Herk / Gil-Werman over row-wide blocks of w
//     columns. Each thread forms its prefix minima P (reset at a block's
//     start) and suffix minima S (reset at a block's end) over its run,
//     with the carries from the threads before and after it taken from two
//     segmented scans (warp shuffles, one shared-memory step across
//     warps). P goes to shared memory (4 bytes per base, the only array
//     kept per base, one pad word per 32 so that reads at a stride of N
//     columns do not conflict); the minimum over [c, c+w) is
//     min(S[c], P[c+w-1]).
//   * Each thread's flags form a bitmask; one scan of the per-thread
//     popcounts gives each thread its first slot, and the thread writes
//     its windows in column order, the value at wp (up to w - 1 columns
//     away, possibly in another thread's run) recomputed by funnel shifts
//     of the staged codes.
//   * Launch shape by tile: rows of L <= 256 take one warp each (four
//     rows per block, no block-wide barrier, N = 8), longer rows one block
//     each (3 block-wide barriers per row; N = 8 up to L = 4096, 16
//     above, up to 1024 threads). Shared memory is ~4.3 bytes per base
//     (72 KB at L = 16384); the attribute for more than 48 KB is set once
//     per size, kernel and device (allow_smem).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kWarpRows = 4;     // rows per block when a warp takes a row
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;
// Keys have the column (< 2^14) in their low 16 bits, so bits 14 and 15
// are free: the scans carry their reset flag in bit 15. kTop is at least
// every key, the value of padding columns and of an empty scan.
constexpr uint32_t kReset = 0x8000u;
constexpr uint32_t kTop = 0xFFFF3FFFu;
constexpr uint64_t kComp = 0xAAAAAAAAAAAAAAAAull;  // complement: code ^ 2

// Zero words staged past a row's codes and validity bits: a run's window
// reads up to 2 words past its first (3 with kWide).
__host__ __device__ constexpr int pad_words(bool wide) { return wide ? 4 : 2; }

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The 2-bit groups of v in reverse order.
__device__ __forceinline__ uint64_t reverse_groups(uint64_t v) {
  const uint64_t b = __brevll(v);
  return ((b >> 1) & 0x5555555555555555ull) |
         ((b & 0x5555555555555555ull) << 1);
}

// 64 bits of the 128-bit value (lo, hi) from bit s (0 <= s < 64).
__device__ __forceinline__ uint64_t window_bits(uint64_t lo, uint64_t hi,
                                                int s) {
  return s ? (lo >> s) | (hi << (64 - s)) : lo;
}

// Canonical value of the k-mer at column c < L of the staged codes (the
// word after c's word must exist: the zero pad past the row); bases past
// L count as 0 on both strands.
__device__ __forceinline__ uint64_t canonical_at(const uint64_t* code, int c,
                                                 int L, int k,
                                                 uint64_t mask2k) {
  const int q = c >> 5;
  const uint64_t f =
      window_bits(code[q], code[q + 1], (2 * c) & 63) & mask2k;
  uint64_t r = reverse_groups(f ^ kComp) >> (64 - 2 * k);
  const int past = c + k - L;  // bases past the row: low groups of r
  if (past > 0) r &= ~0ull << (2 * past);
  return f <= r ? f : r;
}

// The same for 32 < k <= 57 as (lo, hi); maskhi keeps the 2k - 64 bits of
// the high half.
__device__ __forceinline__ void canonical128_at(const uint64_t* code, int c,
                                                int L, int k,
                                                uint64_t maskhi,
                                                uint64_t* lo, uint64_t* hi) {
  const int q = c >> 5, s = (2 * c) & 63;
  const uint64_t a1 = code[q + 1];
  const uint64_t flo = window_bits(code[q], a1, s);
  const uint64_t fhi = window_bits(a1, code[q + 2], s) & maskhi;
  // the complement's groups reversed over 128 bits, then shifted down so
  // that the first base lands in the top group of the 2k bits
  const uint64_t glo = reverse_groups(fhi ^ (kComp & maskhi));
  const uint64_t ghi = reverse_groups(flo ^ kComp);
  const int sh = 128 - 2 * k;  // in [14, 62]
  uint64_t rlo = (glo >> sh) | (ghi << (64 - sh));
  uint64_t rhi = ghi >> sh;
  const int past = c + k - L;  // bases past the row: low groups of r
  if (past >= 32) {
    rlo = 0;
    rhi &= ~0ull << (2 * (past - 32));
  } else if (past > 0) {
    rlo &= ~0ull << (2 * past);
  }
  const bool take_f = fhi < rhi || (fhi == rhi && flo <= rlo);
  *lo = take_f ? flo : rlo;
  *hi = take_f ? fhi : rhi;
}

// Segmented minima over the scans' (flag | key) words. fwd: a run seen
// from its right end (minimum since its last block start); bwd: seen from
// its left end (minimum up to its first block end). a is left of b.
__device__ __forceinline__ uint32_t seg_fwd(uint32_t a, uint32_t b) {
  return b & kReset ? b : (a & kReset) | min(a & ~kReset, b);
}

__device__ __forceinline__ uint32_t seg_bwd(uint32_t a, uint32_t b) {
  return a & kReset ? a : (b & kReset) | min(a, b & ~kReset);
}

// Inclusive scans across a warp's lanes.
__device__ __forceinline__ uint32_t warp_scan_fwd(uint32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = seg_fwd(y, x);
  }
  return x;
}

__device__ __forceinline__ uint32_t warp_scan_bwd(uint32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_down_sync(kFull, x, d);
    if (lane + d < 32) x = seg_bwd(x, y);
  }
  return x;
}

__device__ __forceinline__ int warp_scan_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// P, the prefix minima, one pad word per 32 so that the lanes' reads at a
// stride of N columns fall in distinct banks.
__device__ __forceinline__ int pidx(int c) { return c + (c >> 5); }

template <bool kWarpRow>
__device__ __forceinline__ void row_sync() {
  if (kWarpRow) __syncwarp(); else __syncthreads();
}

// Shared memory of one row, in 8-byte words: P (T*N*33/32 u32), codes
// (L/32 + pad), validity (L/64 + pad), k-mer validity (T*N/32 u32); every
// part 16-byte aligned.
__host__ __device__ __forceinline__ int row_words(int T, int N, int L,
                                                  bool wide) {
  return (T * N * 33) / 64 + (L >> 5) + (L >> 6) + 2 * pad_words(wide) +
         (T * N) / 64;
}

// Threads of a row: a warp, or a block with a run of N columns per thread.
template <int N, bool kWarpRow>
__host__ __forceinline__ int row_threads(int L) {
  return kWarpRow ? 32 : ((L + N - 1) / N + 31) / 32 * 32;
}

// Lets kernel take smem bytes of dynamic shared memory: the opt-in limit
// above 48 KB, raised once per size and device (limit: the kernel's sizes
// so far, by device).
inline cudaError_t allow_smem(const void* kernel, size_t smem,
                              size_t* limit) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || limit[dev] < smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) limit[dev] = smem;
  }
  return cudaSuccess;
}

// One row per warp (kWarpRow, T = 32) or per block (T = blockDim.x); each
// thread owns columns [t * N, t * N + N), those at or past L padding.
// smem: the block's dynamic shared memory (row_words per row). hi_out is
// written only with kWide.
template <int N, bool kWarpRow, bool kWide>
__device__ __forceinline__ void select_rows(
    uint64_t* smem, const uint8_t* __restrict__ pc,
    const uint8_t* __restrict__ pv, const int32_t* __restrict__ mlen,
    const uint8_t* __restrict__ allow, int32_t* __restrict__ pos_out,
    int64_t* __restrict__ val_out, int64_t* __restrict__ hi_out,
    int32_t* __restrict__ tot_out, int R, int L, int k, int w, int Br,
    bool vec) {
  constexpr int kPad = pad_words(kWide);
  __shared__ uint32_t fwd_agg[kMaxWarps], bwd_agg[kMaxWarps];
  __shared__ uint32_t last_key[kMaxWarps];
  __shared__ int warp_cnt[kMaxWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = kWarpRow ? blockIdx.x * kWarpRows + warp : blockIdx.x;
  const int t = kWarpRow ? lane : threadIdx.x;
  const int T = kWarpRow ? 32 : blockDim.x;
  const int nwarps = kWarpRow ? 1 : blockDim.x >> 5;
  const int seg = kWarpRow ? 0 : warp;  // the warp's 32 * N columns
  if (row >= R) return;  // a whole warp (kWarpRow) or block

  const int m = mlen[row];
  const bool short_ok = allow[row] != 0;
  if (m - w < 0 && !(short_ok && m >= 1)) {  // no valid window
    if (t == 0) tot_out[row] = 0;
    return;
  }

  const int cw = L >> 5, vw = L >> 6;
  uint64_t* base = smem + (kWarpRow ? warp * row_words(T, N, L, kWide) : 0);
  uint32_t* P = reinterpret_cast<uint32_t*>(base);
  uint64_t* code = base + (T * N * 33) / 64;
  uint64_t* vb = code + cw + kPad;
  uint32_t* kvw = reinterpret_cast<uint32_t*>(vb + vw + kPad);
  const uint8_t* pcr = pc + static_cast<size_t>(row) * (L >> 2);
  const uint8_t* pvr = pv + static_cast<size_t>(row) * (L >> 3);
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(pcr);
#pragma unroll 1
    for (int i = t; i < (L >> 6); i += T)
      reinterpret_cast<uint4*>(code)[i] = src[i];
    src = reinterpret_cast<const uint4*>(pvr);
#pragma unroll 1
    for (int i = t; i < (L >> 7); i += T)
      reinterpret_cast<uint4*>(vb)[i] = src[i];
  } else {  // byte by byte where an input is not 16-byte aligned
#pragma unroll 1
    for (int i = t; i < (L >> 2); i += T)
      reinterpret_cast<uint8_t*>(code)[i] = pcr[i];
#pragma unroll 1
    for (int i = t; i < (L >> 3); i += T)
      reinterpret_cast<uint8_t*>(vb)[i] = pvr[i];
  }
  if (t < kPad) {
    code[cw + t] = 0;
    vb[vw + t] = 0;
  }
  row_sync<kWarpRow>();

  // 64-bit values: the 2k bits of a k-mer; 128-bit: the 2k - 64 of its
  // high half
  const uint64_t mask2k = kWide ? (1ull << (2 * k - 64)) - 1
                          : k == 32 ? ~0ull
                                    : (1ull << (2 * k)) - 1;
  const uint64_t maskk = (1ull << k) - 1;
  // N divides L, so a run lies wholly inside the row or wholly past it
  const int c0 = t * N;
  uint32_t key[N];
  uint32_t kv = 0;  // bit i: the k-mer at c0 + i is valid
  if (c0 < L) {
    const int q = c0 >> 5, sh = (2 * c0) & 63;
    // validity bits from c0 on; a run's k-mers need N + k - 1 of them
    const uint64_t v0 = vb[c0 >> 6], v1 = vb[(c0 >> 6) + 1];
    const uint64_t vx = window_bits(v0, v1, c0 & 63);
    if constexpr (!kWide) {
      // the 64 bases from c0 on as a 128-bit window (x0, x1); its reverse
      // complement, shifted so that each column's reverse k-mer sits at a
      // constant offset (bases past L complement to 0)
      const uint64_t w1 = code[q + 1];
      const uint64_t x0 = window_bits(code[q], w1, sh);
      const uint64_t x1 = window_bits(w1, code[q + 2], sh);
      const int nv = min(L - c0, 64);  // bases of the window inside the row
      const uint64_t cm0 =
          nv >= 32 ? kComp : kComp & ((1ull << (2 * nv)) - 1);
      const uint64_t cm1 = nv == 64  ? kComp
                           : nv > 32 ? kComp & ((1ull << (2 * nv - 64)) - 1)
                                     : 0;
      const uint64_t z0 = reverse_groups(x1 ^ cm1);
      const uint64_t z1 = reverse_groups(x0 ^ cm0);
      const int b = 128 - 2 * k - 2 * (N - 1);  // in [2, 126]
      const uint64_t zs0 = b < 64 ? window_bits(z0, z1, b) : z1 >> (b - 64);
      const uint64_t zs1 = b < 64 ? z1 >> b : 0;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int c = c0 + i;
        const uint64_t f = window_bits(x0, x1, 2 * i) & mask2k;
        const uint64_t r = window_bits(zs0, zs1, 2 * (N - 1 - i)) & mask2k;
        const uint64_t v = f <= r ? f : r;
        const uint32_t pr =
            c < m ? fmix32(static_cast<uint32_t>(v) ^
                           static_cast<uint32_t>(v >> 32)) & 0xFFFF0000u
                  : 0xFFFF0000u;
        key[i] = pr | static_cast<uint32_t>(c);
        if (c < m && c + k <= L && ((vx >> i) & maskk) == maskk)
          kv |= 1u << i;
      }
    } else {
      // the 96 bases from c0 on as a 192-bit window (x0, x1, x2), and its
      // reverse complement (z0, z1, z2) shifted down by b as above
      const uint64_t w1 = code[q + 1], w2 = code[q + 2];
      const uint64_t x0 = window_bits(code[q], w1, sh);
      const uint64_t x1 = window_bits(w1, w2, sh);
      const uint64_t x2 = window_bits(w2, code[q + 3], sh);
      const int nv = min(L - c0, 96);  // bases of the window inside the row
      const uint64_t cm0 =
          nv >= 32 ? kComp : kComp & ((1ull << (2 * nv)) - 1);
      const uint64_t cm1 = nv >= 64  ? kComp
                           : nv > 32 ? kComp & ((1ull << (2 * nv - 64)) - 1)
                                     : 0;
      const uint64_t cm2 = nv >= 96  ? kComp
                           : nv > 64 ? kComp & ((1ull << (2 * nv - 128)) - 1)
                                     : 0;
      const uint64_t z0 = reverse_groups(x2 ^ cm2);
      const uint64_t z1 = reverse_groups(x1 ^ cm1);
      const uint64_t z2 = reverse_groups(x0 ^ cm0);
      const int b = 192 - 2 * k - 2 * (N - 1);  // in [48, 112]
      uint64_t zs0, zs1, zs2;
      if (b < 64) {
        zs0 = window_bits(z0, z1, b);
        zs1 = window_bits(z1, z2, b);
        zs2 = z2 >> b;
      } else {
        zs0 = window_bits(z1, z2, b - 64);
        zs1 = z2 >> (b - 64);
        zs2 = 0;
      }
      // N + k - 1 validity bits: 64 suffice up to N = 8 (k <= 57)
      const uint64_t vy =
          N > 8 ? window_bits(v1, vb[(c0 >> 6) + 2], c0 & 63) : 0;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int c = c0 + i;
        const int s = 2 * (N - 1 - i);
        const uint64_t flo = window_bits(x0, x1, 2 * i);
        const uint64_t fhi = window_bits(x1, x2, 2 * i) & mask2k;
        const uint64_t rlo = window_bits(zs0, zs1, s);
        const uint64_t rhi = window_bits(zs1, zs2, s) & mask2k;
        const bool take_f = fhi < rhi || (fhi == rhi && flo <= rlo);
        const uint64_t lo = take_f ? flo : rlo;
        const uint64_t hi = take_f ? fhi : rhi;
        const uint32_t fold =
            static_cast<uint32_t>(lo) ^ static_cast<uint32_t>(lo >> 32) ^
            static_cast<uint32_t>(hi) ^ static_cast<uint32_t>(hi >> 32);
        const uint32_t pr =
            c < m ? fmix32(fold) & 0xFFFF0000u : 0xFFFF0000u;
        key[i] = pr | static_cast<uint32_t>(c);
        const uint64_t vi = N > 8 ? window_bits(vx, vy, i) : vx >> i;
        if (c < m && c + k <= L && (vi & maskk) == maskk) kv |= 1u << i;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) key[i] = kTop;
  }
  // k-mer validity of the row: word seg * N + i holds, in bit lane, the
  // column (seg * 32 + lane) * N + i
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t bits = __ballot_sync(kFull, (kv >> i) & 1u);
    if (lane == i) kvw[seg * N + i] = bits;
  }
  auto kmer_valid = [&](int c) -> bool {
    constexpr int kLogN = N == 8 ? 3 : 4;
    return (kvw[((c >> (kLogN + 5)) << kLogN) + (c & (N - 1))] >>
            ((c >> kLogN) & 31)) & 1u;
  };
  // the key at c0 - 1, before the suffix minima replace the keys
  uint32_t kprev = __shfl_up_sync(kFull, key[N - 1], 1);

  // block starts (c % w == 0) and ends (c % w == w - 1) of the run
  uint32_t st = 0;
  int ph = c0 % w;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    st |= ph == 0 ? 1u << i : 0u;
    ph = ph + 1 == w ? 0 : ph + 1;
  }
  const uint32_t en = (st >> 1) | (ph == 0 ? 1u << (N - 1) : 0u);

  // this run's segmented aggregates
  uint32_t fa = kTop, ba = kTop;
#pragma unroll
  for (int i = 0; i < N; ++i)
    fa = (st >> i) & 1u ? kReset | key[i]
                        : (fa & kReset) | min(fa & ~kReset, key[i]);
#pragma unroll
  for (int i = N - 1; i >= 0; --i)
    ba = (en >> i) & 1u ? kReset | key[i]
                        : (ba & kReset) | min(ba & ~kReset, key[i]);
  // carries: fwd over the threads before this one, bwd over those after
  const uint32_t fi = warp_scan_fwd(fa, lane);
  const uint32_t bi = warp_scan_bwd(ba, lane);
  uint32_t fx = __shfl_up_sync(kFull, fi, 1);
  uint32_t bx = __shfl_down_sync(kFull, bi, 1);
  if (lane == 0) fx = kTop;
  if (lane == 31) bx = kTop;
  if (!kWarpRow) {  // one more step over the warps' aggregates
    if (lane == 31) {
      fwd_agg[warp] = fi;
      last_key[warp] = key[N - 1];
    }
    if (lane == 0) bwd_agg[warp] = bi;
    __syncthreads();
    const uint32_t f =
        warp_scan_fwd(lane < nwarps ? fwd_agg[lane] : kTop, lane);
    const uint32_t b =
        warp_scan_bwd(lane < nwarps ? bwd_agg[lane] : kTop, lane);
    const uint32_t fw = __shfl_sync(kFull, f, max(warp - 1, 0));
    const uint32_t bw = __shfl_sync(kFull, b, min(warp + 1, 31));
    if (warp > 0) fx = seg_fwd(fw, fx);
    if (warp + 1 < nwarps) bx = seg_bwd(bx, bw);
    if (lane == 0 && warp > 0) kprev = last_key[warp - 1];
  }

  // prefix minima to shared memory; suffix minima in place of the keys
  {
    uint32_t p = fx & ~kReset;
    uint32_t* Pt = P + pidx(c0);  // the run does not cross a pad word
#pragma unroll
    for (int i = 0; i < N; ++i) {
      p = (st >> i) & 1u ? key[i] : min(p, key[i]);
      Pt[i] = p;
    }
    uint32_t s = bx & ~kReset;
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      s = (en >> i) & 1u ? key[i] : min(s, key[i]);
      key[i] = s;
    }
  }
  row_sync<kWarpRow>();

  // leftmost minimum over [c, min(c + w, L)) from S[c] = s: min(S[c],
  // P[c + w - 1]); near the row's end S[c] alone when c and L - 1 share
  // a block, else min(S[c], P[L - 1])
  auto wmin = [&](int c, uint32_t s) -> int {
    uint32_t v;
    if (c + w <= L) {
      v = min(s, P[pidx(c + w - 1)]);
    } else {
      v = c % w + (L - 1 - c) < w ? s : min(s, P[pidx(L - 1)]);
    }
    return static_cast<int>(v & 0xFFFFu);
  };

  // flags as a bitmask of the run
  uint32_t flags = 0;
  if (c0 < L) {
    int prev = -1;
    if (c0 > 0) prev = wmin(c0 - 1, st & 1u ? kprev : min(kprev, key[0]));
    auto flag = [&](int i, int wp) {
      const int c = c0 + i;
      const bool win = (c <= m - w) || (c == 0 && short_ok && m >= 1);
      if (win && wp != prev && kmer_valid(wp)) flags |= 1u << i;
      prev = wp;
    };
    if (c0 + N - 1 + w <= L) {  // no window of the run is clipped
#pragma unroll
      for (int i = 0; i < N; ++i)
        flag(i, static_cast<int>(
                    min(key[i], P[pidx(c0 + i + w - 1)]) & 0xFFFFu));
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) flag(i, wmin(c0 + i, key[i]));
    }
  }

  // one scan of the per-thread counts gives each thread its first slot
  const int cnt = __popc(flags);
  const int inc = warp_scan_sum(cnt, lane);
  int slot = inc - cnt;
  int total = __shfl_sync(kFull, inc, 31);
  if (!kWarpRow) {  // one more step over the warps' counts
    if (lane == 31) warp_cnt[warp] = inc;
    __syncthreads();
    const int n = warp_scan_sum(lane < nwarps ? warp_cnt[lane] : 0, lane);
    const int before = __shfl_sync(kFull, n, max(warp - 1, 0));
    slot += warp > 0 ? before : 0;
    total = __shfl_sync(kFull, n, 31);
  }
  if (flags && slot < Br) {
    int32_t* pos_row = pos_out + static_cast<size_t>(row) * Br;
    int64_t* val_row = val_out + static_cast<size_t>(row) * Br;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if ((flags >> i) & 1u) {
        if (slot < Br) {
          const int wp = wmin(c0 + i, key[i]);
          pos_row[slot] = wp;
          if constexpr (kWide) {
            uint64_t lo, hi;
            canonical128_at(code, wp, L, k, mask2k, &lo, &hi);
            val_row[slot] = static_cast<int64_t>(lo);
            hi_out[static_cast<size_t>(row) * Br + slot] =
                static_cast<int64_t>(hi);
          } else {
            val_row[slot] =
                static_cast<int64_t>(canonical_at(code, wp, L, k, mask2k));
          }
        }
        ++slot;
      }
    }
  }
  if (t == 0) tot_out[row] = total;
}

}  // namespace
