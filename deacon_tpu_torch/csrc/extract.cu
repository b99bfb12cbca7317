// K1: minimizer extraction and per-row compaction (select_compact).
//
// Replaces the TPU kernel select_compact_packed in
// deacon_tpu/ops/pallas_kernels.py (body _select_compact_kernel_body).
// For every row of a tile (L bases, 2-bit codes plus a validity bitmask)
// it computes, at each column c:
//   * the canonical k-mer value min(fwd, revcomp) as a 64-bit integer
//     (k <= 32; bases past the row's end count as code 0 on both strands);
//   * the selection key (fmix32(lo ^ hi) & 0xFFFF0000) | c, or
//     0xFFFF0000 | c past the row's k-mer count mlen;
//   * k-mer validity: every base of [c, c+k) inside the row and ACGT;
//   * the leftmost minimum wp of the keys over [c, c+w) (clipped at L);
//   * the flag: window valid (c <= mlen - w, or c == 0 for a short read
//     with allow_short and mlen >= 1), a new minimum (c == 0 or
//     wp(c) != wp(c-1)) and a valid k-mer at wp.
// Flagged windows are compacted in column order to the front of the row:
// slot j < Br gets (wp, canonical value at wp); the row total is written
// whatever Br is (the caller reruns the row's read with a larger Br when
// the total exceeds it).
// Slots at or past a row's total are left as they were.
//
// What bounds it on an H100: integer instruction throughput. A row reads
// L/4 + L/8 bytes and writes 12 bytes per selected window (~1.9 bytes per
// base at w = 15); the arithmetic is a few dozen integer operations per
// base, so the operation bound is the larger one. The first version of
// this kernel missed it by ~50x: it rebuilt every k-mer from k
// shared-memory bytes, rescanned k validity bytes and w keys per column,
// kept 9 bytes of shared memory per base and synchronised its block twice
// per blockDim columns of the compaction.
//
// Design: O(1) work per base, independent of k and w.
//   * Each thread owns a contiguous run of N columns (N divides L). The
//     row's packed codes and validity bits are staged in shared memory as
//     they are (16-byte loads, neighbouring threads on neighbouring
//     addresses) with zero words past the row, so bases past L read as
//     code 0.
//   * A thread reads the 64 bases from its first column as one 128-bit
//     window; the forward k-mer of each column is a constant-offset slice
//     of it. The reverse complement of the window (XOR 0xAA.., __brevll,
//     bit pairs swapped back, bases past L complemented to 0) gives each
//     column's reverse k-mer the same way. k-mer validity of the run's
//     columns is a k-bit field of a 64-bit validity window, published as a
//     bitmask (one ballot per column of the run) for the lookups at wp.
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
//     its windows in column order, the value at wp recomputed by a funnel
//     shift of the staged codes.
//   * Launch shape by tile: rows of L <= 256 take one warp each (four
//     rows per block, no block-wide barrier, N = 8), longer rows one block
//     each (3 block-wide barriers per row; N = 8 up to L = 4096, 16
//     above, up to 1024 threads). Shared memory
//     is ~4.3 bytes per base (72 KB at L = 16384); the attribute for more
//     than 48 KB is set once per size and device.

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
// (L/32 + 2), validity (L/64 + 2), k-mer validity (T*N/32 u32); every
// part 16-byte aligned.
__host__ __device__ __forceinline__ int row_words(int T, int N, int L) {
  return (T * N * 33) / 64 + (L >> 5) + (L >> 6) + 4 + (T * N) / 64;
}

// One row per warp (kWarpRow, T = 32) or per block (T = blockDim.x); each
// thread owns columns [t * N, t * N + N), those at or past L padding.
template <int N, bool kWarpRow>
__global__ void __launch_bounds__(kWarpRow ? kWarpRows * 32 : kMaxThreads)
select_compact_kernel(
    const uint8_t* __restrict__ pc, const uint8_t* __restrict__ pv,
    const int32_t* __restrict__ mlen, const uint8_t* __restrict__ allow,
    int32_t* __restrict__ pos_out, int64_t* __restrict__ val_out,
    int32_t* __restrict__ tot_out, int R, int L, int k, int w, int Br,
    bool vec) {
  extern __shared__ __align__(16) uint64_t smem[];
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
  uint64_t* base = smem + (kWarpRow ? warp * row_words(T, N, L) : 0);
  uint32_t* P = reinterpret_cast<uint32_t*>(base);
  uint64_t* code = base + (T * N * 33) / 64;
  uint64_t* vb = code + cw + 2;
  uint32_t* kvw = reinterpret_cast<uint32_t*>(vb + vw + 2);
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
  if (t < 2) {
    code[cw + t] = 0;
    vb[vw + t] = 0;
  }
  row_sync<kWarpRow>();

  const uint64_t mask2k = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const uint64_t maskk = (1ull << k) - 1;
  // N divides L, so a run lies wholly inside the row or wholly past it
  const int c0 = t * N;
  uint32_t key[N];
  uint32_t kv = 0;  // bit i: the k-mer at c0 + i is valid
  if (c0 < L) {
    // the 64 bases from c0 on as a 128-bit window (x0, x1); its reverse
    // complement, shifted so that each column's reverse k-mer sits at a
    // constant offset (bases past L complement to 0)
    const int q = c0 >> 5, sh = (2 * c0) & 63;
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
    // validity bits from c0 on (a run's k-mers need N + k - 1 <= 47)
    const uint64_t vx = window_bits(vb[c0 >> 6], vb[(c0 >> 6) + 1], c0 & 63);
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
      if (c < m && c + k <= L && ((vx >> i) & maskk) == maskk) kv |= 1u << i;
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
          val_row[slot] =
              static_cast<int64_t>(canonical_at(code, wp, L, k, mask2k));
        }
        ++slot;
      }
    }
  }
  if (t == 0) tot_out[row] = total;
}

template <int N, bool kWarpRow>
cudaError_t launch(const void* pc, const void* pv, const void* mlen,
                   const void* allow, void* pos, void* val, void* tot, int R,
                   int L, int k, int w, int Br, cudaStream_t stream) {
  const int T = kWarpRow ? 32 : ((L + N - 1) / N + 31) / 32 * 32;
  const int rows = kWarpRow ? kWarpRows : 1;
  const size_t smem = 8u * row_words(T, N, L) * rows;
  auto kernel = select_compact_kernel<N, kWarpRow>;
  if (smem > 48 * 1024) {
    // the opt-in limit, raised once per size and device
    static size_t limit[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || limit[dev] < smem) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) limit[dev] = smem;
    }
  }
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
