// K2: radix-bucket membership probe and per-read distinct-hit counts.
//
// Replaces the TPU kernel radix_probe_hits in deacon_tpu/ops/radix_probe.py
// (body _probe_kernel_body), in its single-device form and in its sharded
// form (shard_lo / shard_rows, under shard_map in
// deacon_tpu/parallel/sharded.py). Input is the sorted query stream of one
// batch: int64 key (a u64 hash bit pattern), int32 srid (the read id, or -1
// for a filler slot) and an int32 first flag (1 where (key, srid) differs
// from the previous entry). A query is a member when its key sits in bucket
// key >> (64 - p) of the main table (2^p rows of 128 int64 slots) or in
// bucket key >> (64 - sp) of the spill table (2^sp rows of 128, sp > 0
// only). Every member that is real and first of its (key, read) run adds
// one to hits[read], so hits counts the distinct member keys of each read
// (ref: src/filter_common.rs:129-155).
//
// Sharded contract: ``table`` holds the local block of ``rows`` bucket
// rows starting at global row ``row_lo`` (the whole table is row_lo = 0,
// rows = 2^p). A query counts here only when its bucket lies in
// [row_lo, row_lo + rows); the spill table is whole on every shard and is
// read only for such a query, so a spill match counts on the one shard
// that owns the query's primary bucket. Summing the hits of the shards
// of a table gives the unsharded hits exactly.
//
// What the kernel relies on (both hold for every table and stream the port
// builds or converts; ops/radix_probe.py states them where they are made):
// - the stream is sorted by (key as int64, srid), as prep_sorted sorts it;
// - a row of bucket b holds its c keys ascending as u64 in slots 0..c-1 and
//   values of another bucket after them (the empty-slot filler
//   ((b ^ 1) << (64 - p)) cannot equal a key routed to b);
// - a bucket has spill keys only when its main row is full (slot 127 holds
//   a key of b), and each of them is above all 128 keys of the row.
//
// What bounds it on an H100: device-memory bytes, at random 32-byte
// sectors of a table that does not fit in L2 (4 GB at panhuman scale). A
// query must read at least the sector of its row that would hold its key,
// and the stream once (4 B srid, 4 B first, 8 B key per live query).
//
// Design, for this card (the TPU kernel's windowed sort and one-hot
// matmuls are not carried over):
// 1. Stream bounds. The stream is ascending in bucket ^ 2^(p-1) (int64
//    order puts buckets [2^(p-1), 2^p) first), so a block of bucket rows is
//    one slice of the stream, or two where it straddles row 2^(p-1); the
//    fillers (key -1, srid -1) form one run inside bucket 2^p - 1. Each
//    block finds these bounds by six warp-wide 32-ary searches of the
//    stream (about four dependent loads each, from L2 after the first
//    block), so a launch walks only the live part of its own rows: no
//    filler and no query of another shard costs a warp or a load.
// 2. Tiles. A persistent grid of about as many blocks as fit at once; each
//    warp takes 32 consecutive entries of those slices, one lane per
//    query, and loads their srid, first and key in one coalesced round
//    (the slices hold real entries only).
// 3. Row search. A lane searches the row's 32 sectors (4 slots each), one
//    32-byte sector per probe (two 16-byte loads when the tables are
//    16-byte aligned) instead of the 1 KB row: sector 16 first, then two
//    probes guessed from the key's bits below the bucket bits as if the
//    bucket's keys were evenly spread, then bisection; a probe whose
//    sector brackets the key ends it. About three probes a query at a
//    load of ~98 keys a row, at most eight.
// 4. Spill. The spill row is searched only when the main search ends in
//    the row's last sector with slot 127 a key of b below the query: the
//    only case in which a spill key can equal it.
// 5. Atomics. The members of a tile that belong to one read (repeat-heavy
//    reads put many in a row of the stream) are combined with
//    __match_any_sync into one atomicAdd.
// What holds it then is latency, not bytes: each launch's start (the hits
// fill before it, the launch, the bounds search) and one chain of
// dependent loads per query (stream entry, ~3 sector probes), which a
// shard's quarter of the queries does not shorten (PERF.md).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kSlots = 128;
constexpr int kProbe = 4;             // slots per probe: one 32-byte sector
constexpr int kProbes = kSlots / kProbe;
constexpr int kWarps = 8;             // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kBounds = 6;            // stream positions each block finds
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr u64 kSign = 1ull << 63;

// First position i of the stream whose (key ^ kSign, srid) is not below
// (tu, ts): the stream ascends in that pair. Every lane of the warp takes
// part; each step probes 32 evenly spaced entries and keeps the gap in
// which the answer lies.
__device__ long long stream_bound(const int64_t* __restrict__ keys,
                                  const int32_t* __restrict__ srid,
                                  long long q, u64 tu, int ts, int lane) {
  long long lo = 0, hi = q;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long stride = (hi - lo + 31) >> 5;
    const long long i = lo + lane * stride;
    bool ge = true;
    if (i < hi) {
      const u64 u = static_cast<u64>(keys[i]) ^ kSign;
      const int s = ts == INT_MIN ? 0 : srid[i];
      ge = u > tu || (u == tu && s >= ts);
    }
    const unsigned m = __ballot_sync(kFull, ge);
    if (m == 0) {
      lo += 31 * stride + 1;
    } else {
      const int f = __ffs(m) - 1;
      if (f == 0) {
        hi = lo;
      } else {
        const long long next = lo + (f - 1) * stride + 1;
        hi = min(hi, lo + f * stride);
        lo = next;
      }
    }
  }
  return lo;
}

// Position in the stream of bucket' t (bucket ^ 2^(p-1)), 0 <= t <= 2^p:
// the first entry of bucket' t or above.
__device__ long long bucket_bound(const int64_t* __restrict__ keys,
                                  const int32_t* __restrict__ srid,
                                  long long q, u64 t, int p, int lane) {
  if (t == 0) return 0;
  if (t >= (1ull << p)) return q;
  return stream_bound(keys, srid, q, t << (64 - p), INT_MIN, lane);
}

// The kProbe slots of one probe: 16-byte loads where the tables are
// 16-byte aligned (as torch allocates them), else 8-byte loads.
template <bool kVec16>
__device__ __forceinline__ void load_probe(const u64* __restrict__ at,
                                           u64 (&v)[kProbe]) {
  if (kVec16) {
    const ulonglong2* p = reinterpret_cast<const ulonglong2*>(at);
#pragma unroll
    for (int j = 0; j < kProbe / 2; ++j) {
      const ulonglong2 a = __ldg(p + j);
      v[2 * j] = a.x;
      v[2 * j + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kProbe; ++j) v[j] = __ldg(at + j);
  }
}

__device__ __forceinline__ bool holds(const u64 (&v)[kProbe], u64 key) {
  bool hit = false;
#pragma unroll
  for (int j = 0; j < kProbe; ++j) hit |= v[j] == key;
  return hit;
}

// Whether key is in row (the row of bucket b, slot value >> shift giving a
// slot's bucket), read kProbe slots (one probe) at a time. The search keeps
// the probes [lo, hi] that can hold key: lo is the last probe known to
// start with a key of b not above key (0 at first), hi the last that may.
// Reading probe s moves lo to s (and hi too when its last slot is not a
// key of b below key: no later probe can hold key) or hi below s. The
// first read is the middle probe. The second and third, where the probe s
// just read starts with a key of b, are guessed from it as if the bucket's
// keys were evenly spread (key's slot ~ kProbe s frac(key) / frac(head),
// frac the bits below the bucket bits); the others bisect [lo, hi].
// past_full: the search ends in the last probe and slot 127 is a key of b
// below key, so the row is full and key may be in the spill table.
template <bool kVec16>
__device__ __forceinline__ bool row_find(const u64* __restrict__ row, u64 key,
                                         int shift, u64 b, bool* past_full) {
  const float fk = static_cast<float>((key << (64 - shift)) >> 40);
  int lo = 0, hi = kProbes - 1, s = kProbes / 2;
  bool found = false, lo_read = false;
  u64 last = 0;
  for (int step = 0;; ++step) {
    u64 v[kProbe];
    load_probe<kVec16>(row + kProbe * s, v);
    found |= holds(v, key);
    const bool head_in = (v[0] >> shift) == b;
    if (head_in && v[0] <= key) {
      lo = s;
      lo_read = true;
      last = v[kProbe - 1];
      if ((last >> shift) != b || last >= key) hi = s;
    } else {
      hi = s - 1;
    }
    if (found || lo >= hi) break;
    const float fh = static_cast<float>((v[0] << (64 - shift)) >> 40);
    if (step < 2 && head_in && fh > 0.0f) {
      const float slot = fminf(static_cast<float>(kProbe * s) * fk / fh,
                               static_cast<float>(kSlots - 1));
      s = min(max(static_cast<int>(slot) / kProbe, lo + 1), hi);
    } else {
      s = (lo + hi + 1) >> 1;
    }
  }
  if (!found && !lo_read) {  // probe 0 was not read
    u64 v[kProbe];
    load_probe<kVec16>(row, v);
    found = holds(v, key);
  }
  *past_full = !found && lo == kProbes - 1 && (last >> shift) == b &&
               last < key;
  return found;
}

template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
radix_probe_kernel(const int64_t* __restrict__ keys,
                   const int32_t* __restrict__ srid,
                   const int32_t* __restrict__ first, long long q,
                   const int64_t* __restrict__ table, long long row_lo,
                   long long rows, int p, const int64_t* __restrict__ spill,
                   int sp, int32_t* __restrict__ hits) {
  __shared__ long long bound[kBounds];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const u64 half = 1ull << (p - 1), lo_row = row_lo, hi_row = row_lo + rows;
  if (warp < 4) {
    // own rows as bucket' ranges: [a0, a1) the buckets >= 2^(p-1), at the
    // stream's start; [b0, b1) the others, after them
    u64 a0 = max(lo_row, half) - half, a1 = hi_row > half ? hi_row - half : 0;
    u64 b0 = lo_row + half, b1 = min(hi_row, half) + half;
    if (a0 >= a1) a0 = a1 = 0;
    if (b0 >= b1) b0 = b1 = 0;
    const u64 t = warp == 0 ? a0 : warp == 1 ? a1 : warp == 2 ? b0 : b1;
    const long long pos = bucket_bound(keys, srid, q, t, p, lane);
    if (lane == 0) bound[warp] = pos;
  } else if (warp < kBounds) {
    // the filler run: the entries (-1, srid < 0)
    const long long pos = stream_bound(keys, srid, q, ~kSign,
                                       warp == 4 ? INT_MIN : 0, lane);
    if (lane == 0) bound[warp] = pos;
  }
  __syncthreads();
  // three slices of the stream: the first range before the filler run and
  // after it, and the second range
  const long long f0 = bound[4], f1 = bound[5];
  const long long lo0 = bound[0], hi0 = min(bound[1], f0);
  const long long lo1 = max(bound[0], f1), hi1 = bound[1];
  const long long lo2 = bound[2], hi2 = bound[3];
  const long long n0 = max(hi0 - lo0 + 31, 0LL) >> 5;
  const long long n1 = max(hi1 - lo1 + 31, 0LL) >> 5;
  const long long n_tiles = n0 + n1 + (max(hi2 - lo2 + 31, 0LL) >> 5);

  const int shift = 64 - p;
  const u64* tab = reinterpret_cast<const u64*>(table);
  const u64* sp_tab = reinterpret_cast<const u64*>(spill);
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long t = static_cast<long long>(blockIdx.x) * kWarps + warp;
       t < n_tiles; t += n_warps) {  // warp-uniform
    long long i, end;
    if (t < n0) {
      i = lo0 + t * 32;
      end = hi0;
    } else if (t < n0 + n1) {
      i = lo1 + (t - n0) * 32;
      end = hi1;
    } else {
      i = lo2 + (t - n0 - n1) * 32;
      end = hi2;
    }
    i += lane;
    int32_t rid = -1;
    bool member = false;
    if (i < end) {  // a real entry: the slices hold no filler
      rid = srid[i];
      const int32_t head = first[i];
      const u64 key = static_cast<u64>(keys[i]);
      if (rid >= 0 && head != 0) {
        const u64 b = key >> shift;
        if (b >= lo_row && b < hi_row) {
          bool past_full;
          member = row_find<kVec16>(tab + (b - lo_row) * kSlots, key,
                                    shift, b, &past_full);
          if (past_full && sp > 0) {
            const u64 sb = key >> (64 - sp);
            member = row_find<kVec16>(sp_tab + sb * kSlots, key, 64 - sp,
                                      sb, &past_full);
          }
        }
      }
    }
    const unsigned members = __ballot_sync(kFull, member);
    if (member) {
      const unsigned peers = __match_any_sync(members, rid);
      if (lane == __ffs(peers) - 1) atomicAdd(hits + rid, __popc(peers));
    }
  }
}

// Blocks of the persistent grid: as many as fit on the device at once
// (read once per device), fewer for a short stream.
cudaError_t grid_blocks(long long q, int* blocks) {
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int fit = dev < 64 ? resident[dev] : 0;
  if (fit == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, radix_probe_kernel<true>, kThreads, 0);
    if (err != cudaSuccess) return err;
    fit = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) resident[dev] = fit;
  }
  const long long want = (q + kThreads - 1) / kThreads;
  *blocks = static_cast<int>(want < fit ? want : fit);
  return cudaSuccess;
}

}  // namespace

extern "C" int dx_radix_probe(const void* keys, const void* srid,
                              const void* first, long long q,
                              const void* table, long long row_lo,
                              long long rows, int p, const void* spill,
                              int sp, void* hits, void* stream) {
  if (q <= 0) return 0;
  int blocks = 0;
  const cudaError_t err = grid_blocks(q, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec16 = ((reinterpret_cast<uintptr_t>(table) |
                       reinterpret_cast<uintptr_t>(spill)) & 15) == 0;
  auto* kernel = vec16 ? radix_probe_kernel<true> : radix_probe_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(srid),
      static_cast<const int32_t*>(first), q,
      static_cast<const int64_t*>(table), row_lo, rows, p,
      static_cast<const int64_t*>(spill), sp, static_cast<int32_t*>(hits));
  return static_cast<int>(cudaGetLastError());
}
