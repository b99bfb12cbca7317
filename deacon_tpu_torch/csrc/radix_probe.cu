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
// one to hits[read] with an atomic add, so hits counts the distinct member
// keys of each read (ref: src/filter_common.rs:129-155).
//
// Sharded contract: ``table`` holds the local block of ``rows`` bucket
// rows starting at global row ``row_lo`` (the whole table is row_lo = 0,
// rows = 2^p). A query counts here only when its bucket lies in
// [row_lo, row_lo + rows); the spill table is whole on every shard and is
// read only for such a query, so a spill match counts on the one shard
// that owns the query's primary bucket. Summing the hits of the shards
// of a table gives the unsharded hits exactly.
//
// Empty slots hold ((b ^ 1) << (64 - p)), whose bucket is not b, so no
// query routed to b can match one: no sentinel test is needed.
//
// What bounds it on an H100: device-memory bytes. Each probed query reads
// its 1 KB bucket row (and 1 KB of spill row when sp > 0 and the row has
// no match); the stream is sorted by key, so queries of one bucket are
// neighbours and share the row through L1/L2, and the bytes the probe
// must move are the distinct rows touched plus at most 16 bytes per query
// (4 B srid, 4 B first, 8 B key). Each shard reads the whole stream but
// only the bucket rows it owns, so S shards move S x the stream's bytes
// and the same rows as one unsharded launch.
//
// Design: one warp per query. Each lane compares 4 of the 128 slots (one
// coalesced 256-byte load per step across the warp) and a warp vote gives
// membership. Fillers, repeats of a (key, read) pair and queries of
// another shard's rows return before any table load. The TPU version's
// static window sizing, its overflow flag and its rerun do not exist here:
// every query reads its own bucket, so the count is exact on any input in
// one pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 128;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ bool row_has(const uint64_t* __restrict__ row,
                                        uint64_t key, int lane) {
  bool hit = false;
#pragma unroll
  for (int j = lane; j < kSlots; j += 32) hit |= row[j] == key;
  return __any_sync(0xFFFFFFFFu, hit);
}

__global__ void radix_probe_kernel(const int64_t* __restrict__ keys,
                                   const int32_t* __restrict__ srid,
                                   const int32_t* __restrict__ first,
                                   long long q,
                                   const int64_t* __restrict__ table,
                                   long long row_lo, long long rows, int p,
                                   const int64_t* __restrict__ spill, int sp,
                                   int32_t* __restrict__ hits) {
  const int lane = threadIdx.x & 31;
  const long long qi = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                       (threadIdx.x >> 5);
  if (qi >= q) return;  // warp-uniform
  const int32_t rid = srid[qi];
  if (rid < 0 || first[qi] == 0) return;  // warp-uniform
  const uint64_t key = static_cast<uint64_t>(keys[qi]);
  const long long b = static_cast<long long>(key >> (64 - p)) - row_lo;
  if (b < 0 || b >= rows) return;  // warp-uniform: another shard's bucket
  const uint64_t* tab = reinterpret_cast<const uint64_t*>(table);
  bool member = row_has(tab + b * kSlots, key, lane);
  if (sp > 0 && !member) {
    const uint64_t* sp_tab = reinterpret_cast<const uint64_t*>(spill);
    member = row_has(sp_tab + (key >> (64 - sp)) * kSlots, key, lane);
  }
  if (member && lane == 0) atomicAdd(hits + rid, 1);
}

}  // namespace

extern "C" int dx_radix_probe(const void* keys, const void* srid,
                              const void* first, long long q,
                              const void* table, long long row_lo,
                              long long rows, int p, const void* spill,
                              int sp, void* hits, void* stream) {
  if (q <= 0) return 0;
  const long long blocks = (q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  radix_probe_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(srid),
      static_cast<const int32_t*>(first), q,
      static_cast<const int64_t*>(table), row_lo, rows, p,
      static_cast<const int64_t*>(spill), sp, static_cast<int32_t*>(hits));
  return static_cast<int>(cudaGetLastError());
}
