// A driver of the port's five kernels with no torch, for memory checkers.
//
// It calls the C entries of _build/libdeacon_kernels.so (K1
// dx_select_compact, K2 dx_radix_probe, K3 dx_values_select, K4
// dx_select_csum, K5 dx_values_argmin) on the cases of a file and holds
// every output against the expected one in the file, so that a report of
// compute-sanitizer on this process concerns the kernels and the CUDA
// runtime alone. chip_smoke.py --sanitize writes the cases (seeded inputs,
// expected outputs from the kernels' plain PyTorch versions), builds this
// file with nvcc into _build/kernel_check and runs it, plainly and under
// each tool.
//
// Case file, little-endian: u32 magic 0x4B435844 ("DXCK"), u32 version 1,
// u32 case count; then per case: char name[32], i32 kernel (1-5), i64
// params[8], u32 array count, and per array an i64 byte count and the
// bytes.
//   K1, K3, K4, K5: params R, L, k, w, Br, misalign; arrays pc, pv, mlen,
//     allow, then the expected tot, pos, lo and hi (empty but for K3 and
//     K5 at k > 32). pc and pv sit `misalign` bytes past a 16-byte
//     boundary.
//   K2: params q, row_lo, rows, p, sp, num_segments, misalign; arrays
//     keys, srid, first, table, spill (empty when sp is 0) and the
//     expected hits. table and spill sit `misalign` bytes past a 16-byte
//     boundary.
// Slots past a row's total (and past Br) are unspecified and not
// compared. Exit code 0 when every case agrees, 1 on a mismatch or a CUDA
// error, 2 on a bad case file; "kernel_check: device ready" is printed
// once the device answers.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
int dx_select_compact(const void* pc, const void* pv, const void* mlen,
                      const void* allow, void* pos, void* val, void* tot,
                      int R, int L, int k, int w, int Br, void* stream);
int dx_select_csum(const void* pc, const void* pv, const void* mlen,
                   const void* allow, void* pos, void* val, void* tot, int R,
                   int L, int k, int w, int Br, void* stream);
int dx_values_select(const void* pc, const void* pv, const void* mlen,
                     const void* allow, void* pos, void* lo, void* hi,
                     void* tot, int R, int L, int k, int w, int Br,
                     void* stream);
int dx_values_argmin(const void* pc, const void* pv, const void* mlen,
                     const void* allow, void* pos, void* lo, void* hi,
                     void* tot, int R, int L, int k, int w, int Br,
                     void* stream);
int dx_radix_probe(const void* keys, const void* srid, const void* first,
                   long long q, const void* table, long long row_lo,
                   long long rows, int p, const void* spill, int sp,
                   void* hits, void* stream);
}

namespace {

typedef std::vector<uint8_t> Bytes;

struct Case {
  std::string name;
  int kernel = 0;
  int64_t params[8] = {};
  std::vector<Bytes> arrays;
};

bool read_exact(FILE* f, void* dst, size_t n) {
  return std::fread(dst, 1, n, f) == n;
}

bool read_cases(const char* path, std::vector<Case>* cases) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return false;
  uint32_t head[3];
  bool ok = read_exact(f, head, sizeof head) && head[0] == 0x4B435844u &&
            head[1] == 1;
  for (uint32_t c = 0; ok && c < head[2]; ++c) {
    Case cs;
    char name[33] = {};
    uint32_t n_arrays = 0;
    int32_t kernel = 0;
    ok = read_exact(f, name, 32) && read_exact(f, &kernel, 4) &&
         read_exact(f, cs.params, sizeof cs.params) &&
         read_exact(f, &n_arrays, 4) && kernel >= 1 && kernel <= 5;
    cs.name = name;
    cs.kernel = kernel;
    for (uint32_t a = 0; ok && a < n_arrays; ++a) {
      int64_t nbytes = 0;
      ok = read_exact(f, &nbytes, 8) && nbytes >= 0;
      if (ok) {
        cs.arrays.emplace_back(static_cast<size_t>(nbytes));
        ok = read_exact(f, cs.arrays.back().data(),
                        static_cast<size_t>(nbytes));
      }
    }
    if (ok) cases->push_back(std::move(cs));
  }
  std::fclose(f);
  return ok;
}

// A device copy of host bytes `misalign` bytes past a 16-byte boundary
// (cudaMalloc returns at least 256-byte aligned memory), or a filled
// output buffer of n bytes when src is null. The allocation ends where
// the data ends, so that a read past it is outside every allocation.
struct DevBuf {
  uint8_t* base = nullptr;
  uint8_t* ptr = nullptr;
  size_t n = 0;

  cudaError_t make(const Bytes* src, size_t n_bytes, size_t misalign) {
    n = src != nullptr ? src->size() : n_bytes;
    cudaError_t err = cudaMalloc(&base, n + misalign);
    if (err != cudaSuccess) return err;
    ptr = base + misalign;
    if (misalign > 0) err = cudaMemset(base, 0, misalign);
    if (err == cudaSuccess && n > 0)
      err = src != nullptr
                ? cudaMemcpy(ptr, src->data(), n, cudaMemcpyHostToDevice)
                : cudaMemset(ptr, 0xA5, n);
    return err;
  }
  Bytes fetch() const {
    Bytes out(n);
    if (n > 0) cudaMemcpy(out.data(), ptr, n, cudaMemcpyDeviceToHost);
    return out;
  }
  ~DevBuf() {
    if (base != nullptr) cudaFree(base);
  }
};

#define CHECK(call)                                                      \
  do {                                                                   \
    const cudaError_t e_ = (call);                                       \
    if (e_ != cudaSuccess) {                                             \
      std::printf("%s: CUDA error %d (%s) at %s\n", cs.name.c_str(),     \
                  static_cast<int>(e_), cudaGetErrorString(e_), #call);  \
      return -1;                                                         \
    }                                                                    \
  } while (0)

template <typename T>
const T* as(const Bytes& b) {
  return reinterpret_cast<const T*>(b.data());
}

// Slot-grid kernels: returns the number of differing entries (-1 on a
// CUDA error); *live counts the compared slots.
long long run_select(const Case& cs, cudaStream_t stream, long long* live) {
  const int R = static_cast<int>(cs.params[0]);
  const int L = static_cast<int>(cs.params[1]);
  const int k = static_cast<int>(cs.params[2]);
  const int w = static_cast<int>(cs.params[3]);
  const int Br = static_cast<int>(cs.params[4]);
  const size_t mis = static_cast<size_t>(cs.params[5]);
  const bool wide = (cs.kernel == 3 || cs.kernel == 5) && k > 32;
  const std::vector<Bytes>& a = cs.arrays;
  const size_t grid = static_cast<size_t>(R) * Br;
  if (a.size() != 8 || a[0].size() != static_cast<size_t>(R) * (L / 4) ||
      a[1].size() != static_cast<size_t>(R) * (L / 8) ||
      a[4].size() != 4u * R || a[5].size() != 4 * grid ||
      a[6].size() != 8 * grid || a[7].size() != (wide ? 8 * grid : 0)) {
    std::printf("%s: bad arrays\n", cs.name.c_str());
    return -2;
  }
  DevBuf pc, pv, mlen, allow, pos, lo, hi, tot;
  CHECK(pc.make(&a[0], 0, mis));
  CHECK(pv.make(&a[1], 0, mis));
  CHECK(mlen.make(&a[2], 0, 0));
  CHECK(allow.make(&a[3], 0, 0));
  CHECK(pos.make(nullptr, 4 * grid, 0));
  CHECK(lo.make(nullptr, 8 * grid, 0));
  if (wide) CHECK(hi.make(nullptr, 8 * grid, 0));
  CHECK(tot.make(nullptr, 4u * R, 0));
  int err = 0;
  switch (cs.kernel) {
    case 1:
      err = dx_select_compact(pc.ptr, pv.ptr, mlen.ptr, allow.ptr, pos.ptr,
                              lo.ptr, tot.ptr, R, L, k, w, Br, stream);
      break;
    case 4:
      err = dx_select_csum(pc.ptr, pv.ptr, mlen.ptr, allow.ptr, pos.ptr,
                           lo.ptr, tot.ptr, R, L, k, w, Br, stream);
      break;
    case 3:
      err = dx_values_select(pc.ptr, pv.ptr, mlen.ptr, allow.ptr, pos.ptr,
                             lo.ptr, wide ? hi.ptr : nullptr, tot.ptr, R, L,
                             k, w, Br, stream);
      break;
    default:
      err = dx_values_argmin(pc.ptr, pv.ptr, mlen.ptr, allow.ptr, pos.ptr,
                             lo.ptr, wide ? hi.ptr : nullptr, tot.ptr, R, L,
                             k, w, Br, stream);
  }
  CHECK(static_cast<cudaError_t>(err));
  CHECK(cudaStreamSynchronize(stream));
  const Bytes got_tot = tot.fetch(), got_pos = pos.fetch(),
              got_lo = lo.fetch(), got_hi = wide ? hi.fetch() : Bytes();
  long long bad = 0;
  *live = 0;
  for (int r = 0; r < R; ++r) {
    const int32_t t = as<int32_t>(got_tot)[r];
    if (t != as<int32_t>(a[4])[r]) {
      ++bad;
      continue;
    }
    const int n = t < Br ? t : Br;
    for (int j = 0; j < n; ++j) {
      const size_t i = static_cast<size_t>(r) * Br + j;
      bad += as<int32_t>(got_pos)[i] != as<int32_t>(a[5])[i];
      bad += as<int64_t>(got_lo)[i] != as<int64_t>(a[6])[i];
      if (wide) bad += as<int64_t>(got_hi)[i] != as<int64_t>(a[7])[i];
    }
    *live += n;
  }
  return bad;
}

long long run_probe(const Case& cs, cudaStream_t stream, long long* live) {
  const long long q = cs.params[0], row_lo = cs.params[1],
                  rows = cs.params[2];
  const int p = static_cast<int>(cs.params[3]);
  const int sp = static_cast<int>(cs.params[4]);
  const long long n_seg = cs.params[5];
  const size_t mis = static_cast<size_t>(cs.params[6]);
  const std::vector<Bytes>& a = cs.arrays;
  const size_t nq = static_cast<size_t>(q), nr = static_cast<size_t>(rows),
               ns = static_cast<size_t>(n_seg);
  if (q <= 0 || rows <= 0 || n_seg <= 0 || a.size() != 6 ||
      a[0].size() != 8 * nq || a[1].size() != 4 * nq ||
      a[2].size() != 4 * nq || a[3].size() != 8 * 128 * nr ||
      a[4].size() != (sp > 0 ? size_t{8 * 128} << sp : 0) ||
      a[5].size() != 4 * ns) {
    std::printf("%s: bad arrays\n", cs.name.c_str());
    return -2;
  }
  DevBuf keys, srid, first, table, spill, hits;
  CHECK(keys.make(&a[0], 0, 0));
  CHECK(srid.make(&a[1], 0, 0));
  CHECK(first.make(&a[2], 0, 0));
  CHECK(table.make(&a[3], 0, mis));
  if (sp > 0) CHECK(spill.make(&a[4], 0, mis));
  CHECK(hits.make(nullptr, 4 * ns, 0));
  CHECK(cudaMemset(hits.ptr, 0, 4 * ns));
  CHECK(static_cast<cudaError_t>(dx_radix_probe(
      keys.ptr, srid.ptr, first.ptr, q, table.ptr, row_lo, rows, p,
      sp > 0 ? spill.ptr : nullptr, sp, hits.ptr, stream)));
  CHECK(cudaStreamSynchronize(stream));
  const Bytes got = hits.fetch();
  long long bad = 0;
  for (long long i = 0; i < n_seg; ++i)
    bad += as<int32_t>(got)[i] != as<int32_t>(a[5])[i];
  *live = n_seg;
  return bad;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: kernel_check CASES\n");
    return 2;
  }
  std::vector<Case> cases;
  if (!read_cases(argv[1], &cases)) {
    std::fprintf(stderr, "kernel_check: cannot read cases from %s\n",
                 argv[1]);
    return 2;
  }
  cudaError_t err = cudaFree(nullptr);  // the context, before any case
  if (err != cudaSuccess) {
    std::printf("kernel_check: no device: CUDA error %d (%s)\n",
                static_cast<int>(err), cudaGetErrorString(err));
    return 1;
  }
  std::printf("kernel_check: device ready\n");
  cudaStream_t stream;
  if (cudaStreamCreate(&stream) != cudaSuccess) return 1;
  int failed = 0;
  for (const Case& cs : cases) {
    long long live = 0;
    const long long bad = cs.kernel == 2 ? run_probe(cs, stream, &live)
                                         : run_select(cs, stream, &live);
    std::printf("%s: %s (%lld compared, %lld differ)\n", cs.name.c_str(),
                bad == 0 ? "ok" : "FAILED", live, bad < 0 ? 0 : bad);
    failed += bad != 0;
  }
  cudaStreamDestroy(stream);
  std::printf("kernel_check: %zu cases, %d failed\n", cases.size(), failed);
  return failed == 0 ? 0 : 1;
}
