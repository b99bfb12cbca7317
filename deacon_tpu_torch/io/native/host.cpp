// Host I/O library of deacon_tpu_torch: streaming FASTA/FASTQ reading
// (plain, gzip and BGZF, zstd, xz, bzip2; from a file or stdin, or one
// byte range of a plain or BGZF file) into reader-owned batch arenas, the
// record scans that split a file into ranges, compressed output writing,
// 2-bit packing of
// row slices into the device tile layout, the index file's varint codec
// and writer, sorted-set merges of u64 keys, and batched host minimizer
// extraction; and the host engine of `--device host`: a one-shot deflate
// compressor for BGZF output (fastdef), the index build's accumulator
// (dx_runacc_*) and counting set (dx_cset_*), the probe table with its
// <index>.probe sidecar (dx_probe_*), and the whole filter pipeline
// (dx_filter_run). Loaded through ctypes
// (deacon_tpu_torch/io/native_loader.py), which builds it with g++ at
// first use. The plain versions it is held against live in io/fastx.py,
// io/writers.py, ops/pack.py, utils/bincode.py and ops/minimizers_np.py.
//
// Environment read here, with the JAX package's meanings: DEACON_THP and
// DEACON_PROBE_THP (huge-page advice), DEACON_CHUNK_PARSE and
// DEACON_CHUNK_BYTES (the pipeline's chunk-parallel reader),
// DEACON_NATIVE_PROFILE (its per-stage times on stderr; DEACON_TRACE=1
// turns them on too). The pipeline's
// .gz output is always BGZF from fastdef at levels 1-3, zlib above.
//
// Codec libraries: zlib is linked (-lz). zstd, xz and bzip2 are bound at
// first use by dlopen of their runtime libraries (zstd's by the name the
// caller passes, libzstd.so.1 by default; liblzma.so.5, libbz2.so.1); the
// few stream functions used are declared below with the libraries' stable
// ABI, so the build needs only zlib's header. A stream whose codec library is missing fails to open with a
// message naming it (dx_open_error); nothing falls back.
//
// Thread contract: a reader (DxReader) or writer (DxWriter) handle is used
// by one thread at a time; distinct handles are independent. Internal
// worker threads (BGZF inflate, decode-ahead, gzip output's deflate pool
// and output thread, index encode, extraction) never outlive the call or
// handle that started them. The stateless
// functions (pack, codec, merges, extraction) may run concurrently.

#include <algorithm>
#include <array>
#include <atomic>
#include <cerrno>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <dlfcn.h>
#include <fcntl.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

constexpr size_t kBufSize = 1 << 20;

static inline int64_t now_ns() {  // wall clock: stall (wait) counters
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

static inline int64_t now_cpu_ns() {  // this thread's CPU time: compute
  struct timespec ts;                 // stages (immune to steal/preemption)
  clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
  return ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

// Handle counters (dx_reader_stats, dx_writer_stats): a caller hands a
// reader or a writer an int64 array, and the handle adds to its slots
// from then on; with none (the default) each counted section costs one
// branch. A slot is written by one thread (the decode-ahead thread or the
// handle's user; a gzip writer's own threads count apart and are added
// at close) and read once the handle is closed.
enum ReaderStat { kDecodeBusyNs, kDecodeFullWaitNs, kDecodeBytes,
                  kReaderEmptyWaitNs };
enum WriterStat { kEncodeNs, kOutputIoNs, kOutputBytesIn, kOutputBytesOut,
                  kEncodeBusyNs, kEncodeFullWaitNs, kEncodeBlocks };

enum class Codec : int { kPlain = 0, kGzip = 1, kZstd = 2, kXz = 3, kBz2 = 4 };

void* dlopen_first(std::initializer_list<const char*> names) {
  for (const char* n : names) {
    void* h = dlopen(n, RTLD_NOW | RTLD_LOCAL);
    if (h) return h;
  }
  return nullptr;
}

template <typename F>
void bind(void* h, F& fn, const char* name) {
  fn = h ? reinterpret_cast<F>(dlsym(h, name)) : nullptr;
}

// ---- bzip2 (libbz2.so.1) --------------------------------------------------
struct BzStream {
  char* next_in;
  unsigned avail_in, total_in_lo32, total_in_hi32;
  char* next_out;
  unsigned avail_out, total_out_lo32, total_out_hi32;
  void* state;
  void* (*bzalloc)(void*, int, int);
  void (*bzfree)(void*, void*);
  void* opaque;
};
constexpr int kBzOk = 0, kBzStreamEnd = 4;

struct Bz2Api {
  int (*init)(BzStream*, int, int) = nullptr;
  int (*decomp)(BzStream*) = nullptr;
  int (*end)(BzStream*) = nullptr;
  bool ok() const { return init && decomp && end; }
  static const Bz2Api& get() {
    static const Bz2Api api = [] {
      Bz2Api a;
      void* h = dlopen_first({"libbz2.so.1", "libbz2.so.1.0", "libbz2.so"});
      bind(h, a.init, "BZ2_bzDecompressInit");
      bind(h, a.decomp, "BZ2_bzDecompress");
      bind(h, a.end, "BZ2_bzDecompressEnd");
      return a;
    }();
    return api;
  }
};

// ---- zstd (libzstd.so.1) ---------------------------------------------------
struct ZSTD_DStream;
struct ZSTD_CStream;
struct ZSTD_inBuffer {
  const void* src;
  size_t size;
  size_t pos;
};
struct ZSTD_outBuffer {
  void* dst;
  size_t size;
  size_t pos;
};

// Bound per library name: the port names its zstd library in one place
// (io/zstd.py's LIBRARY) and passes it to dx_open / dx_writer_open.
struct ZstdApi {
  ZSTD_DStream* (*createDStream)() = nullptr;
  size_t (*freeDStream)(ZSTD_DStream*) = nullptr;
  size_t (*initDStream)(ZSTD_DStream*) = nullptr;
  size_t (*decompressStream)(ZSTD_DStream*, ZSTD_outBuffer*,
                             ZSTD_inBuffer*) = nullptr;
  unsigned (*isError)(size_t) = nullptr;
  ZSTD_CStream* (*createCStream)() = nullptr;
  size_t (*freeCStream)(ZSTD_CStream*) = nullptr;
  size_t (*initCStream)(ZSTD_CStream*, int) = nullptr;
  size_t (*compressStream)(ZSTD_CStream*, ZSTD_outBuffer*,
                           ZSTD_inBuffer*) = nullptr;
  size_t (*endStream)(ZSTD_CStream*, ZSTD_outBuffer*) = nullptr;
  size_t (*cStreamOutSize)() = nullptr;
  size_t (*compress)(void*, size_t, const void*, size_t, int) = nullptr;
  size_t (*compressBound)(size_t) = nullptr;
  bool ok() const {
    return createDStream && freeDStream && initDStream && decompressStream &&
           isError && createCStream && freeCStream && initCStream &&
           compressStream && endStream && cStreamOutSize && compress &&
           compressBound;
  }
  // The API of library `name`, or nullptr when it cannot be loaded.
  static const ZstdApi* get(const char* name) {
    static std::mutex mu;
    static std::map<std::string, std::unique_ptr<ZstdApi>> bound;
    std::lock_guard<std::mutex> g(mu);
    auto it = bound.find(name);
    if (it == bound.end()) {
      auto a = std::make_unique<ZstdApi>();
      void* h = dlopen_first({name});
      bind(h, a->createDStream, "ZSTD_createDStream");
      bind(h, a->freeDStream, "ZSTD_freeDStream");
      bind(h, a->initDStream, "ZSTD_initDStream");
      bind(h, a->decompressStream, "ZSTD_decompressStream");
      bind(h, a->isError, "ZSTD_isError");
      bind(h, a->createCStream, "ZSTD_createCStream");
      bind(h, a->freeCStream, "ZSTD_freeCStream");
      bind(h, a->initCStream, "ZSTD_initCStream");
      bind(h, a->compressStream, "ZSTD_compressStream");
      bind(h, a->endStream, "ZSTD_endStream");
      bind(h, a->cStreamOutSize, "ZSTD_CStreamOutSize");
      bind(h, a->compress, "ZSTD_compress");
      bind(h, a->compressBound, "ZSTD_compressBound");
      it = bound.emplace(name, std::move(a)).first;
    }
    return it->second->ok() ? it->second.get() : nullptr;
  }
};

// ---- xz (liblzma.so.5) -----------------------------------------------------
enum lzma_ret { LZMA_OK = 0, LZMA_STREAM_END = 1 };
enum lzma_action { LZMA_RUN = 0, LZMA_FINISH = 3 };
enum lzma_reserved_enum { LZMA_RESERVED_ENUM = 0 };
constexpr uint32_t LZMA_CONCATENATED = 0x08;
constexpr int LZMA_CHECK_CRC64 = 4;

struct lzma_stream {  // liblzma 5's public layout (lzma/base.h)
  const uint8_t* next_in;
  size_t avail_in;
  uint64_t total_in;
  uint8_t* next_out;
  size_t avail_out;
  uint64_t total_out;
  const void* allocator;
  void* internal;
  void* reserved_ptr1;
  void* reserved_ptr2;
  void* reserved_ptr3;
  void* reserved_ptr4;
  uint64_t seek_pos;
  uint64_t reserved_int2;
  size_t reserved_int3;
  size_t reserved_int4;
  lzma_reserved_enum reserved_enum1;
  lzma_reserved_enum reserved_enum2;
};
#define LZMA_STREAM_INIT                                                  \
  {                                                                       \
    nullptr, 0, 0, nullptr, 0, 0, nullptr, nullptr, nullptr, nullptr,     \
        nullptr, nullptr, 0, 0, 0, 0, LZMA_RESERVED_ENUM, LZMA_RESERVED_ENUM \
  }

struct LzmaApi {
  int (*stream_decoder)(lzma_stream*, uint64_t, uint32_t) = nullptr;
  int (*easy_encoder)(lzma_stream*, uint32_t, int) = nullptr;
  int (*code)(lzma_stream*, int) = nullptr;
  void (*end)(lzma_stream*) = nullptr;
  int (*easy_buffer_encode)(uint32_t, int, const void*, const uint8_t*,
                            size_t, uint8_t*, size_t*, size_t) = nullptr;
  size_t (*stream_buffer_bound)(size_t) = nullptr;
  bool ok() const {
    return stream_decoder && easy_encoder && code && end &&
           easy_buffer_encode && stream_buffer_bound;
  }
  static const LzmaApi& get() {
    static const LzmaApi api = [] {
      LzmaApi a;
      void* h = dlopen_first({"liblzma.so.5", "liblzma.so"});
      bind(h, a.stream_decoder, "lzma_stream_decoder");
      bind(h, a.easy_encoder, "lzma_easy_encoder");
      bind(h, a.code, "lzma_code");
      bind(h, a.end, "lzma_end");
      bind(h, a.easy_buffer_encode, "lzma_easy_buffer_encode");
      bind(h, a.stream_buffer_bound, "lzma_stream_buffer_bound");
      return a;
    }();
    return api;
  }
};

lzma_ret lzma_stream_decoder(lzma_stream* s, uint64_t memlimit,
                             uint32_t flags) {
  return (lzma_ret)LzmaApi::get().stream_decoder(s, memlimit, flags);
}
lzma_ret lzma_easy_encoder(lzma_stream* s, uint32_t preset, int check) {
  return (lzma_ret)LzmaApi::get().easy_encoder(s, preset, check);
}
lzma_ret lzma_code(lzma_stream* s, lzma_action a) {
  return (lzma_ret)LzmaApi::get().code(s, (int)a);
}
void lzma_end(lzma_stream* s) { LzmaApi::get().end(s); }

// The runtime library a codec needs, or nullptr when it is bound.
const char* missing_codec_library(Codec c, const char* zstd_lib) {
  switch (c) {
    case Codec::kZstd:
      return ZstdApi::get(zstd_lib) ? nullptr : zstd_lib;
    case Codec::kXz:
      return LzmaApi::get().ok() ? nullptr : "liblzma.so.5";
    case Codec::kBz2:
      return Bz2Api::get().ok() ? nullptr : "libbz2.so.1";
    default:
      return nullptr;
  }
}

thread_local std::string g_open_error;  // why the last dx_*open failed


// ---------------------------------------------------------------------------
// Fast one-shot raw-deflate decoder (dx_inflate).
//
// Purpose-built for BGZF blocks: the whole compressed payload is in memory
// and the exact output size is known (ISIZE <= 64 KiB), so the decoder can
// use a 64-bit bit buffer with branchless refills, two-level Huffman tables
// (10-bit primary + subtables, built per dynamic block), multi-literal
// decode per refill, and 8-byte wide match copies — libdeflate's
// techniques. Output goes to a caller buffer with >= kInflateMargin
// writable slack beyond out_len (wide copies overshoot); the BGZF worker
// decodes into a per-thread scratch and memcpys the exact bytes out.
// Integrity is still enforced by the gzip CRC32 + ISIZE check downstream.
// ---------------------------------------------------------------------------

constexpr size_t kInflateMargin = 32;

namespace fastinf {

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;  // valid low bits in buf; NEGATIVE = consumed past the end

  explicit BitReader(const uint8_t* in, size_t n) : p(in), end(in + n) {}

  // Near the end no zero-padding is appended: bits of buf above cnt are
  // exactly the upcoming real bytes (OR-trick) or zero, so peek() reads
  // implicit zeros past the stream and over-consumption drives cnt
  // negative — checked by callers via ok().
  inline void refill() {
    if (cnt >= 56) return;
    if (end - p >= 8) {
      uint64_t w;
      memcpy(&w, p, 8);
      buf |= w << cnt;
      p += (63 - cnt) >> 3;
      cnt |= 56;
    } else {
      while (cnt <= 56 && p < end) {
        buf |= (uint64_t)(*p++) << cnt;
        cnt += 8;
      }
    }
  }

  inline uint64_t peek(int n) const { return buf & ((1ull << n) - 1); }
  inline void consume(int n) {
    buf >>= n;
    cnt -= n;
  }
  inline uint64_t bits(int n) {  // n <= 16
    uint64_t v = buf & ((1ull << n) - 1);
    consume(n);
    return v;
  }
  inline bool ok() const { return cnt >= 0; }
};

// Decode-table entry (primary and subtables share the layout):
//   bits 0..5   consumed bits: code length, or for subtable pointers the
//               primary root width
//   bits 6..7   kind: 0 literal, 1 length/distance, 2 end-of-block/invalid,
//               3 subtable pointer
//   bits 8..11  extra bits (kind 1)
//   bits 16..31 payload: literal byte / base value / subtable offset
enum : uint32_t { kLit = 0u << 6, kVal = 1u << 6, kEnd = 2u << 6, kSub = 3u << 6 };
static inline uint32_t mk(uint32_t kind, uint32_t len, uint32_t extra,
                          uint32_t payload) {
  return kind | len | (extra << 8) | (payload << 16);
}

constexpr int kLitRoot = 10;
constexpr int kDistRoot = 8;
// zlib's ENOUGH bounds: 852 entries for litlen root 9; root 10 needs fewer
// subtable entries. 2048 is ample slack for both tables.
constexpr int kTableSlack = 2048;

struct Tables {
  uint32_t lit[(1 << kLitRoot) + kTableSlack];
  uint32_t dist[(1 << kDistRoot) + kTableSlack];
};

static const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                                      15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                      67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2,
                                      2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5,
                                      0};
static const uint16_t kDistBase[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,   25,
    33,   49,   65,   97,   129,  193,   257,   385,   513,  769,
    1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
static const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,
                                       4, 4, 5, 5, 6, 6, 7, 7,  8,  8,
                                       9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

static inline uint32_t rev_bits(uint32_t code, int len) {
  code = ((code & 0x5555) << 1) | ((code >> 1) & 0x5555);
  code = ((code & 0x3333) << 2) | ((code >> 2) & 0x3333);
  code = ((code & 0x0F0F) << 4) | ((code >> 4) & 0x0F0F);
  code = ((code & 0x00FF) << 8) | ((code >> 8) & 0x00FF);
  return code >> (16 - len);
}

// Builds a two-level decode table from canonical code lengths.
// sym_entry(sym, len) returns the leaf entry for a symbol. Returns the total
// table slots used, or -1 on an invalid (oversubscribed/incomplete) code.
// `single_ok`: a code with one symbol of length 1.. is allowed incomplete
// (deflate permits a single-distance-code tree).
template <typename F>
static int build_table(uint32_t* table, int root, const uint8_t* lens,
                       int nsym, F sym_entry, bool single_ok) {
  int count[16] = {0};
  for (int s = 0; s < nsym; s++) count[lens[s]]++;
  int nz = nsym - count[0];
  if (nz == 0) return -1;  // no symbols
  // Kraft check
  int left = 1;
  int max_len = 0, min_len = 0;
  for (int l = 1; l <= 15; l++) {
    left <<= 1;
    left -= count[l];
    if (left < 0) return -1;  // oversubscribed
    if (count[l]) {
      max_len = l;
      if (!min_len) min_len = l;
    }
  }
  if (left > 0) {
    // incomplete code: allowed only for a single-symbol code when the
    // caller opts in (single dist code); decode of that symbol still works
    if (!(single_ok && nz == 1)) return -1;
  }
  // first canonical code per length
  uint32_t next_code[16] = {0};
  uint32_t code = 0;
  for (int l = 1; l <= 15; l++) {
    code = (code + count[l - 1]) << 1;
    next_code[l] = code;
  }
  int eff_root = root;
  if (max_len < eff_root) eff_root = max_len;
  const uint32_t prim_size = 1u << eff_root;
  // invalid-by-default so corrupt streams hit kEnd entries
  for (uint32_t i = 0; i < prim_size; i++) table[i] = mk(kEnd, 0, 0, 1);
  int used = (int)prim_size;
  // bucket bookkeeping for codes longer than root: canonical codes of the
  // same prefix are contiguous, but fills here are stride-based so order
  // doesn't matter; subtables are sized by each bucket's max length.
  int bucket_max[1 << kLitRoot];
  int bucket_off[1 << kLitRoot];
  bool have_long = max_len > eff_root;
  if (have_long) {
    for (uint32_t i = 0; i < prim_size; i++) bucket_max[i] = 0;
    // pass 1: per-bucket max code length
    uint32_t nc[16];
    memcpy(nc, next_code, sizeof(nc));
    for (int s = 0; s < nsym; s++) {
      int l = lens[s];
      if (!l) continue;
      uint32_t c = nc[l]++;
      if (l > eff_root) {
        uint32_t r = rev_bits(c, l);
        uint32_t b = r & (prim_size - 1);
        if (l > bucket_max[b]) bucket_max[b] = l;
      }
    }
    // pass 2: allocate subtables + pointer entries
    for (uint32_t b = 0; b < prim_size; b++) {
      if (!bucket_max[b]) continue;
      int sub_bits = bucket_max[b] - eff_root;
      bucket_off[b] = used;
      int sz = 1 << sub_bits;
      if (used + sz > (int)prim_size + kTableSlack) return -1;
      for (int i = 0; i < sz; i++) table[used + i] = mk(kEnd, 0, 0, 1);
      table[b] = mk(kSub, (uint32_t)sub_bits, 0, (uint32_t)used);
      used += sz;
    }
  }
  // pass 3: fill leaves
  for (int s = 0; s < nsym; s++) {
    int l = lens[s];
    if (!l) continue;
    uint32_t c = next_code[l]++;
    uint32_t r = rev_bits(c, l);
    uint32_t e = sym_entry(s, l);
    if (l <= eff_root) {
      for (uint32_t i = r; i < prim_size; i += (1u << l)) table[i] = e;
    } else {
      uint32_t b = r & (prim_size - 1);
      int sub_bits = (int)(table[b] & 63);
      uint32_t* sub = table + bucket_off[b];
      uint32_t hi = r >> eff_root;  // (l - eff_root) bits
      for (uint32_t i = hi; i < (1u << sub_bits); i += (1u << (l - eff_root)))
        sub[i] = e;
    }
  }
  // effective root narrower than requested: replicate the primary table up
  // to the requested width so the decode mask stays fixed
  if (eff_root < root) {
    for (uint32_t i = prim_size; i < (1u << root); i++)
      table[i] = table[i & (prim_size - 1)];
    // subtable offsets remain valid (absolute indices)
  }
  return used;
}

static inline uint32_t lit_entry(int sym, int len) {
  if (sym < 256) return mk(kLit, (uint32_t)len, 0, (uint32_t)sym);
  if (sym == 256) return mk(kEnd, (uint32_t)len, 0, 0);
  int li = sym - 257;
  if (li >= 29) return mk(kEnd, (uint32_t)len, 0, 1);  // invalid symbol
  return mk(kVal, (uint32_t)len, kLenExtra[li], kLenBase[li]);
}

static inline uint32_t dist_entry(int sym, int len) {
  if (sym >= 30) return mk(kEnd, (uint32_t)len, 0, 1);
  return mk(kVal, (uint32_t)len, kDistExtra[sym], kDistBase[sym]);
}

// Decodes one symbol via (possibly two-level) table. Consumes its bits.
// Requires >= 15 bits buffered. Returns the leaf entry.
static inline uint32_t decode_entry(BitReader& br, const uint32_t* table,
                                    int root) {
  uint32_t e = table[br.peek(root)];
  if ((e & 0xC0) == kSub) {
    int sub_bits = (int)(e & 63);
    const uint32_t* sub = table + (e >> 16);
    br.consume(root);
    e = sub[br.peek(sub_bits)];
    // leaf's stored length is the FULL code length; consume the remainder
    // (invalid filler leaves have length 0: nothing more to consume)
    int rem = (int)(e & 63) - root;
    if (rem > 0) br.consume(rem);
    return e | 0x8000u;  // flag: bits already consumed
  }
  return e;
}

static const uint8_t kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                     11, 4, 12,  3, 13, 2, 14, 1, 15};

// One-shot raw-deflate decode: decodes exactly out_len bytes (the buffer
// must have kInflateMargin writable slack beyond out_len). Returns 0 on
// success, -1 on corrupt input / size mismatch.
static int dbg_err(int /*site*/) { return -1; }
static int inflate_block(const uint8_t* in, size_t in_len, uint8_t* out,
                         size_t out_len, Tables& tb) {
  BitReader br(in, in_len);
  uint8_t* op = out;
  uint8_t* const oend = out + out_len;
  uint8_t lit_lens[288], dist_lens[32];

  for (;;) {  // block loop
    br.refill();
    if (!br.ok()) return dbg_err(1);
    uint32_t bfinal = (uint32_t)br.bits(1);
    uint32_t btype = (uint32_t)br.bits(2);
    if (btype == 0) {  // stored
      br.consume(br.cnt & 7);  // discard to byte boundary
      if (!br.ok()) return dbg_err(2);
      // bytes still in the bit buffer come first
      uint32_t hdr[4];
      for (int i = 0; i < 4; i++) {
        if (br.cnt >= 8) {
          hdr[i] = (uint32_t)br.bits(8);
        } else if (br.p < br.end) {
          hdr[i] = *br.p++;
        } else {
          return dbg_err(3);
        }
      }
      uint32_t len = hdr[0] | (hdr[1] << 8);
      uint32_t nlen = hdr[2] | (hdr[3] << 8);
      if ((len ^ 0xFFFF) != nlen) return dbg_err(4);
      if ((size_t)(oend - op) < len) return dbg_err(5);
      // drain buffered bytes first (all byte-aligned now)
      while (len && br.cnt >= 8) {
        *op++ = (uint8_t)br.bits(8);
        len--;
      }
      if ((size_t)(br.end - br.p) < len) return dbg_err(6);
      memcpy(op, br.p, len);
      op += len;
      br.p += len;
      // p jumped: bits above cnt still cache pre-jump bytes — the refill
      // OR-trick is only idempotent when p is unmoved, so zero them
      br.buf &= br.cnt ? ((1ull << br.cnt) - 1) : 0;
      if (bfinal) break;
      continue;
    }
    int nlit, ndist;
    if (btype == 1) {  // fixed codes
      for (int i = 0; i < 144; i++) lit_lens[i] = 8;
      for (int i = 144; i < 256; i++) lit_lens[i] = 9;
      for (int i = 256; i < 280; i++) lit_lens[i] = 7;
      for (int i = 280; i < 288; i++) lit_lens[i] = 8;
      for (int i = 0; i < 32; i++) dist_lens[i] = 5;
      nlit = 288;
      ndist = 32;
    } else if (btype == 2) {  // dynamic
      br.refill();
      nlit = (int)br.bits(5) + 257;
      ndist = (int)br.bits(5) + 1;
      int ncl = (int)br.bits(4) + 4;
      if (nlit > 286 || ndist > 30) return dbg_err(7);
      uint8_t cl_lens[19] = {0};
      for (int i = 0; i < ncl; i++) {
        br.refill();
        cl_lens[kClOrder[i]] = (uint8_t)br.bits(3);
      }
      if (!br.ok()) return dbg_err(8);
      uint32_t cl_table[(1 << 7) + 128];
      if (build_table(cl_table, 7, cl_lens, 19,
                      [](int s, int l) {
                        return mk(kVal, (uint32_t)l, 0, (uint32_t)s);
                      },
                      false) < 0)
        return dbg_err(9);
      int n = 0;
      uint8_t all[288 + 32];
      while (n < nlit + ndist) {
        br.refill();
        if (!br.ok()) return dbg_err(10);
        uint32_t e = cl_table[br.peek(7)];
        if ((e & 0xC0) == kEnd) return dbg_err(11);
        br.consume((int)(e & 63));
        int sym = (int)(e >> 16);
        if (sym < 16) {
          all[n++] = (uint8_t)sym;
        } else if (sym == 16) {
          if (n == 0) return dbg_err(12);
          int rep = 3 + (int)br.bits(2);
          if (n + rep > nlit + ndist) return dbg_err(13);
          uint8_t prev = all[n - 1];
          while (rep--) all[n++] = prev;
        } else if (sym == 17) {
          int rep = 3 + (int)br.bits(3);
          if (n + rep > nlit + ndist) return dbg_err(14);
          while (rep--) all[n++] = 0;
        } else {
          int rep = 11 + (int)br.bits(7);
          if (n + rep > nlit + ndist) return dbg_err(15);
          while (rep--) all[n++] = 0;
        }
      }
      if (!br.ok()) return dbg_err(16);
      memcpy(lit_lens, all, nlit);
      memcpy(dist_lens, all + nlit, ndist);
    } else {
      return dbg_err(17);  // btype 3
    }
    if (btype == 2 && lit_lens[256] == 0) return dbg_err(18);  // no EOB code
    if (build_table(tb.lit, kLitRoot, lit_lens, nlit, lit_entry, false) < 0)
      return dbg_err(19);
    int nd = btype == 1 ? 32 : ndist;
    if (build_table(tb.dist, kDistRoot, dist_lens, nd, dist_entry, true) < 0) {
      // a block with NO distance codes at all is legal (literals-only);
      // poison the table so any match attempt errors
      bool any = false;
      for (int i = 0; i < nd; i++) any |= dist_lens[i] != 0;
      if (any) return dbg_err(20);
      for (int i = 0; i < (1 << kDistRoot); i++)
        tb.dist[i] = mk(kEnd, 0, 0, 1);
    }

    // --- symbol loop ---
    for (;;) {
      br.refill();
      if (!br.ok()) return dbg_err(21);
      uint32_t e = decode_entry(br, tb.lit, kLitRoot);
      uint32_t kind = e & 0xC0;
      if (kind == kLit) {
        if (!(e & 0x8000u)) br.consume((int)(e & 63));
        if (op >= oend) return dbg_err(22);
        *op++ = (uint8_t)(e >> 16);
        // literal burst: keep decoding straight from the primary table
        // while bits and blind-store headroom last (a kSub/kVal/kEnd entry
        // exits to the dispatching loop without consuming)
        while (br.cnt >= 15 && op + 8 <= oend) {
          e = tb.lit[br.peek(kLitRoot)];
          if ((e & 0xC0) != kLit) break;
          br.consume((int)(e & 63));
          *op++ = (uint8_t)(e >> 16);
        }
        continue;
      }
      if (kind == kEnd) {
        if ((e >> 16) != 0) return dbg_err(23);  // invalid symbol leaf
        if (!(e & 0x8000u)) br.consume((int)(e & 63));
        break;  // end of block
      }
      // length/distance
      if (!(e & 0x8000u)) br.consume((int)(e & 63));
      uint32_t len = (e >> 16) + (uint32_t)br.bits((int)((e >> 8) & 15));
      br.refill();
      uint32_t de = decode_entry(br, tb.dist, kDistRoot);
      if ((de & 0xC0) != kVal) return dbg_err(24);
      if (!(de & 0x8000u)) br.consume((int)(de & 63));
      uint32_t dist = (de >> 16) + (uint32_t)br.bits((int)((de >> 8) & 15));
      if (!br.ok()) return dbg_err(25);
      if ((size_t)dist > (size_t)(op - out)) return dbg_err(26);
      if ((size_t)len > (size_t)(oend - op)) return dbg_err(27);
      const uint8_t* src = op - dist;
      if (dist >= 8) {
        // wide copy into the margin (caller guarantees slack)
        uint8_t* d = op;
        op += len;
        do {
          memcpy(d, src, 8);
          d += 8;
          src += 8;
        } while (d < op);
      } else if (dist == 1) {
        memset(op, *src, len);
        op += len;
      } else {
        uint8_t* d = op;
        op += len;
        while (d < op) *d++ = *src++;
      }
    }
    if (bfinal) break;
  }
  if (op != oend) return dbg_err(28);
  return br.ok() ? 0 : -1;
}
// ---------------------------------------------------------------------------
// Streaming gzip decoder (plain single-stream .gz, the most common real
// input). Same decode core as inflate_block — 64-bit bit buffer, two-level
// tables, wide copies — restructured to SUSPEND between symbols when the
// contiguous input buffer runs low (the owner compacts + refreads and
// resumes) and to produce straight into the caller's buffer with a 32 KiB
// history window for matches that reach into earlier read() calls. Handles
// the full gzip member framing (FEXTRA/FNAME/FCOMMENT/FHCRC, CRC32+ISIZE
// verification, concatenated members).
// ---------------------------------------------------------------------------

struct StreamGz {
  Tables tb;
  // persistent bit reader state (input offset is owner-managed)
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  // gzip member state machine
  enum { kHdr, kDeflate, kTrailer, kDone, kBad } gstate = kHdr;
  // deflate state within a member
  enum { kBlockHdr, kSymbols, kStored } dstate = kBlockHdr;
  bool bfinal = false;
  size_t stored_left = 0;
  uint32_t crc_run = 0;
  uint64_t isize_run = 0;
  // history window: last <= 32 KiB of decoded output
  uint8_t hist[1 << 15];
  size_t hist_len = 0;

  static constexpr size_t kInMargin = 64;

  void note_output(const uint8_t* p, size_t n) {
    crc_run = (uint32_t)crc32(crc_run, p, (uInt)n);
    isize_run += n;
    if (n >= sizeof(hist)) {
      memcpy(hist, p + n - sizeof(hist), sizeof(hist));
      hist_len = sizeof(hist);
    } else {
      size_t keep = std::min(hist_len, sizeof(hist) - n);
      memmove(hist, hist + hist_len - keep, keep);
      memcpy(hist + keep, p, n);
      hist_len = keep + n;
    }
  }

  // Decodes from in[*ip .. in_len) into out[*op .. out_cap). `final_in`:
  // no more input exists beyond in_len. Advances *ip/*op. Returns
  //  1 = made progress / suspended (needs more input or output space),
  //  0 = clean end of the last gzip member (all input consumed),
  // -1 = corrupt stream.
  int run(const uint8_t* in, size_t in_len, size_t* ip, bool final_in,
          uint8_t* out, size_t out_cap, size_t* op) {
    BitReader br(in + *ip, in_len - *ip);
    br.buf = bitbuf;
    br.cnt = bitcnt;
    uint8_t* const obase = out;
    uint8_t* o = out + *op;
    uint8_t* const oend = out + out_cap;
    const uint8_t* out_done = out + *op;  // bytes not yet crc/hist-noted

    auto save = [&]() {
      bitbuf = br.buf;
      bitcnt = br.cnt;
      *ip = in_len - (size_t)(br.end - br.p);
      if (o != out_done) note_output(out_done, (size_t)(o - out_done));
      out_done = o;
      *op = (size_t)(o - obase);
    };
    auto in_left = [&]() { return (size_t)(br.end - br.p) + (size_t)(br.cnt >> 3); };

    for (;;) {
      if (gstate == kDone) {
        save();
        return 0;
      }
      if (gstate == kBad) return -1;
      if (!final_in && in_left() < kInMargin) {
        save();
        return 1;  // refill input
      }
      if (gstate == kHdr) {
        // byte-aligned: gzip member header (bit buffer holds whole bytes)
        br.consume(br.cnt & 7);
        if (!br.ok()) return -1;
        if (in_left() == 0) {
          if (final_in) {  // clean EOF at a member boundary
            gstate = kDone;
            continue;
          }
          save();
          return 1;
        }
        // the header parser cannot suspend mid-field: demand the whole
        // header be buffered (FEXTRA <= 64 KiB + names; owner buffers are
        // larger than this margin)
        if (!final_in && in_left() < (size_t)(1 << 17)) {
          save();
          return 1;
        }
        if (in_left() < 10) return -1;  // truncated header at EOF
        uint8_t h[10];
        for (int i = 0; i < 10; i++)
          h[i] = br.cnt >= 8 ? (uint8_t)br.bits(8) : *br.p++;
        if (h[0] != 0x1F || h[1] != 0x8B || h[2] != 8) return -1;
        uint8_t flg = h[3];
        auto next_byte = [&](uint8_t* v) -> bool {
          if (br.cnt >= 8) {
            *v = (uint8_t)br.bits(8);
            return true;
          }
          if (br.p < br.end) {
            *v = *br.p++;
            return true;
          }
          return false;
        };
        if (flg & 0x04) {  // FEXTRA
          uint8_t a = 0, b = 0;
          if (!next_byte(&a) || !next_byte(&b)) return -1;
          size_t xlen = (size_t)a | ((size_t)b << 8);
          // skip xlen bytes (suspend-free: input margin may be smaller
          // than xlen; spill through byte loop, refilling is impossible
          // mid-header — instead require the owner provide it: xlen max
          // 64 KiB < owner buffer, so only truncation can fail here)
          for (size_t i = 0; i < xlen; i++) {
            uint8_t t;
            if (!next_byte(&t)) return -1;
          }
        }
        if (flg & 0x08) {  // FNAME: NUL-terminated
          uint8_t t = 0xFF;
          do {
            if (!next_byte(&t)) return -1;
          } while (t != 0);
        }
        if (flg & 0x10) {  // FCOMMENT
          uint8_t t = 0xFF;
          do {
            if (!next_byte(&t)) return -1;
          } while (t != 0);
        }
        if (flg & 0x02) {  // FHCRC
          uint8_t t;
          if (!next_byte(&t) || !next_byte(&t)) return -1;
        }
        crc_run = 0;
        isize_run = 0;
        gstate = kDeflate;
        dstate = kBlockHdr;
        bfinal = false;
        continue;
      }
      if (gstate == kTrailer) {
        br.consume(br.cnt & 7);
        if (!br.ok()) return -1;
        if (in_left() < 8) {
          if (final_in) return -1;  // truncated trailer
          save();
          return 1;
        }
        uint8_t t[8];
        for (int i = 0; i < 8; i++)
          t[i] = br.cnt >= 8 ? (uint8_t)br.bits(8) : *br.p++;
        // flush this call's produced bytes into crc/hist BEFORE checking
        if (o != out_done) {
          note_output(out_done, (size_t)(o - out_done));
          out_done = o;
        }
        uint32_t want_crc, want_isize;
        memcpy(&want_crc, t, 4);
        memcpy(&want_isize, t + 4, 4);
        if (want_crc != crc_run || want_isize != (uint32_t)isize_run)
          return -1;
        // concatenated members: more input -> parse another header
        if (in_left() == 0 && final_in) {
          gstate = kDone;
        } else if (in_left() == 0) {
          // might be EOF or another member; ask for more input
          gstate = kHdr;
          save();
          return 1;
        } else {
          gstate = kHdr;
        }
        continue;
      }
      // gstate == kDeflate
      if (dstate == kBlockHdr) {
        // dynamic block headers decode without suspension: hold off until
        // enough input is buffered (~300 bytes worst case)
        if (!final_in && in_left() < 1024) {
          save();
          return 1;
        }
        br.refill();
        if (!br.ok()) return -1;
        bfinal = br.bits(1) != 0;
        uint32_t btype = (uint32_t)br.bits(2);
        if (btype == 0) {
          br.consume(br.cnt & 7);
          uint32_t hdr[4];
          for (int i = 0; i < 4; i++) {
            if (br.cnt >= 8) {
              hdr[i] = (uint32_t)br.bits(8);
            } else if (br.p < br.end) {
              hdr[i] = *br.p++;
            } else {
              return -1;
            }
          }
          uint32_t len = hdr[0] | (hdr[1] << 8);
          uint32_t nlen = hdr[2] | (hdr[3] << 8);
          if ((len ^ 0xFFFF) != nlen) return -1;
          stored_left = len;
          dstate = kStored;
          continue;
        }
        if (btype == 3) return -1;
        uint8_t lit_lens[288], dist_lens[32];
        int nlit, ndist;
        if (btype == 1) {
          for (int i = 0; i < 144; i++) lit_lens[i] = 8;
          for (int i = 144; i < 256; i++) lit_lens[i] = 9;
          for (int i = 256; i < 280; i++) lit_lens[i] = 7;
          for (int i = 280; i < 288; i++) lit_lens[i] = 8;
          for (int i = 0; i < 32; i++) dist_lens[i] = 5;
          nlit = 288;
          ndist = 32;
        } else {
          br.refill();
          nlit = (int)br.bits(5) + 257;
          ndist = (int)br.bits(5) + 1;
          int ncl = (int)br.bits(4) + 4;
          if (nlit > 286 || ndist > 30) return -1;
          uint8_t cl_lens[19] = {0};
          for (int i = 0; i < ncl; i++) {
            br.refill();
            cl_lens[kClOrder[i]] = (uint8_t)br.bits(3);
          }
          if (!br.ok()) return -1;
          uint32_t cl_table[(1 << 7) + 128];
          if (build_table(cl_table, 7, cl_lens, 19,
                          [](int s, int l) {
                            return mk(kVal, (uint32_t)l, 0, (uint32_t)s);
                          },
                          false) < 0)
            return -1;
          int n = 0;
          uint8_t all[288 + 32];
          while (n < nlit + ndist) {
            br.refill();
            if (!br.ok()) return -1;
            uint32_t e = cl_table[br.peek(7)];
            if ((e & 0xC0) == kEnd) return -1;
            br.consume((int)(e & 63));
            int sym = (int)(e >> 16);
            if (sym < 16) {
              all[n++] = (uint8_t)sym;
            } else if (sym == 16) {
              if (n == 0) return -1;
              int rep = 3 + (int)br.bits(2);
              if (n + rep > nlit + ndist) return -1;
              uint8_t prev = all[n - 1];
              while (rep--) all[n++] = prev;
            } else if (sym == 17) {
              int rep = 3 + (int)br.bits(3);
              if (n + rep > nlit + ndist) return -1;
              while (rep--) all[n++] = 0;
            } else {
              int rep = 11 + (int)br.bits(7);
              if (n + rep > nlit + ndist) return -1;
              while (rep--) all[n++] = 0;
            }
          }
          if (!br.ok()) return -1;
          memcpy(lit_lens, all, nlit);
          memcpy(dist_lens, all + nlit, ndist);
          if (lit_lens[256] == 0) return -1;
        }
        if (build_table(tb.lit, kLitRoot, lit_lens, nlit, lit_entry, false) <
            0)
          return -1;
        int nd = btype == 1 ? 32 : ndist;
        if (build_table(tb.dist, kDistRoot, dist_lens, nd, dist_entry,
                        true) < 0) {
          bool any = false;
          for (int i = 0; i < nd; i++) any |= dist_lens[i] != 0;
          if (any) return -1;
          for (int i = 0; i < (1 << kDistRoot); i++)
            tb.dist[i] = mk(kEnd, 0, 0, 1);
        }
        dstate = kSymbols;
        continue;
      }
      if (dstate == kStored) {
        br.consume(br.cnt & 7);  // should already be aligned
        while (stored_left && br.cnt >= 8 && o < oend) {
          *o++ = (uint8_t)br.bits(8);
          stored_left--;
        }
        size_t take = std::min(
            {stored_left, (size_t)(br.end - br.p), (size_t)(oend - o)});
        memcpy(o, br.p, take);
        o += take;
        br.p += take;
        br.buf &= br.cnt ? ((1ull << br.cnt) - 1) : 0;  // p jumped
        stored_left -= take;
        if (stored_left) {
          if (o >= oend || !final_in) {
            save();
            return 1;  // need output space or input
          }
          return -1;  // truncated stored block at EOF
        }
        dstate = kBlockHdr;
        if (bfinal) gstate = kTrailer;
        continue;
      }
      // dstate == kSymbols
      for (;;) {
        // suspend when input is low (not final) or output margin is gone
        if (!final_in && in_left() < kInMargin) {
          save();
          return 1;
        }
        if ((size_t)(oend - o) < 300) {
          save();
          return 1;  // output space (caller drains)
        }
        br.refill();
        if (!br.ok()) return -1;
        uint32_t e = decode_entry(br, tb.lit, kLitRoot);
        uint32_t kind = e & 0xC0;
        if (kind == kLit) {
          if (!(e & 0x8000u)) br.consume((int)(e & 63));
          *o++ = (uint8_t)(e >> 16);
          while (br.cnt >= 15) {
            e = tb.lit[br.peek(kLitRoot)];
            if ((e & 0xC0) != kLit) break;
            br.consume((int)(e & 63));
            *o++ = (uint8_t)(e >> 16);
          }
          continue;
        }
        if (kind == kEnd) {
          if ((e >> 16) != 0) return -1;
          if (!(e & 0x8000u)) br.consume((int)(e & 63));
          dstate = kBlockHdr;
          if (bfinal) gstate = kTrailer;
          break;
        }
        if (!(e & 0x8000u)) br.consume((int)(e & 63));
        uint32_t len = (e >> 16) + (uint32_t)br.bits((int)((e >> 8) & 15));
        br.refill();
        uint32_t de = decode_entry(br, tb.dist, kDistRoot);
        if ((de & 0xC0) != kVal) return -1;
        if (!(de & 0x8000u)) br.consume((int)(de & 63));
        uint32_t dist = (de >> 16) + (uint32_t)br.bits((int)((de >> 8) & 15));
        if (!br.ok()) return -1;
        size_t pos = (size_t)(o - obase);
        if ((size_t)dist > pos + hist_len) return -1;
        // note: out_cap has >= kInflateMargin slack for wide copies
        if ((size_t)dist > pos) {
          // source starts in the history window (crosses a read boundary)
          size_t from_hist = (size_t)dist - pos;
          const uint8_t* hs = hist + hist_len - from_hist;
          size_t n1 = std::min((size_t)len, from_hist);
          for (size_t i = 0; i < n1; i++) *o++ = hs[i];
          len -= (uint32_t)n1;
          if (!len) continue;
          dist = (uint32_t)(o - obase);  // continue from output start
          if (dist == 0) return -1;      // cannot happen; stay safe
        }
        const uint8_t* src = o - dist;
        if (dist >= 8) {
          uint8_t* d = o;
          o += len;
          do {
            memcpy(d, src, 8);
            d += 8;
            src += 8;
          } while (d < o);
        } else if (dist == 1) {
          memset(o, *src, len);
          o += len;
        } else {
          uint8_t* d = o;
          o += len;
          while (d < o) *d++ = *src++;
        }
      }
    }
  }
};

}  // namespace fastinf

// ---------------------------------------------------------------------------
// Fast one-shot raw-deflate COMPRESSOR (dx_deflate).
//
// The write side of the same idea as fastinf: each output member is a
// whole in-memory buffer (the pipeline's per-batch gzip members; writers
// compress in parallel workers), so a purpose-built greedy compressor can
// replace zlib's fast levels: hash-4 greedy LZ with adaptive literal
// skipping, ONE dynamic-Huffman block per member (built from the member's
// actual symbol frequencies with a Kraft-repair length limiter), and a
// stored-block fallback when the data is incompressible. Targets zlib
// levels 1-3; ratio is comparable
// (dynamic codes + 32 KiB window) at a multiple of the speed.
// ---------------------------------------------------------------------------

namespace fastdef {

using fastinf::kDistBase;
using fastinf::kDistExtra;
using fastinf::kLenBase;
using fastinf::kLenExtra;

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void put(uint32_t bits, int n) {  // n <= 31
    buf |= (uint64_t)bits << cnt;
    cnt += n;
    if (cnt >= 32) {
      size_t off = out.size();
      out.resize(off + 4);
      uint32_t w = (uint32_t)buf;
      memcpy(out.data() + off, &w, 4);
      buf >>= 32;
      cnt -= 32;
    }
  }
  void align_byte() {
    if (cnt & 7) put(0, 8 - (cnt & 7));
  }
  void finish() {  // flush remaining whole/partial bytes
    while (cnt > 0) {
      out.push_back((uint8_t)buf);
      buf >>= 8;
      cnt -= 8;
    }
    buf = 0;
    cnt = 0;
  }
};

// Canonical Huffman code lengths for `n` symbols with the given max bit
// length, from frequencies. Writes lens[] (0 = unused). Simple pairing
// heap build + Kraft-repair clamp, then promotion back to an exactly
// complete code (inflaters reject incomplete litlen/code-length codes).
// force_complete: a single-symbol code gets a dummy second length-1 code
// (the lone legal incomplete code is the single-distance-code case).
static void huff_lengths(const uint32_t* freq, int n, int max_len,
                         uint8_t* lens, bool force_complete) {
  struct Node {
    uint64_t f;
    int l, r;  // children (<n: leaf sym)
  };
  std::vector<Node> nodes;
  std::vector<int> heap;  // indices into nodes, min-heap by freq
  nodes.reserve(2 * n);
  for (int s = 0; s < n; s++) {
    lens[s] = 0;
    if (freq[s]) {
      nodes.push_back({freq[s], s, -1});
      heap.push_back((int)nodes.size() - 1);
    }
  }
  size_t nsym = heap.size();
  if (nsym == 0) return;
  if (nsym == 1) {
    int only = nodes[heap[0]].l;
    lens[only] = 1;
    if (force_complete) lens[only == 0 ? 1 : 0] = 1;  // dummy completes it
    return;
  }
  auto cmp = [&](int a, int b) { return nodes[a].f > nodes[b].f; };
  std::make_heap(heap.begin(), heap.end(), cmp);
  while (heap.size() > 1) {
    std::pop_heap(heap.begin(), heap.end(), cmp);
    int a = heap.back();
    heap.pop_back();
    std::pop_heap(heap.begin(), heap.end(), cmp);
    int b = heap.back();
    heap.pop_back();
    nodes.push_back({nodes[a].f + nodes[b].f, a | (1 << 30), b | (1 << 30)});
    heap.push_back((int)nodes.size() - 1);
    std::push_heap(heap.begin(), heap.end(), cmp);
  }
  // depth-first depths (iterative; tree height <= nsym)
  std::vector<std::pair<int, int>> stack;  // (node index, depth)
  stack.push_back({heap[0], 0});
  while (!stack.empty()) {
    auto [ni, d] = stack.back();
    stack.pop_back();
    const Node& nd = nodes[ni];
    if (nd.r < 0) {
      lens[nd.l] = (uint8_t)std::min(d ? d : 1, 255);
      continue;
    }
    stack.push_back({nd.l & ~(1 << 30), d + 1});
    stack.push_back({nd.r & ~(1 << 30), d + 1});
  }
  // Kraft repair: clamp to max_len, then demote until the code is valid
  uint64_t K = 0;  // sum of 2^(max_len - len)
  for (int s = 0; s < n; s++) {
    if (!lens[s]) continue;
    if (lens[s] > max_len) lens[s] = (uint8_t)max_len;
    K += 1ull << (max_len - lens[s]);
  }
  const uint64_t target = 1ull << max_len;
  while (K > target) {
    // lengthen the longest still-lengthenable code
    int pick = -1;
    for (int s = 0; s < n; s++)
      if (lens[s] && lens[s] < max_len &&
          (pick < 0 || lens[s] > lens[pick]))
        pick = s;
    // pick always exists: K > target implies some len < max_len
    K -= 1ull << (max_len - lens[pick] - 1);
    lens[pick]++;
  }
  while (K < target) {
    // shorten the longest code whose doubled slot still fits; its
    // increment divides the deficit, so this converges to K == target
    int pick = -1;
    for (int s = 0; s < n; s++)
      if (lens[s] > 1 && (1ull << (max_len - lens[s])) <= target - K &&
          (pick < 0 || lens[s] > lens[pick]))
        pick = s;
    if (pick < 0) break;  // cannot happen for nsym >= 2; stay safe
    K += 1ull << (max_len - lens[pick]);
    lens[pick]--;
  }
}

// Canonical code assignment (RFC 1951 ordering) + LSB-first bit reversal.
static void huff_codes(const uint8_t* lens, int n, uint16_t* codes) {
  int count[16] = {0};
  for (int s = 0; s < n; s++) count[lens[s]]++;
  count[0] = 0;
  uint32_t next[16] = {0}, code = 0;
  for (int l = 1; l <= 15; l++) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  for (int s = 0; s < n; s++) {
    if (!lens[s]) {
      codes[s] = 0;
      continue;
    }
    codes[s] = (uint16_t)fastinf::rev_bits(next[lens[s]]++, lens[s]);
  }
}

static inline int dist_sym(uint32_t d) {  // d in [1, 32768]
  if (d <= 4) return (int)d - 1;
  int lg = 31 - __builtin_clz(d - 1);
  return 2 * lg + (int)(((d - 1) >> (lg - 1)) & 1);
}

struct LenSymTable {
  uint8_t sym[256];  // len-3 -> litlen sym - 257
  LenSymTable() {
    for (int s = 0; s < 29; s++) {
      int base = kLenBase[s];
      int span = 1 << kLenExtra[s];
      for (int l = base; l < base + span && l <= 258; l++)
        sym[l - 3] = (uint8_t)s;
    }
    sym[258 - 3] = 28;  // len 258 is its own code (not 284's range)
  }
};
static const LenSymTable kLenSym;

// token stream: literal = byte value; match = (1<<31) | (len << 16) | dist
static constexpr uint32_t kMatchBit = 1u << 31;

static inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

// Emits stored blocks (final) — the incompressible fallback.
static void emit_stored(const uint8_t* in, size_t n,
                        std::vector<uint8_t>& out) {
  size_t pos = 0;
  do {
    size_t take = std::min(n - pos, (size_t)65535);
    bool final = pos + take == n;
    out.push_back(final ? 1 : 0);  // BFINAL, BTYPE=00 (byte-aligned here)
    uint16_t len = (uint16_t)take, nlen = (uint16_t)~take;
    out.push_back((uint8_t)len);
    out.push_back((uint8_t)(len >> 8));
    out.push_back((uint8_t)nlen);
    out.push_back((uint8_t)(nlen >> 8));
    out.insert(out.end(), in + pos, in + pos + take);
    pos += take;
  } while (pos < n);
}

static const uint8_t kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                     11, 4, 12,  3, 13, 2, 14, 1, 15};

// One-shot raw-deflate compress of the whole buffer: ONE dynamic-Huffman
// block (or stored blocks when that is smaller). Appends to `out`.
static void deflate_buffer(const uint8_t* in, size_t n,
                           std::vector<uint8_t>& out) {
  if (n == 0) {
    // final stored block of length 0
    static const uint8_t kEmpty[5] = {1, 0, 0, 0xFF, 0xFF};
    out.insert(out.end(), kEmpty, kEmpty + 5);
    return;
  }
  // --- pass 1: greedy LZ + frequency tally ---
  constexpr int kHashBits = 15;
  constexpr uint32_t kWindow = 32768;
  std::vector<int64_t> table(1u << kHashBits, -(int64_t)kWindow - 1);
  std::vector<uint32_t> tokens;
  tokens.reserve(n / 2 + 16);
  uint32_t freq_ll[288] = {0}, freq_d[30] = {0};
  auto hash4 = [](uint32_t x) {
    return (x * 2654435761u) >> (32 - kHashBits);
  };
  size_t pos = 0;
  uint32_t miss_run = 0;
  const size_t limit = n >= 12 ? n - 12 : 0;  // room for load32 + extension
  while (pos < limit) {
    uint32_t v = load32(in + pos);
    uint32_t h = hash4(v);
    int64_t cand = table[h];
    table[h] = (int64_t)pos;
    if (cand >= 0 && pos - (size_t)cand <= kWindow &&
        load32(in + (size_t)cand) == v) {
      // extend (8 bytes at a time; in has >= 12 bytes of tail slack here)
      size_t len = 4;
      size_t max_len = std::min((size_t)258, n - pos);
      while (len + 8 <= max_len) {
        uint64_t a, b;
        memcpy(&a, in + pos + len, 8);
        memcpy(&b, in + (size_t)cand + len, 8);
        uint64_t x = a ^ b;
        if (x) {
          len += (size_t)(__builtin_ctzll(x) >> 3);
          goto have_len;
        }
        len += 8;
      }
      while (len < max_len && in[pos + len] == in[(size_t)cand + len]) len++;
    have_len:;
      uint32_t dist = (uint32_t)(pos - (size_t)cand);
      tokens.push_back(kMatchBit | ((uint32_t)len << 16) | dist);
      freq_ll[257 + kLenSym.sym[len - 3]]++;
      freq_d[dist_sym(dist)]++;
      // sparse insertion inside the match keeps long-match throughput high
      if (len <= 16) {
        size_t iend = n - pos >= 4 ? std::min(len, n - pos - 3) : 0;
        for (size_t i = 1; i < iend; i++)
          table[hash4(load32(in + pos + i))] = (int64_t)(pos + i);
      } else if (pos + len + 4 <= n) {
        table[hash4(load32(in + pos + len - 2))] = (int64_t)(pos + len - 2);
        table[hash4(load32(in + pos + len - 1))] = (int64_t)(pos + len - 1);
      }
      pos += len;
      miss_run = 0;
    } else {
      tokens.push_back(in[pos]);
      freq_ll[in[pos]]++;
      // adaptive skip: after a run of misses (incompressible region) emit
      // several literals per hash probe
      uint32_t skip = 1 + (miss_run++ >> 7);
      if (skip > 1) {
        size_t end = std::min(pos + skip, limit);
        for (size_t i = pos + 1; i < end; i++) {
          tokens.push_back(in[i]);
          freq_ll[in[i]]++;
        }
        pos = end;
      } else {
        pos++;
      }
    }
  }
  for (; pos < n; pos++) {
    tokens.push_back(in[pos]);
    freq_ll[in[pos]]++;
  }
  freq_ll[256] = 1;  // EOB

  // --- Huffman codes from the member's actual frequencies ---
  uint8_t len_ll[288], len_d[30];
  uint16_t code_ll[288], code_d[30];
  huff_lengths(freq_ll, 288, 15, len_ll, /*force_complete=*/true);
  huff_lengths(freq_d, 30, 15, len_d, /*force_complete=*/false);
  // HDIST >= 1: deflate requires at least one distance code length
  int hlit = 286;
  while (hlit > 257 && len_ll[hlit - 1] == 0) hlit--;
  int hdist = 30;
  while (hdist > 1 && len_d[hdist - 1] == 0) hdist--;
  huff_codes(len_ll, 288, code_ll);
  huff_codes(len_d, 30, code_d);

  // --- code-length-code compression of the header ---
  uint8_t all[288 + 30];
  memcpy(all, len_ll, hlit);
  memcpy(all + hlit, len_d, hdist);
  int nall = hlit + hdist;
  // RLE to CL symbols: (sym, extra_val) pairs
  std::vector<std::pair<uint8_t, uint8_t>> cl;
  cl.reserve(nall);
  uint32_t freq_cl[19] = {0};
  for (int i = 0; i < nall;) {
    uint8_t v = all[i];
    int run = 1;
    while (i + run < nall && all[i + run] == v) run++;
    if (v == 0) {
      while (run >= 3) {
        int take = std::min(run, 138);
        if (take >= 11) {
          cl.push_back({18, (uint8_t)(take - 11)});
          freq_cl[18]++;
        } else {
          cl.push_back({17, (uint8_t)(take - 3)});
          freq_cl[17]++;
        }
        run -= take;
        i += take;
      }
      while (run--) {
        cl.push_back({0, 0});
        freq_cl[0]++;
        i++;
      }
    } else {
      cl.push_back({v, 0});
      freq_cl[v]++;
      i++;
      run--;
      while (run >= 3) {
        int take = std::min(run, 6);
        cl.push_back({16, (uint8_t)(take - 3)});
        freq_cl[16]++;
        run -= take;
        i += take;
      }
      while (run--) {
        cl.push_back({v, 0});
        freq_cl[v]++;
        i++;
      }
    }
  }
  uint8_t len_cl[19];
  uint16_t code_cl[19];
  huff_lengths(freq_cl, 19, 7, len_cl, /*force_complete=*/true);
  huff_codes(len_cl, 19, code_cl);
  int hclen = 19;
  while (hclen > 4 && len_cl[kClOrder[hclen - 1]] == 0) hclen--;

  // --- emit the dynamic block ---
  size_t start = out.size();
  BitWriter bw(out);
  bw.put(1, 1);  // BFINAL
  bw.put(2, 2);  // BTYPE = dynamic
  bw.put((uint32_t)(hlit - 257), 5);
  bw.put((uint32_t)(hdist - 1), 5);
  bw.put((uint32_t)(hclen - 4), 4);
  for (int i = 0; i < hclen; i++) bw.put(len_cl[kClOrder[i]], 3);
  for (auto [sym, extra] : cl) {
    bw.put(code_cl[sym], len_cl[sym]);
    if (sym == 16) bw.put(extra, 2);
    else if (sym == 17) bw.put(extra, 3);
    else if (sym == 18) bw.put(extra, 7);
  }
  for (uint32_t t : tokens) {
    if (!(t & kMatchBit)) {
      bw.put(code_ll[t], len_ll[t]);
      continue;
    }
    uint32_t len = (t >> 16) & 0x7FFF, dist = t & 0xFFFF;
    int ls = kLenSym.sym[len - 3];
    bw.put(code_ll[257 + ls], len_ll[257 + ls]);
    if (kLenExtra[ls]) bw.put(len - kLenBase[ls], kLenExtra[ls]);
    int ds = dist_sym(dist);
    bw.put(code_d[ds], len_d[ds]);
    if (kDistExtra[ds]) bw.put(dist - kDistBase[ds], kDistExtra[ds]);
  }
  bw.put(code_ll[256], len_ll[256]);  // EOB
  bw.finish();

  // incompressible fallback: stored blocks are smaller
  if (out.size() - start > n + 5 * (n / 65535 + 1)) {
    out.resize(start);
    emit_stored(in, n, out);
  }
}

// Whole gzip member (header + raw deflate + CRC32 + ISIZE) appended to out.
static void gzip_member(const uint8_t* in, size_t n,
                        std::vector<uint8_t>& out) {
  static const uint8_t kHdr[10] = {0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 0, 0xFF};
  out.insert(out.end(), kHdr, kHdr + 10);
  deflate_buffer(in, n, out);
  uint32_t crc = (uint32_t)crc32(crc32(0, nullptr, 0), in, (uInt)n);
  uint32_t isize = (uint32_t)n;
  uint8_t tail[8];
  memcpy(tail, &crc, 4);
  memcpy(tail + 4, &isize, 4);
  out.insert(out.end(), tail, tail + 8);
}

// BGZF framing: the same data as bgzip-compatible <= 64 KiB blocks whose
// compressed size rides a "BC" extra subfield. Still a valid .gz stream,
// but ALSO block-parallel decodable (by this framework's own reader and
// by htslib tooling). The canonical 28-byte EOF marker is appended by the
// writer at stream close, not per member.
static const uint8_t kBgzfEof[28] = {
    0x1F, 0x8B, 0x08, 0x04, 0, 0, 0, 0, 0, 0xFF, 0x06, 0x00, 0x42, 0x43,
    0x02, 0x00, 0x1B, 0x00, 0x03, 0x00, 0, 0, 0, 0, 0, 0, 0, 0};

static bool bgzf_member(const uint8_t* in, size_t n,
                        std::vector<uint8_t>& out) {
  constexpr size_t kBlock = 65280;  // bgzip's content size per block
  size_t pos = 0;
  std::vector<uint8_t> body;
  do {
    size_t take = std::min(n - pos, kBlock);
    body.clear();
    deflate_buffer(in + pos, take, body);
    size_t total = 12 + 6 + body.size() + 8;
    if (total > 65536) return false;  // cannot satisfy BSIZE: caller falls
                                      // back to a plain member
    uint8_t hdr[18] = {0x1F, 0x8B, 8,   4,   0, 0, 0, 0, 0,
                       0xFF, 6,    0,   'B', 'C', 2, 0, 0, 0};
    hdr[16] = (uint8_t)((total - 1) & 0xFF);
    hdr[17] = (uint8_t)((total - 1) >> 8);
    out.insert(out.end(), hdr, hdr + 18);
    out.insert(out.end(), body.begin(), body.end());
    uint32_t crc =
        (uint32_t)crc32(crc32(0, nullptr, 0), in + pos, (uInt)take);
    uint32_t isize = (uint32_t)take;
    uint8_t tail[8];
    memcpy(tail, &crc, 4);
    memcpy(tail + 4, &isize, 4);
    out.insert(out.end(), tail, tail + 8);
    pos += take;
  } while (pos < n);
  return true;
}

}  // namespace fastdef

// ---------------------------------------------------------------------------
// Parallel BGZF (blocked gzip) decoding.
//
// bgzip/htslib-style .gz files are sequences of independent gzip members of
// <= 64 KiB whose compressed size is recorded in a "BC" extra subfield, so
// member boundaries are known WITHOUT decoding — unlike plain gzip, whose
// single deflate stream forces serial inflate (the reference is serial here
// too: zlib-rs via niffler, ref: src/local_filter.rs:49). We decode batches
// of blocks across a thread pool and prefetch the next batch on a background
// thread while the parser drains the current one, so BGZF inputs decompress
// at N-core speed and even 1-thread decode overlaps with parsing. Non-BGZF
// gzip members (including a plain .gz that never had BC, or a BGZF file
// concatenated with a plain member) fall back to the serial z_stream
// mid-stream with no bytes lost.
// ---------------------------------------------------------------------------

// Parses one BGZF member header at p[0..n). Returns the total member size
// (header+payload+trailer) via *total. 1 = BGZF, 0 = not a BGZF header,
// -1 = need more bytes to decide, also sets *hlen to the header length.
static int bgzf_parse_header(const uint8_t* p, size_t n, size_t* total,
                             size_t* hlen) {
  if (n < 12) return -1;
  // require exactly FLG=FEXTRA: members with FNAME/FCOMMENT/FHCRC would
  // shift the payload offset — let the serial inflater handle those
  if (p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 || p[3] != 0x04) return 0;
  size_t xlen = (size_t)p[10] | ((size_t)p[11] << 8);
  if (n < 12 + xlen) return -1;
  size_t off = 12, end = 12 + xlen;
  while (off + 4 <= end) {
    uint8_t si1 = p[off], si2 = p[off + 1];
    size_t slen = (size_t)p[off + 2] | ((size_t)p[off + 3] << 8);
    if (off + 4 + slen > end) return 0;  // malformed extra field
    if (si1 == 'B' && si2 == 'C' && slen == 2) {
      size_t bsize =
          ((size_t)p[off + 4] | ((size_t)p[off + 5] << 8)) + 1;
      if (bsize < end + 8) return 0;  // impossible: no room for trailer
      *total = bsize;
      *hlen = end;
      return 1;
    }
    off += 4 + slen;
  }
  return 0;  // FEXTRA without BC: not BGZF
}

struct BgzfBatch {
  std::vector<uint8_t> comp;     // whole members, concatenated
  std::vector<size_t> boff;      // member offset in comp
  std::vector<size_t> bhlen;     // member header length
  std::vector<size_t> bsize;     // member total size
  std::vector<size_t> ooff;      // output offset (prefix sums of ISIZE)
  std::vector<uint8_t> out;      // decompressed bytes
  bool eof = false;       // raw stream fully consumed
  bool fallback = false;  // hit a non-BGZF member: leftover carries it
  std::string err;
};

struct BgzfState {
  FILE* raw = nullptr;
  int nthreads = 1;
  // carry: compressed bytes read ahead of the current member boundary.
  std::vector<uint8_t> carry;
  size_t carry_pos = 0;
  bool raw_eof = false;
  BgzfBatch cur;
  size_t out_pos = 0;
  BgzfBatch next;
  std::thread th;
  bool th_running = false;
  bool done = false;  // no more batches will be produced

  ~BgzfState() {
    if (th_running) th.join();
  }

  size_t carry_avail() const { return carry.size() - carry_pos; }

  // Ensures >= need bytes are available at carry[carry_pos..]. Returns the
  // available count (may be < need only at raw EOF).
  size_t carry_ensure(size_t need) {
    if (carry_avail() >= need) return carry_avail();
    if (carry_pos > 0) {
      carry.erase(carry.begin(), carry.begin() + carry_pos);
      carry_pos = 0;
    }
    while (carry.size() < need && !raw_eof) {
      size_t old = carry.size();
      size_t want = std::max(need - old, kBufSize);
      carry.resize(old + want);
      size_t got = fread(carry.data() + old, 1, want, raw);
      carry.resize(old + got);
      if (got < want) raw_eof = true;
    }
    return carry.size() - carry_pos;
  }

  // Fills b with whole members until ~8 MiB of compressed input, raw EOF,
  // or a non-BGZF member (fallback; the member's bytes stay in carry), then
  // inflates all members in parallel.
  void produce(BgzfBatch& b) {
    b.comp.clear();
    b.boff.clear();
    b.bhlen.clear();
    b.bsize.clear();
    b.ooff.clear();
    b.out.clear();
    b.eof = false;
    b.fallback = false;
    b.err.clear();
    constexpr size_t kBatchComp = 8u << 20;
    size_t out_total = 0;
    while (b.comp.size() < kBatchComp) {
      size_t avail = carry_ensure(12 + 256);  // header + typical xlen
      if (avail == 0) {
        b.eof = true;
        break;
      }
      size_t total = 0, hlen = 0;
      int rc = bgzf_parse_header(carry.data() + carry_pos, avail, &total,
                                 &hlen);
      if (rc < 0 && avail >= 12 && !raw_eof) {
        // header longer than ensured (xlen up to 65535): re-ensure exactly
        size_t xlen = (size_t)carry[carry_pos + 10] |
                      ((size_t)carry[carry_pos + 11] << 8);
        avail = carry_ensure(12 + xlen);
        rc = bgzf_parse_header(carry.data() + carry_pos, avail, &total,
                               &hlen);
      }
      if (rc < 0) {
        b.err = "truncated gzip member header";
        return;
      }
      if (rc == 0) {
        b.fallback = true;  // serial path takes over from carry
        break;
      }
      if (carry_ensure(total) < total) {
        b.err = "truncated BGZF block";
        return;
      }
      const uint8_t* blk = carry.data() + carry_pos;
      size_t isize = (size_t)blk[total - 4] | ((size_t)blk[total - 3] << 8) |
                     ((size_t)blk[total - 2] << 16) |
                     ((size_t)blk[total - 1] << 24);
      if (isize > (1u << 16)) {
        b.err = "BGZF block ISIZE exceeds 64 KiB";
        return;
      }
      b.boff.push_back(b.comp.size());
      b.bhlen.push_back(hlen);
      b.bsize.push_back(total);
      b.ooff.push_back(out_total);
      out_total += isize;
      b.comp.insert(b.comp.end(), blk, blk + total);
      carry_pos += total;
      if (raw_eof && carry_avail() == 0) {
        b.eof = true;
        break;
      }
    }
    b.ooff.push_back(out_total);
    b.out.resize(out_total);
    size_t nblocks = b.boff.size();
    if (nblocks == 0) return;
    int nt = (int)std::min((size_t)nthreads, nblocks);
    std::atomic<size_t> next_blk{0};
    std::atomic<bool> ok{true};
    auto work = [&]() {
      // per-thread scratch with wide-copy margin, then an exact memcpy into
      // the shared output (blocks decode concurrently, so the margin must
      // not bleed into a neighbour's region)
      auto tbs = std::make_unique<fastinf::Tables>();
      std::vector<uint8_t> scratch((1u << 16) + kInflateMargin);
      for (;;) {
        size_t i = next_blk.fetch_add(1);
        if (i >= nblocks || !ok.load(std::memory_order_relaxed)) break;
        const uint8_t* blk = b.comp.data() + b.boff[i];
        size_t payload = b.bsize[i] - b.bhlen[i] - 8;
        size_t olen = b.ooff[i + 1] - b.ooff[i];
        if (olen == 0) continue;  // empty block (e.g. the BGZF EOF marker)
        uint8_t* dst = b.out.data() + b.ooff[i];
        if (fastinf::inflate_block(blk + b.bhlen[i], payload, scratch.data(),
                                   olen, *tbs) != 0) {
          ok.store(false);
          break;
        }
        memcpy(dst, scratch.data(), olen);
        uint32_t want_crc = (uint32_t)blk[b.bsize[i] - 8] |
                            ((uint32_t)blk[b.bsize[i] - 7] << 8) |
                            ((uint32_t)blk[b.bsize[i] - 6] << 16) |
                            ((uint32_t)blk[b.bsize[i] - 5] << 24);
        if ((uint32_t)crc32(crc32(0, nullptr, 0), dst, (uInt)olen) !=
            want_crc) {
          ok.store(false);
          break;
        }
      }
    };
    if (nt <= 1) {
      work();
    } else {
      std::vector<std::thread> ts;
      for (int t = 0; t < nt - 1; t++) ts.emplace_back(work);
      work();
      for (auto& t : ts) t.join();
    }
    if (!ok.load()) b.err = "corrupt BGZF block (inflate/CRC mismatch)";
  }

  void kick() {
    th = std::thread([this] { produce(next); });
    th_running = true;
  }

  // Swaps in the prefetched batch; returns false when no batch remains or
  // on error (err set on cur).
  bool fetch() {
    if (done) return false;
    if (th_running) {
      th.join();
      th_running = false;
    } else {
      produce(next);  // first batch: synchronous
    }
    cur = std::move(next);
    next = BgzfBatch();
    out_pos = 0;
    if (!cur.err.empty() || cur.eof || cur.fallback)
      done = true;
    else
      kick();
    return cur.err.empty();
  }
};

// Streaming decompressing source over a FILE*. All codecs use the same
// raw-input buffer machinery so sniffed magic bytes can be replayed.
struct Source {
  FILE* raw = nullptr;
  Codec codec = Codec::kPlain;
  int64_t* stats = nullptr;  // ReaderStat slots, or none
  bool raw_eof = false;
  std::vector<uint8_t> in_buf;
  size_t in_pos = 0, in_len = 0;

  const ZstdApi* zst = nullptr;
  ZSTD_DStream* zds = nullptr;
  lzma_stream lz = LZMA_STREAM_INIT;
  bool lz_init = false;
  // gzip sub-mode: 0 = unprobed, 1 = parallel BGZF, 2 = serial stream
  int gz_mode = 0;
  std::unique_ptr<BgzfState> bgzf;
  size_t zstd_rc = 0;    // last ZSTD_decompressStream hint (0 = frame done)
  BzStream bz{};
  bool bz_init = false;
  bool bz_mid = false;   // inside a bzip2 member (truncation check)
  // streaming fast-gz state (serial plain gzip via fastinf::StreamGz)
  std::unique_ptr<fastinf::StreamGz> sgz;
  std::vector<uint8_t> gz_carry;   // contiguous unconsumed compressed bytes
  size_t gz_cpos = 0;
  std::vector<uint8_t> gz_out;     // staged decoded bytes (+ copy margin)
  size_t gz_out_pos = 0, gz_out_len = 0;
  bool sgz_done = false;

  ~Source() {
    ahead.reset();  // joins the decode thread BEFORE codecs/raw are torn down
    bgzf.reset();   // joins the prefetch thread BEFORE raw is closed
    if (zds) zst->freeDStream(zds);
    if (lz_init) lzma_end(&lz);
    if (bz_init) Bz2Api::get().end(&bz);
    if (raw && raw != stdin) fclose(raw);
  }

  void init(FILE* f, Codec c, const uint8_t* magic, size_t magic_len,
            const ZstdApi* zstd_api) {
    raw = f;
    zst = zstd_api;
    codec = c;
    in_buf.resize(kBufSize);
    if (magic_len) memcpy(in_buf.data(), magic, magic_len);
    in_len = magic_len;
    in_pos = 0;
    switch (codec) {
      case Codec::kPlain:
      case Codec::kGzip:  // probed at the first read (probe_gz)
        break;
      case Codec::kZstd:
        zds = zst->createDStream();
        zst->initDStream(zds);
        break;
      case Codec::kXz:
        lzma_stream_decoder(&lz, UINT64_MAX, LZMA_CONCATENATED);
        lz_init = true;
        break;
      case Codec::kBz2:
        bz_init = Bz2Api::get().init(&bz, 0, 0) == kBzOk;
        break;
    }
  }

  bool fill_raw() {
    if (raw_eof) return false;
    size_t want = in_buf.size();
    in_len = fread(in_buf.data(), 1, want, raw);
    in_pos = 0;
    if (in_len < want && (feof(raw) || ferror(raw))) raw_eof = true;
    return in_len > 0;
  }

  static int bgzf_threads() {
    int hw = (int)std::thread::hardware_concurrency();
    if (hw < 1) hw = 1;
    return hw > 8 ? 8 : hw;
  }

  // Decides between parallel BGZF and serial gzip on the first read by
  // peeking at the first member header (bgzf_parse_header).
  void probe_gz() {
    size_t need = 12;
    for (;;) {
      // grow in_buf[in_pos..in_len] to `need` raw bytes (bounded: <= 268)
      size_t avail = in_len - in_pos;
      if (avail >= need || raw_eof) break;
      if (in_buf.size() < in_pos + need) in_buf.resize(in_pos + need);
      size_t got = fread(in_buf.data() + in_len, 1, in_pos + need - in_len,
                         raw);
      in_len += got;
      if (got == 0 && (feof(raw) || ferror(raw))) raw_eof = true;
      avail = in_len - in_pos;
      if (avail >= 12) {
        size_t xlen = (size_t)in_buf[in_pos + 10] |
                      ((size_t)in_buf[in_pos + 11] << 8);
        need = 12 + xlen;
        if (need > 12 + 65535) break;  // nonsense xlen: serial will error
      }
      if (avail >= need) break;
    }
    size_t total = 0, hlen = 0;
    int rc = bgzf_parse_header(in_buf.data() + in_pos, in_len - in_pos,
                               &total, &hlen);
    if (rc == 1) {
      gz_mode = 1;
      bgzf = std::make_unique<BgzfState>();
      bgzf->raw = raw;
      bgzf->nthreads = bgzf_threads();
      bgzf->raw_eof = raw_eof;
      bgzf->carry.assign(in_buf.begin() + in_pos, in_buf.begin() + in_len);
      in_pos = in_len = 0;
    } else {
      gz_mode = 2;  // plain gzip: serial z_stream path
    }
  }

  // Serial plain-gzip decode through the resumable fast inflater: the
  // compressed stream stays contiguous in gz_carry (compact + fread), the
  // decoder suspends between symbols at low input, and decoded bytes stage
  // through gz_out (whose tail margin absorbs wide copies).
  int64_t read_gz_fast(uint8_t* dst, size_t n) {
    if (!sgz) {
      sgz = std::make_unique<fastinf::StreamGz>();
      gz_carry.assign(in_buf.begin() + in_pos, in_buf.begin() + in_len);
      in_pos = in_len = 0;
      gz_out.resize(kBufSize + 512);
    }
    size_t out = 0;
    for (;;) {
      if (gz_out_pos < gz_out_len) {
        size_t take = std::min(gz_out_len - gz_out_pos, n - out);
        memcpy(dst + out, gz_out.data() + gz_out_pos, take);
        gz_out_pos += take;
        out += take;
        if (out == n) return (int64_t)out;
      }
      if (sgz_done) return (int64_t)out;
      // keep >= 256 KiB of compressed bytes buffered (the decoder demands
      // whole member/block headers without suspension)
      if (gz_carry.size() - gz_cpos < (size_t)(1 << 18) && !raw_eof) {
        if (gz_cpos > 0) {
          gz_carry.erase(gz_carry.begin(), gz_carry.begin() + gz_cpos);
          gz_cpos = 0;
        }
        size_t old = gz_carry.size();
        size_t want = (size_t)(1 << 19);
        gz_carry.resize(old + want);
        size_t got = fread(gz_carry.data() + old, 1, want, raw);
        gz_carry.resize(old + got);
        if (got < want) raw_eof = true;
      }
      size_t ip = gz_cpos, op = 0;
      int r = sgz->run(gz_carry.data(), gz_carry.size(), &ip, raw_eof,
                       gz_out.data(), gz_out.size(), &op);
      bool in_progress = ip != gz_cpos;
      gz_cpos = ip;
      gz_out_pos = 0;
      gz_out_len = op;
      if (r < 0) return -1;
      if (r == 0) sgz_done = true;
      if (r == 1 && op == 0 && !in_progress && raw_eof)
        return -1;  // no progress possible: truncated stream
    }
  }

  // Drains decompressed BGZF bytes into dst. Returns bytes written, or -1
  // on error. Sets gz_mode = 2 (with leftover compressed bytes replayed
  // through in_buf) when a non-BGZF member or EOF ends the BGZF phase.
  int64_t read_bgzf(uint8_t* dst, size_t n) {
    size_t out = 0;
    BgzfState& st = *bgzf;
    while (out < n) {
      size_t have = st.cur.out.size() - st.out_pos;
      if (have > 0) {
        size_t take = std::min(have, n - out);
        memcpy(dst + out, st.cur.out.data() + st.out_pos, take);
        st.out_pos += take;
        out += take;
        continue;
      }
      if (st.done) {
        if (!st.cur.err.empty()) return -1;
        if (st.cur.fallback) {
          // hand the remaining compressed bytes to the serial path
          size_t left = st.carry_avail();
          in_buf.assign(st.carry.begin() + st.carry_pos, st.carry.end());
          if (in_buf.size() < kBufSize) in_buf.resize(kBufSize);
          in_pos = 0;
          in_len = left;
          raw_eof = st.raw_eof;
          gz_mode = 2;
          bgzf.reset();
        } else {
          raw_eof = true;
          gz_mode = 3;  // fully drained
          bgzf.reset();
        }
        break;
      }
      if (!st.fetch() && !st.cur.err.empty()) return -1;
    }
    return (int64_t)out;
  }

  // Decode-ahead: serial decompression (plain gz / zstd / xz) runs on a
  // background thread filling a bounded chunk queue, so inflate overlaps
  // with record parsing/extraction on the consumer side (the same overlap
  // the BGZF path gets from its batch prefetch).
  struct DecodeAhead {
    std::thread th;
    std::mutex mu;
    std::condition_variable cv_push, cv_pop;
    std::deque<std::vector<uint8_t>> q;
    size_t q_bytes = 0;
    size_t front_pos = 0;
    bool eof = false, err = false, stop = false;
    static constexpr size_t kMaxBytes = 8u << 20;
    ~DecodeAhead() {
      {
        std::lock_guard<std::mutex> g(mu);
        stop = true;
      }
      cv_push.notify_all();
      if (th.joinable()) th.join();
    }
  };
  std::unique_ptr<DecodeAhead> ahead;

  void start_ahead() {
    ahead = std::make_unique<DecodeAhead>();
    DecodeAhead* a = ahead.get();
    a->th = std::thread([this, a] {
      int64_t* st = stats;
      for (;;) {
        std::vector<uint8_t> chunk(kBufSize);
        const int64_t t0 = st ? now_ns() : 0;
        int64_t got = read_direct(chunk.data(), chunk.size());
        if (st) {
          st[kDecodeBusyNs] += now_ns() - t0;
          if (got > 0) st[kDecodeBytes] += got;
        }
        std::unique_lock<std::mutex> lk(a->mu);
        if (got < 0) {
          a->err = true;
        } else if (got == 0) {
          a->eof = true;
        } else {
          chunk.resize((size_t)got);
          a->q_bytes += chunk.size();
          a->q.push_back(std::move(chunk));
        }
        a->cv_pop.notify_one();
        if (a->err || a->eof) return;
        const int64_t tw = st ? now_ns() : 0;
        a->cv_push.wait(
            lk, [a] { return a->q_bytes < DecodeAhead::kMaxBytes || a->stop; });
        if (st) st[kDecodeFullWaitNs] += now_ns() - tw;
        if (a->stop) return;
      }
    });
  }

  int64_t read_ahead(uint8_t* dst, size_t n) {
    DecodeAhead* a = ahead.get();
    size_t out = 0;
    while (out < n) {
      std::unique_lock<std::mutex> lk(a->mu);
      const int64_t tw = stats ? now_ns() : 0;
      a->cv_pop.wait(lk, [a] { return !a->q.empty() || a->eof || a->err; });
      if (stats) stats[kReaderEmptyWaitNs] += now_ns() - tw;
      if (a->q.empty()) {
        if (a->err) return -1;
        break;  // eof
      }
      std::vector<uint8_t>& front = a->q.front();
      size_t take = std::min(front.size() - a->front_pos, n - out);
      memcpy(dst + out, front.data() + a->front_pos, take);
      a->front_pos += take;
      out += take;
      if (a->front_pos >= front.size()) {
        a->q_bytes -= front.size();
        a->q.pop_front();
        a->front_pos = 0;
        a->cv_push.notify_one();
      }
    }
    return (int64_t)out;
  }

  // Decoded-space window of a range reader (dx_open_range): bytes to drop
  // before the first delivered byte, then bytes left to deliver (-1 = to
  // the end of the stream).
  int64_t dec_skip = 0, dec_left = -1;

  // Returns decoded bytes read into dst within the window (0 = end,
  // -1 = error).
  int64_t read(uint8_t* dst, size_t n) {
    while (dec_skip > 0) {
      int64_t got = read_codec(dst, std::min(n, (size_t)dec_skip));
      if (got <= 0) return got;
      dec_skip -= got;
    }
    if (dec_left == 0) return 0;
    if (dec_left > 0 && (int64_t)n > dec_left) n = (size_t)dec_left;
    int64_t got = read_codec(dst, n);
    if (got > 0 && dec_left > 0) dec_left -= got;
    return got;
  }

  // Returns decompressed bytes read into dst (0 = EOF, -1 = error).
  int64_t read_codec(uint8_t* dst, size_t n) {
    if (codec == Codec::kPlain) return read_direct(dst, n);
    if (codec == Codec::kGzip) {
      if (gz_mode == 0) probe_gz();
      if (gz_mode == 1) {
        int64_t got = read_bgzf(dst, n);  // may flip gz_mode to 2 or 3
        if (got < 0 || (size_t)got == n || gz_mode == 1 || gz_mode == 3)
          return got;
        // non-BGZF member mid-stream: serial path finishes this request
        int64_t rest = read_codec(dst + (size_t)got, n - (size_t)got);
        return rest < 0 ? -1 : got + rest;
      }
      if (gz_mode == 3) return 0;
    }
    if (!ahead) start_ahead();
    return read_ahead(dst, n);
  }

  // Serial single-threaded decode of one codec stream (no BGZF, no
  // prefetch). Runs on the decode-ahead thread.
  int64_t read_direct(uint8_t* dst, size_t n) {
    switch (codec) {
      case Codec::kPlain: {
        size_t out = 0;
        // replay sniffed magic first
        if (in_pos < in_len) {
          size_t take = in_len - in_pos;
          if (take > n) take = n;
          memcpy(dst, in_buf.data() + in_pos, take);
          in_pos += take;
          out = take;
        }
        if (out < n) {
          size_t got = fread(dst + out, 1, n - out, raw);
          if (got == 0 && ferror(raw)) return -1;
          out += got;
        }
        return (int64_t)out;
      }
      case Codec::kGzip:
        return read_gz_fast(dst, n);
      case Codec::kZstd: {
        size_t out_total = 0;
        while (out_total < n) {
          if (in_pos >= in_len) {
            if (!fill_raw()) {
              if (zstd_rc != 0) return -1;  // truncated mid-frame
              break;
            }
          }
          ZSTD_inBuffer ib{in_buf.data(), in_len, in_pos};
          ZSTD_outBuffer ob{dst, n, out_total};
          size_t rc = zst->decompressStream(zds, &ob, &ib);
          if (zst->isError(rc)) return -1;
          zstd_rc = rc;
          in_pos = ib.pos;
          size_t produced = ob.pos - out_total;
          out_total = ob.pos;
          if (produced == 0 && in_pos >= in_len && raw_eof) {
            if (rc != 0) return -1;  // frame expects more input at EOF
            break;
          }
        }
        return (int64_t)out_total;
      }
      case Codec::kBz2: {
        if (!bz_init) return -1;
        const Bz2Api& api = Bz2Api::get();
        bz.next_out = (char*)dst;
        bz.avail_out = (unsigned)n;
        while (bz.avail_out > 0) {
          if (bz.avail_in == 0) {
            if (in_pos >= in_len && !fill_raw()) {
              if (bz_mid) return -1;  // truncated mid-member
              break;
            }
            bz.next_in = (char*)(in_buf.data() + in_pos);
            bz.avail_in = (unsigned)(in_len - in_pos);
            in_pos = in_len;
          }
          int r = api.decomp(&bz);
          if (r == kBzStreamEnd) {
            bz_mid = false;
            // support concatenated bzip2 members
            if (bz.avail_in == 0 && in_pos >= in_len && raw_eof) break;
            char* save_in = bz.next_in;
            unsigned save_in_avail = bz.avail_in;
            char* save_out = bz.next_out;
            unsigned save_out_avail = bz.avail_out;
            api.end(&bz);
            memset(&bz, 0, sizeof(bz));
            if (api.init(&bz, 0, 0) != kBzOk) {
              bz_init = false;
              return -1;
            }
            bz.next_in = save_in;
            bz.avail_in = save_in_avail;
            bz.next_out = save_out;
            bz.avail_out = save_out_avail;
            continue;
          }
          if (r != kBzOk) return -1;
          bz_mid = true;
        }
        return (int64_t)(n - bz.avail_out);
      }
      case Codec::kXz: {
        lz.next_out = dst;
        lz.avail_out = n;
        while (lz.avail_out > 0) {
          lzma_action action = LZMA_RUN;
          if (lz.avail_in == 0) {
            if (in_pos >= in_len && !fill_raw()) {
              action = LZMA_FINISH;
            } else {
              lz.next_in = in_buf.data() + in_pos;
              lz.avail_in = in_len - in_pos;
              in_pos = in_len;
            }
          }
          lzma_ret r = lzma_code(&lz, action);
          if (r == LZMA_STREAM_END) break;
          if (r != LZMA_OK) {
            if (lz.avail_out < n) break;  // return what we have
            return -1;
          }
          if (action == LZMA_FINISH && lz.avail_out > 0) break;
        }
        return (int64_t)(n - lz.avail_out);
      }
    }
    return -1;
  }
};


struct DxReader {
  Source src;
  std::vector<uint8_t> buf;
  size_t pos = 0, len = 0;
  bool eof = false;
  int is_fastq = -1;
  std::string error;
  std::vector<uint8_t> pending;  // pushed-back header line
  bool has_pending = false;
  // reader-owned batch buffers for dx_next_batch_view (zero extra copies:
  // bytes go decompression buffer -> here, and the caller reads in place)
  std::vector<uint8_t> batch_arena;
  std::vector<int64_t> batch_meta;
  // bytes handed back by the filter pipeline's chunk-parallel reader when
  // it bails to the serial path (anomalous input or EOF tail): drained
  // before src
  std::vector<uint8_t> replay;
  size_t replay_pos = 0;

  bool refill() {
    if (replay_pos < replay.size()) {
      size_t take = std::min(replay.size() - replay_pos, buf.size());
      memcpy(buf.data(), replay.data() + replay_pos, take);
      replay_pos += take;
      if (replay_pos >= replay.size()) {
        replay.clear();
        replay_pos = 0;
      }
      pos = 0;
      len = take;
      return true;
    }
    if (eof) return false;
    int64_t got = src.read(buf.data(), buf.size());
    if (got < 0) {
      error = "decompression/read error";
      eof = true;
      return false;
    }
    if (got == 0) {
      eof = true;
      return false;
    }
    pos = 0;
    len = (size_t)got;
    return true;
  }


  // Appends the next line's bytes (no \n, \r stripped) to dst.
  // Returns the appended length, or -1 at EOF with nothing read.
  int64_t getline_append(std::vector<uint8_t>& dst) {
    if (has_pending) {
      dst.insert(dst.end(), pending.begin(), pending.end());
      has_pending = false;
      return (int64_t)pending.size();
    }
    const size_t start_size = dst.size();
    bool any = false;
    while (true) {
      if (pos >= len && !refill()) {
        // final line without a trailing '\n': still strip one '\r' so a
        // CRLF file's last record matches the Python parser
        if (dst.size() > start_size && dst.back() == '\r') dst.pop_back();
        int64_t n = (int64_t)(dst.size() - start_size);
        return (any || n > 0) ? n : -1;
      }
      any = true;
      uint8_t* start = buf.data() + pos;
      uint8_t* nl = (uint8_t*)memchr(start, '\n', len - pos);
      if (nl) {
        dst.insert(dst.end(), start, nl);
        pos = (size_t)(nl - buf.data()) + 1;
        if (dst.size() > start_size && dst.back() == '\r') dst.pop_back();
        return (int64_t)(dst.size() - start_size);
      }
      dst.insert(dst.end(), start, buf.data() + len);
      pos = len;
    }
  }

  // Zero-copy record parse: bytes land directly in `arena` (the pipeline
  // batch buffer), m = {id_off,id_len,seq_off,seq_len,qual_off,qual_len}
  // with qual_off = -1 for FASTA — the same layout append_record produced
  // from a Record, minus two full copies of every byte. Returns 1 ok,
  // 0 eof, -1 error.
  int parse_record_into(std::vector<uint8_t>& arena, int64_t* m) {
    int64_t hlen;
    while (true) {  // skip blank lines before the header
      hlen = getline_append(arena);
      if (hlen < 0) {
        if (!error.empty()) return -1;  // decompression error, not EOF
        return 0;
      }
      if (hlen > 0) break;
    }
    const size_t hoff = arena.size() - (size_t)hlen;
    uint8_t marker = arena[hoff];
    if (is_fastq == -1) {
      if (marker == '>') is_fastq = 0;
      else if (marker == '@') is_fastq = 1;
      else {
        error = "Unrecognized FASTX record start";
        return -1;
      }
    }
    if ((is_fastq == 1 && marker != '@') || (is_fastq == 0 && marker != '>')) {
      error = "Record marker mismatch";
      return -1;
    }
    m[0] = (int64_t)hoff + 1;  // id excludes the marker byte
    m[1] = hlen - 1;
    if (is_fastq == 1) {
      int64_t slen = getline_append(arena);
      if (slen < 0) {
        error = "Truncated FASTQ record";
        return -1;
      }
      m[2] = (int64_t)arena.size() - slen;
      m[3] = slen;
      size_t save = arena.size();
      int64_t plen = getline_append(arena);
      if (plen <= 0 || arena[save] != '+') {
        error = "Expected '+' separator";
        return -1;
      }
      arena.resize(save);  // separator line is not part of the record
      int64_t qlen = getline_append(arena);
      if (qlen < 0) {
        error = "Truncated FASTQ record (missing quality)";
        return -1;
      }
      m[4] = (int64_t)arena.size() - qlen;
      m[5] = qlen;
      if (qlen != slen) {
        error = "Quality length != sequence length";
        return -1;
      }
    } else {
      m[2] = (int64_t)arena.size();
      while (true) {  // multi-line FASTA: lines concatenate in place
        size_t save = arena.size();
        int64_t l = getline_append(arena);
        if (l < 0) {
          if (!error.empty()) return -1;  // decompression error, not EOF
          break;
        }
        if (l > 0 && arena[save] == '>') {  // next record: push back
          pending.assign(arena.begin() + save, arena.end());
          has_pending = true;
          arena.resize(save);
          break;
        }
      }
      m[3] = (int64_t)arena.size() - m[2];
      m[4] = -1;
      m[5] = 0;
    }
    return 1;
  }

};

// ---- gzip output: one member, deflated in blocks on a pool of threads ------
//
// A .gz output is deflated as pigz does it. The writer's caller only
// copies its bytes into input blocks of kGzBlock bytes. Worker threads
// deflate whole blocks with zlib at the writer's level, memLevel 8 and
// the default strategy, as raw deflate: each primed with the previous
// block's last 32 KiB (deflateSetDictionary), so matches reach back as in
// one stream, and ended with Z_SYNC_FLUSH (a byte-aligned empty stored
// block), the last with Z_FINISH. One output thread a writer writes
// zlib's own 10-byte gzip header, the blocks in order, then the trailer
// (the blocks' CRC32s combined, ISIZE): one gzip member. An output of at
// most one block is deflated in one call from a fresh state, which gives
// the bytes of one zlib gzip stream fed in any pieces. kGzBlock = 1 MiB:
// priming hashes 32 KiB a block (3%) and a block's end costs ~0.03% of
// its size, while a writer's ~70 MB/s is still ~70 jobs a second to
// spread over the pool.

constexpr size_t kGzBlock = 1 << 20;
constexpr size_t kGzDict = 32768;

struct GzOut;

struct GzBlock {
  GzOut* owner = nullptr;
  std::vector<uint8_t> in;  // dict_len priming bytes, then len input bytes
  size_t dict_len = 0, len = 0;
  std::vector<uint8_t> out;  // the deflated block: out_len bytes
  size_t out_len = 0;
  uLong crc = 0;
  int64_t busy_ns = 0;
  bool last = false, done = false, ok = false;
};

void gz_block_done(GzBlock* b);

// The deflate workers, shared by the gzip writers open in the process:
// made as the first opens, joined as the last closes. Half the CPUs the
// process may run on (sched_getaffinity), 1 to 8.
class DeflatePool {
 public:
  explicit DeflatePool(int n) {
    for (int i = 0; i < n; i++) threads_.emplace_back([this] { run(); });
  }
  ~DeflatePool() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  int size() const { return (int)threads_.size(); }
  void submit(GzBlock* b) {
    {
      std::lock_guard<std::mutex> g(mu_);
      q_.push_back(b);
    }
    cv_.notify_one();
  }

  static std::shared_ptr<DeflatePool> acquire() {
    static std::mutex mu;
    static std::weak_ptr<DeflatePool> shared;
    std::lock_guard<std::mutex> g(mu);
    std::shared_ptr<DeflatePool> p = shared.lock();
    if (!p) {
      int n = 0;
      cpu_set_t set;
      if (sched_getaffinity(0, sizeof(set), &set) == 0) n = CPU_COUNT(&set);
      if (n <= 0) n = (int)std::thread::hardware_concurrency();
      p = std::make_shared<DeflatePool>(std::clamp(n / 2, 1, 8));
      shared = p;
    }
    return p;
  }

 private:
  static constexpr int kNoLevel = -2;

  void run() {
    z_stream zs{};
    int zlevel = kNoLevel;  // the level zs was made for
    for (;;) {
      GzBlock* b;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (q_.empty()) break;
        b = q_.front();
        q_.pop_front();
      }
      const int64_t t0 = now_ns();
      b->ok = deflate_block(zs, zlevel, b);
      b->busy_ns = now_ns() - t0;
      gz_block_done(b);  // from here b is its writer's again
    }
    if (zlevel != kNoLevel) deflateEnd(&zs);
  }

  static bool deflate_block(z_stream& zs, int& zlevel, GzBlock* b);

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<GzBlock*> q_;
  bool stop_ = false;
  std::vector<std::thread> threads_;
};

// A gzip writer's encoder: its blocks, free and in flight, and its output
// thread. The caller's thread only copies and waits.
struct GzOut {
  FILE* file = nullptr;
  int level = 0;
  uint8_t header[10];
  std::shared_ptr<DeflatePool> pool;
  size_t max_in_flight = 2;  // two blocks a worker
  GzBlock* cur = nullptr;    // the block the caller fills
  std::vector<uint8_t> dict;  // the last kGzDict bytes handed off
  std::vector<std::unique_ptr<GzBlock>> blocks;
  std::vector<GzBlock*> free_blocks;
  std::mutex mu;
  std::condition_variable cv_done, cv_space;
  std::deque<GzBlock*> pending;  // handed off, not yet written, in order
  std::atomic<bool> failed{false};
  std::thread out_th;
  // the output thread's counts, added to the writer's stats at close
  int64_t io_ns = 0, bytes_out = 0, busy_ns = 0, n_blocks = 0;

  // Zlib's gzip header for level `lvl` (the first bytes its gzip wrapper
  // writes), the pool and the output thread. false if zlib refuses the
  // level.
  bool open(FILE* f, int lvl) {
    z_stream zs{};
    if (deflateInit2(&zs, lvl, Z_DEFLATED, 16 + MAX_WBITS, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
      return false;
    uint8_t empty[64];
    zs.next_out = empty;
    zs.avail_out = sizeof(empty);
    const bool ok = deflate(&zs, Z_FINISH) == Z_STREAM_END &&
                    sizeof(empty) - zs.avail_out >= sizeof(header);
    deflateEnd(&zs);
    if (!ok) return false;
    memcpy(header, empty, sizeof(header));
    file = f;
    level = lvl;
    pool = DeflatePool::acquire();
    max_in_flight = 2 * (size_t)pool->size();
    cur = take_block(nullptr);
    out_th = std::thread([this] { write_out(); });
    return true;
  }

  // Copies len bytes into blocks. A full block is handed off once more
  // bytes follow it, so the last block is never an empty one after it
  // unless the output is empty.
  bool write(const uint8_t* data, size_t len, int64_t* wait_ns) {
    while (len > 0) {
      if (failed.load(std::memory_order_relaxed)) return false;
      if (cur->len == kGzBlock) {
        hand_off(false);
        cur = take_block(wait_ns);
      }
      const size_t n = std::min(len, kGzBlock - cur->len);
      memcpy(cur->in.data() + cur->dict_len + cur->len, data, n);
      cur->len += n;
      data += n;
      len -= n;
    }
    return !failed.load(std::memory_order_relaxed);
  }

  // Hands off the last block and waits until the output thread has
  // written it and the trailer; the last writer's close joins the pool.
  bool finish() {
    hand_off(true);
    out_th.join();
    pool.reset();
    return !failed.load();
  }

  // A free block primed with the last kGzDict bytes handed off, once
  // fewer than max_in_flight blocks are in flight (the wait's ns into
  // *wait_ns).
  GzBlock* take_block(int64_t* wait_ns) {
    GzBlock* b = nullptr;
    {
      std::unique_lock<std::mutex> lk(mu);
      if (pending.size() >= max_in_flight) {
        const int64_t t0 = wait_ns ? now_ns() : 0;
        cv_space.wait(lk, [this] { return pending.size() < max_in_flight; });
        if (wait_ns) *wait_ns += now_ns() - t0;
      }
      if (!free_blocks.empty()) {
        b = free_blocks.back();
        free_blocks.pop_back();
      }
    }
    if (!b) {
      blocks.push_back(std::make_unique<GzBlock>());
      b = blocks.back().get();
      b->owner = this;
      b->in.resize(kGzDict + kGzBlock);
    }
    b->dict_len = dict.size();
    memcpy(b->in.data(), dict.data(), dict.size());
    b->len = 0;
    b->last = b->done = b->ok = false;
    return b;
  }

  void hand_off(bool last) {
    GzBlock* b = cur;
    cur = nullptr;
    b->last = last;
    if (!last) {  // the next block's priming: this block's input tail
      const uint8_t* end = b->in.data() + b->dict_len + b->len;
      dict.assign(end - std::min(kGzDict, b->dict_len + b->len), end);
    }
    {
      std::lock_guard<std::mutex> g(mu);
      pending.push_back(b);
    }
    pool->submit(b);
  }

  void put(const uint8_t* p, size_t n) {
    if (failed.load(std::memory_order_relaxed)) return;
    const int64_t t0 = now_ns();
    if (fwrite(p, 1, n, file) != n) failed = true;
    io_ns += now_ns() - t0;
    bytes_out += (int64_t)n;
  }

  // The output thread: the header, each block as it comes done in
  // order, the trailer after the last. After a failure it writes nothing
  // and only recycles the blocks, so the caller never waits forever.
  void write_out() {
    uLong crc = crc32(0L, Z_NULL, 0);
    uint32_t isize = 0;
    put(header, sizeof(header));
    for (bool last = false; !last;) {
      GzBlock* b;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [this] {
          return !pending.empty() && pending.front()->done;
        });
        b = pending.front();
      }
      busy_ns += b->busy_ns;
      n_blocks++;
      if (!b->ok) failed = true;
      crc = crc32_combine(crc, b->crc, (z_off_t)b->len);
      isize += (uint32_t)b->len;
      put(b->out.data(), b->out_len);
      last = b->last;
      if (last) {
        uint8_t tail[8];
        for (int i = 0; i < 4; i++) {
          tail[i] = (uint8_t)(crc >> (8 * i));
          tail[4 + i] = (uint8_t)(isize >> (8 * i));
        }
        put(tail, sizeof(tail));
      }
      {
        std::lock_guard<std::mutex> g(mu);
        pending.pop_front();
        free_blocks.push_back(b);
      }
      cv_space.notify_one();
    }
  }
};

void gz_block_done(GzBlock* b) {
  GzOut* g = b->owner;
  std::lock_guard<std::mutex> lk(g->mu);
  b->done = true;
  g->cv_done.notify_one();  // under the lock: the writer may go right after
}

bool DeflatePool::deflate_block(z_stream& zs, int& zlevel, GzBlock* b) {
  const int level = b->owner->level;
  if (zlevel != level) {
    if (zlevel != kNoLevel) deflateEnd(&zs);
    zs = z_stream{};
    zlevel = kNoLevel;
    if (deflateInit2(&zs, level, Z_DEFLATED, -MAX_WBITS, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
      return false;
    zlevel = level;
  } else if (deflateReset(&zs) != Z_OK) {
    return false;
  }
  if (b->dict_len &&
      deflateSetDictionary(&zs, b->in.data(), (uInt)b->dict_len) != Z_OK)
    return false;
  uint8_t* in = b->in.data() + b->dict_len;
  b->crc = crc32(0L, in, (uInt)b->len);
  const size_t bound = deflateBound(&zs, b->len) + 16;
  if (b->out.size() < bound) b->out.resize(bound);
  zs.next_in = in;
  zs.avail_in = (uInt)b->len;
  zs.next_out = b->out.data();
  zs.avail_out = (uInt)b->out.size();
  const int flush = b->last ? Z_FINISH : Z_SYNC_FLUSH;
  for (;;) {
    const int rc = deflate(&zs, flush);
    if (rc == Z_STREAM_ERROR) return false;
    if (b->last ? rc == Z_STREAM_END : zs.avail_in == 0 && zs.avail_out > 0)
      break;
    if (zs.avail_out == 0) {  // past the bound: more room, as zlib asks
      const size_t used = b->out.size();
      b->out.resize(2 * used);
      zs.next_out = b->out.data() + used;
      zs.avail_out = (uInt)(b->out.size() - used);
    } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
      return false;
    }
  }
  b->out_len = b->out.size() - zs.avail_out;
  return true;
}

struct DxWriter {
  FILE* file = nullptr;
  Codec codec = Codec::kPlain;
  std::unique_ptr<GzOut> gz;
  const ZstdApi* zst = nullptr;
  ZSTD_CStream* zcs = nullptr;
  lzma_stream lz = LZMA_STREAM_INIT;
  bool lz_init = false;
  std::vector<uint8_t> out_buf;
  int64_t* stats = nullptr;  // WriterStat slots, or none
};

// fwrite of encoded (or plain) output, counted into the writer's stats.
bool put_output(DxWriter* w, const uint8_t* p, size_t n) {
  if (!w->stats) return fwrite(p, 1, n, w->file) == n;
  const int64_t t0 = now_ns();
  bool ok = fwrite(p, 1, n, w->file) == n;
  w->stats[kOutputIoNs] += now_ns() - t0;
  w->stats[kOutputBytesOut] += (int64_t)n;
  return ok;
}

}  // namespace

extern "C" {

// Opens a FASTX stream (path "-" = stdin), compression sniffed from the
// magic bytes; zstd streams through the library named `zstd_lib`.
// nullptr on failure, with the reason in dx_open_error().
DxReader* dx_open(const char* path, const char* zstd_lib) {
  FILE* f = (!path || strcmp(path, "-") == 0) ? stdin : fopen(path, "rb");
  if (!f) {
    g_open_error = strerror(errno);
    return nullptr;
  }
  uint8_t magic[6] = {0};
  size_t got = fread(magic, 1, sizeof(magic), f);
  Codec codec = Codec::kPlain;
  if (got >= 2 && magic[0] == 0x1f && magic[1] == 0x8b) codec = Codec::kGzip;
  else if (got >= 4 && magic[0] == 0x28 && magic[1] == 0xb5 &&
           magic[2] == 0x2f && magic[3] == 0xfd)
    codec = Codec::kZstd;
  else if (got >= 6 && magic[0] == 0xfd && memcmp(magic + 1, "7zXZ", 4) == 0)
    codec = Codec::kXz;
  else if (got >= 4 && memcmp(magic, "BZh", 3) == 0 && magic[3] >= '1' &&
           magic[3] <= '9')
    codec = Codec::kBz2;
  if (const char* lib = missing_codec_library(codec, zstd_lib)) {
    g_open_error = std::string("cannot load ") + lib +
                   ", which this stream's compression needs";
    if (f != stdin) fclose(f);
    return nullptr;
  }

  auto* r = new DxReader();
  r->buf.resize(kBufSize);
  r->src.init(f, codec, magic, got,
              codec == Codec::kZstd ? ZstdApi::get(zstd_lib) : nullptr);
  return r;
}

// Opens a range of a plain or BGZF FASTX file: seek to raw offset
// `offset` (a record start of a plain file, or a block start of a BGZF
// file), drop `skip` decoded bytes (the partial record at a BGZF block's
// head, owned by the range before), then deliver `len` decoded bytes
// (-1 = to the end). The ranges come from io/split.py. Serial codecs have
// no mid-stream entry, so any other compression fails to open. nullptr on
// failure, with the reason in dx_open_error().
DxReader* dx_open_range(const char* path, int64_t offset, int64_t skip,
                        int64_t len) {
  if (!path || strcmp(path, "-") == 0 || offset < 0 || skip < 0 ||
      len < -1) {
    g_open_error = "a range needs a file path, offset >= 0, skip >= 0 and "
                   "len >= -1";
    return nullptr;
  }
  FILE* f = fopen(path, "rb");
  if (!f) {
    g_open_error = strerror(errno);
    return nullptr;
  }
  uint8_t magic[6] = {0};
  size_t got = fread(magic, 1, sizeof(magic), f);
  Codec codec = Codec::kPlain;
  if (got >= 2 && magic[0] == 0x1f && magic[1] == 0x8b) {
    codec = Codec::kGzip;
  } else if ((got >= 4 && magic[0] == 0x28 && magic[1] == 0xb5 &&
              magic[2] == 0x2f && magic[3] == 0xfd) ||
             (got >= 6 && magic[0] == 0xfd &&
              memcmp(magic + 1, "7zXZ", 4) == 0) ||
             (got >= 4 && memcmp(magic, "BZh", 3) == 0)) {
    g_open_error = "only plain and BGZF files can be read by range";
    fclose(f);
    return nullptr;
  }
  if (fseek(f, (long)offset, SEEK_SET) != 0) {
    g_open_error = strerror(errno);
    fclose(f);
    return nullptr;
  }
  if (codec == Codec::kGzip && len != 0) {
    // the range must start at a BGZF block: the serial inflater cannot
    // enter a stream in its middle
    uint8_t hdr[18];
    size_t n = fread(hdr, 1, sizeof(hdr), f);
    size_t total = 0, hlen = 0;
    if (n && bgzf_parse_header(hdr, n, &total, &hlen) != 1) {
      g_open_error = "no BGZF block starts at the range's offset";
      fclose(f);
      return nullptr;
    }
    fseek(f, (long)offset, SEEK_SET);
  }
  auto* r = new DxReader();
  r->buf.resize(kBufSize);
  r->src.init(f, codec, nullptr, 0, nullptr);
  r->src.dec_skip = skip;
  r->src.dec_left = len;
  return r;
}

const char* dx_open_error() { return g_open_error.c_str(); }

void dx_close(DxReader* r) { delete r; }
int dx_is_fastq(DxReader* r) { return r->is_fastq; }
const char* dx_error(DxReader* r) { return r->error.c_str(); }


// Zero-copy batch parse: records land in reader-owned buffers via
// parse_record_into (one copy per byte total: decompression buffer ->
// arena); the caller reads the returned views in place. Views are valid
// until the next dx_* call on this reader or dx_close. Parses until
// max_rec records or the arena reaches max_bytes. Returns #records
// (0 = EOF), -1 = parse error.
int64_t dx_next_batch_view(DxReader* r, int64_t max_rec, int64_t max_bytes,
                           const uint8_t** arena_out, int64_t* arena_len,
                           const int64_t** meta_out) {
  r->batch_arena.clear();
  r->batch_meta.clear();
  int64_t n = 0;
  int64_t m[6];
  while (n < max_rec && (int64_t)r->batch_arena.size() < max_bytes) {
    int rc = r->parse_record_into(r->batch_arena, m);
    if (rc < 0) return -1;
    if (rc == 0) break;
    r->batch_meta.insert(r->batch_meta.end(), m, m + 6);
    n++;
  }
  *arena_out = r->batch_arena.data();
  *arena_len = (int64_t)r->batch_arena.size();
  *meta_out = r->batch_meta.data();
  return n;
}

// ---------------------------------------------------------------------------
// Writer (codec: 0 plain, 1 gzip, 2 zstd, 3 xz)
// ---------------------------------------------------------------------------

// Opens an output stream (path "-" = stdout) in codec 0 plain, 1 gzip,
// 2 zstd (through the library named `zstd_lib`) or 3 xz. nullptr on
// failure, with the reason in dx_open_error(); a missing codec library
// fails before the file is created.
DxWriter* dx_writer_open(const char* path, int codec, int level,
                         const char* zstd_lib) {
  if (codec < 0 || codec > 3) {  // output side is gz/zst/xz only
    g_open_error = "unsupported output codec";
    return nullptr;
  }
  if (const char* lib = missing_codec_library((Codec)codec, zstd_lib)) {
    g_open_error = std::string("cannot load ") + lib +
                   ", which this output's compression needs";
    return nullptr;
  }
  auto* w = new DxWriter();
  w->codec = (Codec)codec;
  w->file = (strcmp(path, "-") == 0) ? stdout : fopen(path, "wb");
  if (!w->file) {
    g_open_error = strerror(errno);
    delete w;
    return nullptr;
  }
  switch (w->codec) {
    case Codec::kPlain:
      break;
    case Codec::kGzip:
      w->gz = std::make_unique<GzOut>();
      if (!w->gz->open(w->file, level)) {
        g_open_error = "gzip encoder init failed";
        if (w->file != stdout) fclose(w->file);
        delete w;
        return nullptr;
      }
      break;
    case Codec::kZstd:
      w->zst = ZstdApi::get(zstd_lib);
      w->zcs = w->zst->createCStream();
      w->zst->initCStream(w->zcs, level);
      w->out_buf.resize(w->zst->cStreamOutSize());
      break;
    case Codec::kXz:
      if (lzma_easy_encoder(&w->lz, (uint32_t)level, LZMA_CHECK_CRC64) !=
          LZMA_OK) {
        g_open_error = "xz encoder init failed";
        if (w->file != stdout) fclose(w->file);
        delete w;
        return nullptr;
      }
      w->lz_init = true;
      w->out_buf.resize(kBufSize);
      break;
    case Codec::kBz2:  // rejected above
      break;
  }
  return w;
}

static int writer_write(DxWriter* w, const uint8_t* data, int64_t len) {
  switch (w->codec) {
    case Codec::kBz2:
      return -1;  // unreachable: open rejects bz2 writers
    case Codec::kPlain:
      return put_output(w, data, (size_t)len) ? 0 : -1;
    case Codec::kGzip:
      return w->gz->write(data, (size_t)len,
                          w->stats ? &w->stats[kEncodeFullWaitNs] : nullptr)
                 ? 0
                 : -1;
    case Codec::kZstd: {
      ZSTD_inBuffer ib{data, (size_t)len, 0};
      while (ib.pos < ib.size) {
        ZSTD_outBuffer ob{w->out_buf.data(), w->out_buf.size(), 0};
        size_t rc = w->zst->compressStream(w->zcs, &ob, &ib);
        if (w->zst->isError(rc)) return -1;
        if (ob.pos && !put_output(w, w->out_buf.data(), ob.pos)) return -1;
      }
      return 0;
    }
    case Codec::kXz: {
      w->lz.next_in = data;
      w->lz.avail_in = (size_t)len;
      while (w->lz.avail_in > 0) {
        w->lz.next_out = w->out_buf.data();
        w->lz.avail_out = w->out_buf.size();
        if (lzma_code(&w->lz, LZMA_RUN) != LZMA_OK) return -1;
        size_t got = w->out_buf.size() - w->lz.avail_out;
        if (got && !put_output(w, w->out_buf.data(), got)) return -1;
      }
      return 0;
    }
  }
  return -1;
}

static int writer_close(DxWriter* w) {
  int rc = 0;
  switch (w->codec) {
    case Codec::kBz2:
    case Codec::kPlain:
      break;
    case Codec::kGzip:
      if (!w->gz->finish()) rc = -1;
      break;
    case Codec::kZstd: {
      size_t remaining;
      do {
        ZSTD_outBuffer ob{w->out_buf.data(), w->out_buf.size(), 0};
        remaining = w->zst->endStream(w->zcs, &ob);
        if (w->zst->isError(remaining)) {
          rc = -1;
          break;
        }
        if (ob.pos && !put_output(w, w->out_buf.data(), ob.pos)) rc = -1;
      } while (remaining > 0);
      w->zst->freeCStream(w->zcs);
      w->zcs = nullptr;
      break;
    }
    case Codec::kXz: {
      lzma_ret r;
      do {
        w->lz.next_out = w->out_buf.data();
        w->lz.avail_out = w->out_buf.size();
        r = lzma_code(&w->lz, LZMA_FINISH);
        size_t got = w->out_buf.size() - w->lz.avail_out;
        if (got && !put_output(w, w->out_buf.data(), got)) rc = -1;
      } while (r == LZMA_OK);
      if (r != LZMA_STREAM_END) rc = -1;
      lzma_end(&w->lz);
      w->lz_init = false;
      break;
    }
  }
  const int64_t t_io = w->stats ? now_ns() : 0;
  if (w->file && w->file != stdout) {
    if (fclose(w->file)) rc = -1;
  } else if (w->file) {
    if (fflush(w->file)) rc = -1;
  }
  if (w->stats) w->stats[kOutputIoNs] += now_ns() - t_io;
  w->file = nullptr;
  return rc;
}

// Appends len bytes to the output, through its encoder. 0, or -1 on
// failure.
int dx_writer_write(DxWriter* w, const uint8_t* data, int64_t len) {
  int64_t* st = w->stats;
  if (!st) return writer_write(w, data, len);
  const int64_t t0 = now_ns(), io0 = st[kOutputIoNs];
  int rc = writer_write(w, data, len);
  st[kEncodeNs] += now_ns() - t0 - (st[kOutputIoNs] - io0);
  st[kOutputBytesIn] += len;
  return rc;
}

// Ends the encoder's stream, closes the output (stdout is flushed) and
// frees the writer. 0, or -1 on failure.
int dx_writer_close(DxWriter* w) {
  int64_t* st = w->stats;
  const int64_t t0 = st ? now_ns() : 0, io0 = st ? st[kOutputIoNs] : 0;
  int rc = writer_close(w);
  if (st) {
    st[kEncodeNs] += now_ns() - t0 - (st[kOutputIoNs] - io0);
    if (w->gz) {  // the gzip encoder's threads, joined by now
      st[kOutputIoNs] += w->gz->io_ns;
      st[kOutputBytesOut] += w->gz->bytes_out;
      st[kEncodeBusyNs] += w->gz->busy_ns;
      st[kEncodeBlocks] += w->gz->n_blocks;
    }
  }
  delete w;
  return rc;
}

// From now on the reader adds its ReaderStat counts to stats[0..3]: the
// decode-ahead thread's seconds in read_direct (the read and the decode;
// serial gzip, zstd, xz and bzip2 streams) and blocked on its full queue,
// the bytes it decoded, and the reader's wait on the empty queue (ns).
// Call before the first read; stats must outlive dx_close.
void dx_reader_stats(DxReader* r, int64_t* stats) { r->src.stats = stats; }

// From now on the writer adds its WriterStat counts to stats[0..6]: ns
// of the caller's thread in the encoder (the write and close calls less
// their own output; for gzip the copy into blocks, the waits for a free
// block and the close's drain), ns in fwrite and fclose (for gzip on its
// output thread), bytes given, bytes written, and for gzip the workers'
// deflate ns, the caller's waits for a free block (ns, also in the
// first) and the blocks deflated. stats must outlive dx_writer_close.
void dx_writer_stats(DxWriter* w, int64_t* stats) { w->stats = stats; }


// Concatenates n byte ranges, each given by its address and length, into
// out (the filter's output records: ids, sequences and qualities gathered
// from batch arenas and separators).
void dx_gather(const int64_t* addrs, const int64_t* lens, int64_t n,
               uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    memcpy(out, reinterpret_cast<const void*>(addrs[i]), (size_t)lens[i]);
    out += lens[i];
  }
}

// Pack row byte-slices of an arena into the device tile layout:
// codes4 (R x L/4): the 2-bit code of base j of a row at bits 2*(j%4) of
// byte j/4, read from the 256-entry `code` table (the filter passes
// (b >> 1) & 3, the index build the same after IUPAC canonicalisation);
// valid8 (R x L/8): whether base j is A/C/G/T (either case) at bit j%8 of
// byte j/8. Rows at or beyond n_rows, and bytes past a row's length, are
// zero. Every row length must be at most L, and L a multiple of 8.
void dx_pack_tile(const uint8_t* arena, const int64_t* starts,
                  const int64_t* lens, int64_t n_rows, int64_t R, int64_t L,
                  const uint8_t* code, uint8_t* codes4, uint8_t* valid8) {
  const int64_t cw = L / 4, vw = L / 8;
  memset(codes4, 0, (size_t)(R * cw));
  memset(valid8, 0, (size_t)(R * vw));
  static const std::array<uint8_t, 256> vtab = [] {
    std::array<uint8_t, 256> t{};
    for (const char* p = "ACGTacgt"; *p; p++) t[(uint8_t)*p] = 1;
    return t;
  }();
  for (int64_t r = 0; r < n_rows; r++) {
    const uint8_t* s = arena + starts[r];
    const int64_t n = lens[r];
    uint8_t* crow = codes4 + r * cw;
    uint8_t* vrow = valid8 + r * vw;
    int64_t j = 0;
    for (; j + 8 <= n; j += 8) {
      crow[j / 4] = (uint8_t)(code[s[j]] | (code[s[j + 1]] << 2) |
                              (code[s[j + 2]] << 4) | (code[s[j + 3]] << 6));
      crow[j / 4 + 1] =
          (uint8_t)(code[s[j + 4]] | (code[s[j + 5]] << 2) |
                    (code[s[j + 6]] << 4) | (code[s[j + 7]] << 6));
      uint8_t v = 0;
      for (int t = 0; t < 8; t++) v |= (uint8_t)(vtab[s[j + t]] << t);
      vrow[j / 8] = v;
    }
    for (; j < n; j++) {
      crow[j / 4] |= (uint8_t)(code[s[j]] << (2 * (j % 4)));
      vrow[j / 8] |= (uint8_t)(vtab[s[j]] << (j % 8));
    }
  }
}

// ---------------------------------------------------------------------------
// bincode-standard varint u64 array codec (index file format;
// ref: src/index.rs:130-164). Unsigned ints: <251 one raw byte; 251 + u16LE;
// 252 + u32LE; 253 + u64LE.
// ---------------------------------------------------------------------------

// Decode `count` varints from buf[0..len) into out. Returns bytes consumed,
// or -1 on truncated/malformed input.
int64_t dx_decode_u64_varint(const uint8_t* buf, int64_t len, int64_t count,
                             uint64_t* out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < count; i++) {
    // dominant case first: for hash data ~100% of records are 0xFD+u64LE.
    // Unrolled run of 4 keeps the branch predictor and load unit busy.
    while (count - i >= 4 && len - pos >= 36 && buf[pos] == 253 &&
           buf[pos + 9] == 253 && buf[pos + 18] == 253 && buf[pos + 27] == 253) {
      uint64_t v0, v1, v2, v3;
      memcpy(&v0, buf + pos + 1, 8);
      memcpy(&v1, buf + pos + 10, 8);
      memcpy(&v2, buf + pos + 19, 8);
      memcpy(&v3, buf + pos + 28, 8);
      out[i] = v0;
      out[i + 1] = v1;
      out[i + 2] = v2;
      out[i + 3] = v3;
      i += 4;
      pos += 36;
    }
    if (i >= count) break;
    if (pos >= len) return -1;
    uint8_t first = buf[pos];
    if (first == 253) {
      if (pos + 9 > len) return -1;
      uint64_t v;
      memcpy(&v, buf + pos + 1, 8);
      out[i] = v;
      pos += 9;
    } else if (first <= 250) {
      out[i] = first;
      pos += 1;
    } else if (first == 251) {
      if (pos + 3 > len) return -1;
      uint16_t v;
      memcpy(&v, buf + pos + 1, 2);
      out[i] = v;
      pos += 3;
    } else if (first == 252) {
      if (pos + 5 > len) return -1;
      uint32_t v;
      memcpy(&v, buf + pos + 1, 4);
      out[i] = v;
      pos += 5;
    } else {
      return -1;  // 254 (u128) unsupported for u64 arrays; 255 invalid
    }
  }
  return pos;
}

// Parallel fast path for the dominant real-index layout: every record is
// 0xFD + u64LE (9 bytes — xxh3 hashes < 2^32 occur with p ~ 2e-10). Each
// thread verifies markers and decodes a contiguous slice, so output page
// faults (the main cost at GB scale) are taken concurrently. Returns bytes
// consumed
// (9*count), or -1 when any record is not 9 bytes — caller falls back to
// the scalar decoder.
int64_t dx_decode_u64_fixed9(const uint8_t* buf, int64_t len, int64_t count,
                             uint64_t* out, int32_t n_threads) {
  if (count < 0 || len < 9 * count) return -1;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 16) n_threads = 16;
  std::atomic<bool> ok{true};
  auto work = [&](int64_t lo, int64_t hi) {
    const uint8_t* p = buf + 9 * lo;
    for (int64_t i = lo; i < hi; i++, p += 9) {
      if (*p != 253) {
        ok.store(false, std::memory_order_relaxed);
        return;
      }
      memcpy(&out[i], p + 1, 8);
    }
  };
  if (n_threads == 1 || count < 1'000'000) {
    work(0, count);
  } else {
    std::vector<std::thread> ts;
    int64_t per = (count + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      int64_t lo = t * per, hi = std::min<int64_t>(count, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  return ok.load() ? 9 * count : -1;
}

// Parallel encode for values that are ALL > 0xFFFFFFFF (every record is
// 0xFD + u64LE; the caller checks the precondition — real xxh3 hashes
// virtually always satisfy it). Threads write disjoint 9-byte slices, so
// output page faults are taken concurrently. Returns bytes written.
int64_t dx_encode_u64_fixed9(const uint64_t* vals, int64_t count,
                             uint8_t* out, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 16) n_threads = 16;
  auto work = [&](int64_t lo, int64_t hi) {
    uint8_t* p = out + 9 * lo;
    for (int64_t i = lo; i < hi; i++, p += 9) {
      *p = 253;
      memcpy(p + 1, &vals[i], 8);
    }
  };
  if (n_threads == 1 || count < 1'000'000) {
    work(0, count);
  } else {
    std::vector<std::thread> ts;
    int64_t per = (count + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      int64_t lo = t * per, hi = std::min<int64_t>(count, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  return 9 * count;
}

// Encode `count` u64s into out (caller allocates >= 9*count). Returns bytes
// written.
int64_t dx_encode_u64_varint(const uint64_t* vals, int64_t count,
                             uint8_t* out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < count; i++) {
    uint64_t v = vals[i];
    if (v <= 250) {
      out[pos++] = (uint8_t)v;
    } else if (v <= 0xFFFF) {
      out[pos] = 251;
      uint16_t x = (uint16_t)v;
      memcpy(out + pos + 1, &x, 2);
      pos += 3;
    } else if (v <= 0xFFFFFFFFULL) {
      out[pos] = 252;
      uint32_t x = (uint32_t)v;
      memcpy(out + pos + 1, &x, 4);
      pos += 5;
    } else {
      out[pos] = 253;
      memcpy(out + pos + 1, &v, 8);
      pos += 9;
    }
  }
  return pos;
}

// 1 if strictly increasing (sorted + unique), else 0.
// Merge two sorted-unique u64 arrays into `out` (caller-allocated,
// capacity >= na + nb), dropping cross-duplicates. Returns merged count.
// Single linear pass: this is memory-bandwidth bound, and the index-build
// staging merges it serves are far below the radix-sort crossover.
int64_t dx_u64_merge_sorted_unique(const uint64_t* a, int64_t na,
                                   const uint64_t* b, int64_t nb,
                                   uint64_t* out) {
  int64_t i = 0, j = 0, o = 0;
  while (i < na && j < nb) {
    uint64_t va = a[i], vb = b[j];
    if (va < vb) {
      out[o++] = va;
      i++;
    } else if (vb < va) {
      out[o++] = vb;
      j++;
    } else {
      out[o++] = va;
      i++;
      j++;
    }
  }
  if (i < na) {
    memcpy(out + o, a + i, (size_t)(na - i) * 8);
    o += na - i;
  }
  if (j < nb) {
    memcpy(out + o, b + j, (size_t)(nb - j) * 8);
    o += nb - j;
  }
  return o;
}

// A \ B for sorted-unique u64 arrays (one linear pass; out capacity >= na).
int64_t dx_u64_diff_sorted_unique(const uint64_t* a, int64_t na,
                                  const uint64_t* b, int64_t nb,
                                  uint64_t* out) {
  int64_t i = 0, j = 0, o = 0;
  while (i < na && j < nb) {
    uint64_t va = a[i], vb = b[j];
    if (va < vb) out[o++] = a[i++];
    else if (vb < va) j++;
    else { i++; j++; }
  }
  if (i < na) {
    memcpy(out + o, a + i, (size_t)(na - i) * 8);
    o += na - i;
  }
  return o;
}

int dx_u64_sorted_unique(const uint64_t* vals, int64_t count) {
  for (int64_t i = 1; i < count; i++)
    if (vals[i] <= vals[i - 1]) return 0;
  return 1;
}

// LSD radix sort of the low 56 bits (callers partition by the top byte
// first, so it is constant within a run). Stable counting sort per byte.
static void radix_sort_u64_low56(uint64_t* a, int64_t n,
                                 std::vector<uint64_t>& scratch) {
  if (n < 2048) {
    std::sort(a, a + n);
    return;
  }
  if ((int64_t)scratch.size() < n) scratch.resize(n);
  uint64_t* src = a;
  uint64_t* dst = scratch.data();
  int64_t hist[256];
  for (int pass = 0; pass < 7; pass++) {
    const int shift = 8 * pass;
    memset(hist, 0, sizeof hist);
    for (int64_t i = 0; i < n; i++) hist[(src[i] >> shift) & 255]++;
    int64_t acc = 0;
    for (int b = 0; b < 256; b++) {
      int64_t c = hist[b];
      hist[b] = acc;
      acc += c;
    }
    for (int64_t i = 0; i < n; i++) dst[hist[(src[i] >> shift) & 255]++] = src[i];
    std::swap(src, dst);
  }
  if (src != a) memcpy(a, src, (size_t)n * 8);
}

// In-place parallel sort + dedup; returns the unique count. Used by the
// index-build merge (the reference accumulates into an FxHashSet,
// ref: src/index.rs:266-284; our sorted-array representation makes the
// merge a sort): MSB-byte partition (xxh3 keys are uniform, so buckets
// balance), per-bucket LSD radix across threads, one dedup pass.
int64_t dx_u64_sort_unique(uint64_t* vals, int64_t n, int32_t n_threads) {
  if (n <= 1) return n;
  if (n_threads < 1) n_threads = 1;
  int hw = (int)std::thread::hardware_concurrency();
  if (hw > 0 && n_threads > hw) n_threads = hw;
  if (n < (1 << 16)) {
    std::sort(vals, vals + n);
  } else {
    const int T = n_threads;
    std::vector<uint64_t> tmp(n);
    std::vector<std::array<int64_t, 256>> th_counts(T);
    std::vector<std::thread> th;
    for (int t = 0; t < T; t++)
      th.emplace_back([&, t] {
        auto& c = th_counts[t];
        c.fill(0);
        int64_t lo = n * t / T, hi = n * (t + 1) / T;
        for (int64_t i = lo; i < hi; i++) c[vals[i] >> 56]++;
      });
    for (auto& x : th) x.join();
    th.clear();
    // bucket starts, then per-thread scatter cursors within each bucket
    std::array<int64_t, 257> starts{};
    for (int b = 0; b < 256; b++) {
      starts[b + 1] = starts[b];
      for (int t = 0; t < T; t++) starts[b + 1] += th_counts[t][b];
    }
    std::vector<std::array<int64_t, 256>> cur(T);
    for (int b = 0; b < 256; b++) {
      int64_t off = starts[b];
      for (int t = 0; t < T; t++) {
        cur[t][b] = off;
        off += th_counts[t][b];
      }
    }
    for (int t = 0; t < T; t++)
      th.emplace_back([&, t] {
        auto& c = cur[t];
        int64_t lo = n * t / T, hi = n * (t + 1) / T;
        for (int64_t i = lo; i < hi; i++) tmp[c[vals[i] >> 56]++] = vals[i];
      });
    for (auto& x : th) x.join();
    th.clear();
    std::atomic<int> next{0};
    for (int t = 0; t < T; t++)
      th.emplace_back([&] {
        std::vector<uint64_t> scratch;
        for (;;) {
          int b = next.fetch_add(1);
          if (b >= 256) return;
          radix_sort_u64_low56(tmp.data() + starts[b],
                               starts[b + 1] - starts[b], scratch);
        }
      });
    for (auto& x : th) x.join();
    memcpy(vals, tmp.data(), (size_t)n * 8);
  }
  int64_t out = 1;
  for (int64_t i = 1; i < n; i++)
    if (vals[i] != vals[out - 1]) vals[out++] = vals[i];
  return out;
}
// ---------------------------------------------------------------------------
// Streaming index writers. The index stream is bincode-standard
// [fv,k,w][count varint][hash varints] + an optional raw trailer
// (provenance). These encode in parallel chunks and keep the file write
// sequential.
// ---------------------------------------------------------------------------

static inline size_t encode_varint_into(uint64_t v, uint8_t* p) {
  if (v <= 250) {
    p[0] = (uint8_t)v;
    return 1;
  }
  if (v <= 0xFFFF) {
    p[0] = 251;
    uint16_t x = (uint16_t)v;
    memcpy(p + 1, &x, 2);
    return 3;
  }
  if (v <= 0xFFFFFFFFULL) {
    p[0] = 252;
    uint32_t x = (uint32_t)v;
    memcpy(p + 1, &x, 4);
    return 5;
  }
  p[0] = 253;
  memcpy(p + 1, &v, 8);
  return 9;
}

static void encode_block(const uint64_t* v, int64_t n,
                         std::vector<uint8_t>& out) {
  out.resize((size_t)n * 9);
  uint8_t* p = out.data();
  for (int64_t i = 0; i < n; i++) p += encode_varint_into(v[i], p);
  out.resize((size_t)(p - out.data()));
}

// Ordered parallel encode+write of pre-built blocks. `get` fills block i's
// keys (ptr, len); workers encode ahead, the caller's thread writes blocks
// strictly in order. Returns false on I/O error.
namespace idxw {
struct Ctx {
  std::function<void(int, const uint64_t**, int64_t*)> get;
  int n_blocks = 0;
  std::atomic<int> next{0};
  std::vector<std::vector<uint8_t>> bufs;
  std::vector<std::atomic<int>> done;  // 0 pending, 1 ready
  std::mutex mu;
  std::condition_variable cv;
  // written buffers recycle through here instead of being freed — each
  // fresh allocation would fault its pages in again
  std::vector<std::vector<uint8_t>> pool;
};
}  // namespace idxw

static bool write_blocks_ordered(FILE* f, int n_blocks, int n_threads,
                                 const std::function<void(int, const uint64_t**,
                                                          int64_t*)>& get) {
  idxw::Ctx c;
  c.get = get;
  c.n_blocks = n_blocks;
  c.bufs.resize(n_blocks);
  c.done = std::vector<std::atomic<int>>(n_blocks);
  for (auto& d : c.done) d.store(0);
  if (n_threads < 1) n_threads = 1;
  int hw = (int)std::thread::hardware_concurrency();
  if (hw > 0 && n_threads > hw) n_threads = hw;
  // cap look-ahead memory: workers stall until the writer catches up
  std::atomic<int> written{0};
  const int ahead = n_threads * 2 + 2;
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; t++)
    ts.emplace_back([&] {
      for (;;) {
        int i = c.next.fetch_add(1);
        if (i >= c.n_blocks) return;
        while (i - written.load(std::memory_order_acquire) > ahead)
          std::this_thread::yield();
        const uint64_t* keys;
        int64_t n;
        c.get(i, &keys, &n);
        std::vector<uint8_t> buf;
        {
          std::lock_guard<std::mutex> g(c.mu);
          if (!c.pool.empty()) {
            buf = std::move(c.pool.back());
            c.pool.pop_back();
          }
        }
        encode_block(keys, n, buf);
        std::lock_guard<std::mutex> g(c.mu);
        c.bufs[i] = std::move(buf);
        c.done[i].store(1, std::memory_order_release);
        c.cv.notify_all();
      }
    });
  bool ok = true;
  for (int i = 0; i < n_blocks; i++) {
    {
      std::unique_lock<std::mutex> g(c.mu);
      c.cv.wait(g, [&] { return c.done[i].load(std::memory_order_acquire) != 0; });
    }
    if (ok && !c.bufs[i].empty() &&
        fwrite(c.bufs[i].data(), 1, c.bufs[i].size(), f) != c.bufs[i].size())
      ok = false;
    {
      std::lock_guard<std::mutex> g(c.mu);
      c.pool.emplace_back(std::move(c.bufs[i]));
    }
    written.store(i + 1, std::memory_order_release);
  }
  for (auto& t : ts) t.join();
  return ok;
}

// Write a full index stream from an already sorted-unique key array to
// `path` ("-" = stdout, flushed and left open). Returns 0 on success, -1 on
// I/O error (message in errbuf).
int dx_index_write_sorted(const uint64_t* keys, int64_t n, const char* path,
                          int32_t fv, int32_t k, int32_t w,
                          const uint8_t* trailer, int64_t trailer_len,
                          int32_t n_threads, char* errbuf,
                          int64_t errbuf_cap) {
  auto set_err = [&](const char* m) {
    if (errbuf && errbuf_cap > 0) snprintf(errbuf, (size_t)errbuf_cap, "%s", m);
  };
  FILE* f = strcmp(path, "-") == 0 ? stdout : fopen(path, "wb");
  if (!f) {
    set_err("Failed to create index file");
    return -1;
  }
  uint8_t head[12];
  head[0] = (uint8_t)fv;
  head[1] = (uint8_t)k;
  head[2] = (uint8_t)w;
  size_t hlen = 3 + encode_varint_into((uint64_t)n, head + 3);
  bool ok = fwrite(head, 1, hlen, f) == hlen;
  const int64_t kChunk = 4'000'000;
  int n_blocks = (int)((n + kChunk - 1) / kChunk);
  if (ok && n_blocks > 0)
    ok = write_blocks_ordered(
        f, n_blocks, n_threads,
        [&](int i, const uint64_t** kp, int64_t* np) {
          int64_t lo = (int64_t)i * kChunk;
          *kp = keys + lo;
          *np = std::min<int64_t>(kChunk, n - lo);
        });
  if (ok && trailer_len > 0)
    ok = fwrite(trailer, 1, (size_t)trailer_len, f) == (size_t)trailer_len;
  if ((f == stdout ? fflush(f) : fclose(f)) != 0) ok = false;
  if (!ok) {
    set_err("index write failed");
    return -1;
  }
  return 0;
}


}  // extern "C"

// Advise THP for a big buffer (DEACON_THP=1): where nested-paging faults
// are expensive and THP is in madvise mode, 2 MB pages cut first-touch
// fault counts ~500x. With defrag=madvise, direct compaction can cost
// more than that saves on these progressively-touched buffers, so the
// advice is opt-in. Safe no-op when unsupported.
static void advise_huge(void* p, size_t n) {
#ifdef MADV_HUGEPAGE
  static const bool on = [] {
    const char* e = getenv("DEACON_THP");
    return e && e[0] == '1';
  }();
  if (!on || !p || n < (4u << 20)) return;
  uintptr_t lo = ((uintptr_t)p + 4095) & ~(uintptr_t)4095;
  uintptr_t hi = ((uintptr_t)p + n) & ~(uintptr_t)4095;
  if (hi > lo) madvise((void*)lo, hi - lo, MADV_HUGEPAGE);
#endif
}

extern "C" {

// Scatter-accumulator for index build: batches of raw (duplicate-bearing)
// hashes are scattered by top byte as they arrive, so the final stage
// sorts 256 small cache-friendly buckets instead of one giant array (no
// concat, no global scatter passes) and streams them to disk in order.
struct RunAcc {
  std::vector<uint64_t> buckets[256];
  // per-bucket sorted-unique lengths after finish()
  int64_t uniq[256];
  size_t advised_cap[256] = {};
};

void* dx_runacc_new(int64_t capacity_hint) {
  auto* a = new RunAcc();
  if (capacity_hint > 0) {
    size_t per = (size_t)(capacity_hint / 256 + capacity_hint / 2048 + 1024);
    for (int b = 0; b < 256; b++) {
      a->buckets[b].reserve(per);
      advise_huge(a->buckets[b].data(), per * 8);
      a->advised_cap[b] = a->buckets[b].capacity();
    }
  }
  return a;
}

void dx_runacc_free(void* h) { delete static_cast<RunAcc*>(h); }

void dx_runacc_add(void* h, const uint64_t* keys, int64_t n) {
  auto* a = static_cast<RunAcc*>(h);
  for (int64_t i = 0; i < n; i++) a->buckets[keys[i] >> 56].push_back(keys[i]);
  for (int b = 0; b < 256; b++)
    if (a->buckets[b].capacity() != a->advised_cap[b]) {
      advise_huge(a->buckets[b].data(), a->buckets[b].capacity() * 8);
      a->advised_cap[b] = a->buckets[b].capacity();
    }
}

// Sort+dedup each bucket (parallel), then stream the encoded index to
// `path` with a patched count. Returns the distinct-key count, or -1 on
// I/O error, or -2 when the count cannot be patched canonically (caller
// falls back; only possible for counts <= 0xFFFF or > 0xFFFFFFFF).
int64_t dx_runacc_finish_write(void* h, const char* path, int32_t fv,
                               int32_t k, int32_t w, const uint8_t* trailer,
                               int64_t trailer_len, int32_t n_threads,
                               char* errbuf, int64_t errbuf_cap) {
  auto* a = static_cast<RunAcc*>(h);
  auto set_err = [&](const char* m) {
    if (errbuf && errbuf_cap > 0) snprintf(errbuf, (size_t)errbuf_cap, "%s", m);
  };
  if (n_threads < 1) n_threads = 1;
  int hw = (int)std::thread::hardware_concurrency();
  if (hw > 0 && n_threads > hw) n_threads = hw;
  FILE* f = fopen(path, "wb");
  if (!f) {
    set_err("Failed to create index file");
    return -1;
  }
  // header + 252-form count placeholder, patched after the stream. Sort +
  // dedup run lazily inside the encode workers, so late buckets sort
  // while early buckets are being written — the sort phase hides behind
  // the disk write instead of preceding it.
  uint8_t head[8] = {(uint8_t)fv, (uint8_t)k, (uint8_t)w, 252, 0, 0, 0, 0};
  bool ok = fwrite(head, 1, 8, f) == 8;
  static thread_local std::vector<uint64_t> sort_scratch;
  if (ok)
    ok = write_blocks_ordered(
        f, 256, n_threads, [&](int i, const uint64_t** kp, int64_t* np) {
          auto& v = a->buckets[i];
          radix_sort_u64_low56(v.data(), (int64_t)v.size(), sort_scratch);
          int64_t out = v.empty() ? 0 : 1;
          for (size_t j = 1; j < v.size(); j++)
            if (v[j] != v[out - 1]) v[out++] = v[j];
          a->uniq[i] = out;
          *kp = v.data();
          *np = out;
        });
  int64_t total = 0;
  for (int b = 0; b < 256; b++) total += a->uniq[b];
  if (ok && trailer_len > 0)
    ok = fwrite(trailer, 1, (size_t)trailer_len, f) == (size_t)trailer_len;
  if (ok && total > 0xFFFF && total <= 0xFFFFFFFFLL) {
    uint32_t cnt = (uint32_t)total;
    ok = fseek(f, 4, SEEK_SET) == 0 && fwrite(&cnt, 1, 4, f) == 4;
  }
  if (fclose(f) != 0) ok = false;
  if (!ok) {
    set_err("index write failed");
    return -1;
  }
  // non-patchable count (tiny or >2^32): discovered post-sort here; the
  // file is discarded and the caller exports + takes the generic path
  if (total <= 0xFFFF || total > 0xFFFFFFFFLL) {
    remove(path);
    return -2;
  }
  return total;
}

// After a finish attempt returned -2: distinct count and sorted export
// (bucket order == global order) so the caller can take the generic path.
int64_t dx_runacc_unique_count(void* h) {
  auto* a = static_cast<RunAcc*>(h);
  int64_t total = 0;
  for (int b = 0; b < 256; b++) total += a->uniq[b];
  return total;
}

void dx_runacc_export_sorted(void* h, uint64_t* out) {
  auto* a = static_cast<RunAcc*>(h);
  for (int b = 0; b < 256; b++) {
    memcpy(out, a->buckets[b].data(), (size_t)a->uniq[b] * 8);
    out += a->uniq[b];
  }
}

// ---------------------------------------------------------------------------
// Counting insert set (dx_cset_*): the reference's FxHashSet role on the
// BUILD side (ref: src/index.rs:96-107, 266-284) — batch inserts return how
// many keys were new, so the per-sequence running total `index build`
// prints is O(new keys) instead of a re-sort or merge of the accumulated
// set (which cost minutes at panhuman scale). 256 partitions by top byte,
// each an open-addressing linear-probe table; a batch is bucketed once,
// then threads own disjoint partitions, so no locks. Export sorts each
// partition by its low 56 bits (top byte is constant within a partition)
// and concatenates in partition order — globally sorted, ready to write.
// ---------------------------------------------------------------------------

}  // extern "C"

namespace {

struct CSet {
  struct Part {
    uint64_t* slots = nullptr;  // mmap-backed: fresh anon pages are zero
    size_t n_slots = 0;         // LAZILY, so a big capacity hint costs
    int64_t used = 0;           // virtual address space, not page zeroing
    uint32_t mask = 0;
    ~Part() {
      if (slots) munmap(slots, n_slots * 8);
    }
  };
  std::array<Part, 256> parts;
  bool has_zero = false;

  static inline int64_t home(uint64_t v, uint32_t mask) {
    // bits below the partition byte select the slot (keys are xxh3 uniform)
    return (int64_t)((v >> 20) & mask);
  }

  static bool alloc(Part& p, size_t ns) {
    void* m = mmap(nullptr, ns * 8, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (m == MAP_FAILED) return false;
    advise_huge(m, ns * 8);  // opt-in via DEACON_THP=1
    p.slots = (uint64_t*)m;
    p.n_slots = ns;
    p.mask = (uint32_t)(ns - 1);
    return true;
  }

  static void grow(Part& p) {
    uint64_t* old = p.slots;
    size_t old_n = p.n_slots;
    if (!alloc(p, old_n ? old_n * 2 : 4096))
      throw std::bad_alloc();
    for (size_t j = 0; j < old_n; j++) {
      if (j + 16 < old_n && old[j + 16])
        __builtin_prefetch(&p.slots[home(old[j + 16], p.mask)], 1);
      uint64_t v = old[j];
      if (!v) continue;
      int64_t i = home(v, p.mask);
      while (p.slots[i]) i = (i + 1) & p.mask;
      p.slots[i] = v;
    }
    if (old) munmap(old, old_n * 8);
  }

  // insert keys[lo, hi) (all in partition `b`); returns #new
  int64_t insert_range(int b, const uint64_t* keys, int64_t lo, int64_t hi) {
    Part& p = parts[b];
    int64_t added = 0;
    constexpr int64_t D = 24;  // prefetch distance: inserts are random
    for (int64_t j = lo; j < hi; j++) {  // touches of a multi-GB table and
      if (j + D < hi) {                  // run at DRAM latency otherwise
        uint64_t vv = keys[j + D];
        if (vv) __builtin_prefetch(&p.slots[home(vv, p.mask)], 1);
      }
      uint64_t v = keys[j];
      if (v == 0) {
        if (!has_zero) {
          has_zero = true;  // partition 0 only; single-threaded per part
          added++;
        }
        continue;
      }
      if (p.used * 4 >= (int64_t)p.n_slots * 3) grow(p);
      int64_t i = home(v, p.mask);
      for (;;) {
        uint64_t s = p.slots[i];
        if (s == v) break;
        if (s == 0) {
          p.slots[i] = v;
          p.used++;
          added++;
          break;
        }
        i = (i + 1) & p.mask;
      }
    }
    return added;
  }

  int64_t size() const {
    int64_t n = has_zero ? 1 : 0;
    for (auto& p : parts) n += p.used;
    return n;
  }
};

}  // namespace

extern "C" {

void* dx_cset_new(int64_t capacity_hint) {
  auto* s = new CSet();
  size_t per = 4096;
  if (capacity_hint > 0)
    while ((int64_t)per * 3 < capacity_hint / 256 * 4) per *= 2;
  // Cap the pre-size well below the hint: a small build inside a huge
  // pre-sized table pays one page fault per insert (the 400M default hint
  // vs a 25M build = 2M sparse faults), while growth rehashes are
  // amortized linear with good locality.
  if (per > (size_t)1 << 18) per = (size_t)1 << 18;
  for (auto& p : s->parts)
    if (!CSet::alloc(p, per)) {
      delete s;
      return nullptr;
    }
  return s;
}

void dx_cset_free(void* h) { delete static_cast<CSet*>(h); }

int64_t dx_cset_size(void* h) { return static_cast<CSet*>(h)->size(); }

// Returns the number of keys not previously present.
int64_t dx_cset_insert(void* h, const uint64_t* keys, int64_t n,
                       int32_t n_threads) {
  CSet& s = *static_cast<CSet*>(h);
  if (n <= 0) return 0;
  int T = n_threads > 0 ? n_threads
                        : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if (T > 16) T = 16;
  // bucket the batch by top byte (one pass), then threads own disjoint
  // contiguous partition ranges of the scratch array. The scratch is
  // reused across calls (one caller thread under the GIL): a fresh
  // value-initialized vector per insert would cost a memset of the batch
  // plus its page faults per batch at genome scale.
  static thread_local std::vector<uint64_t> tmp_tls;
  auto& tmp = tmp_tls;  // bind the caller's instance: the worker lambdas
  if (tmp.size() < (size_t)n) {  // below must NOT re-resolve thread_local
    tmp.resize((size_t)n);
    advise_huge(tmp.data(), tmp.size() * 8);
  }
  std::array<int64_t, 257> starts{};
  {
    std::array<int64_t, 256> cnt{};
    for (int64_t i = 0; i < n; i++) cnt[keys[i] >> 56]++;
    for (int b = 0; b < 256; b++) starts[b + 1] = starts[b] + cnt[b];
    std::array<int64_t, 256> cur;
    for (int b = 0; b < 256; b++) cur[b] = starts[b];
    for (int64_t i = 0; i < n; i++) tmp[cur[keys[i] >> 56]++] = keys[i];
  }
  if (T == 1 || n < 65536) {
    int64_t added = 0;
    for (int b = 0; b < 256; b++)
      added += s.insert_range(b, tmp.data(), starts[b], starts[b + 1]);
    return added;
  }
  std::vector<int64_t> th_added(T, 0);
  std::vector<std::thread> th;
  for (int t = 0; t < T; t++)
    th.emplace_back([&, t] {
      int64_t a = 0;
      for (int b = t; b < 256; b += T)
        a += s.insert_range(b, tmp.data(), starts[b], starts[b + 1]);
      th_added[t] = a;
    });
  for (auto& x : th) x.join();
  int64_t added = 0;
  for (int64_t a : th_added) added += a;
  return added;
}

// Writes the set's keys to `out` in ascending order; returns the count.
// The set remains valid.
int64_t dx_cset_export_sorted(void* h, uint64_t* out, int32_t n_threads) {
  CSet& s = *static_cast<CSet*>(h);
  int T = n_threads > 0 ? n_threads
                        : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if (T > 16) T = 16;
  std::array<int64_t, 257> offs{};
  offs[0] = s.has_zero ? 1 : 0;
  if (s.has_zero) out[0] = 0;
  for (int b = 0; b < 256; b++) offs[b + 1] = offs[b] + s.parts[b].used;
  std::atomic<int> next{0};
  std::vector<std::thread> th;
  for (int t = 0; t < T; t++)
    th.emplace_back([&] {
      std::vector<uint64_t> scratch;
      for (;;) {
        int b = next.fetch_add(1);
        if (b >= 256) return;
        const CSet::Part& p = s.parts[b];
        uint64_t* dst = out + offs[b];
        int64_t m = 0;
        for (size_t j = 0; j < p.n_slots; j++)
          if (p.slots[j]) dst[m++] = p.slots[j];
        radix_sort_u64_low56(dst, m, scratch);
      }
    });
  for (auto& x : th) x.join();
  return offs[256];
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Single-miss membership probe (the host-side analogue of the device
// engine's HBM probe; plays the reference's FxHashSet role,
// ref: src/index.rs:98, src/filter_common.rs:129-155).
//
// Index keys are xxh3 outputs — already uniform — and arrive sorted, so a
// linear-probing table keyed by the top bits needs no rehash and builds in
// ONE sequential pass: inserting in sorted order keeps home buckets
// monotone, so each key lands at max(home, cursor) and table values stay
// globally sorted. Lookups scan forward from `v >> shift` and stop at an
// empty slot or any value > v — one random cache line touched per probe
// (an offset table plus binary search would take two dependent misses).
// Long-lived processes back the slots with THP (DEACON_PROBE_THP=1) to
// cut TLB misses on multi-GB tables.
// ---------------------------------------------------------------------------

}  // extern "C"

namespace {

struct ProbeTable {
  uint64_t* slots = nullptr;
  size_t map_bytes = 0;  // mmap length (n_slots + spill tail)
  int64_t n_slots = 0;   // exact ceil(n / kProbeLoad) — NOT a power of two:
                         // the home mapping is fastrange (mulhi), which is
                         // monotone in the key just like top-bits, so the
                         // sorted single-pass fill and the value>v lookup
                         // cutoff both still hold, and a panhuman-scale
                         // table costs 8/kProbeLoad bytes/key instead of
                         // up to 2.67x that from pow2 rounding
  bool has_zero = false; // 0 is the empty sentinel; a real 0 key is tracked
                         // out of band
  uint64_t mix = 1;  // 1 = identity; kProbeMix when keys were scrambled
  ~ProbeTable() {
    if (slots) munmap(slots, map_bytes);
  }
};

// Expected lookup cost stays ~1 cache line at this load: stored values are
// globally sorted, so a miss stops at the first value > v, after the mean
// displacement (~(1/(1-a)-1)/2 ~ 2.8 slots), not the full cluster.
constexpr double kProbeLoad = 0.80;

static inline int64_t probe_home(uint64_t v, int64_t n_slots) {
  return (int64_t)((unsigned __int128)v * (uint64_t)n_slots >> 64);
}
constexpr int64_t kProbeSpill = 1 << 16;  // top-of-range clusters overflow
                                          // past n_slots into this zero tail
constexpr int64_t kProbeMaxDisp = kProbeSpill / 2;  // displacement beyond
                                                    // this => keys not
                                                    // uniform => scramble
constexpr int kProbeAhead = 24;
constexpr uint64_t kProbeMix = 0x9E3779B97F4A7C15ULL;  // odd => bijective

inline bool probe_lookup(const ProbeTable& t, uint64_t v) {
  if (v == 0) return t.has_zero;
  v *= t.mix;  // identity (mix=1) for real xxh3-uniform indexes
  int64_t pos = probe_home(v, t.n_slots);
  for (;;) {
    uint64_t e = t.slots[pos];
    if (e == v) return true;
    if (e == 0 || e > v) return false;
    pos++;
  }
}

// One sequential pass over sorted unique nonzero keys: home buckets are
// monotone, so each key lands at max(home, cursor) and stored values stay
// globally sorted (which is what lets lookups stop at any value > v).
// Returns false if some key displaces implausibly far from home — the
// signature of a non-uniform key distribution.
static bool probe_fill(ProbeTable* t, const uint64_t* keys, int64_t n) {
  int64_t cursor = 0;
  for (int64_t i = 0; i < n; i++) {
    uint64_t v = keys[i];
    if (v == 0) {
      t->has_zero = true;
      continue;
    }
    int64_t home = probe_home(v, t->n_slots);
    int64_t pos = home > cursor ? home : cursor;
    if (pos - home > kProbeMaxDisp) return false;
    t->slots[pos] = v;
    cursor = pos + 1;
  }
  return true;
}

}  // namespace

extern "C" {

// Builds the linear-probing table from a sorted unique array. The keys
// array is NOT referenced after this returns.
//
// Real index keys are xxh3 outputs, uniform over the full u64 range, so the
// direct top-bits build succeeds. Structured or range-compressed keys (e.g.
// synthetic test indexes drawn from [0, 2^63)) would overload part of the
// table; the fill detects that via a displacement bound and rebuilds with
// every key multiplied by an odd mixing constant (bijective, so membership
// is preserved) and re-sorted, which redistributes any input uniformly.
void* dx_probe_build(const uint64_t* keys, int64_t n) {
  auto* t = new ProbeTable();
  t->n_slots = (int64_t)((double)(n < 1024 ? 1024 : n) / kProbeLoad) + 1;
  t->map_bytes = (size_t)(t->n_slots + kProbeSpill) * 8;
  t->slots = (uint64_t*)mmap(nullptr, t->map_bytes, PROT_READ | PROT_WRITE,
                             MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (t->slots == MAP_FAILED) {
    t->slots = nullptr;
    delete t;
    return nullptr;
  }
#ifdef MADV_HUGEPAGE
  // THP cuts TLB misses on multi-GB tables but (with defrag=madvise) can
  // cost seconds of synchronous direct compaction at first touch on a
  // fragmented host: worth it only for long-lived processes (the server
  // sets DEACON_PROBE_THP=1), not for a one-shot CLI run.
  const char* thp = getenv("DEACON_PROBE_THP");
  if (thp && thp[0] == '1' && n >= 100'000'000)
    madvise(t->slots, t->map_bytes, MADV_HUGEPAGE);
#endif
  if (probe_fill(t, keys, n)) return t;
  // non-uniform keys: scramble, re-sort, rebuild
  memset(t->slots, 0, t->map_bytes);
  t->has_zero = false;
  t->mix = kProbeMix;
  std::vector<uint64_t> mixed(n);
  for (int64_t i = 0; i < n; i++) mixed[i] = keys[i] * kProbeMix;
  std::sort(mixed.begin(), mixed.end());
  if (!probe_fill(t, mixed.data(), n)) {  // can't happen for real inputs
    delete t;
    return nullptr;
  }
  // a zero KEY scrambles to zero; probe_fill flagged it as has_zero, which
  // matches lookup's pre-scramble v==0 check. Nothing more to do.
  return t;
}

// ---- probe sidecar cache --------------------------------------------------
// Building the probe table at panhuman scale is one sequential pass, but
// over GBs of first-touch page zeroing; a sidecar file next to the index
// (<index>.probe) lets later filter runs mmap the finished table instead,
// and skip decoding the index's hash array entirely. The sidecar is bound
// to the index file by (key count, file size, mtime_ns); its layout is
// the JAX package's, so either package loads the other's.

struct ProbeFileHdr {
  char magic[8];  // "DXPROBE1"
  int64_t key_count;
  int64_t n_slots;
  int64_t idx_size;
  int64_t idx_mtime_ns;
  uint64_t mix;
  uint8_t has_zero;
  uint8_t pad[7];
};
static_assert(sizeof(ProbeFileHdr) == 56, "sidecar header layout");
constexpr int64_t kProbeFileDataOff = 4096;  // page-aligned slots blob

// Returns 0 on success. Writes tmp + rename so readers never see a torn file.
int dx_probe_save(void* handle, const char* path, int64_t key_count,
                  int64_t idx_size, int64_t idx_mtime_ns) {
  auto* t = static_cast<ProbeTable*>(handle);
  // pid-unique temp name: two concurrent first-runs would otherwise
  // interleave writes into one tmp file and rename the corrupt result
  std::string tmp =
      std::string(path) + ".tmp." + std::to_string((long)getpid());
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  ProbeFileHdr h{};
  memcpy(h.magic, "DXPROBE1", 8);
  h.key_count = key_count;
  h.n_slots = t->n_slots;
  h.idx_size = idx_size;
  h.idx_mtime_ns = idx_mtime_ns;
  h.mix = t->mix;
  h.has_zero = t->has_zero ? 1 : 0;
  uint8_t zero_page[kProbeFileDataOff] = {};
  memcpy(zero_page, &h, sizeof(h));
  bool ok = fwrite(zero_page, 1, kProbeFileDataOff, f) == kProbeFileDataOff &&
            fwrite(t->slots, 1, t->map_bytes, f) == t->map_bytes;
  ok = fclose(f) == 0 && ok;
  if (!ok || rename(tmp.c_str(), path) != 0) {
    remove(tmp.c_str());
    return -1;
  }
  return 0;
}

// Returns a read-only file-backed ProbeTable, or NULL when the sidecar is
// missing, malformed, or does not match the index file identity.
void* dx_probe_load(const char* path, int64_t expect_count, int64_t idx_size,
                    int64_t idx_mtime_ns) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  ProbeFileHdr h{};
  struct stat st;
  if (read(fd, &h, sizeof(h)) != (ssize_t)sizeof(h) || fstat(fd, &st) != 0 ||
      memcmp(h.magic, "DXPROBE1", 8) != 0 || h.key_count != expect_count ||
      h.idx_size != idx_size || h.idx_mtime_ns != idx_mtime_ns ||
      h.n_slots <= 0) {
    close(fd);
    return nullptr;
  }
  size_t map_bytes = (size_t)(h.n_slots + kProbeSpill) * 8;
  if ((int64_t)st.st_size != kProbeFileDataOff + (int64_t)map_bytes) {
    close(fd);
    return nullptr;
  }
  void* m = mmap(nullptr, map_bytes, PROT_READ, MAP_PRIVATE, fd,
                 kProbeFileDataOff);
  close(fd);
  if (m == MAP_FAILED) return nullptr;
  // kick off sequential readahead: probes touch the table randomly, and
  // random 4 KB faults from disk are far slower than one streaming pass
  madvise(m, map_bytes, MADV_WILLNEED);
  auto* t = new ProbeTable();
  t->slots = (uint64_t*)m;
  t->map_bytes = map_bytes;
  t->n_slots = h.n_slots;
  t->has_zero = h.has_zero != 0;
  t->mix = h.mix;
  return t;
}

void dx_probe_free(void* handle) {
  delete static_cast<ProbeTable*>(handle);
}

// out[i] = 1 if q[i] is in the table, else 0.
void dx_probe_query(void* handle, const uint64_t* q, int64_t nq,
                    uint8_t* out) {
  const ProbeTable& t = *static_cast<ProbeTable*>(handle);
  for (int64_t i = 0; i < nq; i++) {
    if (i + kProbeAhead < nq)
      __builtin_prefetch(&t.slots[(size_t)probe_home(q[i + kProbeAhead] * t.mix, t.n_slots)]);
    out[i] = probe_lookup(t, q[i]) ? 1 : 0;
  }
}

}  // extern "C"

// ===========================================================================
// Host minimizer-extraction engine
//
// The C++ twin of the NumPy oracle (deacon_tpu_torch/ops/minimizers_np.py)
// and of the device engine: identical scheme, bit-identical outputs
// (enforced by tests/test_torch_native_io.py). Serves the client's host
// extraction — the analogue of the reference's simd-minimizers CPU path
// (ref: src/minimizers.rs:125-191, src/filter_common.rs:211-310).
// ===========================================================================

namespace {

// ---- XXH3-64 small-input paths (seed 0, default secret), matching
// deacon_tpu_torch/utils/xxh3.py bit-for-bit ----
// secret[8..16]^secret[16..24] etc. of the upstream kSecret, seed 0;
// values cross-checked against deacon_tpu_torch/utils/xxh3.py
constexpr uint64_t kBitflip4to8 = 0xc73ab174c5ecd5a2ULL;
constexpr uint64_t kBitflipLo9to16 = 0x6782737bea4239b9ULL;
constexpr uint64_t kBitflipHi9to16 = 0xaf56bc3b0996523aULL;
constexpr uint64_t kPrimeMx2 = 0x9FB21C651E98DF25ULL;
constexpr uint64_t kPrime64_3 = 0x165667919E3779F9ULL;

static inline uint64_t rotl64(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}

static inline uint64_t xxh3_u64(uint64_t v) {
  uint64_t lo32 = v & 0xFFFFFFFFULL, hi32 = v >> 32;
  uint64_t input64 = hi32 | (lo32 << 32);
  uint64_t h = input64 ^ kBitflip4to8;
  h ^= rotl64(h, 49) ^ rotl64(h, 24);
  h *= kPrimeMx2;
  h ^= (h >> 35) + 8ULL;
  h *= kPrimeMx2;
  return h ^ (h >> 28);
}

static inline uint64_t xxh3_u128(uint64_t lo, uint64_t hi) {
  uint64_t il = lo ^ kBitflipLo9to16;
  uint64_t ih = hi ^ kBitflipHi9to16;
  unsigned __int128 m = (unsigned __int128)il * ih;
  uint64_t fold = (uint64_t)m ^ (uint64_t)(m >> 64);
  uint64_t acc = 16ULL + __builtin_bswap64(il) + ih + fold;
  acc ^= acc >> 37;
  acc *= kPrime64_3;
  return acc ^ (acc >> 32);
}

static inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6BU;
  x ^= x >> 13;
  x *= 0xC2B2AE35U;
  x ^= x >> 16;
  return x;
}

// IUPAC->ACGT canonicalisation (index side; ref: src/minimizers.rs:24-43)
struct IupacTable {
  uint8_t map[256];
  IupacTable() {
    for (int i = 0; i < 256; i++) map[i] = 'C';
    auto set = [&](const char* src, char dst) {
      for (const char* p = src; *p; p++) map[(uint8_t)*p] = (uint8_t)dst;
    };
    set("Aa", 'A'); set("Cc", 'C'); set("Gg", 'G'); set("Tt", 'T');
    set("Rr", 'G'); set("Yy", 'C'); set("Ss", 'G'); set("Ww", 'A');
    set("Kk", 'G'); set("Mm", 'C'); set("Bb", 'C'); set("Dd", 'G');
    set("Hh", 'C'); set("Vv", 'G'); set("Nn", 'C');
  }
};
static const IupacTable kIupac;

static inline bool valid_base(uint8_t b) {
  uint8_t u = b & 0xDF;
  return u == 'A' || u == 'C' || u == 'G' || u == 'T';
}

// Scaled Shannon entropy of a k-mer's ACGT composition, float32 math to
// mirror the oracle (ref: src/minimizers.rs:73-121). k < 10 always passes.
static inline float scaled_entropy(const uint8_t* win, int k) {
  float counts[4] = {0, 0, 0, 0};
  float total = 0;
  for (int j = 0; j < k; j++) {
    switch (win[j] & 0xDF) {
      case 'A': counts[0] += 1.0f; total += 1.0f; break;
      case 'C': counts[1] += 1.0f; total += 1.0f; break;
      case 'G': counts[2] += 1.0f; total += 1.0f; break;
      case 'T': counts[3] += 1.0f; total += 1.0f; break;
      default: break;
    }
  }
  if (total <= 0.0f) return 1.0f;
  float acc = 0.0f;
  for (int c = 0; c < 4; c++) {
    if (counts[c] > 0.0f) {
      float p = counts[c] / total;
      acc += p * log2f(p);
    }
  }
  return -acc / 2.0f;
}

// Per-worker scratch for extract_one: reused across records to avoid
// allocation churn in the hot loop.
struct ExtractScratch {
  std::vector<uint32_t> keys;   // selection key per position
  std::vector<uint32_t> pos;    // selected (deduped) window-argmin positions
  std::vector<uint64_t> sfx;    // van Herk block suffix minima
  std::vector<uint64_t> vals;   // canonical k-mer value per position (k<=32)
  std::vector<uint64_t> badbits;  // 1 bit per base, 1 = non-ACGT
  std::vector<uint8_t> canon;     // SIMD index mode: IUPAC-canonicalised seq
};

// true iff no bad bit in [p, p+k) (k <= 32 here, so the window spans at most
// two words)
static inline bool window_clean(const uint64_t* bits, int64_t p, int k) {
  int64_t wi = p >> 6, sh = p & 63;
  uint64_t win = bits[wi] >> sh;
  if (sh) win |= bits[wi + 1] << (64 - sh);
  return (win & ((1ULL << k) - 1)) == 0;
}

#if defined(__AVX512F__) && defined(__AVX512BW__)
// ---- AVX-512 pass 1 -------------------------------------------------------
// The rolling fwd/rc recurrence is a serial ~2-cycle dependency chain per
// base; eight independent lanes (one contiguous chunk of the record each)
// break it. Each lane streams its bytes 8 at a time from one u64
// load; per-step outputs are 8x8-transposed so each lane's values store
// contiguously. Validity moves out of the recurrence into a per-base bad-bit
// mask consulted only at selected positions (same windowed-bitmask idea as
// the reference's filter side, ref: src/filter_common.rs:245-286).

// 1 bit per base, 1 = non-ACGT. Bits at/after n are set (harmless: windows
// never reach them). bits must hold (n >> 6) + 2 words.
static void bad_bitmask(const uint8_t* seq, int64_t n, uint64_t* bits) {
  const __m512i dfm = _mm512_set1_epi8((char)0xDF);
  const __m512i A = _mm512_set1_epi8('A'), C = _mm512_set1_epi8('C');
  const __m512i G = _mm512_set1_epi8('G'), T = _mm512_set1_epi8('T');
  int64_t nb = (n + 63) / 64;
  for (int64_t i = 0; i < nb; i++) {
    int64_t off = i * 64;
    __mmask64 load = (n - off >= 64) ? ~0ULL : ((~0ULL) >> (64 - (n - off)));
    __m512i b = _mm512_maskz_loadu_epi8(load, seq + off);
    __m512i u = _mm512_and_si512(b, dfm);
    __mmask64 ok = _mm512_cmpeq_epi8_mask(u, A) |
                   _mm512_cmpeq_epi8_mask(u, C) |
                   _mm512_cmpeq_epi8_mask(u, G) |
                   _mm512_cmpeq_epi8_mask(u, T);
    bits[i] = ~(uint64_t)ok;
  }
  bits[nb] = ~0ULL;
}

// rows r[s] lane i = lane i's value at step s  ->  cols c[i] = lane i's 8
// consecutive step values
static inline void transpose8x8(const __m512i r[8], __m512i c[8]) {
  __m512i t[8], s[8];
  t[0] = _mm512_unpacklo_epi64(r[0], r[1]);
  t[1] = _mm512_unpackhi_epi64(r[0], r[1]);
  t[2] = _mm512_unpacklo_epi64(r[2], r[3]);
  t[3] = _mm512_unpackhi_epi64(r[2], r[3]);
  t[4] = _mm512_unpacklo_epi64(r[4], r[5]);
  t[5] = _mm512_unpackhi_epi64(r[4], r[5]);
  t[6] = _mm512_unpacklo_epi64(r[6], r[7]);
  t[7] = _mm512_unpackhi_epi64(r[6], r[7]);
  const __m512i iA = _mm512_setr_epi64(0, 1, 8, 9, 4, 5, 12, 13);
  const __m512i iB = _mm512_setr_epi64(2, 3, 10, 11, 6, 7, 14, 15);
  s[0] = _mm512_permutex2var_epi64(t[0], iA, t[2]);
  s[1] = _mm512_permutex2var_epi64(t[1], iA, t[3]);
  s[2] = _mm512_permutex2var_epi64(t[0], iB, t[2]);
  s[3] = _mm512_permutex2var_epi64(t[1], iB, t[3]);
  s[4] = _mm512_permutex2var_epi64(t[4], iA, t[6]);
  s[5] = _mm512_permutex2var_epi64(t[5], iA, t[7]);
  s[6] = _mm512_permutex2var_epi64(t[4], iB, t[6]);
  s[7] = _mm512_permutex2var_epi64(t[5], iB, t[7]);
  const __m512i iC = _mm512_setr_epi64(0, 1, 2, 3, 8, 9, 10, 11);
  const __m512i iD = _mm512_setr_epi64(4, 5, 6, 7, 12, 13, 14, 15);
  c[0] = _mm512_permutex2var_epi64(s[0], iC, s[4]);
  c[1] = _mm512_permutex2var_epi64(s[1], iC, s[5]);
  c[2] = _mm512_permutex2var_epi64(s[2], iC, s[6]);
  c[3] = _mm512_permutex2var_epi64(s[3], iC, s[7]);
  c[4] = _mm512_permutex2var_epi64(s[0], iD, s[4]);
  c[5] = _mm512_permutex2var_epi64(s[1], iD, s[5]);
  c[6] = _mm512_permutex2var_epi64(s[2], iD, s[6]);
  c[7] = _mm512_permutex2var_epi64(s[3], iD, s[7]);
}

static inline __m512i load8_lanes(const uint8_t* base, const int64_t* starts,
                                  int64_t off) {
  // hardware gather: the old 8x memcpy-to-stack + vector reload pattern
  // pays a store-forwarding stall every tile
  const __m512i idx = _mm512_add_epi64(
      _mm512_loadu_si512((const void*)starts), _mm512_set1_epi64(off));
  return _mm512_i64gather_epi64(idx, (const long long*)base, 1);
}

// Vectorized selection-key finalizer: fold 8 u64 canonical values to u32,
// fmix32, keep the top 16 bits. One __m256i of 8 keys per value vector —
// fusing this into pass1's transposed stores saves a separate pass over
// the value planes (keys_from_vals remains as the scalar-path finalizer).
static inline __m256i keys8_avx512(__m512i v) {
  __m256i x = _mm512_cvtepi64_epi32(
      _mm512_xor_si512(v, _mm512_srli_epi64(v, 32)));
  x = _mm256_xor_si256(x, _mm256_srli_epi32(x, 16));
  x = _mm256_mullo_epi32(x, _mm256_set1_epi32((int)0x85EBCA6BU));
  x = _mm256_xor_si256(x, _mm256_srli_epi32(x, 13));
  x = _mm256_mullo_epi32(x, _mm256_set1_epi32((int)0xC2B2AE35U));
  x = _mm256_xor_si256(x, _mm256_srli_epi32(x, 16));
  return _mm256_and_si256(x, _mm256_set1_epi32((int)0xFFFF0000U));
}

// Canonical k-mer value per position, filter-mode codes ((b>>1)&3), k<=32.
// Lanes cover 8 contiguous chunks of L8 = 8*(m/64) positions; the tail
// [8*L8, m) runs the scalar recurrence. Index mode canonicalises into a
// scratch copy first and calls this on the copy (valid bases map to
// themselves so values at kept positions are unchanged). Also emits the
// selection key per position (fmix32 of the folded value, top 16 bits) —
// fused here so the value planes are written and never re-read densely.
static void pass1_avx512(const uint8_t* seq, int64_t n, int k,
                         uint64_t* vals, uint32_t* keys) {
  const int64_t m = n - k + 1;
  const int shift_top = 2 * (k - 1);
  const uint64_t maskv = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const int64_t T = m / 64;
  const int64_t L8 = 8 * T;
  if (T > 0) {
    const __m512i m255 = _mm512_set1_epi64(0xFF);
    const __m512i m3 = _mm512_set1_epi64(3);
    const __m512i m2 = _mm512_set1_epi64(2);
    const __m512i vmask = _mm512_set1_epi64((long long)maskv);
    __m512i fwd = _mm512_setzero_si512(), rc = _mm512_setzero_si512();
    int64_t lane_start[8];
    for (int i = 0; i < 8; i++) lane_start[i] = i * L8;
    // warmup: k-1 bases per lane through the uniform shift-in recurrence;
    // after the main loop's step j, fwd then holds bases [ci+j, ci+j+k).
    for (int64_t t = 0; t < k - 1;) {
      int take = (int)((k - 1 - t) < 8 ? (k - 1 - t) : 8);
      __m512i bytes = load8_lanes(seq, lane_start, t);
      for (int s = 0; s < take; s++) {
        __m512i b = _mm512_and_si512(bytes, m255);
        bytes = _mm512_srli_epi64(bytes, 8);
        __m512i c = _mm512_and_si512(_mm512_srli_epi64(b, 1), m3);
        fwd = _mm512_or_si512(_mm512_srli_epi64(fwd, 2),
                              _mm512_slli_epi64(c, shift_top));
        rc = _mm512_or_si512(
            _mm512_and_si512(_mm512_slli_epi64(rc, 2), vmask),
            _mm512_xor_si512(c, m2));
      }
      t += take;
    }
    for (int64_t tile = 0; tile < T; tile++) {
      int64_t j0 = tile * 8;
      __m512i bytes = load8_lanes(seq, lane_start, k - 1 + j0);
      __m512i rows[8], cols[8];
      for (int s = 0; s < 8; s++) {
        __m512i b = _mm512_and_si512(bytes, m255);
        bytes = _mm512_srli_epi64(bytes, 8);
        __m512i c = _mm512_and_si512(_mm512_srli_epi64(b, 1), m3);
        fwd = _mm512_or_si512(_mm512_srli_epi64(fwd, 2),
                              _mm512_slli_epi64(c, shift_top));
        rc = _mm512_or_si512(
            _mm512_and_si512(_mm512_slli_epi64(rc, 2), vmask),
            _mm512_xor_si512(c, m2));
        rows[s] = _mm512_min_epu64(fwd, rc);
      }
      transpose8x8(rows, cols);
      for (int i = 0; i < 8; i++) {
        _mm512_storeu_si512((void*)(vals + lane_start[i] + j0), cols[i]);
        _mm256_storeu_si256((__m256i*)(keys + lane_start[i] + j0),
                            keys8_avx512(cols[i]));
      }
    }
  }
  // scalar tail [8*L8, m)
  int64_t p0 = 8 * L8;
  if (p0 < m) {
    uint64_t fwd = 0, rc = 0;
    for (int j = 0; j < k - 1; j++) {
      uint64_t c = (seq[p0 + j] >> 1) & 3;
      fwd |= c << (2 * j);
      rc = (rc << 2) | (c ^ 2);
    }
    for (int64_t p = p0; p < m; p++) {
      uint64_t c = (seq[p + k - 1] >> 1) & 3;
      fwd = (p > p0 ? (fwd >> 2) : fwd) | (c << shift_top);
      rc = ((rc << 2) & maskv) | (c ^ 2);
      uint64_t v = fwd <= rc ? fwd : rc;
      vals[p] = v;
      keys[p] = fmix32((uint32_t)v ^ (uint32_t)(v >> 32)) & 0xFFFF0000U;
    }
  }
}
#endif  // __AVX512F__ && __AVX512BW__

#if defined(__AVX512F__) && defined(__AVX512BW__)
// ---- AVX-512 window argmin -----------------------------------------------
// Selection keys carry only 16 bits (top of fmix32), and w fits a u8, so the
// whole scan runs in u32 "pk"s = key | phase — 16 lanes per vector. Layout:
// 16 consecutive w-blocks ride the 16 lanes of one vector; per-block suffix/
// prefix minima are computed phase-by-phase (w vector steps per 16 blocks),
// and each window min combines this block's prefix with the PREVIOUS
// block's suffix — a single cross-lane shift (valignd against the prior
// group's registers). Leftmost tie-break is exact: within a block the
// phase in the pk's low bits resolves ties; across the block pair the
// suffix side (earlier positions) is preferred unless the prefix key is
// strictly smaller.

static void tr16(__m512i m[16]) {  // 16x16 u32 in-place transpose
  __m512i t[16];
  for (int i = 0; i < 16; i += 2) {
    t[i] = _mm512_unpacklo_epi32(m[i], m[i + 1]);
    t[i + 1] = _mm512_unpackhi_epi32(m[i], m[i + 1]);
  }
  for (int i = 0; i < 16; i += 4) {
    m[i] = _mm512_unpacklo_epi64(t[i], t[i + 2]);
    m[i + 1] = _mm512_unpackhi_epi64(t[i], t[i + 2]);
    m[i + 2] = _mm512_unpacklo_epi64(t[i + 1], t[i + 3]);
    m[i + 3] = _mm512_unpackhi_epi64(t[i + 1], t[i + 3]);
  }
  for (int i = 0; i < 4; i++) {
    t[i] = _mm512_shuffle_i32x4(m[i], m[i + 4], 0x88);
    t[i + 4] = _mm512_shuffle_i32x4(m[i], m[i + 4], 0xdd);
    t[i + 8] = _mm512_shuffle_i32x4(m[i + 8], m[i + 12], 0x88);
    t[i + 12] = _mm512_shuffle_i32x4(m[i + 8], m[i + 12], 0xdd);
  }
  for (int i = 0; i < 8; i++) {
    m[i] = _mm512_shuffle_i32x4(t[i], t[i + 8], 0x88);
    m[i + 8] = _mm512_shuffle_i32x4(t[i], t[i + 8], 0xdd);
  }
}

// Requires 2 <= w <= 16, m > w, and keys readable through keys[m + 15]
// (extract_one pads scr.keys). Writes deduplicated window-argmin positions
// to out (caller guarantees m - w + 1 + 16 writable slots — compress
// stores a full vector's worth) and returns the count; a vector resize
// here would value-initialize ~0.5 MB per chunk.
// sfx64 is scratch for the scalar tail.
static int64_t window_argmin_avx512(const uint32_t* keys, int64_t m, int w,
                                    uint32_t* out,
                                    std::vector<uint64_t>& sfx64) {
  const int64_t full_blocks = m / w;
  const int64_t groups = full_blocks / 16;
  uint32_t prev_last = 0xFFFFFFFFu;  // sentinel: first window always emits
  int64_t nout = 0;
  __m512i sfx_prev[17];
  for (int f = 0; f < 17; f++) sfx_prev[f] = _mm512_set1_epi32(-1);
  const __m512i lane_iota = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                              10, 11, 12, 13, 14, 15);
  const __m512i wv = _mm512_set1_epi32(w);
  const __m512i lane_off = _mm512_mullo_epi32(lane_iota, wv);
  const __m512i low16 = _mm512_set1_epi32(0xFFFF);
  for (int64_t g = 0; g < groups; g++) {
    const int64_t base = g * 16 * w;
    __m512i K[16];
    for (int i = 0; i < 16; i++)
      K[i] = _mm512_loadu_si512((const void*)(keys + base + i * w));
    tr16(K);
    __m512i pk[16], sfx[17], win[16];
    for (int f = 0; f < w; f++)
      pk[f] = _mm512_or_si512(K[f], _mm512_set1_epi32(f));
    sfx[w - 1] = pk[w - 1];
    for (int f = w - 2; f >= 0; f--)
      sfx[f] = _mm512_min_epu32(pk[f], sfx[f + 1]);
    sfx[w] = _mm512_set1_epi32(-1);  // window entirely in current block
    __m512i pfx = pk[0];
    __m512i bs_v = _mm512_add_epi32(_mm512_set1_epi32((int)base), lane_off);
    __m512i bs_prev = _mm512_sub_epi32(bs_v, wv);
    for (int f = 0; f < w; f++) {
      if (f) pfx = _mm512_min_epu32(pfx, pk[f]);
      __m512i s = _mm512_alignr_epi32(sfx[f + 1], sfx_prev[f + 1], 15);
      // key tie prefers the suffix side (earlier positions) — unless s is
      // the 0xFFFFFFFF "no suffix" sentinel, whose key field 0xFFFF is
      // reachable by real keys (fmix32 is a bijection): taking the
      // sentinel would emit position base+0xFFFF, off the end of the row
      __mmask16 take_p = _mm512_cmplt_epu32_mask(
          _mm512_srli_epi32(pfx, 16), _mm512_srli_epi32(s, 16)) |
          _mm512_cmpeq_epi32_mask(s, _mm512_set1_epi32(-1));
      __m512i chosen = _mm512_mask_mov_epi32(s, take_p, pfx);
      __m512i cb = _mm512_mask_mov_epi32(bs_prev, take_p, bs_v);
      win[f] = _mm512_add_epi32(cb, _mm512_and_si512(chosen, low16));
    }
    for (int f = w; f < 16; f++) win[f] = win[w - 1];  // tr16 padding
    for (int f = 0; f <= w; f++) sfx_prev[f] = sfx[f];
    tr16(win);  // -> per-lane rows of w consecutive window results
    // Vectorized adjacent-dedup emit: a window result only appends when it
    // differs from the previous window's (positions are non-decreasing, so
    // duplicates are always adjacent). Each row holds w real results then
    // copies of result w-1 (the tr16 padding), which the same compare
    // drops for free. The previous scalar per-candidate loop was the
    // hottest code in extraction (branchy, ~1 op per window).
    int i0 = 0;
    if (g == 0) {
      // block 0: windows before phase w-1 are incomplete; emit only f=w-1
      alignas(64) uint32_t cand[16];
      _mm512_store_si512((void*)cand, win[0]);
      prev_last = cand[w - 1];
      out[nout++] = prev_last;
      i0 = 1;
    }
    for (int i = i0; i < 16; i++) {
      __m512i v = win[i];
      __m512i shifted = _mm512_alignr_epi32(v, _mm512_set1_epi32((int)prev_last), 15);
      __mmask16 keep = _mm512_cmpneq_epu32_mask(v, shifted);
      _mm512_mask_compressstoreu_epi32((void*)(out + nout), keep, v);
      nout += _mm_popcnt_u32((unsigned)keep);
      prev_last = (uint32_t)_mm_extract_epi32(_mm512_extracti32x4_epi32(v, 3), 3);
    }
  }
  // scalar tail over the remaining blocks, seeded with the suffix minima of
  // the block just before it
  int64_t tail_bs = groups * 16 * w;
  if (tail_bs < m) {
    int64_t p0 = tail_bs >= w ? tail_bs - w : 0;
    sfx64.resize(m);
    for (int64_t bs = p0; bs < m; bs += w) {
      int64_t be = bs + w < m ? bs + w : m;
      uint64_t run = ~0ULL;
      for (int64_t j = be - 1; j >= bs; j--) {
        uint64_t pk = ((uint64_t)keys[j] << 32) | (uint32_t)j;
        run = pk < run ? pk : run;
        sfx64[j] = run;
      }
    }
    for (int64_t bs = tail_bs; bs < m; bs += w) {
      int64_t be = bs + w < m ? bs + w : m;
      uint64_t pfx = ~0ULL;
      for (int64_t j = bs; j < be; j++) {
        uint64_t pk = ((uint64_t)keys[j] << 32) | (uint32_t)j;
        pfx = pk < pfx ? pk : pfx;
        if (j >= w - 1) {
          uint64_t s = j - w + 1 >= p0 ? sfx64[j - w + 1] : ~0ULL;
          uint64_t win = s < pfx ? s : pfx;
          uint32_t p = (uint32_t)win;
          if (p != prev_last) {
            prev_last = p;
            out[nout++] = p;
          }
        }
      }
    }
  }
  return nout;
}
#endif  // __AVX512F__ && __AVX512BW__

// code tables: byte -> 2-bit code; filter side packs raw bytes, index side
// IUPAC-canonicalises first (ref: src/minimizers.rs:143-148 vs
// src/filter_common.rs:238). kBadTable: 1 for non-ACGT bytes.
struct CodeTables {
  uint8_t filter[256];
  uint8_t index[256];
  uint8_t bad[256];
  CodeTables() {
    for (int b = 0; b < 256; b++) {
      filter[b] = (uint8_t)((b >> 1) & 3);
      index[b] = (uint8_t)((kIupac.map[b] >> 1) & 3);
      bad[b] = valid_base((uint8_t)b) ? 0 : 1;
    }
  }
};
static const CodeTables kCodes;

// Extract minimizers of one sequence. Appends (hash, position) pairs.
// Returns count appended, or -1 if out capacity would be exceeded.
// Portable bad-bit mask builder (1 bit per base, 1 = non-ACGT; bits at and
// after n are set, harmless because windows never reach them).
[[maybe_unused]] static void bad_bitmask_scalar(const uint8_t* seq, int64_t n,
                               uint64_t* bits) {
  const int64_t nb = (n + 63) / 64;
  for (int64_t i = 0; i < nb; i++) bits[i] = 0;
  for (int64_t i = 0; i < n; i++)
    if (kCodes.bad[seq[i]]) bits[i >> 6] |= 1ULL << (i & 63);
  if (n & 63) bits[nb - 1] |= ~0ULL << (n & 63);
  bits[nb] = ~0ULL;
}

// Selection keys from canonical values: fold to u32, fmix32, keep the top
// 16 bits (the low 16 carry the in-block phase in the argmin scan).
static inline void keys_from_vals(const uint64_t* vals, int64_t m,
                                  uint32_t* keys) {
  for (int64_t p = 0; p < m; p++) {
    uint64_t v = vals[p];
    keys[p] = fmix32((uint32_t)v ^ (uint32_t)(v >> 32)) & 0xFFFF0000U;
  }
}

// Megabase-scale records are processed in chunks of window starts so the
// per-position scratch (values 8 B + keys 4 B) stays cache-resident: the
// unchunked multi-pass layout on a 20 Mbp contig allocates ~240 MB of
// scratch and runs ~20x slower than read-scale inputs (DRAM-bound).
// Chunks overlap by w-1 positions so every window is computed entirely
// inside one chunk; results are bit-identical to the unchunked scan, with
// the chunk-boundary duplicate removed by the carried last-argmin position.
static const int64_t kChunkWindows = 1 << 17;  // ~1.6 MB scratch/chunk

// Extract minimizers whose selecting windows start in [ws0, ws1), a range
// of the sequence's NW = (m > w ? m-w+1 : 1) window starts. Ranges
// partition a record's work across threads (see dx_extract_batch); outputs
// concatenated over a partition equal the whole-record scan except for one
// possible boundary repeat (the predecessor range's last minimizer selected
// again by the first window here), which the merger drops by position.
// index_mode: IUPAC-canonicalise before selection, validity+entropy on the
// original bytes.
static int64_t extract_range(const uint8_t* seq, int64_t n, int k, int w,
                             bool index_mode, float entropy_threshold,
                             ExtractScratch& scr, int64_t ws0, int64_t ws1,
                             uint64_t* out_h, uint32_t* out_p, int64_t cap) {
  if (n < k) return 0;
  const int64_t m = n - k + 1;
  const int shift_top = 2 * (k - 1);
  const bool wide = k > 32;
  const uint8_t* codes = index_mode ? kCodes.index : kCodes.filter;

  // Validity over the ORIGINAL bytes of this range, built once; consulted
  // only at selected positions (same windowed-bitmask idea as the
  // reference's filter side, ref: src/filter_common.rs:245-286).
  // window_clean's 64-bit read covers k <= 56, the filter-side bound.
  // Bit j of the mask covers seq[bit_base + j].
  const int64_t bit_base = ws0 & ~(int64_t)63;
  {
    int64_t p_hi = ws1 - 1 + w - 1 < m - 1 ? ws1 - 1 + w - 1 : m - 1;
    int64_t n_hi = p_hi + k;  // bytes [bit_base, n_hi) are consulted
    scr.badbits.resize(((n_hi - bit_base) >> 6) + 2);
#if defined(__AVX512F__) && defined(__AVX512BW__)
    bad_bitmask(seq + bit_base, n_hi - bit_base, scr.badbits.data());
#else
    bad_bitmask_scalar(seq + bit_base, n_hi - bit_base, scr.badbits.data());
#endif
  }

  int64_t cnt = 0;
  int64_t last_argmin = -1;  // dedup across chunk boundaries
  // one-time scratch sizing for the per-chunk argmin outputs (+16: the
  // SIMD emit compress-stores a full vector's worth past the last result)
  if ((int64_t)scr.pos.size() < kChunkWindows + w + 16)
    scr.pos.resize((size_t)(kChunkWindows + w + 16));
  for (int64_t ws = ws0; ws < ws1; ws += kChunkWindows) {
    const int64_t we = ws + kChunkWindows < ws1 ? ws + kChunkWindows : ws1;
    const int64_t m_loc =
        (we - ws) + w - 1 <= m - ws ? (we - ws) + w - 1 : m - ws;
    const uint8_t* src = seq + ws;
    const int64_t n_loc = m_loc + k - 1;
    scr.keys.resize(m_loc + 16);  // +16: SIMD argmin block loads past m_loc

    // Pass 1: rolling canonical values at every chunk position.
    // fwd = sum code[p+j] << 2j ; rc = sum (code[p+k-1-j]^2) << 2j.
    // The serial recurrence has a ~2-cycle dependency chain; the AVX-512
    // 8-lane chunked version above breaks it.
    if (!wide) {
      scr.vals.resize(m_loc);
      bool use_simd = false;
#if defined(__AVX512F__) && defined(__AVX512BW__)
      if (m_loc >= 512) {
        use_simd = true;
        const uint8_t* psrc = src;
        if (index_mode) {
          // IUPAC-canonicalise a copy: selection must see mapped codes
          // exactly like the reference (ref: src/minimizers.rs:143-148)
          scr.canon.resize(n_loc);
          for (int64_t i = 0; i < n_loc; i++) scr.canon[i] = kIupac.map[src[i]];
          psrc = scr.canon.data();
        }
        pass1_avx512(psrc, n_loc, k, scr.vals.data(), scr.keys.data());
      }
#endif
      if (!use_simd) {
        const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
        uint64_t fwd = 0, rc = 0;
        for (int j = 0; j < k - 1; j++) {
          uint64_t c = codes[src[j]];
          fwd |= c << (2 * j);
          rc = (rc << 2) | (c ^ 2);
        }
        for (int64_t p = 0; p < m_loc; p++) {
          uint64_t c = codes[src[p + k - 1]];
          fwd = (p ? (fwd >> 2) : fwd) | (c << shift_top);
          rc = ((rc << 2) & mask) | (c ^ 2);
          scr.vals[p] = fwd <= rc ? fwd : rc;
        }
        // finalizer pass: selection keys from values (the SIMD path fuses
        // this into pass1's transposed stores)
        keys_from_vals(scr.vals.data(), m_loc, scr.keys.data());
      }
    } else {
      unsigned __int128 fwd = 0, rc = 0;
      const unsigned __int128 mask =
          (((unsigned __int128)1) << (2 * k)) - 1;  // k <= 57 < 64
      for (int j = 0; j < k - 1; j++) {
        unsigned __int128 c = codes[src[j]];
        fwd |= c << (2 * j);
        rc = (rc << 2) | (c ^ 2);
      }
      for (int64_t p = 0; p < m_loc; p++) {
        unsigned __int128 c = codes[src[p + k - 1]];
        fwd = (p ? (fwd >> 2) : fwd) | (c << shift_top);
        rc = ((rc << 2) & mask) | (c ^ 2);
        unsigned __int128 v = fwd <= rc ? fwd : rc;
        uint64_t lo = (uint64_t)v, hi = (uint64_t)(v >> 64);
        uint32_t x = (uint32_t)lo ^ (uint32_t)(lo >> 32) ^ (uint32_t)hi ^
                     (uint32_t)(hi >> 32);
        scr.keys[p] = fmix32(x) & 0xFFFF0000U;
      }
    }
    const uint32_t* keys_buf = scr.keys.data();

    // Window argmin with leftmost tie-break, deduplicated. van Herk/
    // Gil-Werman block minima over (key << 32 | pos) packed u64s: a smaller
    // pos wins key ties automatically, every loop is branch-light (a
    // monotone deque mispredicts). Both scans walk
    // blocks explicitly — a j % w in the hot loop costs an integer divide
    // per position and halved throughput.
    // scr.pos is sized once (before the chunk loop); the paths below write
    // into it by pointer and set npos — per-chunk vector resizes would
    // value-initialize ~0.5 MB of scratch per chunk for nothing.
    uint32_t* pos_out = scr.pos.data();
    int64_t npos = 0;
    if (m <= w) {
      uint32_t best = 0;
      for (int64_t p = 1; p < m; p++)
        if (keys_buf[p] < keys_buf[best]) best = (uint32_t)p;
      pos_out[npos++] = best;
    }
#if defined(__AVX512F__) && defined(__AVX512BW__)
    else if (w >= 2 && w <= 16 && m_loc >= 16 * w) {
      npos = window_argmin_avx512(keys_buf, m_loc, w, pos_out, scr.sfx);
    }
#endif
    else {
      scr.sfx.resize(m_loc);
      for (int64_t bs = 0; bs < m_loc; bs += w) {
        int64_t be = bs + w < m_loc ? bs + w : m_loc;
        uint64_t run = ~0ULL;
        for (int64_t j = be - 1; j >= bs; j--) {
          uint64_t pk = ((uint64_t)keys_buf[j] << 32) | (uint32_t)j;
          run = pk < run ? pk : run;
          scr.sfx[j] = run;
        }
      }
      int64_t last = -1;
      for (int64_t bs = 0; bs < m_loc; bs += w) {
        int64_t be = bs + w < m_loc ? bs + w : m_loc;
        uint64_t pfx = ~0ULL;
        for (int64_t j = bs; j < be; j++) {
          uint64_t pk = ((uint64_t)keys_buf[j] << 32) | (uint32_t)j;
          pfx = pk < pfx ? pk : pfx;
          if (j >= w - 1) {
            uint64_t s = scr.sfx[j - w + 1];
            uint64_t win = s < pfx ? s : pfx;
            int64_t p = (uint32_t)win;
            if (p != last) {
              last = p;
              pos_out[npos++] = (uint32_t)p;
            }
          }
        }
      }
    }

    // Selected positions: validity (no non-ACGT byte in the ORIGINAL
    // k-mer), entropy, hash. k<=32 reads the buffered value; k>32 (rare)
    // recomputes directly. Argmin positions are non-decreasing, so the
    // chunk-boundary duplicate (a window straddling chunks re-selecting the
    // previous chunk's last minimizer) is exactly the last_argmin repeat.
    for (int64_t pi = 0; pi < npos; pi++) {
      const uint32_t lp = pos_out[pi];
      const int64_t p = ws + (int64_t)lp;
      if (p == last_argmin) continue;
      last_argmin = p;
      if (!window_clean(scr.badbits.data(), p - bit_base, k)) continue;
      if (index_mode && entropy_threshold != 0.0f && k >= 10 &&
          scaled_entropy(seq + p, k) < entropy_threshold)
        continue;
      if (cnt >= cap) return -1;
      if (!wide) {
        out_h[cnt] = xxh3_u64(scr.vals[lp]);
      } else {
        unsigned __int128 fwd = 0, rc = 0;
        for (int j = 0; j < k; j++) {
          unsigned __int128 c = index_mode
                                    ? ((kIupac.map[seq[p + j]] >> 1) & 3)
                                    : ((seq[p + j] >> 1) & 3);
          fwd |= c << (2 * j);
          rc = (rc << 2) | (c ^ 2);
        }
        unsigned __int128 v = fwd <= rc ? fwd : rc;
        out_h[cnt] = xxh3_u128((uint64_t)v, (uint64_t)(v >> 64));
      }
      out_p[cnt] = p;
      cnt++;
    }
  }
  return cnt;
}

// Whole-record extraction: every window of the sequence.
static int64_t extract_one(const uint8_t* seq, int64_t n, int k, int w,
                           bool index_mode, float entropy_threshold,
                           ExtractScratch& scr, uint64_t* out_h,
                           uint32_t* out_p, int64_t cap) {
  if (n < k) return 0;
  const int64_t m = n - k + 1;
  const int64_t NW = m > w ? m - w + 1 : 1;
  return extract_range(seq, n, k, w, index_mode, entropy_threshold, scr, 0,
                       NW, out_h, out_p, cap);
}

}  // namespace

extern "C" {

// Batched minimizer extraction over an arena of sequences.
// index_mode=1: IUPAC canonicalisation + entropy filter (index build side,
// ref: src/minimizers.rs:125-191); 0: filter side (raw 2-bit packing,
// ref: src/filter_common.rs:211-310). Caller handles prefix truncation and
// trailing-newline stripping via starts/lens.
// Outputs: out_hashes/out_pos (capacity cap), out_counts per sequence.
// Returns total minimizer count, or -1 if cap was insufficient.
int64_t dx_extract_batch(const uint8_t* arena, const int64_t* starts,
                         const int64_t* lens, int64_t n_seqs, int32_t k,
                         int32_t w, int32_t index_mode,
                         float entropy_threshold, uint64_t* out_hashes,
                         uint32_t* out_pos, int64_t* out_counts,
                         int64_t cap, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  int hw = (int)std::thread::hardware_concurrency();
  if (hw > 0 && n_threads > hw) n_threads = hw;
  // clamp to the unit count, not the sequence count: window-range units let
  // one chromosome-scale record use every core
  int64_t total_units = 0;
  for (int64_t i = 0; i < n_seqs; i++) {
    if (lens[i] < k) continue;
    int64_t m = lens[i] - k + 1;
    int64_t nw = m > w ? m - w + 1 : 1;
    total_units += (nw + 4 * kChunkWindows - 1) / (4 * kChunkWindows);
  }
  if ((int64_t)n_threads > total_units)
    n_threads = (int32_t)(total_units ? total_units : 1);

  if (n_threads == 1) {
    ExtractScratch scr;
    int64_t total = 0;
    for (int64_t i = 0; i < n_seqs; i++) {
      int64_t c = extract_one(arena + starts[i], lens[i], k, w,
                              index_mode != 0, entropy_threshold, scr,
                              out_hashes + total,
                              out_pos + total, cap - total);
      if (c < 0) return -1;
      out_counts[i] = c;
      total += c;
    }
    return total;
  }

  // Multi-threaded: the work list is window-start ranges, not sequences, so
  // a single chromosome-scale record still spreads across every core (the
  // reference's rayon par_iter over records, ref: src/remote_filter.rs:762-
  // 774, leaves one-contig FASTA inputs single-threaded). Each worker takes
  // a contiguous run of units balanced by window count; the sequential
  // merger re-packs outputs in order, dropping the one possible duplicate
  // at each intra-record seam (extract_range's boundary-repeat contract).
  struct Unit {
    int64_t seq, ws0, ws1;
  };
  const int64_t kUnitWindows = 4 * kChunkWindows;
  std::vector<Unit> units;
  for (int64_t i = 0; i < n_seqs; i++) {
    out_counts[i] = 0;
    if (lens[i] < k) continue;
    int64_t m = lens[i] - k + 1;
    int64_t nw = m > w ? m - w + 1 : 1;
    for (int64_t ws = 0; ws < nw; ws += kUnitWindows) {
      units.push_back({i, ws, ws + kUnitWindows < nw ? ws + kUnitWindows : nw});
    }
  }
  const int64_t n_units = (int64_t)units.size();
  int64_t total_windows = 0;
  for (auto& u : units) total_windows += u.ws1 - u.ws0;
  std::vector<int64_t> cuts(n_threads + 1, 0);
  {
    int64_t acc = 0, t = 1;
    for (int64_t i = 0; i < n_units && t < n_threads; i++) {
      acc += units[i].ws1 - units[i].ws0;
      if (acc * n_threads >= total_windows * t) cuts[t++] = i + 1;
    }
    for (int64_t t2 = 1; t2 < n_threads; t2++)
      if (cuts[t2] == 0) cuts[t2] = cuts[t2 - 1];
    cuts[n_threads] = n_units;
  }
  struct Part {
    std::vector<uint64_t> h;
    std::vector<uint32_t> p;
  };
  std::vector<Part> parts(n_threads);
  std::vector<int64_t> unit_counts(n_units, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      Part& part = parts[t];
      ExtractScratch scr;
      std::vector<uint64_t> h1;
      std::vector<uint32_t> p1;
      for (int64_t ui = cuts[t]; ui < cuts[t + 1]; ui++) {
        const Unit& u = units[ui];
        int64_t max_m = u.ws1 - u.ws0;  // <= 1 new minimizer per window
        h1.resize(max_m);
        p1.resize(max_m);
        int64_t c = extract_range(arena + starts[u.seq], lens[u.seq], k, w,
                                  index_mode != 0, entropy_threshold, scr,
                                  u.ws0, u.ws1, h1.data(), p1.data(), max_m);
        unit_counts[ui] = c;  // cannot overflow: cap = window count
        part.h.insert(part.h.end(), h1.begin(), h1.begin() + c);
        part.p.insert(part.p.end(), p1.begin(), p1.begin() + c);
      }
    });
  }
  for (auto& th : threads) th.join();
  // Ordered merge with seam dedup: units of one sequence are consecutive,
  // and minimizer positions are non-decreasing, so a seam duplicate can
  // only be the first output of a unit equalling the last merged position.
  int64_t off = 0;
  {
    std::vector<int64_t> rd(n_threads, 0);
    int thread_of = 0;
    int64_t prev_seq = -1;
    uint32_t last_pos = 0;
    bool have_last = false;
    for (int64_t ui = 0; ui < n_units; ui++) {
      while (ui >= cuts[thread_of + 1]) thread_of++;
      const Unit& u = units[ui];
      Part& part = parts[thread_of];
      int64_t r = rd[thread_of], c = unit_counts[ui];
      if (u.seq != prev_seq) {
        prev_seq = u.seq;
        have_last = false;
      }
      if (c > 0 && have_last && part.p[r] == last_pos) {
        r++;
        c--;
      }
      if (off + c > cap) return -1;
      if (c > 0) {
        memcpy(out_hashes + off, part.h.data() + r, c * 8);
        memcpy(out_pos + off, part.p.data() + r, c * 4);
        last_pos = part.p[r + c - 1];
        have_last = true;
        out_counts[u.seq] += c;
        off += c;
      }
      rd[thread_of] = r + c;  // == original offset + unit_counts[ui]
    }
  }
  return off;
}

}  // extern "C"

// ===========================================================================
// Fully native streaming filter pipeline
//
// The host engine of `filter --device host` (filter/engine.py
// run_host_pipeline): a reader thread parses records into batches, a
// worker pool extracts minimizers + probes the index + applies thresholds,
// and an ordered writer thread formats and writes kept records (the
// paraseq reader / rayon workers / locked writer architecture of the
// reference, ref: src/local_filter.rs:153-187,345-573, re-expressed as an
// explicit pipeline). Semantics (distinct-hit counting, pair-union,
// threshold math, rename numbering, stats) are bit-identical to the
// device engine's and to the JAX package's host engine;
// tests/test_torch_host_engine.py and tests/test_torch_host_fuzz.py hold
// them to both.
// ===========================================================================

namespace {

// Opt-in stage profiler (DEACON_NATIVE_PROFILE=1): per-stage time
// accumulators across all pipeline threads, reported on stderr at the end
// of dx_filter_run. Zero overhead when off (single branch per section).
// Compute stages use per-thread CPU time so hypervisor steal and
// preemption are not booked to whichever stage they interrupt; stall
// counters are genuine waits and use wall time.
struct StageProf {
  bool on = false;
  std::atomic<int64_t> parse{0};          // reader: record parsing
  std::atomic<int64_t> reader_stall{0};   // reader: waiting to hand off
  std::atomic<int64_t> wparse{0};         // workers: chunk parsing
  std::atomic<int64_t> extract{0};        // workers: minimizer extraction
  std::atomic<int64_t> probe{0};          // workers: membership + distinct
  std::atomic<int64_t> format{0};         // workers: record formatting
  std::atomic<int64_t> compress{0};       // workers: output compression
  std::atomic<int64_t> worker_stall{0};   // workers: waiting for batches
  std::atomic<int64_t> emit{0};           // writer: formatting (rename path)
  std::atomic<int64_t> write{0};          // writer: fwrite/encoder
  std::atomic<int64_t> writer_stall{0};   // writer: waiting for next batch
};

struct FBatch {
  int64_t seq_no = 0;
  int64_t n_units = 0;  // records (single) or pairs (paired)
  int raw_kind = 0;     // 0 = meta filled; 1/2 = unparsed FASTQ/FASTA chunk
                        // (chunk-parallel mode: the worker parses it)
  bool paired = false;
  std::vector<uint8_t> arena;
  std::vector<int64_t> meta;  // 6 per record: id_off,id_len,seq_off,seq_len,qual_off,qual_len
  std::vector<uint8_t> keep;  // per unit (worker output)
  // worker-side formatted (and compressed) output bytes: gzip members /
  // zstd frames / xz streams concatenate into valid files, so each batch
  // compresses independently in its worker (pigz-style) and the writer
  // thread only sequences raw byte writes. Disabled under --rename, whose
  // numbering is writer-order.
  bool formatted = false;
  std::vector<uint8_t> cout1, cout2;
};

struct FQueue {
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<FBatch*> q;
  size_t cap;
  bool closed = false;
  explicit FQueue(size_t c) : cap(c) {}
  bool push(FBatch* b) {
    std::unique_lock<std::mutex> lk(mu);
    cv_push.wait(lk, [&] { return q.size() < cap || closed; });
    if (closed) return false;
    q.push_back(b);
    cv_pop.notify_one();
    return true;
  }
  bool pop(FBatch*& out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_pop.wait(lk, [&] { return !q.empty() || closed; });
    if (q.empty()) return false;
    out = q.front();
    q.pop_front();
    cv_push.notify_one();
    return true;
  }
  void close() {
    std::lock_guard<std::mutex> lk(mu);
    closed = true;
    cv_push.notify_all();
    cv_pop.notify_all();
  }
};

struct FilterJob {
  // index
  const ProbeTable* probe = nullptr;  // from dx_probe_build / dx_probe_load
  const ZstdApi* zst = nullptr;       // zstd output members
  // params
  int k = 31, w = 15;
  int64_t prefix_len = 0;
  int64_t abs_threshold = 2;
  double rel_threshold = 0.01;
  bool deplete = false, rename = false;
  // io
  DxWriter* w1 = nullptr;
  DxWriter* w2 = nullptr;
  // pipeline
  FQueue work{4};
  std::mutex done_mu;
  std::condition_variable done_cv;
  std::map<int64_t, FBatch*> done;
  int64_t next_write = 0;
  std::atomic<int64_t> total_batches{-1};
  std::atomic<bool> failed{false};
  int n_workers = 1;                  // worker-pool size
  bool chunk_parse = false;           // single-end chunk-parallel parsing
  std::atomic<int> busy_workers{0};   // workers currently inside a batch
  // recycled batch buffers: arenas/meta/outputs keep their capacity, so
  // steady state allocates nothing per batch (glibc returns multi-MB frees
  // to the kernel, making fresh batches a page-fault storm at GB scale)
  std::mutex free_mu;
  std::vector<FBatch*> free_list;
  FBatch* get_batch() {
    {
      std::lock_guard<std::mutex> lk(free_mu);
      if (!free_list.empty()) {
        FBatch* b = free_list.back();
        free_list.pop_back();
        return b;
      }
    }
    return new FBatch();
  }
  void put_batch(FBatch* b) {
    b->n_units = 0;
    b->raw_kind = 0;
    b->formatted = false;
    // arena keeps its SIZE (not just capacity): the chunked reader's
    // resize() then only zero-fills past the high-water mark; the serial
    // reader clears it on acquisition
    b->meta.clear();
    b->keep.clear();
    b->cout1.clear();
    b->cout2.clear();
    // don't pool chromosome-scale buffers: batches grown by >=8 MB records
    // would otherwise pin up to 8x their peak size for the whole run
    constexpr size_t kPoolCap = (size_t)(8 << 20) * 4;
    if (b->arena.capacity() > kPoolCap) std::vector<uint8_t>().swap(b->arena);
    if (b->cout1.capacity() > kPoolCap) std::vector<uint8_t>().swap(b->cout1);
    if (b->cout2.capacity() > kPoolCap) std::vector<uint8_t>().swap(b->cout2);
    std::lock_guard<std::mutex> lk(free_mu);
    if (free_list.size() < 8) {
      free_list.push_back(b);
      return;
    }
    delete b;
  }
  void drain_free() {
    std::lock_guard<std::mutex> lk(free_mu);
    for (FBatch* b : free_list) delete b;
    free_list.clear();
  }
  // worker-side output formatting/compression (-1 = off, else codec)
  int precompress1 = -1, precompress2 = -1;
  int level1 = 0, level2 = 0;
  int64_t bytes1 = 0, bytes2 = 0;  // writer-thread owned
  std::mutex err_mu;
  std::string err;
  // stats (writer-thread-owned; mirrored into `progress` for live polling)
  int64_t total_seqs = 0, filtered_seqs = 0, total_bp = 0;
  int64_t output_bp = 0, filtered_bp = 0, out_counter = 0;
  int64_t* progress = nullptr;  // [7]: 0-5 stats, 6 = cancel request
                                //        (set by the caller, e.g. SIGINT)

  bool cancelled() const {
    return progress != nullptr &&
           __atomic_load_n(&progress[6], __ATOMIC_RELAXED) != 0;
  }
  StageProf prof;

  void fail(const std::string& m) {
    {
      std::lock_guard<std::mutex> lk(err_mu);
      if (err.empty()) err = m;
    }
    failed.store(true);
    work.close();
    done_cv.notify_all();
  }
};

// required distinct hits (ref: src/filter_common.rs:84-96; Rust f64::round
// is half-away-from-zero and rel >= 0, so floor(x + 0.5))
static inline int64_t required_hits(const FilterJob& J, int64_t total) {
  int64_t rel_req =
      total == 0
          ? 0
          : std::max<int64_t>(
                1, (int64_t)std::floor(J.rel_threshold * (double)total + 0.5));
  return std::max(J.abs_threshold, rel_req);
}

// Distinct index hits among `hashes` (seen-set semantics,
// ref: src/filter_common.rs:129-155), saturating at `req`: the keep
// decision only compares hits against the precomputed requirement, and
// distinct hits grow monotonically, so probing can stop the moment the
// requirement is met — a matching read costs ~req probes instead of one
// per minimizer. For small req (the common -a 2 case) dedup is a linear
// scan of the <=req seen hits; large requirements (high -r) keep the
// sort-based exact count.
static int64_t count_distinct_hits(const FilterJob& J, const uint64_t* hashes,
                                   int64_t n, int64_t req,
                                   std::vector<uint64_t>& scratch) {
  scratch.clear();
  const ProbeTable& t = *J.probe;
  if (n > 0 && n <= kProbeAhead) {
    // short lists (a 150 bp read has ~18 minimizers) never reach the
    // streaming prefetch distance below, so every probe would pay a full
    // DRAM miss; issue all homes upfront instead
    for (int64_t i = 0; i < n; i++)
      __builtin_prefetch(
          &t.slots[(size_t)probe_home(hashes[i] * t.mix, t.n_slots)]);
  }
  if (req > 0 && req <= 64) {
    for (int64_t i = 0; i < n; i++) {
      if (i + kProbeAhead < n)
        __builtin_prefetch(
            &t.slots[(size_t)probe_home(hashes[i + kProbeAhead] * t.mix, t.n_slots)]);
      uint64_t h = hashes[i];
      if (!probe_lookup(t, h)) continue;
      bool seen = false;
      for (uint64_t s : scratch)
        if (s == h) { seen = true; break; }
      if (seen) continue;
      scratch.push_back(h);
      if ((int64_t)scratch.size() >= req) return req;  // decision fixed
    }
    return (int64_t)scratch.size();
  }
  for (int64_t i = 0; i < n; i++) {
    if (i + kProbeAhead < n)
      __builtin_prefetch(&t.slots[(size_t)probe_home(hashes[i + kProbeAhead] * t.mix, t.n_slots)]);
    if (probe_lookup(t, hashes[i])) scratch.push_back(hashes[i]);
  }
  if (scratch.empty()) return 0;
  std::sort(scratch.begin(), scratch.end());
  int64_t distinct = 1;
  for (size_t i = 1; i < scratch.size(); i++)
    if (scratch[i] != scratch[i - 1]) distinct++;
  return distinct;
}

// keep decision (ref: src/filter_common.rs:99-112)
static inline bool keep_decision(const FilterJob& J, int64_t hits,
                                 int64_t required) {
  return J.deplete ? hits < required : hits >= required;
}

// Records at least this long borrow idle workers' cores for extraction
// (a single-contig FASTA otherwise pins one worker at ~1 core while the
// rest wait on the queue).
constexpr int64_t kHugeRecord = 8'000'000;

static void format_kept(const FBatch& b, bool split2,
                        std::vector<uint8_t>& o1, std::vector<uint8_t>& o2);
static bool compress_member(int codec, int level, const ZstdApi* zst,
                            std::vector<uint8_t>& in,
                            std::vector<uint8_t>& out,
                            bool emit_empty = false);
static bool parse_raw_chunk_fastq(FBatch& b, std::string& err);
static bool parse_raw_chunk_fasta(FBatch& b, std::string& err);

static void filter_worker(FilterJob& J) {
  ExtractScratch scr;
  std::vector<uint64_t> hashes, scratch;
  std::vector<uint32_t> posv;
  std::vector<uint8_t> fmt1, fmt2;
  FBatch* b;
  while (true) {
    const int64_t t_pop0 = J.prof.on ? now_ns() : 0;
    if (!J.work.pop(b)) break;
    if (J.prof.on) J.prof.worker_stall.fetch_add(now_ns() - t_pop0);
    if (J.failed.load() || J.cancelled()) {
      if (J.cancelled()) J.fail("Interrupted");
      delete b;
      continue;
    }
    J.busy_workers.fetch_add(1);
    if (b->raw_kind) {
      const int64_t t_wp0 = J.prof.on ? now_cpu_ns() : 0;
      std::string perr;
      bool ok = b->raw_kind == 1 ? parse_raw_chunk_fastq(*b, perr)
                                 : parse_raw_chunk_fasta(*b, perr);
      b->raw_kind = 0;
      if (J.prof.on) J.prof.wparse.fetch_add(now_cpu_ns() - t_wp0);
      if (ok && b->paired) {
        // interleaved chunks split at 8-newline phase: records are even
        b->n_units /= 2;
      }
      if (!ok) {
        J.fail(perr);
        J.busy_workers.fetch_sub(1);
        delete b;
        continue;
      }
    }
    b->keep.resize(b->n_units);
    const int recs_per_unit = b->paired ? 2 : 1;
    int64_t extract_ns = 0, probe_ns = 0, t_u0 = 0;
    for (int64_t u = 0; u < b->n_units; u++) {
      if (J.prof.on) t_u0 = now_cpu_ns();
      hashes.clear();
      for (int r = 0; r < recs_per_unit; r++) {
        const int64_t* m = b->meta.data() + 6 * (u * recs_per_unit + r);
        int64_t len = m[3];
        if (J.prefix_len > 0 && len > J.prefix_len) len = J.prefix_len;
        int64_t max_m = len >= J.k ? len - J.k + 1 : 0;
        if (max_m <= 0) continue;
        size_t base = hashes.size();
        int64_t c;
        if (len >= kHugeRecord) {
          // chromosome-scale record: split its window ranges across the
          // currently idle workers via the batch extractor (outputs are
          // identical for any thread count). Buffers are sized to the
          // expected ~2m/(w+1) density, not one-per-position — a 100 Mbp
          // record would otherwise value-initialize 1.2 GB per batch
          // (a page-fault storm) — and regrown
          // on the rare overflow (dx_extract_batch returns -1).
          int idle = J.n_workers - J.busy_workers.load();
          int nthreads = 1 + (idle > 0 ? idle : 0);
          int64_t cap = max_m * 2 / (J.w + 1) + 4096;
          for (;;) {
            if (cap > max_m) cap = max_m;
            hashes.resize(base + cap);
            posv.resize(cap);
            int64_t st0 = 0, cnt1 = 0;
            c = dx_extract_batch(b->arena.data() + m[2], &st0, &len, 1,
                                 J.k, J.w, /*index_mode=*/0, 0.0f,
                                 hashes.data() + base, posv.data(), &cnt1,
                                 cap, nthreads);
            if (c >= 0 || cap == max_m) break;
            cap *= 2;
          }
        } else {
          hashes.resize(base + max_m);
          posv.resize(max_m);
          c = extract_one(b->arena.data() + m[2], len, J.k, J.w,
                          /*index_mode=*/false, 0.0f, scr,
                          hashes.data() + base, posv.data(), max_m);
        }
        hashes.resize(base + (c > 0 ? c : 0));
      }
      int64_t t_u1 = 0;
      if (J.prof.on) {
        t_u1 = now_cpu_ns();
        extract_ns += t_u1 - t_u0;
      }
      int64_t total = (int64_t)hashes.size();
      int64_t req = required_hits(J, total);
      int64_t hits =
          count_distinct_hits(J, hashes.data(), total, req, scratch);
      b->keep[u] = keep_decision(J, hits, req) ? 1 : 0;
      if (J.prof.on) probe_ns += now_cpu_ns() - t_u1;
    }
    if (J.prof.on) {
      J.prof.extract.fetch_add(extract_ns);
      J.prof.probe.fetch_add(probe_ns);
    }
    if (J.precompress1 >= 0) {
      const int64_t t_f0 = J.prof.on ? now_cpu_ns() : 0;
      fmt1.clear();
      fmt2.clear();
      format_kept(*b, J.w2 != nullptr, fmt1, fmt2);
      const int64_t t_f1 = J.prof.on ? now_cpu_ns() : 0;
      if (J.prof.on) J.prof.format.fetch_add(t_f1 - t_f0);
      bool ok = compress_member(J.precompress1, J.level1, J.zst, fmt1,
                                b->cout1);
      if (ok && J.w2)
        ok = compress_member(J.precompress2, J.level2, J.zst, fmt2,
                             b->cout2);
      if (J.prof.on) J.prof.compress.fetch_add(now_cpu_ns() - t_f1);
      if (!ok) {
        J.fail("output compression failed");
        delete b;
        J.busy_workers.fetch_sub(1);
        continue;
      }
      b->formatted = true;
    }
    J.busy_workers.fetch_sub(1);
    {
      std::lock_guard<std::mutex> lk(J.done_mu);
      J.done[b->seq_no] = b;
    }
    J.done_cv.notify_all();
  }
}

static void append_bytes(std::vector<uint8_t>& dst, const uint8_t* p,
                         int64_t n) {
  dst.insert(dst.end(), p, p + n);
}

// format one record (ref: src/remote_filter.rs:1402-1443); identical bytes
// to io/writers.py format_record
static void emit_record(std::vector<uint8_t>& dst, const FBatch& b,
                        const int64_t* m, bool rename, int64_t seqnum) {
  bool is_fq = m[4] >= 0;
  dst.push_back(is_fq ? '@' : '>');
  if (rename) {
    char tmp[24];
    int n = snprintf(tmp, sizeof(tmp), "%lld", (long long)seqnum);
    append_bytes(dst, (const uint8_t*)tmp, n);
  } else {
    append_bytes(dst, b.arena.data() + m[0], m[1]);
  }
  dst.push_back('\n');
  append_bytes(dst, b.arena.data() + m[2], m[3]);
  if (is_fq) {
    dst.push_back('\n');
    dst.push_back('+');
    dst.push_back('\n');
    append_bytes(dst, b.arena.data() + m[4], m[5]);
  }
  dst.push_back('\n');
}

// format the kept records of a batch exactly as the writer would
// (rename off): pairs interleave unless a second output splits mates
static void format_kept(const FBatch& b, bool split2,
                        std::vector<uint8_t>& o1, std::vector<uint8_t>& o2) {
  const int rpu = b.paired ? 2 : 1;
  for (int64_t u = 0; u < b.n_units; u++) {
    if (!b.keep[u]) continue;
    const int64_t* m1 = b.meta.data() + 6 * u * rpu;
    emit_record(o1, b, m1, /*rename=*/false, 0);
    if (b.paired) emit_record(split2 ? o2 : o1, b, m1 + 6, false, 0);
  }
}

// One self-contained compressed member/frame/stream from `in` (codec 0:
// plain bytes move across). Returns false on codec failure.
static bool compress_member(int codec, int level, const ZstdApi* zst,
                            std::vector<uint8_t>& in,
                            std::vector<uint8_t>& out, bool emit_empty) {
  if (codec == 0) {
    out.swap(in);
    return true;
  }
  out.clear();
  if (in.empty() && !emit_empty) return true;
  if (codec == 1) {  // gzip member
    // fast levels route to the purpose-built one-shot compressor (greedy
    // LZ + per-member dynamic Huffman); higher levels keep zlib's deeper
    // match search.
    if (level <= 3 && in.size() < (size_t)1 << 31) {
      // BGZF framing: still a plain .gz to any consumer, but also
      // bgzip/htslib-compatible and block-parallel decodable
      if (!fastdef::bgzf_member(in.data(), in.size(), out)) {
        out.clear();
        fastdef::gzip_member(in.data(), in.size(), out);
      }
      return true;
    }
    z_stream zs{};
    if (deflateInit2(&zs, level, Z_DEFLATED, 16 + MAX_WBITS, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
      return false;
    out.resize(deflateBound(&zs, in.size()) + 32);
    // zlib's avail_in/avail_out are 32-bit; feed <=1 GiB slices so a
    // single record >4 GiB is not silently truncated
    const size_t kChunk = (size_t)1 << 30;
    size_t in_off = 0, out_off = 0;
    while (true) {
      const size_t in_take = std::min(kChunk, in.size() - in_off);
      const size_t out_room = std::min(kChunk, out.size() - out_off);
      zs.next_in = in.data() + in_off;
      zs.avail_in = (uInt)in_take;
      zs.next_out = out.data() + out_off;
      zs.avail_out = (uInt)out_room;
      int r = deflate(&zs, in_off + in_take == in.size() ? Z_FINISH
                                                         : Z_NO_FLUSH);
      in_off += in_take - zs.avail_in;
      out_off += out_room - zs.avail_out;
      if (r == Z_STREAM_END) break;
      if (r != Z_OK) {
        deflateEnd(&zs);
        out.clear();
        return false;
      }
    }
    out.resize(out_off);
    deflateEnd(&zs);
    return true;
  }
  if (codec == 2) {  // zstd frame
    if (!zst) return false;
    out.resize(zst->compressBound(in.size()));
    size_t r = zst->compress(out.data(), out.size(), in.data(), in.size(),
                             level);
    if (zst->isError(r)) return false;
    out.resize(r);
    return true;
  }
  if (codec == 3) {  // xz stream
    const LzmaApi& lz = LzmaApi::get();
    out.resize(lz.stream_buffer_bound(in.size()));
    size_t out_pos = 0;
    int r = lz.easy_buffer_encode((uint32_t)level, LZMA_CHECK_CRC64, nullptr,
                                  in.data(), in.size(), out.data(), &out_pos,
                                  out.size());
    if (r != LZMA_OK) return false;
    out.resize(out_pos);
    return true;
  }
  return false;
}

static void filter_writer(FilterJob& J) {
  std::vector<uint8_t> buf, buf2;
  while (true) {
    FBatch* b = nullptr;
    const int64_t t_wait0 = J.prof.on ? now_ns() : 0;
    {
      std::unique_lock<std::mutex> lk(J.done_mu);
      J.done_cv.wait(lk, [&] {
        return J.failed.load() || J.done.count(J.next_write) ||
               (J.total_batches.load() >= 0 &&
                J.next_write >= J.total_batches.load());
      });
      if (J.failed.load()) return;
      if (J.total_batches.load() >= 0 &&
          J.next_write >= J.total_batches.load() &&
          !J.done.count(J.next_write))
        return;
      auto it = J.done.find(J.next_write);
      b = it->second;
      J.done.erase(it);
      J.next_write++;
    }
    const int64_t t_emit0 = J.prof.on ? now_ns() : 0;
    const int64_t t_emit0_cpu = J.prof.on ? now_cpu_ns() : 0;
    if (J.prof.on) J.prof.writer_stall.fetch_add(t_emit0 - t_wait0);
    buf.clear();
    buf2.clear();
    const int recs_per_unit = b->paired ? 2 : 1;
    for (int64_t u = 0; u < b->n_units; u++) {
      const int64_t* m1 = b->meta.data() + 6 * u * recs_per_unit;
      if (b->paired) {
        const int64_t* m2 = m1 + 6;
        int64_t pair_bp = m1[3] + m2[3];
        J.total_seqs += 2;
        J.total_bp += pair_bp;
        if (b->keep[u]) {
          J.output_bp += pair_bp;
          J.out_counter += 2;
          if (!b->formatted) {
            emit_record(buf, *b, m1, J.rename, J.out_counter - 1);
            emit_record(J.w2 ? buf2 : buf, *b, m2, J.rename, J.out_counter);
          }
        } else {
          J.filtered_seqs += 2;
          J.filtered_bp += pair_bp;
        }
      } else {
        J.total_seqs += 1;
        J.total_bp += m1[3];
        if (b->keep[u]) {
          J.output_bp += m1[3];
          J.out_counter += 1;
          if (!b->formatted) emit_record(buf, *b, m1, J.rename, J.out_counter);
        } else {
          J.filtered_seqs += 1;
          J.filtered_bp += m1[3];
        }
      }
    }
    if (b->formatted) {
      buf.swap(b->cout1);
      buf2.swap(b->cout2);
    }
    J.put_batch(b);
    const int64_t t_write0 = J.prof.on ? now_ns() : 0;
    if (J.prof.on) J.prof.emit.fetch_add(now_cpu_ns() - t_emit0_cpu);
    if (!buf.empty() && dx_writer_write(J.w1, buf.data(), buf.size()) != 0) {
      J.fail("write failed");
      return;
    }
    J.bytes1 += (int64_t)buf.size();
    if (J.w2 && !buf2.empty() &&
        dx_writer_write(J.w2, buf2.data(), buf2.size()) != 0) {
      J.fail("write failed");
      return;
    }
    J.bytes2 += (int64_t)buf2.size();
    if (J.prof.on) J.prof.write.fetch_add(now_ns() - t_write0);
    if (J.progress) {
      __atomic_store_n(&J.progress[0], J.total_seqs, __ATOMIC_RELAXED);
      __atomic_store_n(&J.progress[1], J.filtered_seqs, __ATOMIC_RELAXED);
      __atomic_store_n(&J.progress[2], J.total_bp, __ATOMIC_RELAXED);
      __atomic_store_n(&J.progress[3], J.output_bp, __ATOMIC_RELAXED);
      __atomic_store_n(&J.progress[4], J.filtered_bp, __ATOMIC_RELAXED);
      __atomic_store_n(&J.progress[5], J.out_counter, __ATOMIC_RELAXED);
    }
  }
}

constexpr int64_t kBatchRecords = 10000;  // ref: src/remote_filter.rs:727
constexpr int64_t kBatchArena = 8 << 20;

// ---------------------------------------------------------------------------
// Chunk-parallel parsing (single-end inputs). A lone reader thread parsing
// records caps end-to-end throughput at one core's parse speed no matter
// how many workers extract — the same wall the reference
// clears with paraseq's worker-side record parsing. Here the reader only
// streams raw chunks and splits them at record boundaries — FASTQ records
// are exactly 4 lines, so the split is the position of the last newline
// whose running count is a multiple of 4; FASTA splits before the last
// "\n>" — and each worker parses its own chunk in place. Inputs the phase
// rule can't handle (blank lines, CR line endings, EOF tails without a
// final newline) fall back to the proven serial reader mid-stream via
// DxReader::replay. Disable with DEACON_CHUNK_PARSE=0.
// ---------------------------------------------------------------------------

constexpr int64_t kRawChunk = 8 << 20;

// Parse a raw FASTQ chunk (complete 4-line records, ends with '\n') into
// meta. Returns false with `err` set on malformed records.
static bool parse_raw_chunk_fastq(FBatch& b, std::string& err) {
  const uint8_t* a = b.arena.data();
  const int64_t n = (int64_t)b.arena.size();
  int64_t pos = 0;
  auto next_nl = [&](int64_t p) -> int64_t {
    const void* q = memchr(a + p, '\n', (size_t)(n - p));
    return q ? (int64_t)((const uint8_t*)q - a) : -1;
  };
  while (pos < n) {
    if (a[pos] != '@') {
      err = "Record marker mismatch";
      return false;
    }
    int64_t e0 = next_nl(pos);
    if (e0 < 0) {
      err = "Truncated FASTQ record";
      return false;
    }
    int64_t s_off = e0 + 1;
    int64_t e1 = next_nl(s_off);
    if (e1 < 0) {
      err = "Truncated FASTQ record";
      return false;
    }
    int64_t p_off = e1 + 1;
    int64_t e2 = next_nl(p_off);
    if (e2 < 0 || p_off >= n || a[p_off] != '+') {
      err = "Expected '+' separator";
      return false;
    }
    int64_t q_off = e2 + 1;
    int64_t e3 = next_nl(q_off);
    if (e3 < 0) {
      err = "Truncated FASTQ record (missing quality)";
      return false;
    }
    if (e3 - q_off != e1 - s_off) {
      err = "Quality length != sequence length";
      return false;
    }
    int64_t m[6] = {pos + 1, e0 - pos - 1, s_off, e1 - s_off, q_off,
                    e3 - q_off};
    b.meta.insert(b.meta.end(), m, m + 6);
    b.n_units++;
    pos = e3 + 1;
  }
  return true;
}

// Parse a raw FASTA chunk (every record starts at a '>' line; the chunk
// starts at one and ends with '\n'). Multi-line sequences are compacted in
// place so each sequence is one contiguous (off, len) span, exactly like
// the serial parser's appended lines.
static bool parse_raw_chunk_fasta(FBatch& b, std::string& err) {
  uint8_t* a = b.arena.data();
  const int64_t n = (int64_t)b.arena.size();
  int64_t pos = 0;
  auto next_nl = [&](int64_t p) -> int64_t {
    const void* q = memchr(a + p, '\n', (size_t)(n - p));
    return q ? (int64_t)((const uint8_t*)q - a) : n;
  };
  while (pos < n) {
    while (pos < n && a[pos] == '\n') pos++;  // blank lines between records
    if (pos >= n) break;
    if (a[pos] != '>') {
      err = "Record marker mismatch";
      return false;
    }
    int64_t e0 = next_nl(pos);
    int64_t id_len = e0 - pos - 1;
    if (id_len > 0 && a[e0 - 1] == '\r') id_len--;
    int64_t seq_off = e0 < n ? e0 + 1 : n;
    int64_t w = seq_off, p = seq_off;
    while (p < n && a[p] != '>') {
      int64_t e = next_nl(p);
      int64_t L = e - p;
      if (L > 0 && a[e - 1] == '\r') L--;
      if (w != p && L > 0) memmove(a + w, a + p, (size_t)L);
      w += L;
      p = e + 1;
    }
    int64_t m[6] = {pos + 1, id_len, seq_off, w - seq_off, -1, 0};
    b.meta.insert(b.meta.end(), m, m + 6);
    b.n_units++;
    pos = p;
  }
  return true;
}

// One pass over a chunk: newline count plus the anomalies that break the
// FASTQ 4-line phase rule (blank lines, CR endings). Plain byte compares —
// the compiler vectorizes both loops.
static void scan_chunk(const uint8_t* a, int64_t n, int64_t* newlines,
                       bool* anomaly) {
  int64_t cnt = 0;
  uint8_t bad = 0;
  for (int64_t i = 0; i < n; i++) {
    cnt += a[i] == '\n';
    bad |= a[i] == '\r';
  }
  for (int64_t i = 0; i + 1 < n; i++)
    bad |= (a[i] == '\n') & (a[i + 1] == '\n');
  *newlines = cnt;
  *anomaly = bad != 0;
}

// memrchr is a GNU extension; keep the file building on non-glibc
static inline const void* dx_memrchr(const void* s, int c, size_t n) {
#ifdef __GLIBC__
  return memrchr(s, c, n);
#else
  const uint8_t* p = (const uint8_t*)s;
  while (n--)
    if (p[n] == (uint8_t)c) return p + n;
  return nullptr;
#endif
}

static int64_t nth_newline_from_end(const uint8_t* a, int64_t n, int64_t k) {
  int64_t i = n;
  while (k-- > 0) {
    const void* p = dx_memrchr(a, '\n', (size_t)i);
    if (!p) return -1;
    i = (int64_t)((const uint8_t*)p - a);
  }
  return i;
}

// Chunk-parallel reader loop (single-end only). Returns true when the
// stream was fully consumed (or the job failed); false to bail — the
// unconsumed bytes are loaded into r->replay and the caller's serial loop
// continues from `seq_no`.
// `pair` = interleaved FASTQ: records group in 2s, so chunks split at
// newline multiples of 8 and each batch unit is a mate pair.
// `records_out` accumulates parsed records (for the serial path's
// interleaved-count error message after a bail).
static bool filter_reader_chunked(FilterJob& J, DxReader* r,
                                  int64_t& seq_no, bool pair,
                                  int64_t* records_out) {
  int64_t chunk_bytes = kRawChunk;
  if (const char* cb = getenv("DEACON_CHUNK_BYTES")) {
    int64_t v = atoll(cb);
    if (v >= 256) chunk_bytes = v;  // test knob: tiny chunks exercise the
  }                                 // carry/accumulate/bail machinery
  std::vector<uint8_t> carry;
  int kind = 0;  // 1 fastq, 2 fasta
  while (!J.failed.load()) {
    if (J.cancelled()) {
      J.fail("Interrupted");
      return true;
    }
    FBatch* b = J.get_batch();
    b->seq_no = seq_no;
    b->paired = pair;
    const int64_t t0 = J.prof.on ? now_ns() : 0;
    // Accumulate reads in place until the arena holds at least one
    // complete record; only the newly read tail is ever scanned, so a
    // record spanning many chunks costs one pass, not one per chunk.
    // resize() on a pool-recycled arena (put_batch keeps its size) only
    // zero-fills when growing past the high-water mark.
    if (b->arena.size() < carry.size() + (size_t)chunk_bytes)
      b->arena.resize(carry.size() + (size_t)chunk_bytes);
    if (!carry.empty()) memcpy(b->arena.data(), carry.data(), carry.size());
    int64_t filled = (int64_t)carry.size();
    carry.clear();
    int64_t scanned = 0;    // prefix already counted/checked
    int64_t newlines = 0;   // FASTQ: '\n' count in [0, scanned)
    bool eof = false;
    int64_t cut = -1;  // arena[0, cut) parses here; the rest carries over
    for (;;) {
      int64_t want = filled + chunk_bytes;
      if ((int64_t)b->arena.size() < want) b->arena.resize((size_t)want);
      while (filled < want) {
        int64_t got =
            r->src.read(b->arena.data() + filled, (size_t)(want - filled));
        if (got < 0) {
          J.put_batch(b);
          J.fail("decompression/read error");
          return true;
        }
        if (got == 0) {
          eof = true;
          break;
        }
        filled += got;
      }
      if (filled == 0) {
        J.put_batch(b);
        return true;  // clean EOF
      }
      if (kind == 0) {
        uint8_t first = b->arena[0];
        if (first == '@') kind = 1;
        else if (first == '>' && !pair) kind = 2;
        else {
          // interleaved FASTA, leading blank line, or unknown marker:
          // let the serial parser handle it (exact errors / blank-skip)
          r->replay.assign(b->arena.begin(), b->arena.begin() + filled);
          J.put_batch(b);
          return false;
        }
        r->is_fastq = kind == 1 ? 1 : 0;
      }
      if (kind == 1) {
        int64_t tail_nl = 0;
        bool anomaly = false;
        scan_chunk(b->arena.data() + scanned, filled - scanned, &tail_nl,
                   &anomaly);
        // blank-line pair straddling the scan boundary
        if (scanned > 0 && b->arena[scanned - 1] == '\n' &&
            b->arena[scanned] == '\n')
          anomaly = true;
        // ...or straddling a batch cut: every batch starts right after a
        // newline (stream start or post-cut carry), so a leading '\n'
        // here is a blank line whose partner newline left with the
        // previous batch
        if (scanned == 0 && b->arena[0] == '\n') anomaly = true;
        if (anomaly) {
          r->replay.assign(b->arena.begin(), b->arena.begin() + filled);
          J.put_batch(b);
          return false;
        }
        newlines += tail_nl;
        scanned = filled;
        const int64_t glines = pair ? 8 : 4;  // lines per batch unit
        if (newlines / glines > 0) {
          int64_t cut_nl = nth_newline_from_end(
              b->arena.data(), filled, newlines % glines + 1);
          cut = cut_nl + 1;
          break;
        }
      } else {
        // FASTA: the latest "\n>" boundary; earlier tails had none (else
        // we would have cut there), so scan only the new tail
        int64_t lo = scanned > 0 ? scanned - 1 : 0;
        int64_t i = filled - lo;
        const uint8_t* base = b->arena.data() + lo;
        while (i > 1) {
          const void* p = dx_memrchr(base, '>', (size_t)i);
          if (!p) break;
          int64_t q = (int64_t)((const uint8_t*)p - base);
          if (q > 0 && base[q - 1] == '\n') {
            cut = lo + q;
            break;
          }
          i = q;
        }
        scanned = filled;
        if (cut > 0) break;
      }
      if (eof) break;  // no boundary found in the whole stream tail
    }
    if (cut <= 0) {
      // partial record tail at EOF (or a lone trailing record): the
      // serial parser handles the EOF rules and exact error messages
      r->replay.assign(b->arena.begin(), b->arena.begin() + filled);
      J.put_batch(b);
      return false;
    }
    if (cut < filled)
      carry.assign(b->arena.begin() + cut, b->arena.begin() + filled);
    if (records_out && kind == 1) {
      const int64_t gl = pair ? 8 : 4;
      *records_out += (newlines - newlines % gl) / 4;
    }
    b->arena.resize((size_t)cut);
    b->raw_kind = kind;
    b->n_units = 0;
    if (J.prof.on) J.prof.parse.fetch_add(now_ns() - t0);
    seq_no++;
    const int64_t t_push0 = J.prof.on ? now_ns() : 0;
    if (!J.work.push(b)) {
      delete b;
      return true;
    }
    if (J.prof.on) J.prof.reader_stall.fetch_add(now_ns() - t_push0);
    if (eof) {
      if (!carry.empty()) {
        r->replay.assign(carry.begin(), carry.end());
        return false;  // EOF tail (e.g. no final newline): serial finishes
      }
      return true;
    }
  }
  return true;
}

// reader thread body; mode: 0 single, 1 paired (two readers), 2 interleaved
static void filter_reader(FilterJob& J, DxReader* r1, DxReader* r2, int mode) {
  int64_t seq_no = 0;
  int64_t chunked_records = 0;
  if ((mode == 0 || mode == 2) && J.chunk_parse) {
    if (filter_reader_chunked(J, r1, seq_no, mode == 2, &chunked_records)) {
      J.total_batches.store(seq_no);
      J.work.close();
      J.done_cv.notify_all();
      return;
    }
    // anomalous input or EOF tail: r1->replay holds the unconsumed bytes
    // and the serial loop below continues from the same batch number
  }
  int64_t interleaved_count = chunked_records;
  bool eof = false;
  while (!eof && !J.failed.load()) {
    if (J.cancelled()) {
      J.fail("Interrupted");
      return;
    }
    FBatch* b = J.get_batch();
    b->seq_no = seq_no;
    b->paired = mode != 0;
    b->arena.clear();
    b->arena.reserve(kBatchArena + 65536);
    int64_t m1[6], m2[6];
    const int64_t t_parse0 = J.prof.on ? now_ns() : 0;
    while (b->n_units < kBatchRecords) {
      const size_t arena_save = b->arena.size();
      int rc = r1->parse_record_into(b->arena, m1);
      if (rc < 0) {
        J.fail(r1->error);
        delete b;
        return;
      }
      if (rc == 0) {
        eof = true;
        break;
      }
      if (mode == 0) {
        b->meta.insert(b->meta.end(), m1, m1 + 6);
        b->n_units++;
        if ((int64_t)b->arena.size() >= kBatchArena) break;
      } else {
        if (mode == 2) interleaved_count++;
        DxReader* rr = mode == 1 ? r2 : r1;
        int rc2 = rr->parse_record_into(b->arena, m2);
        if (rc2 < 0) {
          J.fail(rr->error);
          delete b;
          return;
        }
        if (rc2 == 0) {
          if (mode == 2) {
            char msg[96];
            snprintf(msg, sizeof(msg),
                     "Uneven number of interleaved sequence pairs. Found "
                     "%lld records.",
                     (long long)interleaved_count);
            J.fail(msg);
            delete b;
            return;
          }
          // paired files: stop at the shorter input, dropping the
          // unpaired mate's bytes (ref: src/remote_filter.rs:931-955)
          b->arena.resize(arena_save);
          eof = true;
          break;
        }
        if (mode == 2) interleaved_count++;
        b->meta.insert(b->meta.end(), m1, m1 + 6);
        b->meta.insert(b->meta.end(), m2, m2 + 6);
        b->n_units++;
        if ((int64_t)b->arena.size() >= kBatchArena) break;
      }
    }
    if (J.prof.on) J.prof.parse.fetch_add(now_ns() - t_parse0);
    if (b->n_units == 0) {
      delete b;
      break;
    }
    seq_no++;
    const int64_t t_push0 = J.prof.on ? now_ns() : 0;
    if (!J.work.push(b)) {
      delete b;
      return;
    }
    if (J.prof.on) J.prof.reader_stall.fetch_add(now_ns() - t_push0);
  }
  J.total_batches.store(seq_no);
  J.work.close();
  J.done_cv.notify_all();
}

}  // namespace

extern "C" {

// Run the full native filter pipeline. Returns 0 on success, -1 on error
// (message in errbuf). `progress` is int64[7]: total_seqs, filtered_seqs,
// total_bp, output_bp, filtered_bp, output_seq_counter — updated atomically
// per batch for live polling; final values are the exact run totals —
// plus [6], a cancel-request flag the caller may set (e.g. from a SIGINT
// handler) to abort the run promptly with an "Interrupted" error.
// mode: 0 single (input), 1 paired (input+input2), 2 interleaved (input).
// range_start/range_end: when range_end >= 0, read only input[start:end)
// (plain files at exact record boundaries — pod-data sharding). Paired mode
// additionally takes range2_start/range2_end for input2, split at the SAME
// record indices (io/split.py split_paired_ranges); interleaved stdin is
// not range-splittable.
int dx_filter_run(const char* input, const char* input2, const char* output,
                  const char* output2, int out_codec, int out_level,
                  int out2_codec, int out2_level, void* probe_handle, int32_t k, int32_t w,
                  int64_t prefix_len, int64_t abs_threshold,
                  double rel_threshold, int32_t deplete, int32_t rename,
                  int32_t n_threads, int64_t* progress, char* errbuf,
                  int64_t errbuf_cap, int64_t range_start,
                  int64_t range_end, int64_t range2_start,
                  int64_t range2_end, const char* zstd_lib) {
  auto set_err = [&](const std::string& m) {
    if (errbuf && errbuf_cap > 0)
      snprintf(errbuf, (size_t)errbuf_cap, "%s", m.c_str());
  };
  int mode = input2 == nullptr ? 0
             : (strcmp(input, "-") == 0 && strcmp(input2, "-") == 0) ? 2
                                                                     : 1;
  if (range_end >= 0 && mode == 2) {
    set_err("byte-range filtering does not support interleaved stdin");
    return -1;
  }
  if (range_end >= 0 && mode == 1 && range2_end < 0) {
    set_err("paired byte-range filtering needs a range for input2");
    return -1;
  }
  DxReader* r1 = range_end >= 0
                     ? dx_open_range(input, range_start, 0,
                                     range_end - range_start)
                     : dx_open(input, zstd_lib);
  if (!r1) {
    set_err(std::string("Failed to open ") + input + ": " + g_open_error);
    return -1;
  }
  DxReader* r2 = nullptr;
  if (mode == 1) {
    r2 = range2_end >= 0
             ? dx_open_range(input2, range2_start, 0,
                             range2_end - range2_start)
             : dx_open(input2, zstd_lib);
    if (!r2) {
      dx_close(r1);
      set_err(std::string("Failed to open ") + input2 + ": " + g_open_error);
      return -1;
    }
  }
  FilterJob J;
  {
    // DEACON_TRACE=1 (the port's tracing) turns the profile on as well
    const char* p = getenv("DEACON_NATIVE_PROFILE");
    const char* t = getenv("DEACON_TRACE");
    J.prof.on = (p != nullptr && p[0] != '\0' && p[0] != '0') ||
                (t != nullptr && strcmp(t, "1") == 0);
  }
  if (out_codec == 2 || (output2 && out2_codec == 2)) {
    J.zst = ZstdApi::get(zstd_lib);
    if (!J.zst) {
      dx_close(r1);
      if (r2) dx_close(r2);
      set_err(std::string("cannot load ") + zstd_lib +
              ", which this output's compression needs");
      return -1;
    }
  }
  J.probe = static_cast<ProbeTable*>(probe_handle);
  J.k = k;
  J.w = w;
  J.prefix_len = prefix_len;
  J.abs_threshold = abs_threshold;
  J.rel_threshold = rel_threshold;
  J.deplete = deplete != 0;
  J.rename = rename != 0;
  J.progress = progress;
  // Workers format+compress their own batches (independent gzip members /
  // zstd frames / xz streams concatenate into valid files), so the writer
  // thread only sequences raw writes and output compression parallelizes
  // across the pool. --rename numbering is writer-order, so it keeps the
  // single-stream writer-side path.
  const bool precompress = !J.rename;
  if (precompress) {
    J.precompress1 = out_codec;
    J.precompress2 = out2_codec;
    J.level1 = out_level;
    J.level2 = out2_level;
  }
  J.w1 = dx_writer_open(output, precompress ? 0 : out_codec, out_level,
                        zstd_lib);
  if (!J.w1) {
    dx_close(r1);
    if (r2) dx_close(r2);
    set_err(std::string("Failed to create output file: ") + output + ": " +
            g_open_error);
    return -1;
  }
  if (output2) {
    J.w2 = dx_writer_open(output2, precompress ? 0 : out2_codec, out2_level,
                          zstd_lib);
    if (!J.w2) {
      dx_writer_close(J.w1);
      dx_close(r1);
      if (r2) dx_close(r2);
      set_err(std::string("Failed to create output file: ") + output2 + ": " +
              g_open_error);
      return -1;
    }
  }

  if (n_threads < 1) {
    int hw = (int)std::thread::hardware_concurrency();
    n_threads = hw > 0 ? hw : 1;
  }
  J.n_workers = n_threads;
  {
    // Chunk-parallel parsing pays when the worker pool is wide enough
    // that a serial parsing reader would be the throughput ceiling; on
    // narrow machines (fewer than 4 cores) it only adds scan work to
    // saturated cores. Env overrides:
    // DEACON_CHUNK_PARSE=1 forces on, =0 forces off.
    int hw = (int)std::thread::hardware_concurrency();
    int effective = hw > 0 && hw < n_threads ? hw : n_threads;
    const char* cp = getenv("DEACON_CHUNK_PARSE");
    if (cp && cp[0] == '0') J.chunk_parse = false;
    else if (cp && cp[0] == '1') J.chunk_parse = true;
    else J.chunk_parse = effective >= 4;
  }

  std::vector<std::thread> workers;
  for (int t = 0; t < n_threads; t++)
    workers.emplace_back([&J] { filter_worker(J); });
  std::thread writer_th([&J] { filter_writer(J); });
  std::thread reader_th([&] { filter_reader(J, r1, r2, mode); });

  reader_th.join();
  for (auto& th : workers) th.join();
  J.done_cv.notify_all();
  writer_th.join();

  // free any batches stranded by a failure, then the recycling pool
  for (auto& kv : J.done) delete kv.second;
  J.done.clear();
  J.drain_free();

  dx_close(r1);
  if (r2) dx_close(r2);
  // a compressed output with zero members must still be a valid stream
  // (the single-stream writer emits header+trailer even when empty)
  int rc_empty = 0;
  if (precompress && !J.failed.load()) {
    std::vector<uint8_t> empty_in, member;
    if (J.bytes1 == 0 && out_codec != 0 &&
        compress_member(out_codec, out_level, J.zst, empty_in, member,
                        true) &&
        !member.empty() &&
        dx_writer_write(J.w1, member.data(), member.size()) != 0)
      rc_empty = -1;
    if (J.w2 && J.bytes2 == 0 && out2_codec != 0 &&
        compress_member(out2_codec, out2_level, J.zst, empty_in, member,
                        true) &&
        !member.empty() &&
        dx_writer_write(J.w2, member.data(), member.size()) != 0)
      rc_empty = -1;
  }
  // BGZF-framed outputs end with the canonical 28-byte EOF marker
  if (precompress && !J.failed.load()) {
    if (out_codec == 1 && out_level <= 3 &&
        dx_writer_write(J.w1, fastdef::kBgzfEof, sizeof(fastdef::kBgzfEof)) !=
            0)
      rc_empty = -1;
    if (J.w2 && out2_codec == 1 && out2_level <= 3 &&
        dx_writer_write(J.w2, fastdef::kBgzfEof, sizeof(fastdef::kBgzfEof)) !=
            0)
      rc_empty = -1;
  }
  int rc1 = dx_writer_close(J.w1);
  int rc2 = J.w2 ? dx_writer_close(J.w2) : 0;
  if (rc_empty) rc1 = -1;

  if (J.prof.on) {
    auto ms = [](const std::atomic<int64_t>& v) {
      return (double)v.load() / 1e6;
    };
    fprintf(stderr,
            "DEACON_NATIVE_PROFILE (ms; compute=thread-CPU, io/stall=wall; %d workers)\n"
            "  reader: parse=%.1f stall=%.1f\n"
            "  workers: parse=%.1f extract=%.1f probe=%.1f format=%.1f "
            "compress=%.1f stall=%.1f\n"
            "  writer: emit=%.1f write=%.1f stall=%.1f\n",
            J.n_workers, ms(J.prof.parse), ms(J.prof.reader_stall),
            ms(J.prof.wparse), ms(J.prof.extract), ms(J.prof.probe),
            ms(J.prof.format),
            ms(J.prof.compress), ms(J.prof.worker_stall), ms(J.prof.emit),
            ms(J.prof.write), ms(J.prof.writer_stall));
  }

  if (J.failed.load()) {
    std::lock_guard<std::mutex> lk(J.err_mu);
    set_err(J.err);
    return -1;
  }
  if (rc1 != 0 || rc2 != 0) {
    set_err("native write failed while finishing output");
    return -1;
  }
  if (progress) {
    progress[0] = J.total_seqs;
    progress[1] = J.filtered_seqs;
    progress[2] = J.total_bp;
    progress[3] = J.output_bp;
    progress[4] = J.filtered_bp;
    progress[5] = J.out_counter;
  }
  return 0;
}

}  // extern "C"

extern "C" {

// Test hook for the fast raw-deflate compressor: appends nothing to the
// caller; writes up to out_cap bytes, returns the compressed length or -1
// if it would not fit.
int64_t dx_deflate_raw(const uint8_t* in, int64_t in_len, uint8_t* out,
                       int64_t out_cap) {
  std::vector<uint8_t> buf;
  fastdef::deflate_buffer(in, (size_t)in_len, buf);
  if ((int64_t)buf.size() > out_cap) return -1;
  memcpy(out, buf.data(), buf.size());
  return (int64_t)buf.size();
}

// Test hook for the fast raw-deflate decoder: `out` must have
// kInflateMargin writable bytes beyond out_len. 0 = ok, -1 = error.
int dx_inflate_raw(const uint8_t* in, int64_t in_len, uint8_t* out,
                   int64_t out_len) {
  auto tbs = std::make_unique<fastinf::Tables>();
  return fastinf::inflate_block(in, (size_t)in_len, out, (size_t)out_len,
                                *tbs);
}
}  // extern "C"

// ---------------------------------------------------------------------------
// Record scans of a plain FASTX file for io/split.py's paired split: the
// record index at byte offsets, and the byte offset of record indices, by
// one forward pass over the mapped file.
// ---------------------------------------------------------------------------

namespace {

struct MappedFile {
  const uint8_t* p = nullptr;
  int64_t size = 0;
  int fd = -1;
  bool ok = false;
  explicit MappedFile(const char* path) {
    fd = open(path, O_RDONLY);
    if (fd < 0) return;
    struct stat st;
    if (fstat(fd, &st) != 0) return;
    size = (int64_t)st.st_size;
    if (size == 0) {
      ok = true;  // nothing to map; scans see an empty file
      return;
    }
    void* m = mmap(nullptr, (size_t)size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) return;
    madvise(m, (size_t)size, MADV_SEQUENTIAL);
    p = (const uint8_t*)m;
    ok = true;
  }
  ~MappedFile() {
    if (p) munmap((void*)p, (size_t)size);
    if (fd >= 0) close(fd);
  }
};

// newlines in p[begin, end)
int64_t count_nl(const uint8_t* p, int64_t begin, int64_t end) {
  int64_t c = 0;
  const uint8_t* q = p + begin;
  const uint8_t* lim = p + end;
  while (q < lim) {
    const uint8_t* hit = (const uint8_t*)memchr(q, '\n', (size_t)(lim - q));
    if (!hit) break;
    ++c;
    q = hit + 1;
  }
  return c;
}

// record starts ('>' at a line start) at indices in [begin, end), with a
// virtual newline before index 0
int64_t count_fasta_starts(const uint8_t* p, int64_t begin, int64_t end) {
  int64_t c = 0;
  if (begin == 0 && begin < end && p[0] == '>') ++c;
  const uint8_t* q = p + (begin > 0 ? begin - 1 : begin);
  const uint8_t* lim = p + end;
  while (q + 1 < lim) {
    const uint8_t* hit = (const uint8_t*)memchr(q, '\n', (size_t)(lim - q));
    if (!hit || hit + 1 >= lim) break;
    if (hit[1] == '>') ++c;
    q = hit + 1;
  }
  return c;
}

}  // namespace

extern "C" {

// Record index at each byte offset (offsets ascending, each a record start
// or the file size). 0 = ok, -1 = the file cannot be opened or mapped,
// -2 = an offset is not a FASTQ record boundary (records are 4 lines).
int dx_records_at_offsets(const char* path, const int64_t* offsets,
                          int64_t n, int is_fastq, int64_t* out) {
  MappedFile mf(path);
  if (!mf.ok) return -1;
  int64_t pos = 0, count = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t off = offsets[i] > mf.size ? mf.size : offsets[i];
    if (off < pos) return -1;  // not ascending
    if (is_fastq) {
      count += count_nl(mf.p, pos, off);
      pos = off;
      int64_t eff = count;
      // EOF closes an unterminated final line (the readers' rule)
      if (off == mf.size && mf.size > 0 && mf.p[mf.size - 1] != '\n') ++eff;
      if (eff % 4) return -2;
      out[i] = eff / 4;
    } else {
      count += count_fasta_starts(mf.p, pos, off);
      pos = off;
      out[i] = count;
    }
  }
  return 0;
}

// Byte offset of the start of record r for each r (ascending), the file
// size when the file has fewer records. 0 = ok, -1 = the file cannot be
// opened or mapped.
int dx_offsets_at_records(const char* path, const int64_t* records,
                          int64_t n, int is_fastq, int64_t* out) {
  MappedFile mf(path);
  if (!mf.ok) return -1;
  const uint8_t* lim = mf.p + mf.size;
  int64_t pos = 0;    // scan cursor
  int64_t found = 0;  // newlines (FASTQ) or record starts (FASTA) so far
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = records[i];
    if (r == 0) {
      out[i] = 0;
      continue;
    }
    if (is_fastq) {
      int64_t target = 4 * r;
      while (found < target) {
        const uint8_t* hit = (const uint8_t*)memchr(
            mf.p + pos, '\n', (size_t)(mf.size - pos));
        if (!hit) {
          pos = mf.size;
          break;
        }
        pos = (hit - mf.p) + 1;
        ++found;
      }
      out[i] = found == target ? pos : mf.size;
      continue;
    }
    int64_t target = r + 1;
    int64_t start_off = -1;
    if (found == 0 && pos == 0 && mf.size > 0 && mf.p[0] == '>') {
      found = 1;
      start_off = 0;
      pos = 1;
    }
    while (found < target) {
      int64_t from = pos > 0 ? pos - 1 : 0;
      const uint8_t* hit =
          (const uint8_t*)memchr(mf.p + from, '\n', (size_t)(mf.size - from));
      while (hit && (hit + 1 >= lim || hit[1] != '>'))
        hit = (const uint8_t*)memchr(hit + 1, '\n', (size_t)(lim - (hit + 1)));
      if (!hit) {
        pos = mf.size;
        start_off = -1;
        break;
      }
      ++found;
      start_off = (hit + 1) - mf.p;
      pos = start_off + 1;
    }
    out[i] = (found == target && start_off >= 0) ? start_off : mf.size;
  }
  return 0;
}

}  // extern "C"
