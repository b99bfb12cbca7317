// Host I/O library of deacon_tpu_torch: streaming FASTA/FASTQ reading
// (plain, gzip and BGZF, zstd, xz, bzip2; from a file or stdin, or one
// byte range of a plain or BGZF file) into reader-owned batch arenas, the
// record scans that split a file into ranges, compressed output writing,
// 2-bit packing of
// row slices into the device tile layout, the index file's varint codec
// and writer, sorted-set merges of u64 keys, and batched host minimizer
// extraction. Loaded through ctypes (deacon_tpu_torch/io/native_loader.py),
// which builds it with g++ at first use. The plain versions it is held
// against live in io/fastx.py, io/writers.py, ops/pack.py,
// utils/bincode.py and ops/minimizers_np.py.
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
// worker threads (BGZF inflate, decode-ahead, index encode, extraction)
// never outlive the call or handle that started them. The stateless
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
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

constexpr size_t kBufSize = 1 << 20;

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
  bool ok() const {
    return createDStream && freeDStream && initDStream && decompressStream &&
           isError && createCStream && freeCStream && initCStream &&
           compressStream && endStream && cStreamOutSize;
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
  bool ok() const { return stream_decoder && easy_encoder && code && end; }
  static const LzmaApi& get() {
    static const LzmaApi api = [] {
      LzmaApi a;
      void* h = dlopen_first({"liblzma.so.5", "liblzma.so"});
      bind(h, a.stream_decoder, "lzma_stream_decoder");
      bind(h, a.easy_encoder, "lzma_easy_encoder");
      bind(h, a.code, "lzma_code");
      bind(h, a.end, "lzma_end");
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
      for (;;) {
        std::vector<uint8_t> chunk(kBufSize);
        int64_t got = read_direct(chunk.data(), chunk.size());
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
        a->cv_push.wait(
            lk, [a] { return a->q_bytes < DecodeAhead::kMaxBytes || a->stop; });
        if (a->stop) return;
      }
    });
  }

  int64_t read_ahead(uint8_t* dst, size_t n) {
    DecodeAhead* a = ahead.get();
    size_t out = 0;
    while (out < n) {
      std::unique_lock<std::mutex> lk(a->mu);
      a->cv_pop.wait(lk, [a] { return !a->q.empty() || a->eof || a->err; });
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

  bool refill() {
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

struct DxWriter {
  FILE* file = nullptr;
  Codec codec = Codec::kPlain;
  z_stream zs{};
  bool zs_init = false;
  const ZstdApi* zst = nullptr;
  ZSTD_CStream* zcs = nullptr;
  lzma_stream lz = LZMA_STREAM_INIT;
  bool lz_init = false;
  std::vector<uint8_t> out_buf;
};

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
      if (deflateInit2(&w->zs, level, Z_DEFLATED, 16 + MAX_WBITS, 8,
                       Z_DEFAULT_STRATEGY) != Z_OK) {
        g_open_error = "gzip encoder init failed";
        if (w->file != stdout) fclose(w->file);
        delete w;
        return nullptr;
      }
      w->zs_init = true;
      w->out_buf.resize(kBufSize);
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

int dx_writer_write(DxWriter* w, const uint8_t* data, int64_t len) {
  switch (w->codec) {
    case Codec::kBz2:
      return -1;  // unreachable: open rejects bz2 writers
    case Codec::kPlain:
      return fwrite(data, 1, (size_t)len, w->file) == (size_t)len ? 0 : -1;
    case Codec::kGzip: {
      w->zs.next_in = const_cast<uint8_t*>(data);
      w->zs.avail_in = (uInt)len;
      while (w->zs.avail_in > 0) {
        w->zs.next_out = w->out_buf.data();
        w->zs.avail_out = (uInt)w->out_buf.size();
        if (deflate(&w->zs, Z_NO_FLUSH) != Z_OK) return -1;
        size_t got = w->out_buf.size() - w->zs.avail_out;
        if (got && fwrite(w->out_buf.data(), 1, got, w->file) != got)
          return -1;
      }
      return 0;
    }
    case Codec::kZstd: {
      ZSTD_inBuffer ib{data, (size_t)len, 0};
      while (ib.pos < ib.size) {
        ZSTD_outBuffer ob{w->out_buf.data(), w->out_buf.size(), 0};
        size_t rc = w->zst->compressStream(w->zcs, &ob, &ib);
        if (w->zst->isError(rc)) return -1;
        if (ob.pos && fwrite(w->out_buf.data(), 1, ob.pos, w->file) != ob.pos)
          return -1;
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
        if (got && fwrite(w->out_buf.data(), 1, got, w->file) != got)
          return -1;
      }
      return 0;
    }
  }
  return -1;
}

int dx_writer_close(DxWriter* w) {
  int rc = 0;
  switch (w->codec) {
    case Codec::kBz2:
    case Codec::kPlain:
      break;
    case Codec::kGzip: {
      int r;
      do {
        w->zs.next_out = w->out_buf.data();
        w->zs.avail_out = (uInt)w->out_buf.size();
        r = deflate(&w->zs, Z_FINISH);
        size_t got = w->out_buf.size() - w->zs.avail_out;
        if (got && fwrite(w->out_buf.data(), 1, got, w->file) != got) rc = -1;
      } while (r == Z_OK);
      if (r != Z_STREAM_END) rc = -1;
      deflateEnd(&w->zs);
      w->zs_init = false;
      break;
    }
    case Codec::kZstd: {
      size_t remaining;
      do {
        ZSTD_outBuffer ob{w->out_buf.data(), w->out_buf.size(), 0};
        remaining = w->zst->endStream(w->zcs, &ob);
        if (w->zst->isError(remaining)) {
          rc = -1;
          break;
        }
        if (ob.pos && fwrite(w->out_buf.data(), 1, ob.pos, w->file) != ob.pos)
          rc = -1;
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
        if (got && fwrite(w->out_buf.data(), 1, got, w->file) != got) rc = -1;
      } while (r == LZMA_OK);
      if (r != LZMA_STREAM_END) rc = -1;
      lzma_end(&w->lz);
      w->lz_init = false;
      break;
    }
  }
  if (w->file && w->file != stdout) {
    if (fclose(w->file)) rc = -1;
  } else if (w->file) {
    if (fflush(w->file)) rc = -1;
  }
  w->file = nullptr;
  delete w;
  return rc;
}


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
