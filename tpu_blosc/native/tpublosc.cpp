// tpublosc — native host backend for the tpu_blosc framework.
//
// This is the framework's host runtime: the role the reference
// fills with Plan9 assembly (shuffle_amd64.s / shuffle_arm64.s) and
// third-party Go codec libraries (pierrec/lz4, klauspost/compress).  It is
// a from-scratch C++17 implementation of:
//
//   * LZ4 block format encode (greedy + hash-chain HC) / safe decode
//     (stream-compatible with lz4.CompressBlock/UncompressBlock used at
//     reference codec.go:63-128)
//   * raw Snappy encode / safe decode (≙ klauspost snappy, codec.go:228-244)
//   * byte shuffle / unshuffle with AVX2 specializations for typeSize
//     2/4/8 (≙ shuffle_amd64.s:138-330, generalized) and a blocked
//     generic path (≙ shuffle.go:60-72)
//   * bit shuffle / unshuffle via 8x8 bit anti-transpose on uint64 planes
//     (≙ the scalar GPR transpose at shuffle_amd64.s:346-1394, but using
//     the mask-shift trick instead of per-bit moves)
//   * OpenMP-parallel whole-chunk block pipelines (shuffle+compress /
//     decompress+unshuffle of every block of a chunk in one call) — the
//     host-side analogue of sharding blocks across devices.
//
// Exported C ABI consumed by native/backend.py via ctypes.  All functions
// are thread-safe and allocation-free on the hot path (callers provide
// bounded output buffers; per-thread scratch is stack/heap local).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <algorithm>
#include <mutex>
#include <thread>
#include <vector>

#include <cstdio>
#include <dlfcn.h>
#include <pthread.h>
#include <time.h>
#include <unistd.h>

#if defined(__x86_64__) || defined(_M_X64)
#include <emmintrin.h>
#endif

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__GLIBC__)
#include <malloc.h>
// Large allocations normally go through mmap and are munmap'd on free, so
// every buffer pays full page-fault cost again — pathological on
// virtualized hosts with slow fault handling (measured ~50us/page on the
// target VM: a fresh 64 MB buffer costs ~1 s before a single byte of real
// work).  Keeping large blocks on the brk heap lets glibc reuse
// already-faulted pages across the allocate/free churn of a compression
// pipeline.  Opt out with TPU_BLOSC_NO_MALLOC_TUNE=1.
__attribute__((constructor)) static void tpb_tune_malloc() {
  if (!std::getenv("TPU_BLOSC_NO_MALLOC_TUNE")) {
    mallopt(M_MMAP_MAX, 0);
    mallopt(M_TRIM_THRESHOLD, -1);
  }
}
#endif

#if defined(__AVX2__)
#include <immintrin.h>
#endif

// System compression libraries for the ZLIB/ZSTD block pipelines (the
// reference uses klauspost/compress for both, codec.go:134-222; the
// formats are standard so any conformant implementation interoperates).
// zlib is linked; libzstd is dlopen'd (see ZstdLib below).
#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// libzstd, resolved at run time
//
// Hosts often ship the runtime libzstd.so.1 without its development header
// or link-time symlink, so the build neither includes <zstd.h> nor links
// -lzstd: the stable-ABI subset used here is declared locally and
// resolved with dlopen on first use.  Without a loadable libzstd every
// ZSTD call reports an error and tpb_zstd_available() returns 0 (the
// Python layer then keeps the ZSTD codec off the native paths).
// ---------------------------------------------------------------------------

typedef struct ZSTD_CCtx_s ZSTD_CCtx;
typedef struct ZSTD_DCtx_s ZSTD_DCtx;
constexpr unsigned long long ZSTD_CONTENTSIZE_UNKNOWN = 0ULL - 1;
constexpr unsigned long long ZSTD_CONTENTSIZE_ERROR = 0ULL - 2;

struct ZstdLib {
  ZSTD_CCtx *(*create_c)(void) = nullptr;
  size_t (*free_c)(ZSTD_CCtx *) = nullptr;
  ZSTD_DCtx *(*create_d)(void) = nullptr;
  size_t (*free_d)(ZSTD_DCtx *) = nullptr;
  size_t (*compress_cctx)(ZSTD_CCtx *, void *, size_t, const void *, size_t,
                          int) = nullptr;
  size_t (*compress)(void *, size_t, const void *, size_t, int) = nullptr;
  size_t (*decompress_dctx)(ZSTD_DCtx *, void *, size_t, const void *,
                            size_t) = nullptr;
  size_t (*decompress)(void *, size_t, const void *, size_t) = nullptr;
  unsigned (*is_error)(size_t) = nullptr;
  size_t (*bound)(size_t) = nullptr;
  unsigned long long (*content_size)(const void *, size_t) = nullptr;
  size_t (*frame_size)(const void *, size_t) = nullptr;
  bool ok = false;
  ZstdLib() {
    const char *names[] = {"libzstd.so.1", "libzstd.so", "libzstd.1.dylib",
                           "libzstd.dylib"};
    void *h = nullptr;
    for (const char *name : names) {
      if ((h = dlopen(name, RTLD_NOW)) != nullptr) break;
    }
    if (!h) return;
    create_c = (ZSTD_CCtx * (*)(void)) dlsym(h, "ZSTD_createCCtx");
    free_c = (size_t(*)(ZSTD_CCtx *))dlsym(h, "ZSTD_freeCCtx");
    create_d = (ZSTD_DCtx * (*)(void)) dlsym(h, "ZSTD_createDCtx");
    free_d = (size_t(*)(ZSTD_DCtx *))dlsym(h, "ZSTD_freeDCtx");
    compress_cctx = (size_t(*)(ZSTD_CCtx *, void *, size_t, const void *,
                               size_t, int))dlsym(h, "ZSTD_compressCCtx");
    compress = (size_t(*)(void *, size_t, const void *, size_t,
                          int))dlsym(h, "ZSTD_compress");
    decompress_dctx = (size_t(*)(ZSTD_DCtx *, void *, size_t, const void *,
                                 size_t))dlsym(h, "ZSTD_decompressDCtx");
    decompress = (size_t(*)(void *, size_t, const void *,
                            size_t))dlsym(h, "ZSTD_decompress");
    is_error = (unsigned (*)(size_t))dlsym(h, "ZSTD_isError");
    bound = (size_t(*)(size_t))dlsym(h, "ZSTD_compressBound");
    content_size = (unsigned long long (*)(const void *, size_t))dlsym(
        h, "ZSTD_getFrameContentSize");
    frame_size = (size_t(*)(const void *, size_t))dlsym(
        h, "ZSTD_findFrameCompressedSize");
    ok = create_c && free_c && create_d && free_d && compress_cctx &&
         compress && decompress_dctx && decompress && is_error && bound &&
         content_size && frame_size;
  }
};

static const ZstdLib &zstd_lib() {
  static const ZstdLib lib;
  return lib;
}

// zstd.h-shaped wrappers: the codec code below reads as plain libzstd use.
// An unloaded library yields null contexts and error codes.
constexpr size_t kZstdError = (size_t)-1;
static inline ZSTD_CCtx *ZSTD_createCCtx() {
  return zstd_lib().ok ? zstd_lib().create_c() : nullptr;
}
static inline void ZSTD_freeCCtx(ZSTD_CCtx *p) {
  if (p) zstd_lib().free_c(p);
}
static inline ZSTD_DCtx *ZSTD_createDCtx() {
  return zstd_lib().ok ? zstd_lib().create_d() : nullptr;
}
static inline void ZSTD_freeDCtx(ZSTD_DCtx *p) {
  if (p) zstd_lib().free_d(p);
}
static inline size_t ZSTD_compressCCtx(ZSTD_CCtx *c, void *dst, size_t cap,
                                       const void *src, size_t n, int lv) {
  return zstd_lib().compress_cctx(c, dst, cap, src, n, lv);
}
static inline size_t ZSTD_compress(void *dst, size_t cap, const void *src,
                                   size_t n, int lv) {
  return zstd_lib().ok ? zstd_lib().compress(dst, cap, src, n, lv)
                       : kZstdError;
}
static inline size_t ZSTD_decompressDCtx(ZSTD_DCtx *d, void *dst, size_t cap,
                                         const void *src, size_t n) {
  return zstd_lib().decompress_dctx(d, dst, cap, src, n);
}
static inline size_t ZSTD_decompress(void *dst, size_t cap, const void *src,
                                     size_t n) {
  return zstd_lib().ok ? zstd_lib().decompress(dst, cap, src, n)
                       : kZstdError;
}
static inline unsigned ZSTD_isError(size_t code) {
  return zstd_lib().ok ? zstd_lib().is_error(code) : 1;
}
static inline size_t ZSTD_compressBound(size_t n) {
  // the library's own bound when loaded; otherwise zstd's documented
  // formula (ZSTD_COMPRESSBOUND) so buffer sizing never depends on it
  if (zstd_lib().ok) return zstd_lib().bound(n);
  return n + (n >> 8) + (n < (128 << 10) ? ((128 << 10) - n) >> 11 : 0);
}
static inline unsigned long long ZSTD_getFrameContentSize(const void *src,
                                                          size_t n) {
  return zstd_lib().ok ? zstd_lib().content_size(src, n)
                       : ZSTD_CONTENTSIZE_ERROR;
}
static inline size_t ZSTD_findFrameCompressedSize(const void *src,
                                                  size_t n) {
  return zstd_lib().ok ? zstd_lib().frame_size(src, n) : kZstdError;
}

#if defined(__x86_64__) || defined(_M_X64)
static inline void cpu_relax() { _mm_pause(); }
#else
static inline void cpu_relax() { std::this_thread::yield(); }
#endif

// ---------------------------------------------------------------------------
// spin pool — sub-microsecond-handoff parallel-for for the small frame jobs
//
// OpenMP region entry costs 2.5-3 us clean and up to ~13 us under the
// target VM's scheduler steal (measured; see kFrameSegMin history), which
// made parallelism a loss below ~512 KiB.  This pool keeps three workers
// spinning for ~50 us after the last task (then they futex-sleep), so a
// hot handoff is one atomic store + CAS claims — engaging the whole host
// on the reference's own 100 KB benchmark shape.
//
// Safety model: tasks are claimed by compare-exchange on a single
// {generation, index} word, so a worker that raced past a task switch
// can never execute a stale function on a fresh index (its CAS fails on
// the generation bits).  run() returns only after every claimed slice
// reported completion, and try_lock serializes callers — a concurrent
// caller just runs its loop serially.  fork() is detected by pid and the
// pool restarts in the child.
//
// No condvar: a futex wake costs ~45 us of VM exits on the target
// firecracker host (measured — it stalled the NOTIFIER that long and
// delayed the woken workers further).  Idle workers instead nap with
// nanosleep on an exponential backoff (100 us → 4 ms cap) and re-check
// the cursor when they wake: the dispatching thread never syscalls, a
// burst's first call after an idle period simply runs its slices itself
// while the workers self-wake, and everything after that is parallel.
// ---------------------------------------------------------------------------
class SpinPool {
 public:
  using Fn = void (*)(void *, int);
  static constexpr int kWorkers = 3;  // + the calling thread = 4 lanes

  // Run fn(arg, i) for i in [0, n); false = caller must loop serially
  // (pool busy, single-thread config, re-entry, or n tiny).
  bool run(Fn fn, void *arg, int n) {
    if (n <= 1 || lanes_.load(std::memory_order_relaxed) <= 1) return false;
    // Re-entry guard: a slice the OWNING thread executes inline may call
    // run() again (batch slices -> fused small-frame / segmented-zlib
    // encode), and std::mutex::try_lock by the thread that already holds
    // the mutex is UB.  Workers' nested try_lock is defined (fails busy).
    if (owner_) return false;
    if (!job_mtx_.try_lock()) return false;
    owner_ = true;
    job_active_.store(true, std::memory_order_relaxed);
    ensure_started();
    // Two-generation publication: PARK the cursor on a fresh generation
    // with an exhausted index BEFORE touching the job fields, so a worker
    // that stalled holding the previous generation can never pair its
    // stale generation with this job's n (it would claim an index the
    // previous job never issued, double-executing a slice and overcounting
    // done_ — run() would then return while a worker still used the
    // caller's stack context).  After the park, every claim against any
    // older generation fails on the generation bits, and claims against
    // the park generation see an exhausted index; only the second bump
    // publishes real work, with the job fields safely ordered before it.
    cursor_.store((++gen_ << 20) | 0xFFFFF, std::memory_order_release);
    fn_.store(fn, std::memory_order_relaxed);
    arg_.store(arg, std::memory_order_relaxed);
    n_.store(n, std::memory_order_relaxed);
    done_.store(0, std::memory_order_relaxed);
    const uint64_t g = ++gen_;  // guarded by job_mtx_
    cursor_.store(g << 20, std::memory_order_release);
    for (;;) {
      const int i = claim(g, n);
      if (i < 0) break;
      fn(arg, i);
      done_.fetch_add(1, std::memory_order_release);
    }
    while (done_.load(std::memory_order_acquire) < n) cpu_relax();
    job_active_.store(false, std::memory_order_relaxed);
    owner_ = false;
    job_mtx_.unlock();
    return true;
  }

  // Cheap advisory: is a job running right now (so a nested run() from a
  // worker/owner would certainly return false)?  Callers use it to skip
  // work that only pays off if the pool engages — e.g. the fused-decode
  // split scan from inside a batch slice (a few us per small frame,
  // measured wasted on every decompress_batch item before this hint).
  bool busy_hint() const {
    return owner_ || job_active_.load(std::memory_order_relaxed);
  }

  void set_lanes(int n) {
    std::lock_guard<std::mutex> lk(job_mtx_);  // orders lanes_user_ vs
    lanes_user_ = true;                        // ensure_started's read
    lanes_.store(n < 1 ? 1 : (n > 1 + kWorkers ? 1 + kWorkers : n),
                 std::memory_order_relaxed);
  }

 private:
  int claim(uint64_t g, int n) {
    uint64_t cur = cursor_.load(std::memory_order_relaxed);
    for (;;) {
      if ((cur >> 20) != g) return -1;  // task switched
      const int idx = (int)(cur & 0xFFFFF);
      if (idx >= n) return -2;  // exhausted
      if (cursor_.compare_exchange_weak(cur, cur + 1,
                                        std::memory_order_acquire,
                                        std::memory_order_relaxed))
        return idx;
    }
  }

  void ensure_started() {  // guarded by job_mtx_
    if (started_ && !g_forked.load(std::memory_order_relaxed)) return;
    if (!atfork_registered_) {
      pthread_atfork(nullptr, nullptr,
                     [] { g_forked.store(true, std::memory_order_relaxed); });
      atfork_registered_ = true;
    }
    g_forked.store(false, std::memory_order_relaxed);
    if (!lanes_user_) {
      const int hc = (int)std::thread::hardware_concurrency();
      lanes_.store(hc < 1 ? 1 : (hc > 1 + kWorkers ? 1 + kWorkers : hc),
                   std::memory_order_relaxed);
    }
    // fresh process (first use, or child after fork: inherited workers
    // do not exist here) — reset coordination state and spawn workers
    cursor_.store(gen_ << 20 | 0xFFFFF, std::memory_order_relaxed);
    for (int w = 0; w < kWorkers; w++)
      std::thread([this, w] { worker_loop(w); }).detach();
    started_ = true;
  }

  void worker_loop(int w) {
    uint64_t last = cursor_.load(std::memory_order_acquire) >> 20;
    for (;;) {
      uint64_t cur = cursor_.load(std::memory_order_acquire);
      uint64_t g = cur >> 20;
      if (g == last) {
        // no new task: spin ~30 us, then nap with exponential backoff
        int spins = 0;
        long nap_ns = 100 * 1000;
        for (;;) {
          cpu_relax();
          cur = cursor_.load(std::memory_order_acquire);
          if ((cur >> 20) != last) break;
          if (++spins > 20000) {
            struct timespec ts = {0, nap_ns};
            nanosleep(&ts, nullptr);
            // cap 16 ms: an idle process costs ~60 timer wakes/s/worker,
            // and a late joiner only means the burst's first calls run
            // serial-speed while the workers arrive
            if (nap_ns < 16 * 1000 * 1000) nap_ns *= 2;
            cur = cursor_.load(std::memory_order_acquire);
            if ((cur >> 20) != last) break;
          }
        }
        continue;
      }
      last = g;
      if (w + 2 > lanes_.load(std::memory_order_relaxed)) continue;
      Fn fn = fn_.load(std::memory_order_relaxed);
      void *arg = arg_.load(std::memory_order_relaxed);
      const int n = n_.load(std::memory_order_relaxed);
      for (;;) {
        const int i = claim(g, n);
        if (i < 0) break;
        fn(arg, i);
        done_.fetch_add(1, std::memory_order_release);
      }
    }
  }

  std::mutex job_mtx_;          // one task at a time; try_lock => serial
  std::atomic<bool> job_active_{false};    // advisory, see busy_hint()
  std::atomic<uint64_t> cursor_{0xFFFFF};  // (gen << 20) | next index
  std::atomic<int> done_{0};
  std::atomic<int> lanes_{1 + kWorkers};
  uint64_t gen_ = 0;
  std::atomic<Fn> fn_{nullptr};
  std::atomic<void *> arg_{nullptr};
  std::atomic<int> n_{0};
  bool started_ = false;
  bool lanes_user_ = false;
  bool atfork_registered_ = false;
  static std::atomic<bool> g_forked;
  // true while THIS thread holds job_mtx_ (see run()'s re-entry guard)
  static thread_local bool owner_;
};

std::atomic<bool> SpinPool::g_forked{false};
thread_local bool SpinPool::owner_ = false;

static SpinPool &spin_pool() {
  static SpinPool *p = new SpinPool();  // leaked: workers live to exit
  return *p;
}

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

static inline uint32_t read32(const uint8_t *p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static inline uint64_t read64(const uint8_t *p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

static inline void write64(uint8_t *p, uint64_t v) { std::memcpy(p, &v, 8); }

// Copy an LZ match dst[k] = dst[k - offset] for k in [0, len).  Handles the
// self-overlapping case (offset < len) in O(len) with pattern doubling
// instead of byte-by-byte — critical for the long small-offset runs that
// shuffled ramp data produces.
static inline void match_copy(uint8_t *d, int64_t offset, int64_t len) {
  const uint8_t *s = d - offset;
  if (offset >= len) {
    std::memmove(d, s, (size_t)len);
    return;
  }
  // seed one period, then double: each memcpy source [d-offset, …) is
  // fully written and p stays a multiple of offset
  for (int64_t k = 0; k < offset; k++) d[k] = s[k];
  int64_t p = offset;
  while (p < len) {
    int64_t chunk = std::min(p, len - p);
    std::memcpy(d + p, d, (size_t)chunk);
    p += chunk;
  }
}

// ---------------------------------------------------------------------------
// LZ4 block format
// ---------------------------------------------------------------------------

constexpr int kMinMatch = 4;
constexpr int kMfLimit = 12;       // no match starts within last 12 bytes
constexpr int kLastLiterals = 5;   // last 5 bytes are always literals
constexpr int kMaxOffset = 65535;
constexpr int kHashLog = 16;
constexpr uint32_t kHashMult = 2654435761u;

static inline uint32_t lz4_hash(uint32_t v) {
  return (v * kHashMult) >> (32 - kHashLog);
}

// Worst case size (mirror of lz4_ref.compress_bound).
static inline int64_t lz4_bound(int64_t n) { return n + n / 255 + 16; }

// Where an encoded block's final literals-only token sits — the segment-
// concatenation path (lz4_frame_parallel) needs it to stitch seams: a
// literals-only token is only valid at end-of-block, so a non-final
// segment's tail literals must be merged into the next segment's first
// sequence.  tok_off == 0 means the whole stream is one literal token.
struct Lz4Tail {
  int64_t tok_off = 0;  // output offset of the final token byte
  int64_t lit_len = 0;  // its literal count
};

// Emit literal run + optional match; returns new output pos or -1 on overflow.
static inline int64_t lz4_emit(uint8_t *dst, int64_t di, int64_t cap,
                               const uint8_t *lit, int64_t lit_len,
                               int offset, int64_t match_len) {
  const int64_t ml = match_len > 0 ? match_len - kMinMatch : 0;
  // worst-case bytes for this sequence
  int64_t need = 1 + lit_len + lit_len / 255 + 1 + 2 + ml / 255 + 1;
  if (di + need > cap) return -1;
  uint8_t *op = dst + di;
  uint8_t token_lit = lit_len >= 15 ? 15 : (uint8_t)lit_len;
  uint8_t token_ml =
      match_len > 0 ? (ml >= 15 ? 15 : (uint8_t)ml) : 0;
  *op++ = (uint8_t)((token_lit << 4) | token_ml);
  if (lit_len >= 15) {
    int64_t rem = lit_len - 15;
    while (rem >= 255) { *op++ = 255; rem -= 255; }
    *op++ = (uint8_t)rem;
  }
  std::memcpy(op, lit, (size_t)lit_len);
  op += lit_len;
  if (match_len > 0) {
    *op++ = (uint8_t)(offset & 0xFF);
    *op++ = (uint8_t)(offset >> 8);
    if (ml >= 15) {
      int64_t rem = ml - 15;
      while (rem >= 255) { *op++ = 255; rem -= 255; }
      *op++ = (uint8_t)rem;
    }
  }
  return op - dst;
}

// Greedy/HC LZ4 block encoder.  depth==1: greedy, single hash probe
// (≙ lz4.CompressBlock); depth>1: hash-chain search of that many candidates
// (≙ lz4.CompressBlockHC effort tiers, see codecs/lz4_ref.hc_depth_for_level).
// Callers may pass per-thread tables (head: 1<<kHashLog u32, chain: 65536
// u32) to avoid per-block allocation; pass nullptr for one-shot use.
//
// TAGGED mode (epoch > 0): head/chain entries carry an 8-bit epoch in
// their top byte and the per-call 256 KiB table memset is skipped —
// entries from other calls simply fail the epoch check.  That memset is
// 66% of a 100 KB encode (measured), so the scratch-reusing pipelines
// pass a per-scratch epoch counter (BlockScratch::next_epoch clears on
// wrap).  Match discovery — and therefore the output stream — is
// byte-identical to the memset mode.  Requires n + 1 < 2^24.
template <bool TAGGED>
static int64_t lz4_compress_impl(const uint8_t *src, int64_t n, uint8_t *dst,
                                 int64_t cap, int depth, uint32_t *head,
                                 uint32_t *chain, uint32_t epoch,
                                 Lz4Tail *tail = nullptr) {
  int64_t di = 0;
  const uint32_t tag = epoch << 24;

  // entry -> candidate position (or -1); TAGGED validates the epoch byte
  auto epos = [&](uint32_t e) -> int64_t {
    if (TAGGED) {
      if ((e >> 24) != epoch) return -1;
      return (int64_t)(e & 0xFFFFFF) - 1;
    }
    return (int64_t)e - 1;
  };
  auto etag = [&](int64_t pos) -> uint32_t {
    return TAGGED ? (tag | (uint32_t)(pos + 1)) : (uint32_t)(pos + 1);
  };

  const int64_t limit = n - kMfLimit;        // last valid match start
  const int64_t match_limit = n - kLastLiterals;
  int64_t anchor = 0, i = 0;
  int64_t search_count = 0;

  while (i <= limit) {
    uint32_t seq = read32(src + i);
    uint32_t h = lz4_hash(seq);
    int64_t best_ref = -1, best_len = 0;

    int64_t cand = epos(head[h]);
    int d = depth;
    while (cand >= 0 && cand < i && d > 0 && i - cand <= kMaxOffset) {
      if (read32(src + cand) == seq) {
        int64_t mlen = kMinMatch;
        // fast extension: 64-byte then 32-byte AVX2 compares (long matches
        // dominate on shuffled numeric data — ratios >100x mean multi-KB
        // matches), then 8-byte, then the ctz on the differing word
#if defined(__AVX2__)
        while (i + mlen + 64 <= match_limit) {
          __m256i va0 =
              _mm256_loadu_si256((const __m256i *)(src + cand + mlen));
          __m256i vb0 = _mm256_loadu_si256((const __m256i *)(src + i + mlen));
          __m256i va1 =
              _mm256_loadu_si256((const __m256i *)(src + cand + mlen + 32));
          __m256i vb1 =
              _mm256_loadu_si256((const __m256i *)(src + i + mlen + 32));
          uint32_t eq0 = (uint32_t)_mm256_movemask_epi8(
              _mm256_cmpeq_epi8(va0, vb0));
          uint32_t eq1 = (uint32_t)_mm256_movemask_epi8(
              _mm256_cmpeq_epi8(va1, vb1));
          uint64_t eq = (uint64_t)eq0 | ((uint64_t)eq1 << 32);
          if (eq != ~0ull) {
            mlen += __builtin_ctzll(~eq);
            goto match_done;
          }
          mlen += 64;
        }
        while (i + mlen + 32 <= match_limit) {
          __m256i va = _mm256_loadu_si256((const __m256i *)(src + cand + mlen));
          __m256i vb = _mm256_loadu_si256((const __m256i *)(src + i + mlen));
          uint32_t eq = (uint32_t)_mm256_movemask_epi8(
              _mm256_cmpeq_epi8(va, vb));
          if (eq != 0xFFFFFFFFu) {
            mlen += __builtin_ctz(~eq);
            goto match_done;
          }
          mlen += 32;
        }
#endif
        while (i + mlen + 8 <= match_limit &&
               read64(src + cand + mlen) == read64(src + i + mlen))
          mlen += 8;
        if (i + mlen + 8 > match_limit) {
          while (i + mlen < match_limit && src[cand + mlen] == src[i + mlen])
            mlen++;
        } else {
          uint64_t diff = read64(src + cand + mlen) ^ read64(src + i + mlen);
          mlen += __builtin_ctzll(diff) >> 3;
        }
#if defined(__AVX2__)
      match_done:;
#endif
        if (mlen > best_len) {
          best_len = mlen;
          best_ref = cand;
          if (!chain) break;
        }
      }
      if (!chain) break;
      d--;
      cand = epos(chain[cand & 0xFFFF]);
    }

    if (chain) chain[i & 0xFFFF] = head[h];
    head[h] = etag(i);

    if (best_len >= kMinMatch) {
      int64_t ref = best_ref;
      while (i > anchor && ref > 0 && src[i - 1] == src[ref - 1]) {
        i--;
        ref--;
        best_len++;
      }
      di = lz4_emit(dst, di, cap, src + anchor, i - anchor,
                    (int)(i - ref), best_len);
      if (di < 0) break;
      // insert a few positions inside the match so future matches can
      // reference it (greedy LZ4 inserts i+2; do the same cheaply)
      if (i + 2 <= limit) {
        uint32_t h2 = lz4_hash(read32(src + i + 2));
        if (chain) chain[(i + 2) & 0xFFFF] = head[h2];
        head[h2] = etag(i + 2);
      }
      i += best_len;
      anchor = i;
      search_count = 0;
    } else {
      // acceleration through incompressible regions (like LZ4 searchMatchNb)
      search_count++;
      i += 1 + (depth == 1 ? (search_count >> 6) : 0);
    }
  }

  if (di < 0) return -1;
  if (tail) {
    tail->tok_off = di;
    tail->lit_len = n - anchor;
  }
  return lz4_emit(dst, di, cap, src + anchor, n - anchor, 0, 0);
}

// Dispatcher: allocates/clears tables as needed and picks the tagged or
// memset table mode.  ``epoch`` > 0 selects tagged mode (caller manages
// the counter via BlockScratch::next_epoch and guarantees n+1 < 2^24).
static int64_t lz4_compress_t(const uint8_t *src, int64_t n, uint8_t *dst,
                              int64_t cap, int depth, uint32_t *head_ext,
                              uint32_t *chain_ext, uint32_t epoch = 0,
                              Lz4Tail *tail = nullptr) {
  if (n == 0) return 0;
  if (n < kMfLimit + 1) {
    int64_t di = 0;
    if (tail) {
      tail->tok_off = 0;
      tail->lit_len = n;
    }
    return lz4_emit(dst, di, cap, src, n, 0, 0);
  }
  // head[h] = last position + 1 with hash h (0 = empty).
  // chain[pos & 0xFFFF] = previous position + 1 in the same bucket; the
  // 64K window matches the LZ4 offset range.
  const int64_t head_sz = (int64_t)1 << kHashLog;
  uint32_t *head = head_ext;
  uint32_t *chain = chain_ext;
  bool owned = false;
  if (!head) {
    head = (uint32_t *)std::malloc((size_t)head_sz * 4);
    chain = depth > 1 ? (uint32_t *)std::malloc(65536 * 4) : nullptr;
    owned = true;
    if (!head || (depth > 1 && !chain)) {
      std::free(head);
      std::free(chain);
      return -2;
    }
    epoch = 0;  // one-shot tables: memset mode
  }
  if (depth <= 1) chain = nullptr;
  int64_t out;
  if (epoch > 0 && n + 1 <= 0xFFFFFF) {
    out = lz4_compress_impl<true>(src, n, dst, cap, depth, head, chain, epoch,
                                  tail);
  } else {
    std::memset(head, 0, (size_t)head_sz * 4);
    if (chain) std::memset(chain, 0, 65536 * 4);
    out = lz4_compress_impl<false>(src, n, dst, cap, depth, head, chain, 0,
                                   tail);
  }
  if (owned) {
    std::free(head);
    std::free(chain);
  }
  return out;
}

static int64_t lz4_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                            int64_t cap, int depth) {
  return lz4_compress_t(src, n, dst, cap, depth, nullptr, nullptr);
}

// ---------------------------------------------------------------------------
// fixed-offset scan LZ4 encoder
//
// On filtered numeric data the match structure is PERIODIC: nearly every
// position matches at one block-wide offset (the bitshuffle group stride,
// a byte-plane period, a struct pitch...).  The greedy hash encoder pays
// its ~35-cycle loop-carried latency chain (read32 -> hash -> head[] ->
// candidate compare -> AVX extend -> ctz) PER SEQUENCE to rediscover that
// one offset a million times per 16 MiB; this encoder finds it once with
// a sampled probe, builds the equality mask at memory speed (AVX2 compare
// -> bitmask), and walks the mask islands emitting standard LZ4 sequences
// in O(islands).  Measured on the 16 MiB f32 bitshuffle config (BASELINE
// profile: 1.17 M sequences, mean match 14): 0.85 -> 2.2 GB/s single-
// thread AND ratio 4.43 -> 5.29 (one shared offset beats greedy's
// per-position churn).  This is the host mirror of the device match-
// discovery strategy (device.py _device_match_pipeline).
//
// Output is valid LZ4 for ANY block decoder (≙ the stream contract of
// reference codec.go:63-84); it is not byte-identical to the greedy
// encoder -- the pipelines gate engagement on the probe and fall back.
// ---------------------------------------------------------------------------

// probe offsets: pow2 plus 3*pow2 strides cover both power-of-two numeric
// layouts and 3-channel / 96-byte-struct interleaves
static const int kScanOffsets[] = {1,  2,  3,  4,   6,   8,   12,  16,  24, 32,
                                   48, 64, 96, 128, 192, 256, 384, 512, 768,
                                   1024};
constexpr int kNumScanOffsets = sizeof(kScanOffsets) / sizeof(int);
constexpr int kScanMinRun = 8;            // islands shorter than this stay literal
constexpr int64_t kScanMinBytes = 256 * 1024;  // probe cost amortization floor

struct ScanProbe {
  int offset;       // best candidate (0 = none usable)
  double eq_frac;   // equality fraction at best offset
  double mean_run;  // mean equality-run length at best offset
  double iso_frac;  // fraction of breaks that are isolated single bytes
};

// Equality, run-start, and isolated-break counts for one offset over
// [lo, hi).  An isolated break (eq pattern 1,0,1) is the signature of a
// lone corrupted byte in otherwise-periodic data: the greedy encoder
// handles it with one sequence (it switches to offset 2d), the fixed-
// offset scan pays two sequences plus literals, so a window dominated by
// isolated breaks must decline.
static inline void scan_window_stats(const uint8_t *src, int64_t lo,
                                     int64_t hi, int d, int64_t *eqc_out,
                                     int64_t *runs_out,
                                     int64_t *iso_out = nullptr) {
  int64_t eqc = 0, runs = 0, iso = 0;
  uint32_t prev = 0;  // bit0 = previous eq, bit1 = eq before that
  int64_t j = lo;
#if defined(__AVX2__)
  for (; j + 32 <= hi; j += 32) {
    __m256i a = _mm256_loadu_si256((const __m256i *)(src + j));
    __m256i b = _mm256_loadu_si256((const __m256i *)(src + j - d));
    uint32_t m = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(a, b));
    eqc += __builtin_popcount(m);
    // prev bit1 = eq at chunk_pos-1, bit0 = eq at chunk_pos-2
    uint32_t m1 = (m << 1) | (prev >> 1);  // eq one back, aligned to k
    uint32_t m2 = (m << 2) | (prev & 3);   // eq two back, aligned to k
    runs += __builtin_popcount(m & ~m1);
    iso += __builtin_popcount(m & ~m1 & m2);  // 1,0,1 => break at bit k-1
    prev = m >> 30;
  }
#endif
  bool p1 = (prev >> 1) & 1, p2 = prev & 1;
  for (; j < hi; j++) {
    bool e = src[j] == src[j - d];
    eqc += e;
    runs += e && !p1;
    iso += e && !p1 && p2;
    p2 = p1;
    p1 = e;
  }
  *eqc_out += eqc;
  *runs_out += runs;
  if (iso_out) *iso_out += iso;
}

// Two-phase sampled probe: one 4 KiB window over every candidate offset
// (cheap decline for non-periodic data), then two confirmation windows on
// the winner only.  Total cost ~(20+2) * 4 KiB of compares per block.
static ScanProbe lz4_scan_probe(const uint8_t *src, int64_t n) {
  ScanProbe out{0, 0.0, 0.0, 0.0};
  const int64_t win = 4096;
  if (n < 4 * win) return out;
  int64_t besteq = 0, bestruns = 1;
  int best_d = 0;
  const int64_t lo1 = n / 3;
  for (int oi = 0; oi < kNumScanOffsets; oi++) {
    const int d = kScanOffsets[oi];
    if (d * 8 >= n) break;
    int64_t eqc = 0, runs = 0;
    scan_window_stats(src, lo1 < d ? d : lo1, lo1 + win, d, &eqc, &runs);
    if (runs == 0) runs = 1;
    // long-run data (>=98.5% equality in runs longer than the greedy
    // crossover) needs no scan -- greedy skips through giant matches at
    // memory speed.  Decline after this single window so run-friendly
    // workloads pay ~4 KiB of probe, not 20 offsets' worth.
    if (eqc * 64 >= win * 63 && eqc > runs * 48) return out;
    // prefer the offset with the longer mean run among high-equality ones
    if (eqc * 4 >= win * 3 &&
        (best_d == 0 || eqc * bestruns > besteq * runs)) {
      besteq = eqc;
      bestruns = runs;
      best_d = d;
    }
  }
  if (best_d == 0) return out;
  int64_t eqc = besteq, runs = bestruns, tot = win, iso = 0;
  {  // re-stat the phase-1 window for the isolated-break count
    int64_t e0 = 0, r0 = 0;
    scan_window_stats(src, lo1 < best_d ? best_d : lo1, lo1 + win, best_d,
                      &e0, &r0, &iso);
  }
  for (int w = 0; w < 2; w++) {
    int64_t lo = w == 0 ? best_d : n - win;
    int64_t hi = lo + win < n ? lo + win : n;
    scan_window_stats(src, lo, hi, best_d, &eqc, &runs, &iso);
    tot += hi - lo;
  }
  out.offset = best_d;
  out.eq_frac = (double)eqc / (double)tot;
  out.mean_run = (double)eqc / (double)(runs > 0 ? runs : 1);
  out.iso_frac = (double)iso / (double)(runs > 0 ? runs : 1);
  return out;
}

// Emit the scan encoding for offset d.  Returns bytes written, or -1 when
// the output would exceed cap (caller falls back to the greedy encoder).
static int64_t lz4_scan_emit(const uint8_t *src, int64_t n, uint8_t *dst,
                             int64_t cap, int d, uint64_t *mask,
                             Lz4Tail *tail = nullptr) {
  // --- build the equality bitmask (1 bit per byte, LSB-first): whole
  // 64-byte groups produce one full mask word per iteration (two AVX2
  // compares), no memset / read-modify-write traffic ---
  const int64_t nw = (n + 63) >> 6;
  {
    // words fully below d: no matches possible there
    const int64_t head_words = (d + 63) >> 6;  // words touching [0, d)
    for (int64_t w = 0; w < head_words && w < nw; w++) mask[w] = 0;
    // scalar for the partial word containing d (bits < d stay 0)
    int64_t j = d;
    const int64_t head_end = (head_words << 6) < n ? head_words << 6 : n;
    for (; j < head_end; j++)
      if (src[j] == src[j - d]) mask[j >> 6] |= 1ull << (j & 63);
    // full words from head_end
    int64_t w = head_words;
#if defined(__AVX2__)
    const int64_t full = n >> 6;
    for (; w < full; w++) {
      const int64_t p = w << 6;
      __m256i a0 = _mm256_loadu_si256((const __m256i *)(src + p));
      __m256i b0 = _mm256_loadu_si256((const __m256i *)(src + p - d));
      __m256i a1 = _mm256_loadu_si256((const __m256i *)(src + p + 32));
      __m256i b1 = _mm256_loadu_si256((const __m256i *)(src + p + 32 - d));
      uint32_t lo =
          (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(a0, b0));
      uint32_t hi =
          (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(a1, b1));
      mask[w] = (uint64_t)lo | ((uint64_t)hi << 32);
    }
#endif
    // scalar remainder (non-AVX full words + the ragged tail word)
    if (w < nw && w >= head_words) {
      for (int64_t k = w; k < nw; k++) mask[k] = 0;
      for (int64_t p = w << 6; p < n; p++)
        if (src[p] == src[p - d]) mask[p >> 6] |= 1ull << (p & 63);
    }
  }

  // --- walk islands of 1s; emit a sequence per island of length >= T ---
  //
  // Word-at-a-time walk: each mask word is consumed once with ctz steps
  // (island start = next 1, island end = next 0), a carry tracks islands
  // crossing word boundaries, and the bulk of the file runs through a
  // "safe region" with no end-of-block checks and an inlined short-form
  // sequence emit (token + blind 16-byte literal copy + LE16 offset + at
  // most one length byte).  The original bit-cursor walk paid ~31 cycles
  // of branch mispredicts per island (measured: the walk, not the emit,
  // was 83% of a 16 MiB encode); this form is 2.6x faster with output
  // bytes identical at every size (cross-checked in tests).
  const int64_t last_match_start = n - kMfLimit;      // LZ4: start <= n-12
  const int64_t match_end_limit = n - kLastLiterals;  // and end <= n-5
  int64_t di = 0, anchor = 0;
  int64_t run_start = -1;  // open island start carried across words
  bool done = false, overflow = false;

  auto process = [&](int64_t s, int64_t e_raw) {
    // careful-path island handling: exact end-of-block semantics
    if (s >= last_match_start) {
      done = true;
      return;
    }
    int64_t e = e_raw > match_end_limit ? match_end_limit : e_raw;
    int64_t run = e - s;
    if (run < kScanMinRun) return;
    di = lz4_emit(dst, di, cap, src + anchor, s - anchor, d, run);
    if (di < 0) {
      overflow = true;
      done = true;
      return;
    }
    anchor = e;
  };

  // Safe region: islands can neither start past last_match_start nor
  // close past match_end_limit, and every blind 16-byte literal copy
  // stays inside the buffer (anchors <= base+64 <= n-16).
  int64_t safe_words = (last_match_start - 63) >> 6;
  if (safe_words > (match_end_limit - 64) >> 6)
    safe_words = (match_end_limit - 64) >> 6;
  if (safe_words > (n - 80) >> 6) safe_words = (n - 80) >> 6;
  if (safe_words > nw) safe_words = nw;
  if (safe_words < 0) safe_words = 0;

  const uint16_t off16 = (uint16_t)d;
  int64_t w = 0;
  for (; w < safe_words; w++) {
    uint64_t m = mask[w];
    const int64_t base = w << 6;
    if (run_start >= 0) {
      if (m == ~0ull) continue;
      const int e_in = (int)__builtin_ctzll(~m);
      const int64_t s = run_start, e = base + e_in;
      run_start = -1;
      if (e - s >= kScanMinRun) {
        const int64_t lit = s - anchor;
        const int64_t ml = e - s - kMinMatch;
        if (lit < 15 && ml < 15 + 255 && di + lit + 20 <= cap) {
          uint8_t *op = dst + di;
          *op++ = (uint8_t)((lit << 4) | (ml >= 15 ? 15 : ml));
          std::memcpy(op, src + anchor, 16);  // lit <= 14: blind copy
          op += lit;
          std::memcpy(op, &off16, 2);
          op += 2;
          if (ml >= 15) *op++ = (uint8_t)(ml - 15);
          di = op - dst;
        } else {
          di = lz4_emit(dst, di, cap, src + anchor, lit, d, e - s);
          if (di < 0) return -1;
        }
        anchor = e;
      }
      m &= ~0ull << e_in;  // bit e_in is 0; clears the closed island
    }
    while (m) {
      const int s_in = (int)__builtin_ctzll(m);
      const uint64_t z = ~(m | (((uint64_t)1 << s_in) - 1));
      if (!z) {  // island runs to the word end: carry it
        run_start = base + s_in;
        break;
      }
      const int e_in = (int)__builtin_ctzll(z);
      if (e_in - s_in >= kScanMinRun) {
        const int64_t s = base + s_in, e = base + e_in;
        const int64_t lit = s - anchor;
        const int64_t ml = e - s - kMinMatch;
        if (lit < 15 && ml < 15 + 255 && di + lit + 20 <= cap) {
          uint8_t *op = dst + di;
          *op++ = (uint8_t)((lit << 4) | (ml >= 15 ? 15 : ml));
          std::memcpy(op, src + anchor, 16);
          op += lit;
          std::memcpy(op, &off16, 2);
          op += 2;
          if (ml >= 15) *op++ = (uint8_t)(ml - 15);
          di = op - dst;
        } else {
          di = lz4_emit(dst, di, cap, src + anchor, lit, d, e - s);
          if (di < 0) return -1;
        }
        anchor = e;
      }
      m &= ~0ull << e_in;
    }
  }
  for (; w < nw && !done; w++) {  // careful tail: exact clamping
    uint64_t m = mask[w];
    const int64_t base = w << 6;
    if (run_start >= 0) {
      if (m == ~0ull) continue;
      const int e_in = (int)__builtin_ctzll(~m);
      process(run_start, base + e_in);
      run_start = -1;
      if (done) break;
      m &= ~0ull << e_in;
    }
    while (m) {
      const int s_in = (int)__builtin_ctzll(m);
      const uint64_t z = ~(m | (((uint64_t)1 << s_in) - 1));
      if (!z) {
        run_start = base + s_in;
        break;
      }
      const int e_in = (int)__builtin_ctzll(z);
      process(base + s_in, base + e_in);
      if (done) break;
      m &= ~0ull << e_in;
    }
  }
  if (!done && run_start >= 0) process(run_start, n);
  if (overflow) return -1;
  if (tail) {
    tail->tok_off = di;
    tail->lit_len = n - anchor;
  }
  return lz4_emit(dst, di, cap, src + anchor, n - anchor, 0, 0);
}

// ---------------------------------------------------------------------------
// pair-interleaved greedy LZ4 (depth == 1)
//
// The greedy loop is LATENCY-bound: one sequence per iteration whose
// loop-carried chain (read32 -> hash -> head[] load -> candidate compare ->
// AVX extend -> ctz -> next anchor) is ~35 cycles while its instruction
// count would issue in ~10.  Encoding TWO independent blocks in one
// interleaved loop overlaps the chains in the OoO window: measured +74%
// single-thread and +24% under full 4-thread DRAM contention on the
// 64 MiB shuffled-ramp config.  All state lives in caller locals (a
// struct would be reloaded after every dst store — a uint8_t* store may
// alias anything).  Streams are byte-identical to lz4_compress_impl
// (same algorithm, same insert policy) — verified by tests.
// ---------------------------------------------------------------------------

struct Lz4PairArgs {
  const uint8_t *src;
  int64_t n;
  uint8_t *dst;
  int64_t cap;
  uint32_t *head;
  uint32_t epoch;
  int64_t result;  // written back: bytes emitted or -1 on overflow
};

template <bool TAGGED>
static void lz4_compress_pair_impl(Lz4PairArgs &A, Lz4PairArgs &B) {
  // one encode step for one stream; all state passed as caller locals
  auto step = [](const uint8_t *src, uint8_t *dst, const int64_t n,
                 const int64_t cap, const int64_t limit,
                 const int64_t match_limit, uint32_t *head,
                 const uint32_t epoch, int64_t &i, int64_t &anchor,
                 int64_t &di, int64_t &search_count,
                 bool &done) __attribute__((always_inline)) {
    const uint32_t tag = epoch << 24;
    if (i > limit) {
      di = lz4_emit(dst, di, cap, src + anchor, n - anchor, 0, 0);
      done = true;
      return;
    }
    uint32_t seq = read32(src + i);
    uint32_t h = lz4_hash(seq);
    uint32_t e = head[h];
    int64_t cand;
    if (TAGGED) {
      cand = (e >> 24) == epoch ? (int64_t)(e & 0xFFFFFF) - 1 : -1;
    } else {
      cand = (int64_t)e - 1;
    }
    head[h] = TAGGED ? (tag | (uint32_t)(i + 1)) : (uint32_t)(i + 1);

    if (cand >= 0 && cand < i && i - cand <= kMaxOffset &&
        read32(src + cand) == seq) {
      int64_t mlen = kMinMatch;
      // NOTE: the 64-byte double-compare unroll used by lz4_compress_impl
      // measured a wash here — the two-stream interleave already hides the
      // compare latency and the extra registers hurt the step inlining.
#if defined(__AVX2__)
      while (i + mlen + 32 <= match_limit) {
        __m256i va = _mm256_loadu_si256((const __m256i *)(src + cand + mlen));
        __m256i vb = _mm256_loadu_si256((const __m256i *)(src + i + mlen));
        uint32_t eq =
            (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(va, vb));
        if (eq != 0xFFFFFFFFu) {
          mlen += __builtin_ctz(~eq);
          goto pair_match_done;
        }
        mlen += 32;
      }
#endif
      while (i + mlen + 8 <= match_limit &&
             read64(src + cand + mlen) == read64(src + i + mlen))
        mlen += 8;
      if (i + mlen + 8 > match_limit) {
        while (i + mlen < match_limit && src[cand + mlen] == src[i + mlen])
          mlen++;
      } else {
        uint64_t diff = read64(src + cand + mlen) ^ read64(src + i + mlen);
        mlen += __builtin_ctzll(diff) >> 3;
      }
#if defined(__AVX2__)
    pair_match_done:;
#endif
      int64_t ref = cand;
      while (i > anchor && ref > 0 && src[i - 1] == src[ref - 1]) {
        i--;
        ref--;
        mlen++;
      }
      const int64_t ni = i + mlen;
      if (ni <= limit)
        __builtin_prefetch(&head[lz4_hash(read32(src + ni))], 1);
      const int64_t lit_len = i - anchor;
      const int64_t mlc = mlen - kMinMatch;
      const int offset = (int)(i - ref);
      if (lit_len < 15 && mlc < 15 && anchor + 16 <= n && di + 19 <= cap) {
        // short-sequence fast path: fixed-16 literal copy, no call
        uint8_t *op = dst + di;
        *op++ = (uint8_t)((lit_len << 4) | mlc);
        std::memcpy(op, src + anchor, 16);
        op += lit_len;
        op[0] = (uint8_t)(offset & 0xFF);
        op[1] = (uint8_t)(offset >> 8);
        di = (op + 2) - dst;
      } else {
        di = lz4_emit(dst, di, cap, src + anchor, lit_len, offset, mlen);
        if (di < 0) {
          done = true;
          return;
        }
      }
      if (i + 2 <= limit) {
        uint32_t h2 = lz4_hash(read32(src + i + 2));
        head[h2] = TAGGED ? (tag | (uint32_t)(i + 3)) : (uint32_t)(i + 3);
      }
      i = ni;
      anchor = ni;
      search_count = 0;
    } else {
      search_count++;
      i += 1 + (search_count >> 6);
    }
  };

  const uint8_t *srcA = A.src;
  uint8_t *dstA = A.dst;
  const int64_t nA = A.n, capA = A.cap;
  const int64_t limitA = nA - kMfLimit, mlimitA = nA - kLastLiterals;
  uint32_t *headA = A.head;
  const uint32_t epochA = A.epoch;
  int64_t iA = 0, anchorA = 0, diA = 0, scA = 0;
  bool doneA = false;
  const uint8_t *srcB = B.src;
  uint8_t *dstB = B.dst;
  const int64_t nB = B.n, capB = B.cap;
  const int64_t limitB = nB - kMfLimit, mlimitB = nB - kLastLiterals;
  uint32_t *headB = B.head;
  const uint32_t epochB = B.epoch;
  int64_t iB = 0, anchorB = 0, diB = 0, scB = 0;
  bool doneB = false;

  if (nA == 0) doneA = true;
  else if (nA < kMfLimit + 1) {
    diA = lz4_emit(dstA, 0, capA, srcA, nA, 0, 0);
    doneA = true;
  }
  if (nB == 0) doneB = true;
  else if (nB < kMfLimit + 1) {
    diB = lz4_emit(dstB, 0, capB, srcB, nB, 0, 0);
    doneB = true;
  }

  while (!(doneA | doneB)) {
    step(srcA, dstA, nA, capA, limitA, mlimitA, headA, epochA,
         iA, anchorA, diA, scA, doneA);
    step(srcB, dstB, nB, capB, limitB, mlimitB, headB, epochB,
         iB, anchorB, diB, scB, doneB);
  }
  while (!doneA)
    step(srcA, dstA, nA, capA, limitA, mlimitA, headA, epochA,
         iA, anchorA, diA, scA, doneA);
  while (!doneB)
    step(srcB, dstB, nB, capB, limitB, mlimitB, headB, epochB,
         iB, anchorB, diB, scB, doneB);
  A.result = diA;
  B.result = diB;
}

// Gate + dispatch: returns -2 when the scan path declines (caller uses
// the greedy encoder), else the scan result (or -1 on cap overflow).
static int64_t lz4_scan_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                                 int64_t cap, uint64_t *mask,
                                 Lz4Tail *tail = nullptr) {
  static const bool disabled = std::getenv("TPU_BLOSC_NO_SCAN") != nullptr;
  if (disabled) return -2;
  ScanProbe pr = lz4_scan_probe(src, n);
  // engage only where greedy is slow: high equality at one offset with
  // SHORT dense islands.  Greedy throughput ~ mean_run / 16 ns while the
  // scan runs a flat ~2.2-3 GB/s, so past ~48-byte runs greedy wins; and
  // below ~10-byte runs the scan's literal fraction ruins the ratio.
  // iso_frac: data whose breaks are mostly lone corrupted bytes encodes
  // ~2x smaller under greedy (it bridges them at offset 2d) -- decline.
  if (pr.offset == 0 || pr.eq_frac < 0.78 || pr.mean_run < 10.0 ||
      pr.mean_run > 48.0 || pr.iso_frac > 0.55)
    return -2;
  return lz4_scan_emit(src, n, dst, cap, pr.offset, mask, tail);
}

// Emit a valid LZ4 block stream for run-length-encoded data: the input is
// (value, length) run records whose concatenation is the uncompressed
// block.  Each long run becomes one literal byte + an offset-1 match (the
// classic LZ4 RLE form); short runs accumulate into literal sections.
// Used by the device-RLE pipeline: the O(n) run scan happens on the device
// and only O(runs) records reach the host, which emits tokens here in
// O(runs) -- the output decodes with ANY LZ4 block decoder.
//
// Returns bytes written or negative error (cap too small / bad records).
static int64_t lz4_emit_runs(const uint8_t *vals, const int64_t *lens,
                             int64_t nruns, int64_t n, uint8_t *dst,
                             int64_t cap) {
  int64_t di = 0;
  int64_t emitted = 0;        // uncompressed bytes fully covered so far
  // pending literals = optional synthetic head run (leftover of a match)
  // followed by input runs [pend_first, pend_first + pend_count)
  uint8_t synth_val = 0;
  int64_t synth_len = 0;
  int64_t pend_first = 0, pend_count = 0, pend_total = 0;

  auto emit_len_ext = [&](int64_t rem) {
    while (rem >= 255) {
      dst[di++] = 255;
      rem -= 255;
    }
    dst[di++] = (uint8_t)rem;
  };

  auto write_pending_bytes = [&]() {
    if (synth_len) {
      std::memset(dst + di, synth_val, (size_t)synth_len);
      di += synth_len;
    }
    for (int64_t k = 0; k < pend_count; k++) {
      std::memset(dst + di, vals[pend_first + k],
                  (size_t)lens[pend_first + k]);
      di += lens[pend_first + k];
    }
  };

  for (int64_t r = 0; r < nruns; r++) {
    int64_t L = lens[r];
    if (L < 0) return -3;
    if (L == 0) continue;
    int64_t start = emitted + pend_total + synth_len;
    if (start + L > n) return -3;
    if (L >= 5 && start + 1 <= n - kMfLimit) {
      int64_t max_m = (n - kLastLiterals) - (start + 1);
      int64_t mlen = L - 1 < max_m ? L - 1 : max_m;
      if (mlen >= kMinMatch) {
        int64_t lit_len = synth_len + pend_total + 1;
        int64_t ml = mlen - kMinMatch;
        int64_t need = 1 + lit_len + lit_len / 255 + 1 + 2 + ml / 255 + 1;
        if (di + need > cap) return -1;
        dst[di++] = (uint8_t)(((lit_len >= 15 ? 15 : lit_len) << 4) |
                              (ml >= 15 ? 15 : ml));
        if (lit_len >= 15) emit_len_ext(lit_len - 15);
        write_pending_bytes();
        dst[di++] = vals[r];  // seed literal the offset-1 match references
        dst[di++] = 1;        // offset = 1 (little-endian)
        dst[di++] = 0;
        if (ml >= 15) emit_len_ext(ml - 15);
        emitted = start + 1 + mlen;
        synth_len = L - 1 - mlen;  // untaken tail of this run, if any
        synth_val = vals[r];
        pend_first = r + 1;
        pend_count = 0;
        pend_total = 0;
        continue;
      }
    }
    // run joins the pending literals
    if (pend_count == 0) pend_first = r;
    pend_count++;
    pend_total += L;
  }

  // final literal-only sequence (pending + synthetic leftover)
  int64_t lit_len = synth_len + pend_total;
  if (emitted + lit_len != n) return -3;
  if (lit_len > 0) {
    int64_t need = 1 + lit_len + lit_len / 255 + 1;
    if (di + need > cap) return -1;
    dst[di++] = (uint8_t)((lit_len >= 15 ? 15 : lit_len) << 4);
    if (lit_len >= 15) emit_len_ext(lit_len - 15);
    write_pending_bytes();
  }
  return di;
}

// Emit a valid LZ4 block stream from fixed-offset match records: the
// uncompressed block is rows of `seg` bytes; row r reproduces as
// out[i] = literal (at the positions listed in lit_pos, sorted,
// block-relative) or out[i] = out[i - row_d[r]] otherwise.  Every
// non-literal gap must lie within one row, be >= kMinMatch long, start at
// a local offset >= row_d[r], and the block must end with >= 5 literals
// (the device-side mask construction guarantees all of this: positions
// < d and the last 16 bytes of each row are forced literal, and match
// runs survive only if >= the opening window).  Used by the device match
// pipeline: the device discovers matches and ships O(literals) records; the
// host serializes tokens here in O(records).  Output decodes with ANY
// LZ4 block decoder.
//
// Returns bytes written, -1 when cap is too small, -3 on malformed
// records (defensive: indicates a device-side bug, never UB).
static int64_t lz4_emit_mixed(const int64_t *lit_pos, const uint8_t *lit_bytes,
                              int64_t nlit, const int32_t *row_d, int64_t seg,
                              int64_t n, uint8_t *dst, int64_t cap) {
  if (n <= 0 || seg <= 0 || n % seg) return -3;
  int64_t di = 0, p = 0, j = 0;

  auto emit_len_ext = [&](int64_t rem) {
    while (rem >= 255) {
      dst[di++] = 255;
      rem -= 255;
    }
    dst[di++] = (uint8_t)rem;
  };

  while (true) {
    if (j < nlit && lit_pos[j] < p) return -3;  // unsorted / duplicate
    int64_t l0 = j;
    while (j < nlit && lit_pos[j] == p) {
      p++;
      j++;
    }
    int64_t lit_len = j - l0;
    if (j >= nlit) {
      // final literal-only sequence must close the block exactly
      if (p != n) return -3;
      int64_t need = 1 + lit_len / 255 + 1 + lit_len;
      if (di + need > cap) return -1;
      dst[di++] = (uint8_t)((lit_len >= 15 ? 15 : lit_len) << 4);
      if (lit_len >= 15) emit_len_ext(lit_len - 15);
      std::memcpy(dst + di, lit_bytes + l0, (size_t)lit_len);
      di += lit_len;
      return di;
    }
    int64_t next = lit_pos[j];
    // LZ4 end-of-block rules, enforced defensively so emitted streams
    // decode with ANY spec-compliant decoder regardless of producer:
    // last 5 bytes are literals (match end <= n-5) AND the last match
    // must START at least 12 bytes before end-of-block (p <= n-12).
    if (next <= p || next > n - 5 || p > n - 12) return -3;
    int64_t gap = next - p;
    if (gap < kMinMatch) return -3;
    int64_t row = p / seg;
    if ((next - 1) / seg != row) return -3;  // match crosses a row
    int64_t d = row_d[row];
    if (d < 1 || d > 65535 || p - row * seg < d) return -3;
    int64_t ml = gap - kMinMatch;
    int64_t need = 1 + lit_len / 255 + 1 + lit_len + 2 + ml / 255 + 1;
    if (di + need > cap) return -1;
    dst[di++] = (uint8_t)(((lit_len >= 15 ? 15 : lit_len) << 4) |
                          (ml >= 15 ? 15 : ml));
    if (lit_len >= 15) emit_len_ext(lit_len - 15);
    std::memcpy(dst + di, lit_bytes + l0, (size_t)lit_len);
    di += lit_len;
    dst[di++] = (uint8_t)(d & 0xFF);
    dst[di++] = (uint8_t)(d >> 8);
    if (ml >= 15) emit_len_ext(ml - 15);
    p = next;
  }
}

// Safe LZ4 block decoder.  Returns bytes written or negative error.
static int64_t lz4_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                              int64_t cap) {
  int64_t si = 0, di = 0;
  while (si < n) {
    uint8_t token = src[si++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (si >= n) return -1;  // truncated literal length
        b = src[si++];
        lit += b;
      } while (b == 255);
    }
    if (si + lit > n) return -2;   // literal overruns input
    if (di + lit > cap) return -3; // output overflow
    // wild copy when margins allow, exact copy otherwise
    if (lit && si + lit + 16 <= n && di + lit + 16 <= cap) {
      const uint8_t *s = src + si;
      uint8_t *d = dst + di;
      for (int64_t k = 0; k < lit; k += 16) {
        std::memcpy(d + k, s + k, 16);
      }
    } else {
      std::memcpy(dst + di, src + si, (size_t)lit);
    }
    si += lit;
    di += lit;
    if (si >= n) break;  // last sequence: literals only
    if (si + 2 > n) return -4;  // truncated offset
    int64_t offset = src[si] | ((int64_t)src[si + 1] << 8);
    si += 2;
    if (offset == 0 || offset > di) return -5;  // invalid offset
    int64_t mlen = (token & 0xF) + kMinMatch;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (si >= n) return -6;  // truncated match length
        b = src[si++];
        mlen += b;
      } while (b == 255);
    }
    if (di + mlen > cap) return -7;  // output overflow
    uint8_t *d = dst + di;
    const uint8_t *s = d - offset;
#if defined(__AVX2__)
    // NOTE: a register-resident pattern-replication path for small
    // 32-multiple offsets (preload the period, cycle pure stores)
    // measured SLOWER here (25-27 vs 28-33 GB/s on the 64 MiB headline):
    // this core forwards 32-byte-distance store->load fine and the
    // variable-count register loop costs more than it saves.
    if (offset >= 32 && di + mlen + 32 <= cap) {
      for (int64_t k = 0; k < mlen; k += 32)
        _mm256_storeu_si256(
            (__m256i *)(d + k),
            _mm256_loadu_si256((const __m256i *)(s + k)));
    } else
#endif
    if (offset >= 8 && di + mlen + 16 <= cap) {
      for (int64_t k = 0; k < mlen; k += 8) write64(d + k, read64(s + k));
    } else {
      match_copy(d, offset, mlen);
    }
    di += mlen;
  }
  return di;
}

// ---------------------------------------------------------------------------
// parallel single-stream LZ4 decode
//
// Frames produced by the segment-parallel encoder (lz4_frame_parallel)
// have a provable structure: output positions k*seg are always inside a
// literal run (the stitched seams), no match crosses a cut, and every
// match's source stays inside its own segment.  A token PRE-SCAN (no
// byte copying) locates the sequence containing each cut and verifies
// those three properties for the whole stream; when they hold, the
// chunks decode concurrently — the decode-side mirror of the encoder's
// segment parallelism, still on a plain single-block frame.  Streams
// from any other encoder (the reference's, our serial path) simply fail
// the verification at the first cross-cut match and take the sequential
// decoder; correctness never depends on who produced the frame.
// ---------------------------------------------------------------------------

// Locate cut k's containing sequence (token position + literals to skip)
// and verify chunk independence.  Returns false when the stream was not
// produced by our segment layout (caller decodes sequentially).  All
// bounds the chunk decoders rely on are validated here.
// ``cuts`` holds the nseg+1 decoded-stream boundaries (cuts[0]=0,
// cuts[nseg]=n): uniform ceil(n/nseg) pieces for the big-frame layout,
// plane-aligned fused_bounds pieces for the small fused frames (round 5).
// ``tok_cnt`` (optional) collects per-chunk token counts and ``min_off``
// the smallest match offset — the fused small-frame decode's engagement
// heuristics read them (see lz4_fused_decode_unshuffle).
static bool lz4_split_scan(const uint8_t *src, int64_t ns, int64_t n,
                           int nseg, const int64_t *cuts, int64_t *tok_ip,
                           int64_t *lit_skip, int64_t *tok_cnt = nullptr,
                           int64_t *min_off = nullptr) {
  int64_t si = 0, di = 0;
  int next = 1;
  tok_ip[0] = 0;
  lit_skip[0] = 0;
  if (tok_cnt)
    for (int k = 0; k < nseg; k++) tok_cnt[k] = 0;
  if (min_off) *min_off = INT64_MAX;
  // Early imbalance abort (only when stats are requested, i.e. the fused
  // small-frame path): a chunk whose token count blows 4x past the
  // heaviest COMPLETED chunk is the f32-ramp class (one mantissa plane
  // carrying ~all tokens) — the caller's balance gate would reject
  // anyway, so stop paying the scan (~3 us on 880-token streams, a pure
  // 14% loss otherwise).  Armed only once TWO chunks completed and
  // keyed to the completed MAX, so a light FIRST plane (constant-LSB
  // data) before balanced heavy ones never false-aborts (review r5).
  int64_t early_cap = INT64_MAX, completed_max = 0;
  while (si < ns) {
    const int64_t tok_pos = si;
    uint8_t token = src[si++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (si >= ns) return false;
        b = src[si++];
        lit += b;
      } while (b == 255);
    }
    if (si + lit > ns || di + lit > n) return false;
    while (next < nseg && cuts[next] <= di + lit) {
      tok_ip[next] = tok_pos;
      lit_skip[next] = cuts[next] - di;
      if (tok_cnt) {
        completed_max = std::max(completed_max, tok_cnt[next - 1]);
        if (next >= 2) early_cap = 8 + 4 * completed_max;
      }
      next++;
    }
    if (tok_cnt && ++tok_cnt[next - 1] > early_cap) return false;
    si += lit;
    di += lit;
    if (si >= ns) break;  // closing literals-only token
    if (si + 2 > ns) return false;
    const int64_t offset = src[si] | ((int64_t)src[si + 1] << 8);
    si += 2;
    if (offset == 0 || offset > di) return false;
    if (min_off && offset < *min_off) *min_off = offset;
    int64_t mlen = (token & 0xF) + kMinMatch;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (si >= ns) return false;
        b = src[si++];
        mlen += b;
      } while (b == 255);
    }
    if (di + mlen > n) return false;
    // a cut inside a match ⇒ not our seam layout
    if (next < nseg && cuts[next] < di + mlen) return false;
    // independence: the source must stay inside the current chunk
    if (di - offset < cuts[next - 1]) return false;
    di += mlen;
  }
  return di == n && next == nseg;
}

// Decode one chunk: sequences from token position ``si``, dropping the
// first ``skip`` literal bytes (they belong to the previous chunk), into
// dst[c0, c1).  Wild copies are clamped to c1 so no store ever crosses
// into a neighbour chunk (that would race).  The scan validated every
// bound; the checks here only protect against races on corrupt input.
static int64_t lz4_decompress_chunk(const uint8_t *src, int64_t ns,
                                    int64_t si, int64_t skip, uint8_t *dst,
                                    int64_t c0, int64_t c1) {
  int64_t di = c0;
  int64_t drop = skip;
  while (si < ns && di < c1) {
    uint8_t token = src[si++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (si >= ns) return -1;
        b = src[si++];
        lit += b;
      } while (b == 255);
    }
    if (si + lit > ns) return -2;
    int64_t lsrc = si + drop;
    int64_t take = lit - drop;
    drop = 0;
    si += lit;
    if (take < 0) return -2;
    if (take > c1 - di) take = c1 - di;  // seam: stop at the cut
    if (take) {
      if (lsrc + take + 16 <= ns && di + take + 16 <= c1) {
        const uint8_t *s = src + lsrc;
        uint8_t *d = dst + di;
        for (int64_t k = 0; k < take; k += 16) std::memcpy(d + k, s + k, 16);
      } else {
        std::memcpy(dst + di, src + lsrc, (size_t)take);
      }
      di += take;
    }
    if (di >= c1) break;
    if (si >= ns) break;  // closing literals
    if (si + 2 > ns) return -4;
    const int64_t offset = src[si] | ((int64_t)src[si + 1] << 8);
    si += 2;
    if (offset == 0 || di - offset < c0) return -5;  // would cross the cut
    int64_t mlen = (token & 0xF) + kMinMatch;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (si >= ns) return -6;
        b = src[si++];
        mlen += b;
      } while (b == 255);
    }
    if (di + mlen > c1) return -7;
    uint8_t *d = dst + di;
    const uint8_t *s = d - offset;
#if defined(__AVX2__)
    if (offset >= 32 && di + mlen + 32 <= c1) {
      for (int64_t k = 0; k < mlen; k += 32)
        _mm256_storeu_si256((__m256i *)(d + k),
                            _mm256_loadu_si256((const __m256i *)(s + k)));
    } else
#endif
    if (offset >= 8 && di + mlen + 16 <= c1) {
      for (int64_t k = 0; k < mlen; k += 8) write64(d + k, read64(s + k));
    } else {
      match_copy(d, offset, mlen);
    }
    di += mlen;
  }
  return di - c0;
}

// Scan + parallel chunk decode.  Returns n on success, -1000 when the
// stream does not match our segment layout (caller runs the sequential
// decoder, which also owns canonical error codes for corrupt frames).
constexpr int64_t kSplitReject = -1000;
constexpr int kMaxDecodeSegments = 8;  // == kMaxFrameSegments (asserted
                                       // where both are visible)

struct Lz4DecCtx {
  const uint8_t *src;
  uint8_t *dst;
  const int64_t *tok_ip;
  const int64_t *lit_skip;
  const int64_t *cuts;
  int64_t ns, n;
  uint8_t ok[kMaxDecodeSegments];
};

static void lz4_decode_chunk_slice(void *p, int k) {
  Lz4DecCtx &c = *(Lz4DecCtx *)p;
  const int64_t c0 = c.cuts[k], c1 = c.cuts[k + 1];
  c.ok[k] = lz4_decompress_chunk(c.src, c.ns, c.tok_ip[k], c.lit_skip[k],
                                 c.dst, c0, c1) == c1 - c0;
}

static void uniform_cuts(int64_t n, int nseg, int64_t *cuts) {
  const int64_t seg = (n + nseg - 1) / nseg;
  cuts[0] = 0;
  for (int k = 1; k < nseg; k++) cuts[k] = std::min(n, (int64_t)k * seg);
  cuts[nseg] = n;
}

static int64_t lz4_decompress_parallel(const uint8_t *src, int64_t ns,
                                       uint8_t *dst, int64_t n, int nseg) {
  int64_t cuts[kMaxDecodeSegments + 1];
  int64_t tok_ip[kMaxDecodeSegments], lit_skip[kMaxDecodeSegments];
  if (nseg < 2 || nseg > kMaxDecodeSegments) return kSplitReject;
  uniform_cuts(n, nseg, cuts);
  if (!lz4_split_scan(src, ns, n, nseg, cuts, tok_ip, lit_skip))
    return kSplitReject;
  Lz4DecCtx ctx{src, dst, tok_ip, lit_skip, cuts, ns, n, {}};
  if (!spin_pool().run(lz4_decode_chunk_slice, &ctx, nseg))
    for (int k = 0; k < nseg; k++) lz4_decode_chunk_slice(&ctx, k);
  for (int k = 0; k < nseg; k++)
    if (!ctx.ok[k]) return kSplitReject;
  return n;
}

// ---------------------------------------------------------------------------
// raw Snappy
// ---------------------------------------------------------------------------

static inline int64_t snappy_bound(int64_t n) { return 32 + n + n / 6; }

static inline int64_t snappy_emit_literal(uint8_t *dst, int64_t di,
                                          const uint8_t *lit, int64_t len) {
  int64_t n = len - 1;
  if (n < 60) {
    dst[di++] = (uint8_t)(n << 2);
  } else if (n < (1 << 8)) {
    dst[di++] = 60 << 2;
    dst[di++] = (uint8_t)n;
  } else if (n < (1 << 16)) {
    dst[di++] = 61 << 2;
    dst[di++] = (uint8_t)n;
    dst[di++] = (uint8_t)(n >> 8);
  } else if (n < (1 << 24)) {
    dst[di++] = 62 << 2;
    dst[di++] = (uint8_t)n;
    dst[di++] = (uint8_t)(n >> 8);
    dst[di++] = (uint8_t)(n >> 16);
  } else {
    dst[di++] = 63 << 2;
    dst[di++] = (uint8_t)n;
    dst[di++] = (uint8_t)(n >> 8);
    dst[di++] = (uint8_t)(n >> 16);
    dst[di++] = (uint8_t)(n >> 24);
  }
  std::memcpy(dst + di, lit, (size_t)len);
  return di + len;
}

static inline int64_t snappy_emit_copy(uint8_t *dst, int64_t di,
                                       int64_t offset, int64_t length) {
  while (length > 0) {
    int64_t chunk;
    if (length > 64)
      chunk = length < 68 ? 60 : 64;  // never leave a tail < 4
    else
      chunk = length;
    if (chunk >= 4 && chunk <= 11 && offset < 2048) {
      dst[di++] = (uint8_t)(((offset >> 8) << 5) | ((chunk - 4) << 2) | 0x01);
      dst[di++] = (uint8_t)(offset & 0xFF);
    } else {
      dst[di++] = (uint8_t)(((chunk - 1) << 2) | 0x02);
      dst[di++] = (uint8_t)(offset & 0xFF);
      dst[di++] = (uint8_t)(offset >> 8);
    }
    length -= chunk;
  }
  return di;
}

static int64_t snappy_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                               int64_t cap) {
  if (cap < snappy_bound(n)) return -1;
  int64_t di = 0;
  // uvarint preamble
  uint64_t x = (uint64_t)n;
  while (x >= 0x80) {
    dst[di++] = (uint8_t)(x & 0x7F) | 0x80;
    x >>= 7;
  }
  dst[di++] = (uint8_t)x;
  if (n == 0) return di;
  if (n < 16) return snappy_emit_literal(dst, di, src, n);

  constexpr uint32_t kSnappyMult = 0x1E35A7BD;
  constexpr int kTableBits = 14;
  int32_t table[1 << kTableBits];
  std::memset(table, -1, sizeof(table));

  int64_t anchor = 0, i = 0;
  const int64_t limit = n - 4;
  int64_t skip = 32;
  while (i <= limit) {
    uint32_t seq = read32(src + i);
    uint32_t h = (seq * kSnappyMult) >> (32 - kTableBits);
    int64_t cand = table[h];
    table[h] = (int32_t)i;
    if (cand >= 0 && i - cand <= 0xFFFF && read32(src + cand) == seq) {
      // 32-byte vector match extension (same mlen as the byte loop —
      // output bytes identical; the scalar loop was the encoder's
      // bottleneck on long-match data: 3.3 -> ~10 GB/s on the 1 MiB
      // f32 ramp config)
      int64_t mlen = 4;
#if defined(__AVX2__)
      while (i + mlen + 32 <= n) {
        __m256i va = _mm256_loadu_si256((const __m256i *)(src + cand + mlen));
        __m256i vb = _mm256_loadu_si256((const __m256i *)(src + i + mlen));
        uint32_t eq =
            (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(va, vb));
        if (eq != 0xFFFFFFFFu) {
          mlen += __builtin_ctz(~eq);
          goto snappy_match_done;
        }
        mlen += 32;
      }
#endif
      while (i + mlen < n && src[cand + mlen] == src[i + mlen]) mlen++;
#if defined(__AVX2__)
    snappy_match_done:;
#endif
      if (i > anchor) di = snappy_emit_literal(dst, di, src + anchor, i - anchor);
      di = snappy_emit_copy(dst, di, i - cand, mlen);
      i += mlen;
      anchor = i;
      skip = 32;
    } else {
      i += skip >> 5;
      skip++;
    }
  }
  if (anchor < n) di = snappy_emit_literal(dst, di, src + anchor, n - anchor);
  return di;
}

// Fast bounded-length match copy for the Snappy decoders.  Copy ops cap
// length at 64, so with >= 80 bytes of writable slack past the copy the
// chunked forms below may overrun `length` blindly — the overrun sits in
// not-yet-decoded territory that later ops rewrite front-to-back before
// reading it.  `slack` is the caller's remaining writable bytes AFTER
// this copy (serial: total - di; parallel chunks: c1 - di, so a blind
// write can never cross the chunk seam into a concurrent neighbor).
// The generic match_copy's byte-seed + doubling was the decode
// bottleneck: 65% of ramp-class streams' copies have offset < 8
// (measured), and these forms take single-thread decode 2.5 -> 13 GB/s.
// Returns false when there is not enough slack (caller uses match_copy).
static inline bool snappy_fast_copy(uint8_t *d, int64_t offset,
                                    int64_t length, int64_t slack) {
  if (slack < 80) return false;
  const uint8_t *s = d - offset;
  if (offset >= 32) {  // two 32B chunks cover len <= 64, sources final
    std::memcpy(d, s, 32);
    std::memcpy(d + 32, s + 32, 32);
    return true;
  }
  if (offset >= 8) {  // 8B chunks: each chunk's source written before it
    int64_t p = 0;
    do {
      std::memcpy(d + p, s + p, 8);
      p += 8;
    } while (p < length);
    return true;
  }
  uint64_t pat;
  if (offset == 1) {
    pat = 0x0101010101010101ull * s[0];
  } else if (offset == 2) {
    uint16_t v;
    std::memcpy(&v, s, 2);
    pat = 0x0001000100010001ull * v;
  } else if (offset == 4) {
    uint32_t v;
    std::memcpy(&v, s, 4);
    pat = ((uint64_t)v << 32) | v;
  } else {  // 3,5,6,7: byte-seed 16, then 8B chunks at lag16 >= 8
    for (int k = 0; k < 16; k++) d[k] = s[k];
    const int64_t lag16 = 16 - (16 % offset);
    const uint8_t *s2 = d + 16 - lag16;
    int64_t p = 16;
    while (p < length) {
      std::memcpy(d + p, s2 + (p - 16), 8);
      p += 8;
    }
    return true;
  }
  // offsets 1/2/4: pure register stores, no store-to-load forwarding
  int64_t p = 0;
  do {
    std::memcpy(d + p, &pat, 8);
    p += 8;
  } while (p < length);
  return true;
}

static int64_t snappy_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                                 int64_t cap) {
  // uvarint preamble
  uint64_t total = 0;
  int shift = 0;
  int64_t pos = 0;
  for (;;) {
    if (pos >= n || shift > 63) return -1;
    uint8_t b = src[pos++];
    total |= (uint64_t)(b & 0x7F) << shift;
    if (b < 0x80) break;
    shift += 7;
  }
  if ((int64_t)total > cap) return -2;
  int64_t di = 0;
  while (pos < n) {
    uint8_t tag = src[pos++];
    int kind = tag & 0x03;
    if (kind == 0x00) {  // literal
      int64_t len = tag >> 2;
      if (len >= 60) {
        int extra = (int)(len - 59);
        if (pos + extra > n) return -3;
        len = 0;
        for (int k = 0; k < extra; k++) len |= (int64_t)src[pos + k] << (8 * k);
        pos += extra;
      }
      len += 1;
      if (pos + len > n || di + len > (int64_t)total) return -4;
      std::memcpy(dst + di, src + pos, (size_t)len);
      pos += len;
      di += len;
      continue;
    }
    int64_t length, offset;
    if (kind == 0x01) {
      if (pos >= n) return -5;
      length = ((tag >> 2) & 0x7) + 4;
      offset = ((int64_t)(tag >> 5) << 8) | src[pos++];
    } else if (kind == 0x02) {
      if (pos + 2 > n) return -6;
      length = (tag >> 2) + 1;
      offset = src[pos] | ((int64_t)src[pos + 1] << 8);
      pos += 2;
    } else {
      if (pos + 4 > n) return -7;
      length = (tag >> 2) + 1;
      offset = (int64_t)read32(src + pos);
      pos += 4;
    }
    if (offset == 0 || offset > di || di + length > (int64_t)total) return -8;
    uint8_t *d = dst + di;
    di += length;
    if (!snappy_fast_copy(d, offset, length, (int64_t)total - di))
      match_copy(d, offset, length);
  }
  if (di != (int64_t)total) return -9;
  return di;
}

// ---------------------------------------------------------------------------
// parallel Snappy decode (same seam idea as lz4_decompress_parallel, but
// simpler: our per-segment encodes put every cut exactly at an element
// boundary, and Snappy has no end-of-stream token constraints).  The
// scan walks elements, locates each cut, and verifies no copy reaches
// back past its chunk base; foreign streams fail and take the
// sequential decoder.
// ---------------------------------------------------------------------------

static int64_t snappy_preamble(const uint8_t *src, int64_t n, int64_t *hdr);

static bool snappy_split_scan(const uint8_t *src, int64_t ns, int64_t n,
                              int nseg, const int64_t *cuts,
                              int64_t *elem_ip, int64_t *lit_skip,
                              int64_t *tok_cnt = nullptr,
                              int64_t *min_off = nullptr) {
  int64_t hdr = 0;
  if (snappy_preamble(src, ns, &hdr) != n) return false;
  int64_t pos = hdr, di = 0;
  int next = 1;
  elem_ip[0] = hdr;
  lit_skip[0] = 0;
  if (tok_cnt)
    for (int k = 0; k < nseg; k++) tok_cnt[k] = 0;
  if (min_off) *min_off = INT64_MAX;
  int64_t early_cap = INT64_MAX, completed_max = 0;
  while (pos < ns) {
    const int64_t epos = pos;
    while (next < nseg && cuts[next] == di) {
      elem_ip[next] = epos;  // cut exactly at this element's start
      lit_skip[next] = 0;
      if (tok_cnt) {
        completed_max = std::max(completed_max, tok_cnt[next - 1]);
        if (next >= 2) early_cap = 8 + 4 * completed_max;
      }
      next++;
    }
    if (tok_cnt && ++tok_cnt[next - 1] > early_cap) return false;
    uint8_t tag = src[pos++];
    const int kind = tag & 0x03;
    if (kind == 0x00) {
      int64_t len = tag >> 2;
      if (len >= 60) {
        int extra = (int)(len - 59);
        if (pos + extra > ns) return false;
        len = 0;
        for (int k = 0; k < extra; k++)
          len |= (int64_t)src[pos + k] << (8 * k);
        pos += extra;
      }
      len += 1;
      if (pos + len > ns || di + len > n) return false;
      while (next < nseg && cuts[next] < di + len) {
        elem_ip[next] = epos;  // cut inside this literal: skip a prefix
        lit_skip[next] = cuts[next] - di;
        if (tok_cnt) {
          completed_max = std::max(completed_max, tok_cnt[next - 1]);
          if (next >= 2) early_cap = 8 + 4 * completed_max;
        }
        next++;
      }
      pos += len;
      di += len;
      continue;
    }
    int64_t length, offset;
    if (kind == 0x01) {
      if (pos >= ns) return false;
      length = ((tag >> 2) & 0x7) + 4;
      offset = ((int64_t)(tag >> 5) << 8) | src[pos++];
    } else if (kind == 0x02) {
      if (pos + 2 > ns) return false;
      length = (tag >> 2) + 1;
      offset = src[pos] | ((int64_t)src[pos + 1] << 8);
      pos += 2;
    } else {
      if (pos + 4 > ns) return false;
      length = (tag >> 2) + 1;
      offset = (int64_t)read32(src + pos);
      pos += 4;
    }
    if (offset == 0 || offset > di || di + length > n) return false;
    if (min_off && offset < *min_off) *min_off = offset;
    // a cut strictly inside a copy ⇒ not our segment layout
    if (next < nseg && cuts[next] < di + length) return false;
    // independence: the source must stay inside the current chunk
    if (di - offset < cuts[next - 1]) return false;
    di += length;
  }
  return di == n && next == nseg;
}

static int64_t snappy_decompress_chunk(const uint8_t *src, int64_t ns,
                                       int64_t pos, int64_t skip,
                                       uint8_t *dst, int64_t c0, int64_t c1) {
  int64_t di = c0, drop = skip;
  while (pos < ns && di < c1) {
    uint8_t tag = src[pos++];
    const int kind = tag & 0x03;
    if (kind == 0x00) {
      int64_t len = tag >> 2;
      if (len >= 60) {
        int extra = (int)(len - 59);
        if (pos + extra > ns) return -3;
        len = 0;
        for (int k = 0; k < extra; k++)
          len |= (int64_t)src[pos + k] << (8 * k);
        pos += extra;
      }
      len += 1;
      const int64_t lsrc = pos + drop;
      int64_t take = len - drop;
      drop = 0;
      pos += len;
      if (take < 0 || lsrc + take > ns) return -3;
      if (take > c1 - di) take = c1 - di;  // seam: stop at the cut
      std::memcpy(dst + di, src + lsrc, (size_t)take);
      di += take;
      continue;
    }
    if (drop) return -3;  // scan never starts a chunk mid-copy
    int64_t length, offset;
    if (kind == 0x01) {
      if (pos >= ns) return -5;
      length = ((tag >> 2) & 0x7) + 4;
      offset = ((int64_t)(tag >> 5) << 8) | src[pos++];
    } else if (kind == 0x02) {
      if (pos + 2 > ns) return -6;
      length = (tag >> 2) + 1;
      offset = src[pos] | ((int64_t)src[pos + 1] << 8);
      pos += 2;
    } else {
      if (pos + 4 > ns) return -7;
      length = (tag >> 2) + 1;
      offset = (int64_t)read32(src + pos);
      pos += 4;
    }
    if (offset == 0 || di - offset < c0 || di + length > c1) return -8;
    uint8_t *d = dst + di;
    di += length;
    // slack bounded by the CHUNK end: a blind overrun must never cross
    // the seam into a concurrently-decoding neighbor chunk
    if (!snappy_fast_copy(d, offset, length, c1 - di))
      match_copy(d, offset, length);
  }
  return di - c0;
}

struct SnappyDecCtx {
  const uint8_t *src;
  uint8_t *dst;
  const int64_t *elem_ip;
  const int64_t *lit_skip;
  const int64_t *cuts;
  int64_t ns, n;
  uint8_t ok[kMaxDecodeSegments];
};

static void snappy_decode_chunk_slice(void *p, int k) {
  SnappyDecCtx &c = *(SnappyDecCtx *)p;
  const int64_t c0 = c.cuts[k], c1 = c.cuts[k + 1];
  c.ok[k] = snappy_decompress_chunk(c.src, c.ns, c.elem_ip[k], c.lit_skip[k],
                                    c.dst, c0, c1) == c1 - c0;
}

static void uniform_cuts(int64_t n, int nseg, int64_t *cuts);

static int64_t snappy_decompress_parallel(const uint8_t *src, int64_t ns,
                                          uint8_t *dst, int64_t n, int nseg) {
  int64_t cuts[kMaxDecodeSegments + 1];
  int64_t elem_ip[kMaxDecodeSegments], lit_skip[kMaxDecodeSegments];
  if (nseg < 2 || nseg > kMaxDecodeSegments) return kSplitReject;
  uniform_cuts(n, nseg, cuts);
  if (!snappy_split_scan(src, ns, n, nseg, cuts, elem_ip, lit_skip))
    return kSplitReject;
  SnappyDecCtx ctx{src, dst, elem_ip, lit_skip, cuts, ns, n, {}};
  if (!spin_pool().run(snappy_decode_chunk_slice, &ctx, nseg))
    for (int k = 0; k < nseg; k++) snappy_decode_chunk_slice(&ctx, k);
  for (int k = 0; k < nseg; k++)
    if (!ctx.ok[k]) return kSplitReject;
  return n;
}

// ---------------------------------------------------------------------------
// parallel multi-frame ZSTD decode: zstd frames are self-delimiting and
// independent (RFC 8878 §3), so a payload holding several frames — what
// the segment-parallel encoder emits — decodes one frame per thread.
// Single-frame payloads (every other encoder) reject into the sequential
// path.
// ---------------------------------------------------------------------------

// RAII thread-local ZSTD context holders: raw thread_local pointers
// would leak a multi-MB workspace per exiting thread (short-lived caller
// threads churn them); destructors free at thread exit, zero hot cost.
struct ZstdCctxTL {
  ZSTD_CCtx *p = ZSTD_createCCtx();
  ~ZstdCctxTL() { ZSTD_freeCCtx(p); }
};
struct ZstdDctxTL {
  ZSTD_DCtx *p = ZSTD_createDCtx();
  ~ZstdDctxTL() { ZSTD_freeDCtx(p); }
};

static int64_t zstd_decompress_parallel(const uint8_t *src, int64_t ns,
                                        uint8_t *dst, int64_t n) {
  struct Fr {
    int64_t so, cs, dofs, ds;
  };
  Fr frames[2 * kMaxDecodeSegments];
  int nf = 0;
  int64_t so = 0, dofs = 0;
  while (so < ns) {
    if (nf >= 2 * kMaxDecodeSegments) return kSplitReject;
    const unsigned long long c =
        ZSTD_getFrameContentSize(src + so, (size_t)(ns - so));
    if (c == ZSTD_CONTENTSIZE_UNKNOWN || c == ZSTD_CONTENTSIZE_ERROR)
      return kSplitReject;
    const size_t cs = ZSTD_findFrameCompressedSize(src + so, (size_t)(ns - so));
    if (ZSTD_isError(cs) || cs == 0) return kSplitReject;
    if (dofs + (int64_t)c > n) return kSplitReject;
    frames[nf].so = so;
    frames[nf].cs = (int64_t)cs;
    frames[nf].dofs = dofs;
    frames[nf].ds = (int64_t)c;
    nf++;
    so += (int64_t)cs;
    dofs += (int64_t)c;
  }
  if (nf < 2 || dofs != n) return kSplitReject;
  struct ZstdDecCtx {
    const uint8_t *src;
    uint8_t *dst;
    const Fr *frames;
    uint8_t ok[2 * kMaxDecodeSegments];
  } ctx{src, dst, frames, {}};
  auto fn = [](void *p, int k) {
    ZstdDecCtx &c = *(ZstdDecCtx *)p;
    static thread_local ZstdDctxTL tl;
    ZSTD_DCtx *dctx = tl.p;
    const size_t w =
        dctx ? ZSTD_decompressDCtx(dctx, c.dst + c.frames[k].dofs,
                                   (size_t)c.frames[k].ds,
                                   c.src + c.frames[k].so,
                                   (size_t)c.frames[k].cs)
             : ZSTD_decompress(c.dst + c.frames[k].dofs,
                               (size_t)c.frames[k].ds, c.src + c.frames[k].so,
                               (size_t)c.frames[k].cs);
    c.ok[k] = !ZSTD_isError(w) && (int64_t)w == c.frames[k].ds;
  };
  if (!spin_pool().run(fn, &ctx, nf))
    for (int k = 0; k < nf; k++) fn(&ctx, k);
  for (int k = 0; k < nf; k++)
    if (!ctx.ok[k]) return kSplitReject;
  return n;
}

// ---------------------------------------------------------------------------
// byte shuffle / unshuffle
// (semantics: SURVEY §2.5 — dst[j*ne + i] = src[i*ts + j]; tail verbatim)
// ---------------------------------------------------------------------------

// scalar fallback over an element range [e0, e1)
static void shuffle_scalar(const uint8_t *src, uint8_t *dst, int64_t ne,
                           int ts, int64_t e0, int64_t e1) {
  for (int j = 0; j < ts; j++) {
    uint8_t *d = dst + (int64_t)j * ne;
    const uint8_t *s = src + j;
    for (int64_t i = e0; i < e1; i++) d[i] = s[(int64_t)i * ts];
  }
}

static void unshuffle_scalar(const uint8_t *src, uint8_t *dst, int64_t ne,
                             int ts, int64_t e0, int64_t e1) {
  for (int j = 0; j < ts; j++) {
    const uint8_t *s = src + (int64_t)j * ne;
    uint8_t *d = dst + j;
    for (int64_t i = e0; i < e1; i++) d[(int64_t)i * ts] = s[i];
  }
}

#if defined(__AVX2__)

// ts == 4: 32 elements (128 B) per iteration — VPSHUFB lane grouping +
// VPERMD cross-lane merge (the intrinsics form of shuffle_amd64.s:138-243,
// widened 4x), then unpack/permute2x128 ladders so every plane gets one
// full 32-byte store.
static void shuffle4_avx2(const uint8_t *src, uint8_t *dst, int64_t ne,
                          int64_t e0, int64_t e1) {
  const __m256i mask = _mm256_setr_epi8(
      0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15,
      0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15);
  const __m256i perm = _mm256_setr_epi32(0, 4, 1, 5, 2, 6, 3, 7);
  int64_t i = e0;
  for (; i + 32 <= e1; i += 32) {
    const uint8_t *s = src + i * 4;
    // each vk = [p0 p1 p2 p3] as 8-byte qwords for its 8 elements
    __m256i v0 = _mm256_permutevar8x32_epi32(
        _mm256_shuffle_epi8(_mm256_loadu_si256((const __m256i *)s), mask),
        perm);
    __m256i v1 = _mm256_permutevar8x32_epi32(
        _mm256_shuffle_epi8(_mm256_loadu_si256((const __m256i *)(s + 32)),
                            mask),
        perm);
    __m256i v2 = _mm256_permutevar8x32_epi32(
        _mm256_shuffle_epi8(_mm256_loadu_si256((const __m256i *)(s + 64)),
                            mask),
        perm);
    __m256i v3 = _mm256_permutevar8x32_epi32(
        _mm256_shuffle_epi8(_mm256_loadu_si256((const __m256i *)(s + 96)),
                            mask),
        perm);
    __m256i t0 = _mm256_unpacklo_epi64(v0, v1);  // [p0a p0b | p2a p2b]
    __m256i t1 = _mm256_unpackhi_epi64(v0, v1);  // [p1a p1b | p3a p3b]
    __m256i t2 = _mm256_unpacklo_epi64(v2, v3);  // [p0c p0d | p2c p2d]
    __m256i t3 = _mm256_unpackhi_epi64(v2, v3);  // [p1c p1d | p3c p3d]
    _mm256_storeu_si256((__m256i *)(dst + i),
                        _mm256_permute2x128_si256(t0, t2, 0x20));
    _mm256_storeu_si256((__m256i *)(dst + ne + i),
                        _mm256_permute2x128_si256(t1, t3, 0x20));
    _mm256_storeu_si256((__m256i *)(dst + 2 * ne + i),
                        _mm256_permute2x128_si256(t0, t2, 0x31));
    _mm256_storeu_si256((__m256i *)(dst + 3 * ne + i),
                        _mm256_permute2x128_si256(t1, t3, 0x31));
  }
  if (i < e1) shuffle_scalar(src, dst, ne, 4, i, e1);
}

static void unshuffle4_avx2(const uint8_t *src, uint8_t *dst, int64_t ne,
                            int64_t e0, int64_t e1) {
  const __m256i mask = _mm256_setr_epi8(
      0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15,
      0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15);
  const __m256i perm = _mm256_setr_epi32(0, 2, 4, 6, 1, 3, 5, 7);
  int64_t i = e0;
  for (; i + 32 <= e1; i += 32) {
    __m256i p0 = _mm256_loadu_si256((const __m256i *)(src + i));
    __m256i p1 = _mm256_loadu_si256((const __m256i *)(src + ne + i));
    __m256i p2 = _mm256_loadu_si256((const __m256i *)(src + 2 * ne + i));
    __m256i p3 = _mm256_loadu_si256((const __m256i *)(src + 3 * ne + i));
    // pK = [k0 k1 k2 k3]: plane-K 8-byte pieces of element groups 0-3
    __m256i t0 = _mm256_unpacklo_epi64(p0, p1);  // [a0 b0 | a2 b2]
    __m256i t1 = _mm256_unpackhi_epi64(p0, p1);  // [a1 b1 | a3 b3]
    __m256i t2 = _mm256_unpacklo_epi64(p2, p3);  // [c0 d0 | c2 d2]
    __m256i t3 = _mm256_unpackhi_epi64(p2, p3);  // [c1 d1 | c3 d3]
    __m256i v0 = _mm256_permute2x128_si256(t0, t2, 0x20);  // elems 0-7
    __m256i v1 = _mm256_permute2x128_si256(t1, t3, 0x20);  // elems 8-15
    __m256i v2 = _mm256_permute2x128_si256(t0, t2, 0x31);  // elems 16-23
    __m256i v3 = _mm256_permute2x128_si256(t1, t3, 0x31);  // elems 24-31
    uint8_t *d = dst + i * 4;
    _mm256_storeu_si256(
        (__m256i *)d,
        _mm256_shuffle_epi8(_mm256_permutevar8x32_epi32(v0, perm), mask));
    _mm256_storeu_si256(
        (__m256i *)(d + 32),
        _mm256_shuffle_epi8(_mm256_permutevar8x32_epi32(v1, perm), mask));
    _mm256_storeu_si256(
        (__m256i *)(d + 64),
        _mm256_shuffle_epi8(_mm256_permutevar8x32_epi32(v2, perm), mask));
    _mm256_storeu_si256(
        (__m256i *)(d + 96),
        _mm256_shuffle_epi8(_mm256_permutevar8x32_epi32(v3, perm), mask));
  }
  if (i < e1) unshuffle_scalar(src, dst, ne, 4, i, e1);
}

// ts == 2: 16 elements (32 B) per iteration.
static void shuffle2_avx2(const uint8_t *src, uint8_t *dst, int64_t ne,
                          int64_t e0, int64_t e1) {
  const __m256i mask = _mm256_setr_epi8(
      0, 2, 4, 6, 8, 10, 12, 14, 1, 3, 5, 7, 9, 11, 13, 15,
      0, 2, 4, 6, 8, 10, 12, 14, 1, 3, 5, 7, 9, 11, 13, 15);
  int64_t i = e0;
  for (; i + 16 <= e1; i += 16) {
    __m256i v = _mm256_loadu_si256((const __m256i *)(src + i * 2));
    v = _mm256_shuffle_epi8(v, mask);
    v = _mm256_permute4x64_epi64(v, 0xD8);  // 0,2,1,3
    __m128i lo = _mm256_castsi256_si128(v);
    __m128i hi = _mm256_extracti128_si256(v, 1);
    _mm_storeu_si128((__m128i *)(dst + i), lo);
    _mm_storeu_si128((__m128i *)(dst + ne + i), hi);
  }
  if (i < e1) shuffle_scalar(src, dst, ne, 2, i, e1);
}

static void unshuffle2_avx2(const uint8_t *src, uint8_t *dst, int64_t ne,
                            int64_t e0, int64_t e1) {
  const __m256i mask = _mm256_setr_epi8(
      0, 8, 1, 9, 2, 10, 3, 11, 4, 12, 5, 13, 6, 14, 7, 15,
      0, 8, 1, 9, 2, 10, 3, 11, 4, 12, 5, 13, 6, 14, 7, 15);
  int64_t i = e0;
  for (; i + 16 <= e1; i += 16) {
    __m128i lo = _mm_loadu_si128((const __m128i *)(src + i));
    __m128i hi = _mm_loadu_si128((const __m128i *)(src + ne + i));
    __m256i v = _mm256_set_m128i(hi, lo);
    v = _mm256_permute4x64_epi64(v, 0xD8);
    v = _mm256_shuffle_epi8(v, mask);
    _mm256_storeu_si256((__m256i *)(dst + i * 2), v);
  }
  if (i < e1) unshuffle_scalar(src, dst, ne, 2, i, e1);
}

// ts == 8: 8x8 byte transpose per 8 elements via SSE unpack ladders.
static void shuffle8_sse(const uint8_t *src, uint8_t *dst, int64_t ne,
                         int64_t e0, int64_t e1) {
  int64_t i = e0;
  for (; i + 8 <= e1; i += 8) {
    const uint8_t *s = src + i * 8;
    __m128i r0 = _mm_loadl_epi64((const __m128i *)(s));
    __m128i r1 = _mm_loadl_epi64((const __m128i *)(s + 8));
    __m128i r2 = _mm_loadl_epi64((const __m128i *)(s + 16));
    __m128i r3 = _mm_loadl_epi64((const __m128i *)(s + 24));
    __m128i r4 = _mm_loadl_epi64((const __m128i *)(s + 32));
    __m128i r5 = _mm_loadl_epi64((const __m128i *)(s + 40));
    __m128i r6 = _mm_loadl_epi64((const __m128i *)(s + 48));
    __m128i r7 = _mm_loadl_epi64((const __m128i *)(s + 56));
    __m128i t0 = _mm_unpacklo_epi8(r0, r1);
    __m128i t1 = _mm_unpacklo_epi8(r2, r3);
    __m128i t2 = _mm_unpacklo_epi8(r4, r5);
    __m128i t3 = _mm_unpacklo_epi8(r6, r7);
    __m128i u0 = _mm_unpacklo_epi16(t0, t1);
    __m128i u1 = _mm_unpackhi_epi16(t0, t1);
    __m128i u2 = _mm_unpacklo_epi16(t2, t3);
    __m128i u3 = _mm_unpackhi_epi16(t2, t3);
    __m128i v0 = _mm_unpacklo_epi32(u0, u2);  // planes 0,1
    __m128i v1 = _mm_unpackhi_epi32(u0, u2);  // planes 2,3
    __m128i v2 = _mm_unpacklo_epi32(u1, u3);  // planes 4,5
    __m128i v3 = _mm_unpackhi_epi32(u1, u3);  // planes 6,7
    _mm_storel_epi64((__m128i *)(dst + i), v0);
    _mm_storel_epi64((__m128i *)(dst + ne + i), _mm_srli_si128(v0, 8));
    _mm_storel_epi64((__m128i *)(dst + 2 * ne + i), v1);
    _mm_storel_epi64((__m128i *)(dst + 3 * ne + i), _mm_srli_si128(v1, 8));
    _mm_storel_epi64((__m128i *)(dst + 4 * ne + i), v2);
    _mm_storel_epi64((__m128i *)(dst + 5 * ne + i), _mm_srli_si128(v2, 8));
    _mm_storel_epi64((__m128i *)(dst + 6 * ne + i), v3);
    _mm_storel_epi64((__m128i *)(dst + 7 * ne + i), _mm_srli_si128(v3, 8));
  }
  if (i < e1) shuffle_scalar(src, dst, ne, 8, i, e1);
}

static void unshuffle8_sse(const uint8_t *src, uint8_t *dst, int64_t ne,
                           int64_t e0, int64_t e1) {
  int64_t i = e0;
  for (; i + 8 <= e1; i += 8) {
    __m128i r0 = _mm_loadl_epi64((const __m128i *)(src + i));
    __m128i r1 = _mm_loadl_epi64((const __m128i *)(src + ne + i));
    __m128i r2 = _mm_loadl_epi64((const __m128i *)(src + 2 * ne + i));
    __m128i r3 = _mm_loadl_epi64((const __m128i *)(src + 3 * ne + i));
    __m128i r4 = _mm_loadl_epi64((const __m128i *)(src + 4 * ne + i));
    __m128i r5 = _mm_loadl_epi64((const __m128i *)(src + 5 * ne + i));
    __m128i r6 = _mm_loadl_epi64((const __m128i *)(src + 6 * ne + i));
    __m128i r7 = _mm_loadl_epi64((const __m128i *)(src + 7 * ne + i));
    __m128i t0 = _mm_unpacklo_epi8(r0, r1);
    __m128i t1 = _mm_unpacklo_epi8(r2, r3);
    __m128i t2 = _mm_unpacklo_epi8(r4, r5);
    __m128i t3 = _mm_unpacklo_epi8(r6, r7);
    __m128i u0 = _mm_unpacklo_epi16(t0, t1);
    __m128i u1 = _mm_unpackhi_epi16(t0, t1);
    __m128i u2 = _mm_unpacklo_epi16(t2, t3);
    __m128i u3 = _mm_unpackhi_epi16(t2, t3);
    uint8_t *d = dst + i * 8;
    _mm_storeu_si128((__m128i *)(d), _mm_unpacklo_epi32(u0, u2));
    _mm_storeu_si128((__m128i *)(d + 16), _mm_unpackhi_epi32(u0, u2));
    _mm_storeu_si128((__m128i *)(d + 32), _mm_unpacklo_epi32(u1, u3));
    _mm_storeu_si128((__m128i *)(d + 48), _mm_unpackhi_epi32(u1, u3));
  }
  if (i < e1) unshuffle_scalar(src, dst, ne, 8, i, e1);
}

// 8x8 byte transpose of 8 rows at src+k*stride (8 bytes each) via the
// SSE unpack ladder; outputs 4 xmms, each two 8-byte transposed rows.
struct T8x8 {
  __m128i v0, v1, v2, v3;  // rows (0,1), (2,3), (4,5), (6,7)
};

static inline T8x8 transpose8x8_bytes(const uint8_t *base, int64_t stride) {
  __m128i r0 = _mm_loadl_epi64((const __m128i *)(base));
  __m128i r1 = _mm_loadl_epi64((const __m128i *)(base + stride));
  __m128i r2 = _mm_loadl_epi64((const __m128i *)(base + 2 * stride));
  __m128i r3 = _mm_loadl_epi64((const __m128i *)(base + 3 * stride));
  __m128i r4 = _mm_loadl_epi64((const __m128i *)(base + 4 * stride));
  __m128i r5 = _mm_loadl_epi64((const __m128i *)(base + 5 * stride));
  __m128i r6 = _mm_loadl_epi64((const __m128i *)(base + 6 * stride));
  __m128i r7 = _mm_loadl_epi64((const __m128i *)(base + 7 * stride));
  __m128i t0 = _mm_unpacklo_epi8(r0, r1);
  __m128i t1 = _mm_unpacklo_epi8(r2, r3);
  __m128i t2 = _mm_unpacklo_epi8(r4, r5);
  __m128i t3 = _mm_unpacklo_epi8(r6, r7);
  __m128i u0 = _mm_unpacklo_epi16(t0, t1);
  __m128i u1 = _mm_unpackhi_epi16(t0, t1);
  __m128i u2 = _mm_unpacklo_epi16(t2, t3);
  __m128i u3 = _mm_unpackhi_epi16(t2, t3);
  return {_mm_unpacklo_epi32(u0, u2), _mm_unpackhi_epi32(u0, u2),
          _mm_unpacklo_epi32(u1, u3), _mm_unpackhi_epi32(u1, u3)};
}

// ts == 16: 16 elements (256 B) per iteration as four 8x8 blocks; each
// plane receives one contiguous 16-byte store.
static void shuffle16_sse(const uint8_t *src, uint8_t *dst, int64_t ne,
                          int64_t e0, int64_t e1) {
  int64_t i = e0;
  for (; i + 16 <= e1; i += 16) {
    const uint8_t *s = src + i * 16;
    for (int h = 0; h < 2; h++) {          // plane halves 0-7 / 8-15
      T8x8 g0 = transpose8x8_bytes(s + h * 8, 16);
      T8x8 g1 = transpose8x8_bytes(s + 128 + h * 8, 16);
      const __m128i *a = &g0.v0;
      const __m128i *b = &g1.v0;
      for (int k = 0; k < 4; k++) {        // rows (2k, 2k+1)
        uint8_t *d0 = dst + (int64_t)(h * 8 + 2 * k) * ne + i;
        uint8_t *d1 = dst + (int64_t)(h * 8 + 2 * k + 1) * ne + i;
        _mm_storeu_si128((__m128i *)d0,
                         _mm_unpacklo_epi64(a[k], b[k]));
        _mm_storeu_si128((__m128i *)d1,
                         _mm_unpackhi_epi64(a[k], b[k]));
      }
    }
  }
  if (i < e1) shuffle_scalar(src, dst, ne, 16, i, e1);
}

static void unshuffle16_sse(const uint8_t *src, uint8_t *dst, int64_t ne,
                            int64_t e0, int64_t e1) {
  int64_t i = e0;
  alignas(16) uint8_t tmp[256];
  for (; i + 16 <= e1; i += 16) {
    // gather the 16x16 tile (planes x elements), transpose into tmp
    // (elements x planes), then copy out contiguously
    for (int h = 0; h < 2; h++) {          // element halves 0-7 / 8-15
      for (int q = 0; q < 2; q++) {        // plane halves 0-7 / 8-15
        // rows = planes q*8..q*8+7, columns = elements h*8..h*8+7
        const uint8_t *base = src + (int64_t)(q * 8) * ne + i + h * 8;
        T8x8 t = transpose8x8_bytes(base, ne);
        const __m128i *v = &t.v0;
        for (int k = 0; k < 4; k++) {
          // transposed rows are elements (2k, 2k+1) of this half, bytes
          // q*8..q*8+7
          std::memcpy(tmp + (h * 8 + 2 * k) * 16 + q * 8, (const uint8_t *)&v[k], 8);
          std::memcpy(tmp + (h * 8 + 2 * k + 1) * 16 + q * 8,
                      (const uint8_t *)&v[k] + 8, 8);
        }
      }
    }
    std::memcpy(dst + i * 16, tmp, 256);
  }
  if (i < e1) unshuffle_scalar(src, dst, ne, 16, i, e1);
}

#endif  // __AVX2__

static void shuffle_range(const uint8_t *src, uint8_t *dst, int64_t ne,
                          int ts, int64_t e0, int64_t e1) {
#if defined(__AVX2__)
  switch (ts) {
    case 2: shuffle2_avx2(src, dst, ne, e0, e1); return;
    case 4: shuffle4_avx2(src, dst, ne, e0, e1); return;
    case 8: shuffle8_sse(src, dst, ne, e0, e1); return;
    case 16: shuffle16_sse(src, dst, ne, e0, e1); return;
  }
#endif
  shuffle_scalar(src, dst, ne, ts, e0, e1);
}

static void unshuffle_range(const uint8_t *src, uint8_t *dst, int64_t ne,
                            int ts, int64_t e0, int64_t e1) {
#if defined(__AVX2__)
  switch (ts) {
    case 2: unshuffle2_avx2(src, dst, ne, e0, e1); return;
    case 4: unshuffle4_avx2(src, dst, ne, e0, e1); return;
    case 8: unshuffle8_sse(src, dst, ne, e0, e1); return;
    case 16: unshuffle16_sse(src, dst, ne, e0, e1); return;
  }
#endif
  unshuffle_scalar(src, dst, ne, ts, e0, e1);
}

// aligned with kFrameSegMin: below this the fork/steal jitter of a
// parallel region (~3-9 us on the target VM) beats the saved filter time
constexpr int64_t kParallelCutoff = 512 << 10;

static void shuffle_full(const uint8_t *src, uint8_t *dst, int64_t n, int ts) {
  if (ts <= 1 || n < ts) {
    std::memcpy(dst, src, (size_t)n);
    return;
  }
  int64_t ne = n / ts;
  int64_t body = ne * ts;
#ifdef _OPENMP
  if (n >= kParallelCutoff) {
    int nt = omp_get_max_threads();
    int64_t per = (ne + nt - 1) / nt;
#pragma omp parallel for schedule(static)
    for (int t = 0; t < nt; t++) {
      int64_t a = t * per, b = std::min(ne, a + per);
      if (a < b) shuffle_range(src, dst, ne, ts, a, b);
    }
  } else
#endif
  {
    shuffle_range(src, dst, ne, ts, 0, ne);
  }
  std::memcpy(dst + body, src + body, (size_t)(n - body));
}

static void unshuffle_full(const uint8_t *src, uint8_t *dst, int64_t n,
                           int ts) {
  if (ts <= 1 || n < ts) {
    std::memcpy(dst, src, (size_t)n);
    return;
  }
  int64_t ne = n / ts;
  int64_t body = ne * ts;
#ifdef _OPENMP
  if (n >= kParallelCutoff) {
    int nt = omp_get_max_threads();
    int64_t per = (ne + nt - 1) / nt;
#pragma omp parallel for schedule(static)
    for (int t = 0; t < nt; t++) {
      int64_t a = t * per, b = std::min(ne, a + per);
      if (a < b) unshuffle_range(src, dst, ne, ts, a, b);
    }
  } else
#endif
  {
    unshuffle_range(src, dst, ne, ts, 0, ne);
  }
  std::memcpy(dst + body, src + body, (size_t)(n - body));
}

// ---------------------------------------------------------------------------
// bit shuffle / unshuffle
// (semantics: SURVEY §2.6 — per 8-element group, per byte position, an 8x8
//  bit ANTI-transpose: out byte o bit (7-e) = in byte e bit (7-o).
//  anti_transpose(x) = bswap(transpose(bswap(x))) on a uint64 holding the
//  8 gathered bytes little-endian; it is an involution.)
// ---------------------------------------------------------------------------

static inline uint64_t bit_transpose8(uint64_t x) {
  // standard 8x8 bit transpose: byte r (little-endian) = row r, bit b = col
  // b; result byte c bit r = input byte r bit c.  Mask-shift ladder.
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAULL;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCULL;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ULL;
  x = x ^ t ^ (t << 28);
  return x;
}

static inline uint64_t bit_anti_transpose8(uint64_t x) {
  return __builtin_bswap64(bit_transpose8(__builtin_bswap64(x)));
}

static void bitshuffle_groups(const uint8_t *src, uint8_t *dst, int ts,
                              int64_t g0, int64_t g1);
static void bitunshuffle_groups(const uint8_t *src, uint8_t *dst, int ts,
                                int64_t g0, int64_t g1);

#if defined(__AVX2__)

// vectorized 8x8 bit anti-transpose of four uint64 planes at once:
// anti_T(x) = bswap64(T(bswap64(x))) with T the mask-shift ladder.
static inline __m256i bit_anti_transpose8_x4(__m256i x) {
  const __m256i bswap_mask = _mm256_setr_epi8(
      7, 6, 5, 4, 3, 2, 1, 0, 15, 14, 13, 12, 11, 10, 9, 8,
      7, 6, 5, 4, 3, 2, 1, 0, 15, 14, 13, 12, 11, 10, 9, 8);
  x = _mm256_shuffle_epi8(x, bswap_mask);
  __m256i t;
  const __m256i m7 = _mm256_set1_epi64x(0x00AA00AA00AA00AAULL);
  t = _mm256_and_si256(_mm256_xor_si256(x, _mm256_srli_epi64(x, 7)), m7);
  x = _mm256_xor_si256(_mm256_xor_si256(x, t), _mm256_slli_epi64(t, 7));
  const __m256i m14 = _mm256_set1_epi64x(0x0000CCCC0000CCCCULL);
  t = _mm256_and_si256(_mm256_xor_si256(x, _mm256_srli_epi64(x, 14)), m14);
  x = _mm256_xor_si256(_mm256_xor_si256(x, t), _mm256_slli_epi64(t, 14));
  const __m256i m28 = _mm256_set1_epi64x(0x00000000F0F0F0F0ULL);
  t = _mm256_and_si256(_mm256_xor_si256(x, _mm256_srli_epi64(x, 28)), m28);
  x = _mm256_xor_si256(_mm256_xor_si256(x, t), _mm256_slli_epi64(t, 28));
  return _mm256_shuffle_epi8(x, bswap_mask);
}

// ts == 4: one 32-byte group (8 elements) per iteration — group-local
// byte shuffle (shuffle4's inner transform) then the bit anti-transpose
// of all 4 plane qwords in parallel.
static void bitshuffle4_avx2(const uint8_t *src, uint8_t *dst, int64_t g0,
                             int64_t g1) {
  const __m256i mask = _mm256_setr_epi8(
      0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15,
      0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15);
  const __m256i perm = _mm256_setr_epi32(0, 4, 1, 5, 2, 6, 3, 7);
  for (int64_t g = g0; g < g1; g++) {
    __m256i v = _mm256_loadu_si256((const __m256i *)(src + g * 32));
    v = _mm256_permutevar8x32_epi32(_mm256_shuffle_epi8(v, mask), perm);
    v = bit_anti_transpose8_x4(v);
    _mm256_storeu_si256((__m256i *)(dst + g * 32), v);
  }
}

static void bitunshuffle4_avx2(const uint8_t *src, uint8_t *dst, int64_t g0,
                               int64_t g1) {
  const __m256i mask = _mm256_setr_epi8(
      0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15,
      0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15);
  const __m256i perm = _mm256_setr_epi32(0, 2, 4, 6, 1, 3, 5, 7);
  for (int64_t g = g0; g < g1; g++) {
    __m256i v = _mm256_loadu_si256((const __m256i *)(src + g * 32));
    v = bit_anti_transpose8_x4(v);
    v = _mm256_shuffle_epi8(_mm256_permutevar8x32_epi32(v, perm), mask);
    _mm256_storeu_si256((__m256i *)(dst + g * 32), v);
  }
}

// ts == 8: one 64-byte group per iteration via the SSE 8x8 byte transpose
// (shuffle8's ladder) + two anti-transpose vectors.
static void bitshuffle8_avx2(const uint8_t *src, uint8_t *dst, int64_t g0,
                             int64_t g1) {
  for (int64_t g = g0; g < g1; g++) {
    const uint8_t *s = src + g * 64;
    uint8_t tmp[64];
    shuffle8_sse(s, tmp, 8, 0, 8);  // 8 elements, planes of 8 bytes
    __m256i lo = _mm256_loadu_si256((const __m256i *)tmp);
    __m256i hi = _mm256_loadu_si256((const __m256i *)(tmp + 32));
    _mm256_storeu_si256((__m256i *)(dst + g * 64),
                        bit_anti_transpose8_x4(lo));
    _mm256_storeu_si256((__m256i *)(dst + g * 64 + 32),
                        bit_anti_transpose8_x4(hi));
  }
}

static void bitunshuffle8_avx2(const uint8_t *src, uint8_t *dst, int64_t g0,
                               int64_t g1) {
  for (int64_t g = g0; g < g1; g++) {
    const uint8_t *s = src + g * 64;
    uint8_t tmp[64];
    __m256i lo = _mm256_loadu_si256((const __m256i *)s);
    __m256i hi = _mm256_loadu_si256((const __m256i *)(s + 32));
    _mm256_storeu_si256((__m256i *)tmp, bit_anti_transpose8_x4(lo));
    _mm256_storeu_si256((__m256i *)(tmp + 32), bit_anti_transpose8_x4(hi));
    unshuffle8_sse(tmp, dst + g * 64, 8, 0, 8);
  }
}

// ts == 2: two 16-byte groups per ymm (each 128-bit lane is one group).
static void bitshuffle2_avx2(const uint8_t *src, uint8_t *dst, int64_t g0,
                             int64_t g1) {
  const __m256i mask = _mm256_setr_epi8(
      0, 2, 4, 6, 8, 10, 12, 14, 1, 3, 5, 7, 9, 11, 13, 15,
      0, 2, 4, 6, 8, 10, 12, 14, 1, 3, 5, 7, 9, 11, 13, 15);
  int64_t g = g0;
  for (; g + 2 <= g1; g += 2) {
    __m256i v = _mm256_loadu_si256((const __m256i *)(src + g * 16));
    v = _mm256_shuffle_epi8(v, mask);
    v = bit_anti_transpose8_x4(v);
    _mm256_storeu_si256((__m256i *)(dst + g * 16), v);
  }
  if (g < g1) bitshuffle_groups(src, dst, 2, g, g1);
}

static void bitunshuffle2_avx2(const uint8_t *src, uint8_t *dst, int64_t g0,
                               int64_t g1) {
  const __m256i mask = _mm256_setr_epi8(
      0, 8, 1, 9, 2, 10, 3, 11, 4, 12, 5, 13, 6, 14, 7, 15,
      0, 8, 1, 9, 2, 10, 3, 11, 4, 12, 5, 13, 6, 14, 7, 15);
  int64_t g = g0;
  for (; g + 2 <= g1; g += 2) {
    __m256i v = _mm256_loadu_si256((const __m256i *)(src + g * 16));
    v = bit_anti_transpose8_x4(v);
    v = _mm256_shuffle_epi8(v, mask);
    _mm256_storeu_si256((__m256i *)(dst + g * 16), v);
  }
  if (g < g1) bitunshuffle_groups(src, dst, 2, g, g1);
}

#endif  // __AVX2__

static void bitshuffle_groups(const uint8_t *src, uint8_t *dst, int ts,
                              int64_t g0, int64_t g1) {
  const int64_t group = 8 * (int64_t)ts;
  for (int64_t g = g0; g < g1; g++) {
    const uint8_t *s = src + g * group;
    uint8_t *d = dst + g * group;
    for (int b = 0; b < ts; b++) {
      uint64_t x = 0;
      for (int e = 0; e < 8; e++)
        x |= (uint64_t)s[e * ts + b] << (8 * e);
      write64(d + b * 8, bit_anti_transpose8(x));
    }
  }
}

static void bitunshuffle_groups(const uint8_t *src, uint8_t *dst, int ts,
                                int64_t g0, int64_t g1) {
  const int64_t group = 8 * (int64_t)ts;
  for (int64_t g = g0; g < g1; g++) {
    const uint8_t *s = src + g * group;
    uint8_t *d = dst + g * group;
    for (int b = 0; b < ts; b++) {
      uint64_t x = bit_anti_transpose8(read64(s + b * 8));
      for (int e = 0; e < 8; e++)
        d[e * ts + b] = (uint8_t)(x >> (8 * e));
    }
  }
}

static void bitshuffle_range(const uint8_t *src, uint8_t *dst, int ts,
                             bool inverse, int64_t g0, int64_t g1) {
#if defined(__AVX2__)
  if (ts == 2) {
    (inverse ? bitunshuffle2_avx2 : bitshuffle2_avx2)(src, dst, g0, g1);
    return;
  }
  if (ts == 4) {
    (inverse ? bitunshuffle4_avx2 : bitshuffle4_avx2)(src, dst, g0, g1);
    return;
  }
  if (ts == 8) {
    (inverse ? bitunshuffle8_avx2 : bitshuffle8_avx2)(src, dst, g0, g1);
    return;
  }
#endif
  (inverse ? bitunshuffle_groups : bitshuffle_groups)(src, dst, ts, g0, g1);
}

static void bitshuffle_full(const uint8_t *src, uint8_t *dst, int64_t n,
                            int ts, bool inverse) {
  if (ts <= 1 || n < ts) {
    std::memcpy(dst, src, (size_t)n);
    return;
  }
  int64_t ne = n / ts;
  int64_t groups = ne / 8;
  int64_t grouped = groups * 8 * ts;
#ifdef _OPENMP
  if (n >= kParallelCutoff) {
    int nt = omp_get_max_threads();
    int64_t per = (groups + nt - 1) / nt;
#pragma omp parallel for schedule(static)
    for (int t = 0; t < nt; t++) {
      int64_t a = t * per, b = std::min(groups, a + per);
      if (a < b) bitshuffle_range(src, dst, ts, inverse, a, b);
    }
  } else
#endif
  {
    bitshuffle_range(src, dst, ts, inverse, 0, groups);
  }
  // partial group + typesize tail copied verbatim (shuffle.go:204-218)
  std::memcpy(dst + grouped, src + grouped, (size_t)(n - grouped));
}

// ---------------------------------------------------------------------------
// BloscLZ block codec (codec ID 0)
//
// Fills the enum slot the reference declares but never implements
// ("internal, not implemented", blosc.go:58 — its codec map has no entry,
// codec.go:27-33).  Format spec + pure-Python oracle:
// codecs/blosclz_ref.py.  FastLZ-family tokens: 5-bit literal runs
// (1..32), 3-bit match codes with 255-extension, 13-bit distances with a
// 3-byte long-distance escape (up to ~16 MiB), overlap legal.  Unlike LZ4
// there are NO end-of-stream constraints — a match may be the final token
// and literal runs are legal anywhere — so independently encoded segments
// concatenate into one valid stream with no seam stitching at all.
// ---------------------------------------------------------------------------

constexpr int64_t kBzMaxNearDist = 8191;
constexpr int64_t kBzMaxDist = 8191 + ((int64_t)1 << 24);
constexpr uint32_t kBzEscapeRaw = 0x1FFF;
constexpr int64_t kBzMinFarMatch = 6;  // escape token costs 5 bytes

static inline int64_t blosclz_bound(int64_t n) { return n + n / 32 + 16; }

// Literal runs of <=32 bytes, 1 control byte each; -1 on overflow.
static inline int64_t bz_emit_lits(uint8_t *dst, int64_t di, int64_t cap,
                                   const uint8_t *lit, int64_t len) {
  while (len > 0) {
    const int64_t run = len > 32 ? 32 : len;
    if (di + 1 + run > cap) return -1;
    dst[di++] = (uint8_t)(run - 1);
    std::memcpy(dst + di, lit, (size_t)run);
    di += run;
    lit += run;
    len -= run;
  }
  return di;
}

static inline int64_t bz_emit_match(uint8_t *dst, int64_t di, int64_t cap,
                                    int64_t len, int64_t dist) {
  const int64_t ext = len > 8 ? (len - 9) / 255 + 1 : 0;
  const uint32_t raw =
      dist <= kBzMaxNearDist ? (uint32_t)(dist - 1) : kBzEscapeRaw;
  if (di + 1 + ext + 1 + (raw == kBzEscapeRaw ? 3 : 0) > cap) return -1;
  if (len <= 8) {
    dst[di++] = (uint8_t)(((len - 2) << 5) | (raw >> 8));
  } else {
    dst[di++] = (uint8_t)((7u << 5) | (raw >> 8));
    int64_t rem = len - 9;
    while (rem >= 255) {
      dst[di++] = 255;
      rem -= 255;
    }
    dst[di++] = (uint8_t)rem;
  }
  dst[di++] = (uint8_t)(raw & 0xFF);
  if (raw == kBzEscapeRaw) {
    const uint32_t x = (uint32_t)(dist - (kBzMaxNearDist + 1));
    dst[di++] = (uint8_t)(x & 0xFF);
    dst[di++] = (uint8_t)((x >> 8) & 0xFF);
    dst[di++] = (uint8_t)((x >> 16) & 0xFF);
  }
  return di;
}

// Greedy single-probe encoder, the structural twin of lz4_compress_impl:
// same hash, same tagged-epoch head-table reuse, same AVX2 match
// extension — different token emitter and no end-of-block constraints
// (matches may run to the very last byte).  Native minimum match is 4
// (one read32 compare); the format allows 3 and the Python oracle emits
// them — decoders accept both, encoders need not agree (the
// cross-decodability contract, tests/test_differential.py).
template <bool TAGGED>
static int64_t blosclz_compress_impl(const uint8_t *src, int64_t n,
                                     uint8_t *dst, int64_t cap,
                                     uint32_t *head, uint32_t epoch) {
  int64_t di = 0;
  const uint32_t tag = epoch << 24;
  auto epos = [&](uint32_t e) -> int64_t {
    if (TAGGED) {
      if ((e >> 24) != epoch) return -1;
      return (int64_t)(e & 0xFFFFFF) - 1;
    }
    return (int64_t)e - 1;
  };
  auto etag = [&](int64_t pos) -> uint32_t {
    return TAGGED ? (tag | (uint32_t)(pos + 1)) : (uint32_t)(pos + 1);
  };

  const int64_t limit = n - 4;
  int64_t anchor = 0, i = 0, search_count = 0;
  while (i <= limit) {
    const uint32_t seq = read32(src + i);
    const uint32_t h = lz4_hash(seq);
    const int64_t cand = epos(head[h]);
    head[h] = etag(i);
    if (cand >= 0 && cand < i && i - cand <= kBzMaxDist &&
        read32(src + cand) == seq) {
      int64_t mlen = 4;
#if defined(__AVX2__)
      while (i + mlen + 32 <= n) {
        const __m256i va =
            _mm256_loadu_si256((const __m256i *)(src + cand + mlen));
        const __m256i vb =
            _mm256_loadu_si256((const __m256i *)(src + i + mlen));
        const uint32_t eq =
            (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(va, vb));
        if (eq != 0xFFFFFFFFu) {
          mlen += __builtin_ctz(~eq);
          goto bz_match_done;
        }
        mlen += 32;
      }
#endif
      while (i + mlen + 8 <= n &&
             read64(src + cand + mlen) == read64(src + i + mlen))
        mlen += 8;
      if (i + mlen + 8 > n) {
        while (i + mlen < n && src[cand + mlen] == src[i + mlen]) mlen++;
      } else {
        const uint64_t diff =
            read64(src + cand + mlen) ^ read64(src + i + mlen);
        mlen += __builtin_ctzll(diff) >> 3;
      }
#if defined(__AVX2__)
    bz_match_done:;
#endif
      if (i - cand <= kBzMaxNearDist || mlen >= kBzMinFarMatch) {
        // extend backward into pending literals (distance is unchanged)
        int64_t ref = cand;
        while (i > anchor && ref > 0 && src[i - 1] == src[ref - 1]) {
          i--;
          ref--;
          mlen++;
        }
        di = bz_emit_lits(dst, di, cap, src + anchor, i - anchor);
        if (di < 0) return -1;
        di = bz_emit_match(dst, di, cap, mlen, i - ref);
        if (di < 0) return -1;
        if (i + 2 <= limit) head[lz4_hash(read32(src + i + 2))] = etag(i + 2);
        i += mlen;
        anchor = i;
        search_count = 0;
        continue;
      }
    }
    search_count++;
    i += 1 + (search_count >> 6);
  }
  return bz_emit_lits(dst, di, cap, src + anchor, n - anchor);
}

// Dispatcher twin of lz4_compress_t: external head table + tagged epochs
// when the caller manages them, one-shot malloc + memset otherwise.
static int64_t blosclz_compress_t(const uint8_t *src, int64_t n, uint8_t *dst,
                                  int64_t cap, uint32_t *head_ext,
                                  uint32_t epoch = 0) {
  if (n == 0) return 0;
  if (n < 4) return bz_emit_lits(dst, 0, cap, src, n);
  const int64_t head_sz = (int64_t)1 << kHashLog;
  uint32_t *head = head_ext;
  bool owned = false;
  if (!head) {
    head = (uint32_t *)std::malloc((size_t)head_sz * 4);
    if (!head) return -2;
    owned = true;
    epoch = 0;
  }
  int64_t out;
  if (epoch > 0 && n + 1 <= 0xFFFFFF) {
    out = blosclz_compress_impl<true>(src, n, dst, cap, head, epoch);
  } else {
    std::memset(head, 0, (size_t)head_sz * 4);
    out = blosclz_compress_impl<false>(src, n, dst, cap, head, 0);
  }
  if (owned) std::free(head);
  return out;
}

static int64_t blosclz_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                                int64_t cap) {
  return blosclz_compress_t(src, n, dst, cap, nullptr);
}

static int64_t blosclz_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                                  int64_t cap) {
  int64_t si = 0, di = 0;
  while (si < n) {
    const uint8_t ctrl = src[si++];
    if (ctrl < 0x20) {
      const int64_t run = ctrl + 1;
      if (si + run > n) return -1;   // literal run overruns input
      if (di + run > cap) return -2; // output overflow
      std::memcpy(dst + di, src + si, (size_t)run);
      si += run;
      di += run;
      continue;
    }
    int64_t len;
    const uint32_t mcode = ctrl >> 5;
    if (mcode < 7) {
      len = mcode + 2;
    } else {
      len = 9;
      uint8_t b;
      do {
        if (si >= n) return -3;  // truncated match length
        b = src[si++];
        len += b;
      } while (b == 0xFF);
    }
    if (si >= n) return -4;  // truncated distance
    const uint32_t raw = ((uint32_t)(ctrl & 0x1F) << 8) | src[si++];
    int64_t dist;
    if (raw == kBzEscapeRaw) {
      if (si + 3 > n) return -5;  // truncated far distance
      dist = kBzMaxNearDist + 1 +
             (int64_t)(src[si] | ((uint32_t)src[si + 1] << 8) |
                       ((uint32_t)src[si + 2] << 16));
      si += 3;
    } else {
      dist = (int64_t)raw + 1;
    }
    if (dist > di) return -6;    // reaches before stream start
    if (di + len > cap) return -7;  // output overflow
    uint8_t *d = dst + di;
    const uint8_t *s = d - dist;
#if defined(__AVX2__)
    if (dist >= 32 && di + len + 32 <= cap) {
      for (int64_t k = 0; k < len; k += 32)
        _mm256_storeu_si256((__m256i *)(d + k),
                            _mm256_loadu_si256((const __m256i *)(s + k)));
    } else
#endif
    if (dist >= 8 && di + len + 16 <= cap) {
      for (int64_t k = 0; k < len; k += 8) write64(d + k, read64(s + k));
    } else {
      match_copy(d, dist, len);
    }
    di += len;
  }
  return di;
}

// ---------------------------------------------------------------------------
// parallel BloscLZ decode — the simplest of the family: our segment-
// parallel encoder concatenates independently encoded segments, so cuts
// land exactly ON token boundaries (no LZ4-style seam stitching, no
// snappy preamble).  The pre-scan walks tokens (no byte copying),
// records the input offset where each chunk's output starts, and
// verifies no match reaches back across its chunk start.  Any other
// producer (our serial encoder, the Python oracle) fails the scan and
// takes the sequential decoder — correctness never depends on who
// encoded the stream.
// ---------------------------------------------------------------------------

static bool blosclz_split_scan(const uint8_t *src, int64_t ns, int64_t n,
                               int nseg, const int64_t *cuts,
                               int64_t *tok_ip, int64_t *tok_cnt = nullptr,
                               int64_t *min_off = nullptr) {
  int64_t si = 0, di = 0, chunk_start = 0;
  int next = 1;
  tok_ip[0] = 0;
  if (tok_cnt)
    for (int k = 0; k < nseg; k++) tok_cnt[k] = 0;
  if (min_off) *min_off = INT64_MAX;
  int64_t early_cap = INT64_MAX, completed_max = 0;
  while (si < ns) {
    if (next < nseg && di == cuts[next]) {
      tok_ip[next] = si;
      chunk_start = di;
      if (tok_cnt) {
        completed_max = std::max(completed_max, tok_cnt[next - 1]);
        if (next >= 2) early_cap = 8 + 4 * completed_max;
      }
      next++;
    }
    if (tok_cnt && ++tok_cnt[next - 1] > early_cap) return false;
    const uint8_t ctrl = src[si++];
    if (ctrl < 0x20) {
      const int64_t run = ctrl + 1;
      if (si + run > ns) return false;
      si += run;
      di += run;
      continue;
    }
    int64_t len;
    if ((ctrl >> 5) < 7) {
      len = (ctrl >> 5) + 2;
    } else {
      len = 9;
      uint8_t b;
      do {
        if (si >= ns) return false;
        b = src[si++];
        len += b;
      } while (b == 0xFF);
    }
    if (si >= ns) return false;
    const uint32_t raw = ((uint32_t)(ctrl & 0x1F) << 8) | src[si++];
    int64_t dist;
    if (raw == kBzEscapeRaw) {
      if (si + 3 > ns) return false;
      dist = kBzMaxNearDist + 1 +
             (int64_t)(src[si] | ((uint32_t)src[si + 1] << 8) |
                       ((uint32_t)src[si + 2] << 16));
      si += 3;
    } else {
      dist = (int64_t)raw + 1;
    }
    if (dist > di - chunk_start) return false;  // cross-cut or invalid
    if (min_off && dist < *min_off) *min_off = dist;
    di += len;
    if (di > n) return false;
  }
  // a token straddling a cut skips the di == next*seg equality above and
  // leaves next short — exactly the streams that must reject
  return next == nseg && di == n;
}

// Decode one chunk [c0, c1); all stores stay inside the chunk (wild
// copies fall back to exact ones near c1 — neighbour chunks decode
// concurrently).  The scan proved the token layout; bounds are still
// re-checked so a torn buffer can only fail, never overwrite.
static bool blosclz_decompress_chunk(const uint8_t *src, int64_t ns,
                                     int64_t ip, uint8_t *dst, int64_t c0,
                                     int64_t c1) {
  int64_t si = ip, di = c0;
  while (di < c1) {
    if (si >= ns) return false;
    const uint8_t ctrl = src[si++];
    if (ctrl < 0x20) {
      const int64_t run = ctrl + 1;
      if (si + run > ns || di + run > c1) return false;
      std::memcpy(dst + di, src + si, (size_t)run);
      si += run;
      di += run;
      continue;
    }
    int64_t len;
    if ((ctrl >> 5) < 7) {
      len = (ctrl >> 5) + 2;
    } else {
      len = 9;
      uint8_t b;
      do {
        if (si >= ns) return false;
        b = src[si++];
        len += b;
      } while (b == 0xFF);
    }
    if (si >= ns) return false;
    const uint32_t raw = ((uint32_t)(ctrl & 0x1F) << 8) | src[si++];
    int64_t dist;
    if (raw == kBzEscapeRaw) {
      if (si + 3 > ns) return false;
      dist = kBzMaxNearDist + 1 +
             (int64_t)(src[si] | ((uint32_t)src[si + 1] << 8) |
                       ((uint32_t)src[si + 2] << 16));
      si += 3;
    } else {
      dist = (int64_t)raw + 1;
    }
    if (dist > di - c0 || di + len > c1) return false;
    uint8_t *d = dst + di;
    const uint8_t *s = d - dist;
#if defined(__AVX2__)
    if (dist >= 32 && di + len + 32 <= c1) {
      for (int64_t k = 0; k < len; k += 32)
        _mm256_storeu_si256((__m256i *)(d + k),
                            _mm256_loadu_si256((const __m256i *)(s + k)));
    } else
#endif
    if (dist >= 8 && di + len + 16 <= c1) {
      for (int64_t k = 0; k < len; k += 8) write64(d + k, read64(s + k));
    } else {
      match_copy(d, dist, len);
    }
    di += len;
  }
  return di == c1;
}

struct BlosclzDecCtx {
  const uint8_t *src;
  uint8_t *dst;
  const int64_t *tok_ip;
  const int64_t *cuts;
  int64_t ns, n;
  uint8_t ok[kMaxDecodeSegments];
};

static void blosclz_decode_chunk_slice(void *p, int k) {
  BlosclzDecCtx &c = *(BlosclzDecCtx *)p;
  const int64_t c0 = c.cuts[k], c1 = c.cuts[k + 1];
  c.ok[k] = blosclz_decompress_chunk(c.src, c.ns, c.tok_ip[k], c.dst, c0, c1);
}

static int64_t blosclz_decompress_parallel(const uint8_t *src, int64_t ns,
                                           uint8_t *dst, int64_t n,
                                           int nseg) {
  int64_t cuts[kMaxDecodeSegments + 1];
  int64_t tok_ip[kMaxDecodeSegments];
  if (nseg < 2 || nseg > kMaxDecodeSegments) return kSplitReject;
  uniform_cuts(n, nseg, cuts);
  if (!blosclz_split_scan(src, ns, n, nseg, cuts, tok_ip))
    return kSplitReject;
  BlosclzDecCtx ctx{src, dst, tok_ip, cuts, ns, n, {}};
  if (!spin_pool().run(blosclz_decode_chunk_slice, &ctx, nseg))
    for (int k = 0; k < nseg; k++) blosclz_decode_chunk_slice(&ctx, k);
  for (int k = 0; k < nseg; k++)
    if (!ctx.ok[k]) return kSplitReject;
  return n;
}

// ---------------------------------------------------------------------------
// whole-chunk block pipelines (OpenMP across blocks)
// ---------------------------------------------------------------------------

enum CodecId {
  kCodecBlosclz = 0,  // our extension — the reference never implements it
  kCodecLz4 = 1,
  kCodecLz4Hc = 2,
  kCodecSnappy = 3,
  kCodecZlib = 4,
  kCodecZstd = 5,
};
enum ShuffleMode { kNoShuffle = 0, kByteShuffle = 1, kBitShuffle = 2 };

// ---------------------------------------------------------------------------
// optional libdeflate acceleration for the ZLIB codec
//
// dlopen'd so the build never requires it (the toolchain line stays
// `-lz -lzstd`); TPU_BLOSC_NO_LIBDEFLATE=1 forces libz everywhere.
// Decode always rides it when present (measured 5-7x, 1.2 -> 6.4-9 GB/s
// single-thread on the shuffled-ramp fixture; reading is byte-agnostic).
// Encode (round 4) rides it ONLY for SHUFFLED payloads at zlib level
// >= 4: there libdeflate measured faster AND smaller than libz at a 1:1
// level map on every fixture/level (1 MiB
// shuffled-ramp level 5 is -16.7% size at 1.8x speed).  On UNSHUFFLED
// data (text) libdeflate loses size at speed parity, so that class — and
// any level <= 3, where libz is faster on compressible data — keeps libz
// output, bit-identical to CPython's zlib.  TPU_BLOSC_NO_LIBDEFLATE_ENC=1
// forces libz on the encode side only.
// ---------------------------------------------------------------------------

struct LibDeflate {
  void *(*alloc_d)(void) = nullptr;
  // _ex variant: reports consumed input, so trailing bytes after the
  // stream are tolerated exactly like libz's uncompress()
  int (*decompress_ex)(void *, const void *, size_t, void *, size_t,
                       size_t *, size_t *) = nullptr;
  // raw-deflate _ex decode: the parallel pigz-seam inflate feeds it one
  // terminated piece per thread (zlib_decompress_parallel)
  int (*decompress_raw_ex)(void *, const void *, size_t, void *, size_t,
                           size_t *, size_t *) = nullptr;
  bool raw_ok = false;
  // encode side (round 4): raw-deflate compressor for SHUFFLED payloads,
  // where libdeflate measured both faster AND smaller than libz at every
  // level >= 4 (on unshuffled text it loses size,
  // so that class keeps libz)
  void *(*alloc_c)(int) = nullptr;
  size_t (*compress_raw)(void *, const void *, size_t, void *,
                         size_t) = nullptr;
  void (*free_c)(void *) = nullptr;
  void (*free_d)(void *) = nullptr;
  bool ok = false;
  bool enc_ok = false;
  LibDeflate() {
    if (std::getenv("TPU_BLOSC_NO_LIBDEFLATE")) return;
    void *h = dlopen("libdeflate.so.0", RTLD_NOW);
    if (!h) h = dlopen("libdeflate.so", RTLD_NOW);
    if (!h) return;
    alloc_d = (void *(*)(void))dlsym(h, "libdeflate_alloc_decompressor");
    decompress_ex =
        (int (*)(void *, const void *, size_t, void *, size_t, size_t *,
                 size_t *))dlsym(h, "libdeflate_zlib_decompress_ex");
    ok = alloc_d && decompress_ex;
    decompress_raw_ex =
        (int (*)(void *, const void *, size_t, void *, size_t, size_t *,
                 size_t *))dlsym(h, "libdeflate_deflate_decompress_ex");
    raw_ok = alloc_d && decompress_raw_ex;
    alloc_c = (void *(*)(int))dlsym(h, "libdeflate_alloc_compressor");
    compress_raw = (size_t (*)(void *, const void *, size_t, void *,
                               size_t))dlsym(h, "libdeflate_deflate_compress");
    enc_ok = alloc_c && compress_raw &&
             !std::getenv("TPU_BLOSC_NO_LIBDEFLATE_ENC");
    free_c = (void (*)(void *))dlsym(h, "libdeflate_free_compressor");
    free_d = (void (*)(void *))dlsym(h, "libdeflate_free_decompressor");
  }
};

static LibDeflate &libdeflate() {
  static LibDeflate ld;
  return ld;
}

// RAII thread-local libdeflate context holders (review r5: raw
// thread_local pointers leaked one workspace per exiting thread; the
// dlopened library outlives every thread, so freeing in the destructor
// is safe).
struct LdCompTL {
  void *comps[10] = {};
  ~LdCompTL() {
    LibDeflate &ld = libdeflate();
    if (ld.free_c)
      for (void *c : comps)
        if (c) ld.free_c(c);
  }
};
struct LdDecTL {
  void *dec = nullptr;
  ~LdDecTL() {
    LibDeflate &ld = libdeflate();
    if (dec && ld.free_d) ld.free_d(dec);
  }
};

// One per-level compressor cache per thread, shared by BOTH encode call
// sites (segmented + whole-stream) — two separate caches doubled the
// per-thread workspace at high levels (review r5b).
static void *&ld_comp_slot(int level) {
  static thread_local LdCompTL tl;
  return tl.comps[level];
}

// ---------------------------------------------------------------------------
// Deflate block walker (round 4): find the BFINAL header bit and the end
// bit of a complete raw-deflate stream WITHOUT reconstructing any output.
// libdeflate has no streaming/flush API, so its segments always end with
// BFINAL=1 — unusable mid-stream in the pigz layout.  The walker makes
// them usable: clear BFINAL, zero-pad to a byte boundary, and append the
// empty stored block 00 00 FF FF — bit-for-bit the layout Z_SYNC_FLUSH
// emits — so patched libdeflate segments concatenate with libz segments
// into ONE standard deflate stream.  The walk decodes block headers and
// Huffman symbols (lengths and extra-bit counts only; no window, no
// stores) via 15-bit reversed-code LUTs; cost scales with COMPRESSED
// bytes (ratio x cheaper than the encode it follows).
// ---------------------------------------------------------------------------

struct DeflateWalkBits {
  const uint8_t *p;
  int64_t nbytes;
  int64_t pos = 0;  // bit cursor
  bool fail = false;
  inline uint32_t peek(int k) {
    const int64_t byte = pos >> 3;
    uint64_t w = 0;
    if (byte + 8 <= nbytes) {
      std::memcpy(&w, p + byte, 8);
    } else if (byte < nbytes) {
      std::memcpy(&w, p + byte, (size_t)(nbytes - byte));
    }
    w >>= (pos & 7);
    return (uint32_t)(w & ((1ull << k) - 1));
  }
  inline uint32_t get(int k) {
    uint32_t v = peek(k);
    pos += k;
    if (pos > nbytes * 8) fail = true;
    return v;
  }
};

// Canonical Huffman decoder for the walker: a 10-bit root LUT indexed by
// REVERSED code bits (deflate packs code bits MSB-first into an LSB-first
// bit stream) with a canonical first-code fallback for codes longer than
// 10 bits.  The small root keeps the PER-BLOCK build cost at ~2 KiB of
// memset (libdeflate splits segments into many blocks; a 15-bit LUT's
// 64 KiB clear per block measured as large as the encode it follows).
constexpr int kWalkRootBits = 10;

struct WalkTable {
  uint16_t root[1 << kWalkRootBits];  // (sym << 4) | len; 0 = long/invalid
  uint16_t first_code[16];            // canonical first code per length
  uint16_t base_idx[16];              // index of that code's first symbol
  uint16_t count[16];
  uint16_t sym_ordered[288];          // symbols sorted by (len, code)
};

static bool walk_build_table(const uint8_t *lens, int nsym, WalkTable &t) {
  int count[16] = {0};
  for (int s = 0; s < nsym; s++) {
    if (lens[s] > 15) return false;
    count[lens[s]]++;
  }
  count[0] = 0;
  int64_t left = 1;
  for (int b = 1; b <= 15; b++) {
    left <<= 1;
    left -= count[b];
    if (left < 0) return false;  // over-subscribed
  }
  uint32_t next[16] = {0};
  uint32_t code = 0;
  uint32_t idx = 0;
  for (int b = 1; b <= 15; b++) {
    code = (code + count[b - 1]) << 1;
    next[b] = code;
    t.first_code[b] = (uint16_t)code;
    t.base_idx[b] = (uint16_t)idx;
    t.count[b] = (uint16_t)count[b];
    idx += count[b];
  }
  std::memset(t.root, 0, sizeof(t.root));
  uint32_t next_idx[16];
  for (int b = 0; b < 16; b++) next_idx[b] = t.base_idx[b];
  for (int s = 0; s < nsym; s++) {
    const int l = lens[s];
    if (!l) continue;
    const uint32_t c = next[l]++;
    t.sym_ordered[next_idx[l]++] = (uint16_t)s;
    if (l > kWalkRootBits) continue;  // long codes take the fallback
    uint32_t r = 0;
    for (int i = 0; i < l; i++) r |= ((c >> i) & 1u) << (l - 1 - i);
    for (uint32_t pad = r; pad < (1u << kWalkRootBits); pad += (1u << l))
      t.root[pad] = (uint16_t)((s << 4) | l);
  }
  return true;
}

static inline int walk_decode(DeflateWalkBits &bw, const WalkTable &t) {
  const uint16_t e = t.root[bw.peek(kWalkRootBits)];
  const int l = e & 15;
  if (l) {
    bw.pos += l;
    if (bw.pos > bw.nbytes * 8) {
      bw.fail = true;
      return -1;
    }
    return e >> 4;
  }
  // canonical bit-by-bit fallback for codes longer than the root
  uint32_t bits = bw.peek(15);
  uint32_t code = 0;
  for (int b = 1; b <= 15; b++) {
    code = (code << 1) | (bits & 1u);
    bits >>= 1;
    if (b > kWalkRootBits) {
      const uint32_t off = code - t.first_code[b];
      if (code >= t.first_code[b] && off < t.count[b]) {
        bw.pos += b;
        if (bw.pos > bw.nbytes * 8) {
          bw.fail = true;
          return -1;
        }
        return t.sym_ordered[t.base_idx[b] + off];
      }
    }
  }
  bw.fail = true;
  return -1;
}

static const uint8_t kWalkLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                          1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                          4, 4, 4, 4, 5, 5, 5, 5, 0};
static const uint8_t kWalkDistExtra[30] = {0, 0, 0,  0,  1,  1,  2,  2,
                                           3, 3, 4,  4,  5,  5,  6,  6,
                                           7, 7, 8,  8,  9,  9,  10, 10,
                                           11, 11, 12, 12, 13, 13};

static bool deflate_walk(const uint8_t *p, int64_t nbytes,
                         int64_t *bfinal_bit, int64_t *end_bit) {
  thread_local WalkTable lit_tab, dist_tab, cl_tab;
  DeflateWalkBits bw{p, nbytes};
  for (;;) {
    const int64_t hdr = bw.pos;
    const uint32_t bfinal = bw.get(1);
    const uint32_t btype = bw.get(2);
    if (bw.fail) return false;
    if (btype == 0) {  // stored
      bw.pos = (bw.pos + 7) & ~7ll;
      if (bw.pos + 32 > nbytes * 8) return false;
      const uint32_t len = bw.get(16);
      const uint32_t nlen = bw.get(16);
      if ((len ^ nlen) != 0xFFFFu) return false;
      bw.pos += (int64_t)len * 8;
      if (bw.pos > nbytes * 8) return false;
    } else if (btype == 3) {
      return false;
    } else {
      if (btype == 1) {  // fixed tables (rare from libdeflate; rebuild)
        uint8_t lens[288];
        for (int i = 0; i < 144; i++) lens[i] = 8;
        for (int i = 144; i < 256; i++) lens[i] = 9;
        for (int i = 256; i < 280; i++) lens[i] = 7;
        for (int i = 280; i < 288; i++) lens[i] = 8;
        if (!walk_build_table(lens, 288, lit_tab)) return false;
        uint8_t dlens[32];
        std::memset(dlens, 5, 32);
        if (!walk_build_table(dlens, 32, dist_tab)) return false;
      } else {  // dynamic
        const uint32_t hlit = bw.get(5) + 257;
        const uint32_t hdist = bw.get(5) + 1;
        const uint32_t hclen = bw.get(4) + 4;
        if (bw.fail || hlit > 288 || hdist > 32) return false;
        static const uint8_t ord[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                        11, 4,  12, 3, 13, 2, 14, 1, 15};
        uint8_t cl_lens[19] = {0};
        for (uint32_t i = 0; i < hclen; i++) cl_lens[ord[i]] = (uint8_t)bw.get(3);
        if (bw.fail || !walk_build_table(cl_lens, 19, cl_tab))
          return false;
        uint8_t lens[288 + 32] = {0};
        const uint32_t need = hlit + hdist;
        uint32_t i = 0;
        while (i < need) {
          const int sym = walk_decode(bw, cl_tab);
          if (sym < 0) return false;
          if (sym < 16) {
            lens[i++] = (uint8_t)sym;
          } else if (sym == 16) {
            if (i == 0) return false;
            uint32_t r = 3 + bw.get(2);
            if (i + r > need) return false;
            const uint8_t v = lens[i - 1];
            while (r--) lens[i++] = v;
          } else if (sym == 17) {
            uint32_t r = 3 + bw.get(3);
            if (i + r > need) return false;
            i += r;  // lens[] pre-zeroed
          } else {
            uint32_t r = 11 + bw.get(7);
            if (i + r > need) return false;
            i += r;
          }
          if (bw.fail) return false;
        }
        if (!walk_build_table(lens, (int)hlit, lit_tab)) return false;
        if (!walk_build_table(lens + hlit, (int)hdist, dist_tab))
          return false;
      }
      for (;;) {  // symbol walk to end-of-block
        const int sym = walk_decode(bw, lit_tab);
        if (sym < 0) return false;
        if (sym < 256) continue;
        if (sym == 256) break;
        const int ls = sym - 257;
        if (ls >= 29) return false;
        bw.pos += kWalkLenExtra[ls];
        const int ds = walk_decode(bw, dist_tab);
        if (ds < 0 || ds >= 30) return false;
        bw.pos += kWalkDistExtra[ds];
        if (bw.pos > nbytes * 8) return false;
      }
    }
    if (bfinal) {
      *bfinal_bit = hdr;
      *end_bit = bw.pos;
      return !bw.fail;
    }
  }
}

// Encode one pigz segment via libdeflate and (for non-final segments)
// patch it non-final: clear BFINAL, byte-align, append the Z_SYNC_FLUSH
// stored-block marker.  Returns bytes written or -2 ("use libz instead").
static int64_t zlib_ld_segment(const uint8_t *src, int64_t len, uint8_t *dst,
                               int64_t cap, int level, bool final_seg) {
  LibDeflate &ld = libdeflate();
  if (!ld.enc_ok || level < 4 || cap <= 8) return -2;
  if (level > 9) level = 9;
  void *&comp = ld_comp_slot(level);
  if (!comp) comp = ld.alloc_c(level);
  if (!comp) return -2;
  const size_t sz =
      ld.compress_raw(comp, src, (size_t)len, dst, (size_t)(cap - 8));
  if (!sz) return -2;  // didn't fit: libz path decides (then memcpy)
  if (final_seg) return (int64_t)sz;
  int64_t bfinal_bit = -1, end_bit = -1;
  if (!deflate_walk(dst, (int64_t)sz, &bfinal_bit, &end_bit)) return -2;
  dst[bfinal_bit >> 3] &= (uint8_t)~(1u << (bfinal_bit & 7));
  // the stored-block header (BFINAL=0, BTYPE=00) is three 0 bits at
  // end_bit: mask the tail of the last data byte, zero any spill byte
  const int64_t out_hdr = (end_bit + 3 + 7) >> 3;
  if (end_bit & 7)
    dst[end_bit >> 3] &= (uint8_t)((1u << (end_bit & 7)) - 1);
  for (int64_t b = (end_bit + 7) >> 3; b < out_hdr; b++) dst[b] = 0;
  if (out_hdr + 4 > cap) return -2;
  int64_t o = out_hdr;
  dst[o++] = 0x00;
  dst[o++] = 0x00;
  dst[o++] = 0xFF;
  dst[o++] = 0xFF;
  return o;
}

// Whole-stream libdeflate zlib encode (single final segment: no walker
// needed) for shuffled payloads; returns -2 to fall back to libz.
static int64_t zlib_ld_whole(const uint8_t *src, int64_t n, uint8_t *dst,
                             int64_t cap, int level) {
  LibDeflate &ld = libdeflate();
  // the 64 KiB floor keeps small frames/blocks bit-identical to CPython's
  // zlib (the differential-test contract); libdeflate is still smaller
  // down to 8 KiB blocks on shuffled data, but the speed win below the
  // floor is negligible and the byte-identity is worth more
  if (!ld.enc_ok || level < 4 || cap < 8 || n < (64 << 10)) return -2;
  const int lv = level > 9 ? 9 : level;
  void *&comp = ld_comp_slot(lv);
  if (!comp) comp = ld.alloc_c(lv);
  if (!comp) return -2;
  const size_t sz =
      ld.compress_raw(comp, src, (size_t)n, dst + 2, (size_t)(cap - 6));
  if (!sz) return -2;
  // zlib wrapper: same CMF/FLG formula as the pigz frame path
  const int flevel = level <= 1 ? 0 : level <= 5 ? 1 : level == 6 ? 2 : 3;
  unsigned flg = (unsigned)flevel << 6;
  const unsigned rem = ((0x78u << 8) | flg) % 31;
  if (rem) flg += 31 - rem;
  dst[0] = 0x78;
  dst[1] = (uint8_t)flg;
  const unsigned long adler =
      adler32(adler32(0L, Z_NULL, 0), (const Bytef *)src, (uInt)n);
  int64_t o = 2 + (int64_t)sz;
  dst[o++] = (uint8_t)(adler >> 24);
  dst[o++] = (uint8_t)(adler >> 16);
  dst[o++] = (uint8_t)(adler >> 8);
  dst[o++] = (uint8_t)adler;
  return o;
}

static int64_t zlib_decompress_fast(const uint8_t *src, int64_t n,
                                    uint8_t *dst, int64_t cap) {
  LibDeflate &ld = libdeflate();
  if (ld.ok) {
    static thread_local LdDecTL tl;
    void *&dec = tl.dec;
    if (!dec) dec = ld.alloc_d();
    if (dec) {
      size_t actual_in = 0, actual_out = 0;
      int rc = ld.decompress_ex(dec, src, (size_t)n, dst, (size_t)cap,
                                &actual_in, &actual_out);
      // 0 == LIBDEFLATE_SUCCESS; mirror uncompress(): trailing input
      // after the stream is ignored, the caller validates actual_out
      return rc == 0 ? (int64_t)actual_out : -100 - Z_DATA_ERROR;
    }
  }
  uLongf out_len = (uLongf)cap;
  int rc = uncompress((Bytef *)dst, &out_len, (const Bytef *)src, (uLong)n);
  return rc == Z_OK ? (int64_t)out_len : -100 - rc;
}

// level_or_depth carries the LZ4HC chain depth for kCodecLz4Hc, the
// 1-9 zlib level for kCodecZlib, and the mapped zstd level for kCodecZstd.
static int64_t codec_compress(int codec, int level_or_depth,
                              const uint8_t *src, int64_t n, uint8_t *dst,
                              int64_t cap, uint32_t *lz4_head = nullptr,
                              uint32_t *lz4_chain = nullptr,
                              uint32_t lz4_epoch = 0,
                              uint64_t *scan_mask = nullptr,
                              Lz4Tail *tail = nullptr,
                              int zlib_shuffled = 0) {
  switch (codec) {
    case kCodecBlosclz:
      return blosclz_compress_t(src, n, dst, cap, lz4_head, lz4_epoch);
    case kCodecSnappy:
      return snappy_compress(src, n, dst, cap);
    case kCodecZlib: {
      if (zlib_shuffled) {
        const int64_t w = zlib_ld_whole(src, n, dst, cap, level_or_depth);
        if (w >= 0) return w;
      }
      uLongf out_len = (uLongf)cap;
      int rc = compress2((Bytef *)dst, &out_len, (const Bytef *)src,
                         (uLong)n, level_or_depth);
      return rc == Z_OK ? (int64_t)out_len : -100 - rc;
    }
    case kCodecZstd: {
      // Reused per-thread context: ZSTD_compress creates and frees a
      // CCtx + multi-MB workspace on EVERY call, which on this VM's
      // ~50 us page faults costs more than small blocks' actual
      // compression (≙ the reference's persistent shared encoders,
      // codec.go:177-198).  The context reuses its workspace across
      // blocks; zstd resizes it internally when level/srcSize demand.
      static thread_local ZstdCctxTL tl;
      ZSTD_CCtx *cctx = tl.p;
      size_t w = cctx ? ZSTD_compressCCtx(cctx, dst, (size_t)cap, src,
                                          (size_t)n, level_or_depth)
                      : ZSTD_compress(dst, (size_t)cap, src, (size_t)n,
                                      level_or_depth);
      return ZSTD_isError(w) ? -200 : (int64_t)w;
    }
    default: {
      const int depth = codec == kCodecLz4Hc ? level_or_depth : 1;
      if (depth == 1 && scan_mask && n >= kScanMinBytes) {
        int64_t w = lz4_scan_compress(src, n, dst, cap, scan_mask, tail);
        // accept only a clear win (ratio >= 4): a marginal scan result
        // could undercut what greedy would find, so re-encode instead
        if (w >= 0 && w * 4 <= n) return w;
      }
      return lz4_compress_t(src, n, dst, cap, depth, lz4_head, lz4_chain,
                            lz4_epoch, tail);
    }
  }
}

static int64_t codec_decompress(int codec, const uint8_t *src, int64_t n,
                                uint8_t *dst, int64_t cap) {
  switch (codec) {
    case kCodecBlosclz:
      return blosclz_decompress(src, n, dst, cap);
    case kCodecSnappy:
      return snappy_decompress(src, n, dst, cap);
    case kCodecZlib:
      return zlib_decompress_fast(src, n, dst, cap);
    case kCodecZstd: {
      // per-thread DCtx reuse — see the CCtx note in codec_compress
      static thread_local ZstdDctxTL tl;
      ZSTD_DCtx *dctx = tl.p;
      size_t w = dctx ? ZSTD_decompressDCtx(dctx, dst, (size_t)cap, src,
                                            (size_t)n)
                      : ZSTD_decompress(dst, (size_t)cap, src, (size_t)n);
      return ZSTD_isError(w) ? -200 : (int64_t)w;
    }
    default:
      return lz4_decompress(src, n, dst, cap);
  }
}

static int64_t codec_bound(int codec, int64_t n) {
  switch (codec) {
    case kCodecBlosclz:
      return blosclz_bound(n);
    case kCodecSnappy:
      return snappy_bound(n);
    case kCodecZlib:
      return (int64_t)compressBound((uLong)n) + 16;
    case kCodecZstd:
      return (int64_t)ZSTD_compressBound((size_t)n) + 16;
    default:
      return lz4_bound(n);
  }
}

struct BlockScratch {
  uint8_t *buf = nullptr;
  int64_t cap = 0;
  uint8_t *buf2 = nullptr;  // second buffer (segment slots, frame path)
  int64_t cap2 = 0;
  uint32_t *head = nullptr;   // per-thread LZ4 hash table
  uint32_t *head2 = nullptr;  // second table for the pair-interleaved path
  uint32_t *chain = nullptr;  // per-thread LZ4HC chain table
  uint32_t epoch = 0;         // tagged-entry generation (see lz4_compress_impl)
  uint64_t *scan_mask = nullptr;  // per-thread scan-encoder bitmask
  int64_t scan_words = 0;
  ~BlockScratch() {
    std::free(buf);
    std::free(buf2);
    std::free(head);
    std::free(head2);
    std::free(chain);
    std::free(scan_mask);
  }
  // scan-encoder mask scratch for an n-byte block (nullptr on OOM: the
  // caller just stays on the greedy path)
  uint64_t *scan(int64_t n) {
    int64_t nw = (n + 63) >> 6;
    if (nw > scan_words) {
      std::free(scan_mask);
      scan_mask = (uint64_t *)std::malloc((size_t)nw * 8);
      scan_words = scan_mask ? nw : 0;
    }
    return scan_mask;
  }
  uint8_t *get(int64_t need) {
    if (need > cap) {
      std::free(buf);
      buf = (uint8_t *)std::malloc((size_t)need);
      cap = buf ? need : 0;
    }
    return buf;
  }
  uint8_t *get2(int64_t need) {
    if (need > cap2) {
      std::free(buf2);
      buf2 = (uint8_t *)std::malloc((size_t)need);
      cap2 = buf2 ? need : 0;
    }
    return buf2;
  }
  // calloc: tag byte 0 never matches a live epoch (epochs are 1..255)
  uint32_t *lz4_head() {
    if (!head) head = (uint32_t *)std::calloc((size_t)1 << kHashLog, 4);
    return head;
  }
  uint32_t *lz4_head2() {
    if (!head2) head2 = (uint32_t *)std::calloc((size_t)1 << kHashLog, 4);
    return head2;
  }
  uint32_t *lz4_chain() {
    if (!chain) chain = (uint32_t *)std::calloc(65536, 4);
    return chain;
  }
  // Fresh epoch for a tagged encode of n bytes; 0 = caller must use the
  // memset mode (n too large for 24-bit positions), in which case the
  // tables get raw-position entries, so the next tagged use forces a
  // clearing wrap.
  uint32_t next_epoch(int64_t n) {
    if (n + 1 > 0xFFFFFF) {
      epoch = 255;
      return 0;
    }
    if (++epoch >= 256) {
      if (head) std::memset(head, 0, ((size_t)1 << kHashLog) * 4);
      if (head2) std::memset(head2, 0, ((size_t)1 << kHashLog) * 4);
      if (chain) std::memset(chain, 0, 65536 * 4);
      epoch = 1;
    }
    return epoch;
  }
};

// Per-thread scratch reused across single-shot frame calls — keeps the
// 100 KB-class hot path free of malloc/page-fault churn (the VM pays
// ~50 us per fault; see the mallopt note above).
static BlockScratch &frame_scratch() {
  static thread_local BlockScratch s;
  return s;
}

// ---------------------------------------------------------------------------
// parallel inflate for OUR pigz-layout zlib streams (round-4 session 2).
//
// The segment-parallel encoder ends every non-final segment with the
// Z_SYNC_FLUSH empty stored block (… 00 00 FF FF, byte-aligned), so the
// seams are byte positions.  They are data-dependent — the stream cannot
// carry them — so the decoder SCANS for the 4-byte marker and accepts the
// parallel path only when the candidate count is EXACTLY nseg-1 (the
// encoder's deterministic segment count for this n).  Each piece then
// becomes a complete raw-deflate stream by appending 01 00 00 FF FF (an
// empty stored block with BFINAL=1) and inflates independently at full
// libdeflate speed.  Validation is strict: per-piece exact input
// consumption and exact output size, then whole-stream adler32 against
// the trailer (per-piece adlers, adler32_combine).  ANY mismatch — a
// false marker inside compressed data, a window-primed libz segment
// whose matches reach back across the seam (raw inflate fails with
// distance-too-far), a foreign stream — rejects into the sequential
// decoder, so correctness never depends on the producer.  Primed
// segments whose matches happen NOT to reach back decode correctly
// independently (priming only matters when referenced).
// ---------------------------------------------------------------------------

struct ZlibDecCtx {
  const uint8_t *pieces[kMaxDecodeSegments];  // staged (terminated) input
  int64_t plen[kMaxDecodeSegments];           // staged length
  int64_t in_expect[kMaxDecodeSegments];      // exact consumption required
  uint8_t *dst;
  int64_t lo[kMaxDecodeSegments], sz[kMaxDecodeSegments];
  unsigned long adler[kMaxDecodeSegments];
  uint8_t ok[kMaxDecodeSegments];
  // one failed piece dooms the whole attempt (serial fallback), so
  // siblings stop claiming work as soon as any slice fails
  std::atomic<int> abort{0};
};

static void zlib_decode_piece_slice(void *p, int t) {
  ZlibDecCtx &c = *(ZlibDecCtx *)p;
  if (c.abort.load(std::memory_order_relaxed)) {
    c.ok[t] = 0;
    return;
  }
  LibDeflate &ld = libdeflate();
  static thread_local LdDecTL tl;
  void *&dec = tl.dec;
  if (!dec) dec = ld.alloc_d();
  if (!dec) {
    c.ok[t] = 0;
    c.abort.store(1, std::memory_order_relaxed);
    return;
  }
  size_t in_used = 0, out_used = 0;
  int rc = ld.decompress_raw_ex(dec, c.pieces[t], (size_t)c.plen[t],
                                c.dst + c.lo[t], (size_t)c.sz[t], &in_used,
                                &out_used);
  c.ok[t] = rc == 0 && (int64_t)in_used == c.in_expect[t] &&
            (int64_t)out_used == c.sz[t];
  if (c.ok[t])
    c.adler[t] = adler32(adler32(0L, Z_NULL, 0), c.dst + c.lo[t],
                         (uInt)c.sz[t]);
  else
    c.abort.store(1, std::memory_order_relaxed);
}

static int64_t zlib_decompress_parallel(const uint8_t *payload, int64_t ps,
                                        uint8_t *dst, int64_t n, int nseg,
                                        BlockScratch &scratch) {
  LibDeflate &ld = libdeflate();
  if (!ld.raw_ok || nseg < 2 || nseg > kMaxDecodeSegments || ps < 11 ||
      (payload[0] & 0x0F) != 8 || (payload[0] & 0xF0) > 0x70 ||
      (((unsigned)payload[0] << 8) | payload[1]) % 31 != 0 ||
      (payload[1] & 0x20))  // FDICT streams are not ours
    return kSplitReject;
  // seam scan: cut positions AFTER each 00 00 FF FF in the deflate body.
  // memchr-hop to each 0x00 candidate: deflate bytes are near-uniform, so
  // this skips ~256 bytes per probe instead of walking one byte at a time
  // (the scan runs on EVERY eligible decode, including foreign streams
  // that reject right here)
  const int64_t body0 = 2, body1 = ps - 4;  // [header) … (adler trailer]
  int64_t cuts[kMaxDecodeSegments];
  int ncut = 0;
  for (int64_t i = body0; i + 4 <= body1;) {
    const void *z = std::memchr(payload + i, 0x00, (size_t)(body1 - 3 - i));
    if (!z) break;
    i = (const uint8_t *)z - payload;
    if (payload[i + 1] == 0x00 && payload[i + 2] == 0xFF &&
        payload[i + 3] == 0xFF) {
      if (ncut >= nseg - 1) return kSplitReject;  // too many: not ours
      cuts[ncut++] = i + 4;
      i += 4;  // markers cannot overlap themselves
    } else {
      i += payload[i + 1] == 0x00 ? 1 : 2;  // keep a 00 00 prefix live
    }
  }
  if (ncut != nseg - 1 || cuts[ncut - 1] >= body1) return kSplitReject;
  // stage the non-final pieces with the 5-byte BFINAL terminator; the
  // final piece already ends with BFINAL=1 and reads in place
  uint8_t *stage = scratch.get2(ps + 5 * (int64_t)nseg);
  if (!stage) return kSplitReject;
  static const uint8_t kFin[5] = {0x01, 0x00, 0x00, 0xFF, 0xFF};
  const int64_t seg = (n + nseg - 1) / nseg;
  ZlibDecCtx ctx{};
  ctx.dst = dst;
  int64_t sp = 0;
  for (int t = 0; t < nseg; t++) {
    const int64_t a = t == 0 ? body0 : cuts[t - 1];
    const int64_t b = t == nseg - 1 ? body1 : cuts[t];
    ctx.lo[t] = (int64_t)t * seg;
    ctx.sz[t] = std::min(n, ctx.lo[t] + seg) - ctx.lo[t];
    if (b <= a || ctx.sz[t] <= 0) return kSplitReject;
    if (t == nseg - 1) {
      ctx.pieces[t] = payload + a;
      ctx.plen[t] = ctx.in_expect[t] = b - a;
    } else {
      std::memcpy(stage + sp, payload + a, (size_t)(b - a));
      std::memcpy(stage + sp + (b - a), kFin, 5);
      ctx.pieces[t] = stage + sp;
      ctx.plen[t] = ctx.in_expect[t] = (b - a) + 5;
      sp += (b - a) + 5;
    }
  }
  if (!spin_pool().run(zlib_decode_piece_slice, &ctx, nseg))
    for (int t = 0; t < nseg; t++) zlib_decode_piece_slice(&ctx, t);
  unsigned long adler = adler32(0L, Z_NULL, 0);
  for (int t = 0; t < nseg; t++) {
    if (!ctx.ok[t]) return kSplitReject;
    adler = adler32_combine(adler, ctx.adler[t], (z_off_t)ctx.sz[t]);
  }
  const unsigned long want = ((unsigned long)payload[ps - 4] << 24) |
                             ((unsigned long)payload[ps - 3] << 16) |
                             ((unsigned long)payload[ps - 2] << 8) |
                             (unsigned long)payload[ps - 1];
  if (adler != want) return kSplitReject;
  return n;
}


// ---------------------------------------------------------------------------
// parallel single-stream LZ4 frame body
//
// LZ4 block streams CONCATENATE: a sequence ends at a byte boundary and
// the next token simply continues, so encoding contiguous segments of the
// filtered stream as independent blocks and concatenating the outputs
// yields ONE valid LZ4 block stream (matches and offsets never cross a
// cut; each segment carries its own >=5-literal tail; the overall
// end-of-block constraints are enforced by the final segment).  Any LZ4
// block decoder — including the reference's lz4.UncompressBlock
// (codec.go:77-84) — reads the result, so the frame stays a
// reference-compatible single-block frame (blosc.go:364) while the encode
// runs on all cores.  This is how the single-shot path (the reference's
// own 100 KB benchmark shape) engages the whole host below the multi-
// block threshold.
//
// Segmentation is a pure function of n (kFrameSegMin/kMaxFrameSegments),
// NEVER of the thread count, so the output bytes are identical across
// machines, tpb_set_num_threads settings, and non-OpenMP builds — the
// golden-size pins stay machine-independent.  Cost vs the serial encoder:
// matches cannot cross segment cuts and each segment ends in literals
// (<0.5% size inflation measured on the BASELINE configs).
// ---------------------------------------------------------------------------

constexpr int kMaxFrameSegments = 8;
static_assert(kMaxFrameSegments == kMaxDecodeSegments,
              "encoder segmentation and decode pre-scan must agree");
// Engagement floor: with the spin pool's ~0.5 us hot handoff the parallel
// frame paths win from ~192-256 KiB up (measured; OpenMP's 3-13 us
// fork/steal jitter had forced 512 KiB).  Below that, random ~5-9 us
// vCPU preemption stalls on this shared host dominate the 1-2 us slices
// — 100 KB frames stay serial, keeping the reference-config pins stable.
// Segmentation is still a pure function of n — see frame_segments.
constexpr int64_t kFrameSegMin = 256 << 10;
// Round-4 floor for the FUSED small-frame path (one dispatch, per-plane
// slices reading only the shared read-only src): the dispatch+stitch
// overhead (~1 us) needs >= ~1 us slices to amortize
constexpr int64_t kSmallFrameMin = 48 << 10;

static inline int frame_segments(int64_t n, int codec) {
  static const bool disabled =
      std::getenv("TPU_BLOSC_NO_FRAME_PARALLEL") != nullptr;
  if (disabled) return 1;
  // kCodecZstd is listed for the DECODE side only (parallel multi-frame
  // payload decode, parity with klauspost DecodeAll's concatenated-frame
  // acceptance); the encoder never segments zstd — see tpb_compress_frame.
  // kCodecZlib is ENCODE-side only (pigz-style raw-deflate segments under
  // one zlib wrapper; inflate has no parallelizable boundaries).
  if (codec != kCodecLz4 && codec != kCodecLz4Hc &&
      codec != kCodecSnappy && codec != kCodecZstd && codec != kCodecZlib &&
      codec != kCodecBlosclz)
    return 1;
  if (n < kFrameSegMin) {
    // zlib's per-segment work (~140 us at a 25 KiB slice) dwarfs both
    // the dispatch overhead and the vCPU stall floor, so the small-frame
    // window segments for zlib in BOTH shuffle modes (imbalance between
    // slices is a few % of a slice, unlike the byte-oriented codecs —
    // see the fused-gate note in tpb_compress_frame); everything else
    // gates on the fused small-frame path there (needs ts/mode)
    if (codec == kCodecZlib && n >= kSmallFrameMin) return 4;
    return 1;
  }
  // zlib's per-segment work (~0.6 ms at 256 KiB) sits far above the
  // ~5-9 us vCPU stall floor, so finer slices only help: 8 segments from
  // 1 MiB up lets the 4-lane pool rebalance around stalls (measured
  // round 4: 1 MiB shuffled-ramp 0.92 -> ~1.1 GB/s); the byte-oriented
  // codecs keep 4 below 2 MiB (their ~60 us slices would hit the floor)
  if (codec == kCodecZlib)
    return n < (1 << 20) ? 4 : kMaxFrameSegments;
  return n < (2 << 20) ? 4 : kMaxFrameSegments;
}

// Raw-deflate one segment of a pigz-style parallel zlib stream.  Non-final
// segments end with Z_SYNC_FLUSH (all blocks BFINAL=0, byte-aligned via an
// empty stored block) so the raw bodies concatenate into ONE valid deflate
// stream; the final segment ends with Z_FINISH.  Segments t>0 prime the
// window with the 32 KiB that precede them, recovering nearly all of the
// cross-segment ratio.  Returns bytes written, -1 on overflow/zlib error.
static int64_t zlib_deflate_segment(const uint8_t *src, int64_t len,
                                    uint8_t *dst, int64_t cap, int level,
                                    const uint8_t *dict, int64_t dict_len,
                                    bool final_seg) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // windowBits = -15: raw deflate (no zlib header/trailer per segment)
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return -1;
  if (dict_len > 0)
    deflateSetDictionary(&zs, dict, (uInt)dict_len);
  zs.next_in = (Bytef *)src;
  zs.avail_in = (uInt)len;
  zs.next_out = (Bytef *)dst;
  zs.avail_out = (uInt)cap;
  int rc = deflate(&zs, final_seg ? Z_FINISH : Z_SYNC_FLUSH);
  int64_t out = (int64_t)zs.total_out;
  bool ok = final_seg ? (rc == Z_STREAM_END)
                      : (rc == Z_OK && zs.avail_in == 0);
  deflateEnd(&zs);
  return ok ? out : -1;
}

// Parse a Snappy uvarint preamble; returns the declared length and sets
// *hdr to the preamble size, or -1 on malformed input.
static inline int64_t snappy_preamble(const uint8_t *src, int64_t n,
                                      int64_t *hdr) {
  uint64_t total = 0;
  int shift = 0;
  int64_t pos = 0;
  for (;;) {
    if (pos >= n || shift > 63) return -1;
    uint8_t b = src[pos++];
    total |= (uint64_t)(b & 0x7F) << shift;
    if (b < 0x80) break;
    shift += 7;
  }
  *hdr = pos;
  return (int64_t)total;
}

// Per-segment work contexts for the SpinPool trampolines (the pool takes
// a plain function pointer; these structs carry the closure state).
struct FrameEncCtx {
  const uint8_t *src;
  uint8_t *sb;
  const uint8_t *stream;
  uint8_t *slots;
  int64_t *sizes;
  Lz4Tail *tails;
  unsigned long *adlers;
  int64_t n, seg, slot, units, body, per;
  int ts, shuffle_mode, codec, depth, nseg;
  // fused small-frame mode (round 4): slice t extracts byte-plane t from
  // the read-only src and encodes it locally, so no dirty filtered lines
  // ever cross cores; segment bounds are plane-aligned (t * n/ts), the
  // last segment absorbs the <ts-byte tail
  int fused = 0;
};

static void frame_filter_slice(void *p, int t) {
  FrameEncCtx &c = *(FrameEncCtx *)p;
  const int64_t a = (int64_t)t * c.per, b = std::min(c.units, a + c.per);
  if (a < b) {
    if (c.shuffle_mode == kByteShuffle)
      shuffle_range(c.src, c.sb, c.n / c.ts, c.ts, a, b);
    else
      bitshuffle_range(c.src, c.sb, c.ts, false, a, b);
  }
  if (t == c.nseg - 1 && c.body < c.n)
    std::memcpy(c.sb + c.body, c.src + c.body, (size_t)(c.n - c.body));
}

// Byte-plane extractors for the fused small-frame slices: each slice
// pulls its own plane(s) from the shared READ-ONLY src, so no core ever
// reads another core's freshly written lines (the serial-filter +
// pooled-encode variant measured 2-3 us of cross-core dirty-line pulls
// at 100 KB — worse than serial).

// dst[i] = src[(k0+i)*4 + plane] for i in [0, k1-k0): a sub-range of one
// byte plane of the ts=4 shuffle (whole plane: k0=0, k1=ne).
static void extract_plane4(const uint8_t *src, int64_t k0, int64_t k1,
                           int plane, uint8_t *dst) {
  const int64_t ne = k1 - k0;
  src += k0 * 4;
  int64_t k = 0;
#if defined(__SSSE3__) || defined(__AVX2__)
  const __m128i m = _mm_setr_epi8(
      (char)plane, (char)(4 + plane), (char)(8 + plane), (char)(12 + plane),
      (char)0x80, (char)0x80, (char)0x80, (char)0x80, (char)0x80, (char)0x80,
      (char)0x80, (char)0x80, (char)0x80, (char)0x80, (char)0x80,
      (char)0x80);
  for (; k + 16 <= ne; k += 16) {
    const __m128i a = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i *)(src + (k + 0) * 4)), m);
    const __m128i b = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i *)(src + (k + 4) * 4)), m);
    const __m128i c2 = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i *)(src + (k + 8) * 4)), m);
    const __m128i d = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i *)(src + (k + 12) * 4)), m);
    const __m128i ab = _mm_unpacklo_epi32(a, b);
    const __m128i cd = _mm_unpacklo_epi32(c2, d);
    _mm_storeu_si128((__m128i *)(dst + k), _mm_unpacklo_epi64(ab, cd));
  }
#endif
  for (; k < ne; k++) dst[k] = src[k * 4 + plane];
}

// dst[i] = src[(k0+i)*2 + plane] for i in [0, k1-k0): a sub-range of one
// ts=2 byte plane.  Small fused frames cut on plane boundaries only
// (sub-plane cuts measured +56% size on the i16 ramp pin there); the
// >= 256 KiB fused path reuses the plain segmentation's sub-plane cuts,
// which already exist in the two-stage path at identical boundaries.
static void extract_plane2(const uint8_t *src, int64_t k0, int64_t k1,
                           int plane, uint8_t *dst) {
  int64_t i = 0;
  const int64_t cnt = k1 - k0;
  const uint8_t *s = src + k0 * 2;
#if defined(__SSSE3__) || defined(__AVX2__)
  const __m128i m = _mm_setr_epi8(
      (char)plane, (char)(2 + plane), (char)(4 + plane), (char)(6 + plane),
      (char)(8 + plane), (char)(10 + plane), (char)(12 + plane),
      (char)(14 + plane), (char)0x80, (char)0x80, (char)0x80, (char)0x80,
      (char)0x80, (char)0x80, (char)0x80, (char)0x80);
  for (; i + 16 <= cnt; i += 16) {
    const __m128i a = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i *)(s + i * 2)), m);
    const __m128i b = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i *)(s + i * 2 + 16)), m);
    _mm_storeu_si128((__m128i *)(dst + i), _mm_unpacklo_epi64(a, b));
  }
#endif
  for (; i < cnt; i++) dst[i] = s[i * 2 + plane];
}

// Fused-slice bounds over the SHUFFLED stream, mirrored by the snappy
// stitcher: whole planes per slice when nseg == ts (the small-frame
// configs: ts=2:2, ts=4:4 — SUB-plane cuts there were measured +56%
// size and rejected, see tpb_compress_frame), equal sub-plane pieces
// when nseg > ts (the >= 256 KiB configs, where these bounds coincide
// with the plain t*ceil(n/nseg) cuts — the big-path fused gate requires
// n % max(ts, nseg) == 0 precisely so the BYTES stay identical to the
// two-stage filter+encode path).  The last slice absorbs the n % ts
// tail.  Must stay a pure function of (n, ts, nseg, t).
static inline void fused_bounds(int64_t n, int ts, int nseg, int t,
                                int64_t *lo, int64_t *hi) {
  const int64_t pl = n / ts;
  if (ts >= nseg) {
    const int64_t per = (int64_t)(ts / nseg) * pl;  // bytes per slice
    *lo = (int64_t)t * per;
    *hi = t == nseg - 1 ? n : *lo + per;
  } else {
    const int div = nseg / ts;  // slices per plane
    const int p = t / div, h = t % div;
    const int64_t hb = pl / div;
    *lo = (int64_t)p * pl + (int64_t)h * hb;
    *hi = h == div - 1 ? (int64_t)(p + 1) * pl : *lo + hb;
    if (t == nseg - 1) *hi = n;  // tail rides the last slice
  }
}

// fused small-frame slice: extract own plane, then encode own segment
static void frame_fused_slice(void *p, int t);

static void frame_encode_slice(void *p, int t) {
  FrameEncCtx &c = *(FrameEncCtx *)p;
  int64_t lo, hi;
  if (c.fused) {  // plane-aligned bounds; last slice absorbs the tail
    fused_bounds(c.n, c.ts, c.nseg, t, &lo, &hi);
  } else {
    lo = (int64_t)t * c.seg;
    hi = std::min(c.n, lo + c.seg);
  }
  if (lo >= hi) {
    c.sizes[t] = 0;
    return;
  }
  if (c.codec == kCodecZlib) {
    // FILTERED payloads ride libdeflate (faster AND smaller at level >= 4,
    // see the LibDeflate header note); the walker patches non-final
    // segments to the Z_SYNC_FLUSH layout so mixed libdeflate/libz
    // segments still concatenate into one standard stream.  The gate is
    // "did filtering actually run" (sb set), NOT the mode flag: ts=1
    // makes shuffle a no-op, and unfiltered text through libdeflate
    // measured 2.7x LARGER — mirror the serial path's to_compress != src
    int64_t w = -2;
    if (c.sb != nullptr)
      w = zlib_ld_segment(c.stream + lo, hi - lo, c.slots + t * c.slot,
                          c.slot, c.depth, t == c.nseg - 1);
    if (w < 0)
      w = zlib_deflate_segment(
          c.stream + lo, hi - lo, c.slots + t * c.slot, c.slot, c.depth,
          // dictionary = the window preceding this segment, CLAMPED to
          // what exists: segments under 32 KiB (the 48-255 KiB small-
          // frame zlib window has ~12 KiB slices) would otherwise prime
          // from before the buffer — out-of-bounds garbage that emitted
          // invalid-distance streams (caught by the round-4 session-2
          // parallel-inflate sweep; CPython zlib rejected them too)
          lo > 0 ? c.stream + lo - std::min<int64_t>(lo, 32768) : nullptr,
          std::min<int64_t>(lo, 32768),
          t == c.nseg - 1);
    c.sizes[t] = w;
    c.adlers[t] =
        adler32(adler32(0L, Z_NULL, 0), c.stream + lo, (uInt)(hi - lo));
    return;
  }
  BlockScratch &ls = frame_scratch();  // per-thread tables, warm
  const bool lz4ish = c.codec == kCodecLz4 || c.codec == kCodecLz4Hc ||
                      c.codec == kCodecBlosclz;
  const uint32_t ep = lz4ish ? ls.next_epoch(hi - lo) : 0;
  c.sizes[t] = codec_compress(
      c.codec, c.depth, c.stream + lo, hi - lo, c.slots + t * c.slot, c.slot,
      lz4ish ? ls.lz4_head() : nullptr,
      c.depth > 1 ? ls.lz4_chain() : nullptr, ep,
      c.codec == kCodecLz4 ? ls.scan(hi - lo) : nullptr, &c.tails[t]);
}

static void frame_fused_slice(void *p, int t) {
  FrameEncCtx &c = *(FrameEncCtx *)p;
  const int64_t pl = c.n / c.ts;  // plane length
  int64_t lo, hi;
  fused_bounds(c.n, c.ts, c.nseg, t, &lo, &hi);
  // every fused slice lies within ONE plane (nseg >= ts for all engaged
  // configs); the n % ts tail past body is copied verbatim below
  const int64_t body_hi = std::min(hi, c.body);
  const int pn = (int)(lo / pl);
  const int64_t k0 = lo - (int64_t)pn * pl, k1 = body_hi - (int64_t)pn * pl;
  if (c.ts == 2)
    extract_plane2(c.src, k0, k1, pn, c.sb + lo);
  else
    extract_plane4(c.src, k0, k1, pn, c.sb + lo);
  if (t == c.nseg - 1 && c.body < c.n)
    std::memcpy(c.sb + c.body, c.src + c.body, (size_t)(c.n - c.body));
  frame_encode_slice(p, t);
}

// Bulk copies with precomputed destinations (stitch pieces / snappy
// bodies): pool-dispatched when the payload is big enough to matter.
struct CopyPiece {
  const uint8_t *src;
  int64_t dst;
  int64_t len;
};
struct CopyCtx {
  uint8_t *payload;
  const CopyPiece *pieces;
};
static void frame_copy_piece(void *p, int k) {
  CopyCtx &c = *(CopyCtx *)p;
  if (c.pieces[k].len > 0)
    std::memcpy(c.payload + c.pieces[k].dst, c.pieces[k].src,
                (size_t)c.pieces[k].len);
}
static void run_pieces(uint8_t *payload, const CopyPiece *pieces, int np,
                       int64_t total) {
  CopyCtx c{payload, pieces};
  if (total < (256 << 10) || !spin_pool().run(frame_copy_piece, &c, np)) {
    for (int k = 0; k < np; k++) frame_copy_piece(&c, k);
  }
}

// Pool-sliced whole-buffer filter/unfilter for the single-block frame
// paths: same element/group split as shuffle_full/bitshuffle_full, but
// dispatched on the spin pool — the OpenMP _full variants must not run
// while pool workers spin (2x oversubscription on 4 vCPUs was measured
// at 4x slowdown on the decode unfilter).
struct FilterCtx {
  const uint8_t *src;
  uint8_t *dst;
  int64_t n, units, per;
  int ts, mode, nsl;
  bool inverse;
};

static void filter_ctx_slice(void *p, int t) {
  FilterCtx &c = *(FilterCtx *)p;
  const int64_t a = (int64_t)t * c.per, b = std::min(c.units, a + c.per);
  if (a < b) {
    if (c.mode == kByteShuffle) {
      if (c.inverse)
        unshuffle_range(c.src, c.dst, c.n / c.ts, c.ts, a, b);
      else
        shuffle_range(c.src, c.dst, c.n / c.ts, c.ts, a, b);
    } else {
      bitshuffle_range(c.src, c.dst, c.ts, c.inverse, a, b);
    }
  }
  if (t == c.nsl - 1) {
    const int64_t body =
        c.mode == kByteShuffle ? (c.n / c.ts) * c.ts : c.units * 8 * c.ts;
    if (body < c.n)
      std::memcpy(c.dst + body, c.src + body, (size_t)(c.n - body));
  }
}

// filter (inverse=false) or unfilter (inverse=true) a whole buffer on the
// pool; falls back to one serial slice
static void filter_buffer_pool(const uint8_t *src, uint8_t *dst, int64_t n,
                               int ts, int mode, bool inverse) {
  if (ts <= 1 || n < ts) {
    std::memcpy(dst, src, (size_t)n);
    return;
  }
  const int64_t ne = n / ts;
  const int64_t units = mode == kByteShuffle ? ne : ne / 8;
  // a 4-slice tier at the fused small-frame floor (48 KiB) was measured
  // SLOWER than serial here (5.6 vs 3.5 us at 100 KB: ~0.8 us unshuffle
  // slices sit below the dispatch floor) — don't re-add it
  const int nsl = n >= kFrameSegMin ? kMaxFrameSegments : 1;
  FilterCtx c{src, dst, n, units, (units + nsl - 1) / nsl,
              ts,  mode, nsl, inverse};
  if (nsl == 1 || !spin_pool().run(filter_ctx_slice, &c, nsl))
    for (int t = 0; t < nsl; t++) filter_ctx_slice(&c, t);
}

// Returns the payload size written to ``payload``; any value >= n means
// "incompressible, caller takes the memcpy fallback" (the concat is
// skipped in that case); -2 on allocation failure.  LZ4/LZ4HC segments
// are seam-stitched (see above); Snappy segments concatenate directly —
// mid-stream literal elements are always valid in Snappy, so only the
// per-segment uvarint preambles are stripped under one global preamble.
static int64_t frame_compress_parallel(const uint8_t *src, int64_t n, int ts,
                                       int shuffle_mode, int codec, int depth,
                                       int nseg, uint8_t *payload,
                                       BlockScratch &scratch, int fused = 0) {
  const bool filtered = shuffle_mode != kNoShuffle && ts > 1 && n >= ts;
  const uint8_t *stream = src;
  uint8_t *sb = nullptr;
  if (filtered) {
    sb = scratch.get(n);
    if (!sb) return -2;
    stream = sb;
  }
  const int64_t seg = (n + nseg - 1) / nseg;
  // fused slices are plane-aligned and unequal (the last carries the
  // tail); the slot bound must cover the largest
  int64_t max_slice = seg;
  if (fused) {
    max_slice = 0;
    for (int t = 0; t < nseg; t++) {
      int64_t lo, hi;
      fused_bounds(n, ts, nseg, t, &lo, &hi);
      max_slice = std::max(max_slice, hi - lo);
    }
  }
  const int64_t slot = codec_bound(codec, max_slice);
  uint8_t *slots = scratch.get2((int64_t)nseg * slot);
  if (!slots) return -2;

  // filter split (same element/group ranges shuffle_full/bitshuffle_full
  // use); the tail past ``body`` is copied verbatim by the last slice
  int64_t units = 0, body = n;
  if (filtered) {
    const int64_t ne = n / ts;
    if (shuffle_mode == kByteShuffle) {
      units = ne;
      body = ne * ts;
    } else {
      units = ne / 8;
      body = units * 8 * ts;
    }
  }
  const int64_t per = filtered ? (units + nseg - 1) / nseg : 0;

  int64_t sizes[kMaxFrameSegments];
  Lz4Tail tails[kMaxFrameSegments];
  unsigned long adlers[kMaxFrameSegments] = {0};
  FrameEncCtx ctx{src,   sb,   stream, slots, sizes, tails, adlers,
                  n,     seg,  slot,   units, body,  per,
                  ts,    shuffle_mode, codec, depth, nseg, fused};
  if (fused) {
    // ONE dispatch: each slice extracts its own plane from the shared
    // read-only src and encodes it locally (no filter barrier, no
    // cross-core dirty filtered lines — both measured losses at 100 KB)
    if (!spin_pool().run(frame_fused_slice, &ctx, nseg))
      for (int t = 0; t < nseg; t++) frame_fused_slice(&ctx, t);
  } else {
    if (filtered) {
      // sb must be fully materialized before any encode starts (run() is
      // a completion barrier)
      if (!spin_pool().run(frame_filter_slice, &ctx, nseg))
        for (int t = 0; t < nseg; t++) frame_filter_slice(&ctx, t);
    }
    if (!spin_pool().run(frame_encode_slice, &ctx, nseg))
      for (int t = 0; t < nseg; t++) frame_encode_slice(&ctx, t);
  }

  int64_t sum = 0;
  for (int t = 0; t < nseg; t++) {
    if (sizes[t] < 0) return n;  // slot overflow ⇒ incompressible ⇒ memcpy
    sum += sizes[t];
  }
  if (sum >= n) return sum;  // caller takes the memcpy fallback

  if (codec == kCodecZlib) {
    // one zlib wrapper around the concatenated raw-deflate bodies
    // (pigz layout): 2-byte header, bodies (non-final segments end in a
    // byte-aligned empty stored block from Z_SYNC_FLUSH), big-endian
    // adler32 of the whole uncompressed stream via adler32_combine
    const int flevel = depth <= 1 ? 0 : depth <= 5 ? 1 : depth == 6 ? 2 : 3;
    unsigned flg = (unsigned)flevel << 6;
    const unsigned rem = ((0x78u << 8) | flg) % 31;
    if (rem) flg += 31 - rem;
    int64_t di = 0;
    payload[di++] = 0x78;
    payload[di++] = (uint8_t)flg;
    CopyPiece bodies[kMaxFrameSegments];
    int nb = 0;
    unsigned long adler = adler32(0L, Z_NULL, 0);
    for (int t = 0; t < nseg; t++) {
      if (sizes[t] <= 0) continue;
      const int64_t lo = (int64_t)t * seg, hi = std::min(n, lo + seg);
      bodies[nb++] = {slots + t * slot, di, sizes[t]};
      di += sizes[t];
      adler = adler32_combine(adler, adlers[t], (z_off_t)(hi - lo));
    }
    if (di + 4 >= n) return di + 4;  // caller takes the memcpy fallback
    payload[di++] = (uint8_t)(adler >> 24);
    payload[di++] = (uint8_t)(adler >> 16);
    payload[di++] = (uint8_t)(adler >> 8);
    payload[di++] = (uint8_t)adler;
    run_pieces(payload, bodies, nb, di);
    return di;
  }

  if (codec == kCodecBlosclz) {
    // BloscLZ has no preamble and no end-of-stream constraints: segment
    // outputs concatenate directly into one valid stream (format spec,
    // codecs/blosclz_ref.py)
    int64_t di = 0;
    CopyPiece bodies[kMaxFrameSegments];
    int nb = 0;
    for (int t = 0; t < nseg; t++) {
      if (sizes[t] <= 0) continue;
      bodies[nb++] = {slots + t * slot, di, sizes[t]};
      di += sizes[t];
    }
    run_pieces(payload, bodies, nb, di);
    return di;  // sum < n already established above
  }

  if (codec == kCodecSnappy) {
    // one global preamble, then per-segment bodies (their own preambles
    // stripped): Snappy has no end-of-stream token constraints, so plain
    // body concatenation is already one valid stream
    int64_t di = 0;
    uint64_t x = (uint64_t)n;
    while (x >= 0x80) {
      payload[di++] = (uint8_t)(x & 0x7F) | 0x80;
      x >>= 7;
    }
    payload[di++] = (uint8_t)x;
    CopyPiece bodies[kMaxFrameSegments];
    int nb = 0;
    for (int t = 0; t < nseg; t++) {
      if (sizes[t] <= 0) continue;
      // per-segment bounds must mirror frame_encode_slice: fused slices
      // are plane-aligned (fused_bounds), not the ceil(n/nseg) of the
      // plain path — the mismatch silently forced ragged fused snappy
      // frames into the memcpy fallback (found via the ratio-1.00 frame
      // on the 100 KB mixed config, 2026-08-19)
      int64_t lo, hi;
      if (fused) {
        fused_bounds(n, ts, nseg, t, &lo, &hi);
      } else {
        lo = (int64_t)t * seg;
        hi = std::min(n, lo + seg);
      }
      int64_t hdr = 0;
      const uint8_t *s = slots + t * slot;
      if (snappy_preamble(s, sizes[t], &hdr) != hi - lo) return n;
      bodies[nb++] = {s + hdr, di, sizes[t] - hdr};
      di += sizes[t] - hdr;
    }
    if (di >= n) return di;  // caller takes the memcpy fallback
    run_pieces(payload, bodies, nb, di);
    return di;
  }

  // --- seam-stitched concatenation ---
  // A literals-only token is valid only at end-of-block, so each non-final
  // segment's tail token is dropped and its literal bytes become "pending",
  // merged into the next segment's first sequence (same literals in the
  // same order; match offsets are relative so they survive the shift).
  // A segment that encoded to a single literal token (tok_off == 0) just
  // extends the pending run.  The final pending run is emitted as the
  // block's closing literals, preserving the end-of-block rules the last
  // segment already enforced.
  //
  // Two passes: a sequential metadata pass parses one token per seam,
  // writes the (tiny) merged token headers, and records every bulk copy
  // with its exact destination; the bulk copies then run in parallel —
  // on barely-compressible data the concat is a full compressed-bytes
  // copy, which sequentially would eat the encode speedup.
  const int64_t cap = lz4_bound(n);
  CopyPiece pieces[4 * kMaxFrameSegments + 2];
  int npieces = 0;
  struct Chunk {
    const uint8_t *p;
    int64_t len;
  };
  Chunk pend[kMaxFrameSegments];
  int npend = 0;
  int64_t pend_total = 0, di = 0;
  auto emit_lit_header = [&](int64_t lit, uint8_t match_nibble) -> bool {
    const int64_t need = 1 + (lit >= 15 ? (lit - 15) / 255 + 1 : 0) + lit;
    if (di + need + 8 > cap) return false;
    payload[di++] =
        (uint8_t)(((lit >= 15 ? 15 : lit) << 4) | (match_nibble & 0x0F));
    if (lit >= 15) {
      int64_t rem = lit - 15;
      while (rem >= 255) {
        payload[di++] = 255;
        rem -= 255;
      }
      payload[di++] = (uint8_t)rem;
    }
    return true;
  };
  auto flush_pend = [&]() {
    for (int k = 0; k < npend; k++) {
      pieces[npieces++] = {pend[k].p, di, pend[k].len};
      di += pend[k].len;
    }
    npend = 0;
    pend_total = 0;
  };
  for (int t = 0; t < nseg; t++) {
    if (sizes[t] <= 0) continue;
    const uint8_t *s = slots + t * slot;
    const int64_t m = sizes[t];
    const Lz4Tail &tl = tails[t];
    if (tl.tok_off == 0) {
      // single literal token: its literal bytes (the last lit_len) pend
      pend[npend++] = {s + m - tl.lit_len, tl.lit_len};
      pend_total += tl.lit_len;
      continue;
    }
    if (pend_total > 0) {
      // merge pending + this stream's first sequence literals
      int64_t pos = 0;
      const uint8_t tok = s[pos++];
      int64_t lit = tok >> 4;
      if (lit == 15) {
        uint8_t b;
        do {
          b = s[pos++];
          lit += b;
        } while (b == 255);
      }
      if (!emit_lit_header(pend_total + lit, tok)) return n;
      flush_pend();
      if (di + (tl.tok_off - pos) > cap) return n;
      // first-sequence literals, then its match part through the last match
      pieces[npieces++] = {s + pos, di, tl.tok_off - pos};
      di += tl.tok_off - pos;
    } else {
      if (di + tl.tok_off > cap) return n;
      pieces[npieces++] = {s, di, tl.tok_off};
      di += tl.tok_off;
    }
    pend[0] = {s + m - tl.lit_len, tl.lit_len};
    npend = 1;
    pend_total = tl.lit_len;
  }
  // closing literals-only token
  if (!emit_lit_header(pend_total, 0)) return n;
  if (di + pend_total > cap) return n;
  flush_pend();
  run_pieces(payload, pieces, npieces, di);
  return di;
}

}  // namespace

extern "C" {

// ---- single-buffer entry points (ctypes ABI used by native/backend.py) ----

int64_t tpb_lz4_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                         int64_t cap, int depth) {
  return lz4_compress(src, n, dst, cap, depth < 1 ? 1 : depth);
}

int64_t tpb_lz4_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                           int64_t cap) {
  return lz4_decompress(src, n, dst, cap);
}

int64_t tpb_blosclz_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                             int64_t cap) {
  return blosclz_compress(src, n, dst, cap);
}

int64_t tpb_blosclz_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                               int64_t cap) {
  return blosclz_decompress(src, n, dst, cap);
}

int64_t tpb_lz4_emit_runs(const uint8_t *vals, const int64_t *lens,
                          int64_t nruns, int64_t n, uint8_t *dst,
                          int64_t cap) {
  return lz4_emit_runs(vals, lens, nruns, n, dst, cap);
}

int64_t tpb_lz4_emit_mixed(const int64_t *lit_pos, const uint8_t *lit_bytes,
                           int64_t nlit, const int32_t *row_d, int64_t seg,
                           int64_t n, uint8_t *dst, int64_t cap) {
  return lz4_emit_mixed(lit_pos, lit_bytes, nlit, row_d, seg, n, dst, cap);
}

// Set-bit positions of a little-endian bit-packed mask (the device match
// pipeline's literal mask, device.py _unpack_positions).  Scans u64 words
// with ctz — ~20x the NumPy unpackbits formulation on multi-MiB masks.
// Returns the number of positions written, or -1 if out of capacity.
int64_t tpb_mask_positions(const uint8_t *mask, int64_t nbytes, int32_t *out,
                           int64_t cap) {
  int64_t k = 0;
  int64_t i = 0;
  const int64_t nw = nbytes / 8;
  for (int64_t w = 0; w < nw; ++w) {
    uint64_t v;
    std::memcpy(&v, mask + w * 8, 8);
    if (!v) continue;
    const int64_t base = w * 64;
    if (k + 64 > cap) {  // rare: exact-capacity tail handling
      while (v) {
        if (k >= cap) return -1;
        out[k++] = (int32_t)(base + __builtin_ctzll(v));
        v &= v - 1;
      }
      continue;
    }
    while (v) {
      out[k++] = (int32_t)(base + __builtin_ctzll(v));
      v &= v - 1;
    }
  }
  for (i = nw * 8; i < nbytes; ++i) {
    uint8_t b = mask[i];
    while (b) {
      if (k >= cap) return -1;
      out[k++] = (int32_t)(i * 8 + __builtin_ctz(b));
      b &= b - 1;
    }
  }
  return k;
}

int64_t tpb_snappy_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                            int64_t cap) {
  return snappy_compress(src, n, dst, cap);
}

int64_t tpb_snappy_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                              int64_t cap) {
  return snappy_decompress(src, n, dst, cap);
}

int tpb_zstd_available(void) { return zstd_lib().ok ? 1 : 0; }

int64_t tpb_zstd_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                          int64_t cap, int level) {
  return codec_compress(kCodecZstd, level, src, n, dst, cap);
}

int64_t tpb_zstd_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                            int64_t cap) {
  return codec_decompress(kCodecZstd, src, n, dst, cap);
}

void tpb_shuffle(const uint8_t *src, uint8_t *dst, int64_t n, int ts) {
  shuffle_full(src, dst, n, ts);
}

void tpb_unshuffle(const uint8_t *src, uint8_t *dst, int64_t n, int ts) {
  unshuffle_full(src, dst, n, ts);
}

void tpb_bitshuffle(const uint8_t *src, uint8_t *dst, int64_t n, int ts) {
  bitshuffle_full(src, dst, n, ts, false);
}

void tpb_bitunshuffle(const uint8_t *src, uint8_t *dst, int64_t n, int ts) {
  bitshuffle_full(src, dst, n, ts, true);
}

// ---- chunk pipeline: filter + compress every block in parallel ----
//
// Block i covers src[i*block_size : min((i+1)*block_size, n)).
// Output slot i is out[i*slot_stride : ...]; out_sizes[i] receives the
// payload size; out_memcpy[i] is 1 when the block stored raw pre-filter
// bytes (memcpy fallback, ≙ blosc.go:341-345 per block).
// Returns 0 on success, negative on error.
int64_t tpb_compress_blocks(const uint8_t *src, int64_t n, int64_t block_size,
                            int ts, int shuffle_mode, int codec, int depth,
                            uint8_t *out, int64_t slot_stride,
                            int64_t *out_sizes, uint8_t *out_memcpy,
                            int num_threads) {
  if (n <= 0 || block_size <= 0) return -1;
  // bit 3 of shuffle_mode: "data arrives ALREADY filtered" (the device
  // pipeline filters on-chip then compresses host-side with mode 0) —
  // no filtering here, but codec classification (zlib's libdeflate path)
  // must match the equivalent host frame byte-for-byte
  const bool prefiltered = (shuffle_mode & 8) != 0;
  shuffle_mode &= 7;
  int64_t nb = (n + block_size - 1) / block_size;
#ifdef _OPENMP
  int nt = num_threads > 0 ? num_threads : omp_get_max_threads();
#else
  int nt = 1;
  (void)num_threads;
#endif
  (void)nt;
  // relaxed atomics: the flag is a monotone error latch read after the
  // parallel-region barrier; relaxed ordering suffices and keeps TSan happy
  std::atomic<int64_t> err{0};

  // shuffle block i into dst (or return src pointer when unfiltered)
  auto prep = [&](int64_t i, BlockScratch &scratch, uint8_t *dst,
                  int64_t &bs_out) -> const uint8_t * {
    int64_t off = i * block_size;
    int64_t bs = std::min(block_size, n - off);
    bs_out = bs;
    const uint8_t *block = src + off;
    if (shuffle_mode != kNoShuffle && ts > 1 && bs >= ts) {
      if (!dst) return nullptr;
      if (shuffle_mode == kByteShuffle)
        shuffle_full(block, dst, bs, ts);
      else
        bitshuffle_full(block, dst, bs, ts, false);
      return dst;
    }
    (void)scratch;
    return block;
  };
  // memcpy-fallback bookkeeping shared by both loops
  auto finish = [&](int64_t i, int64_t written, int64_t bs) {
    uint8_t *slot = out + i * slot_stride;
    if (written < 0) {
      err.store(written, std::memory_order_relaxed);
      return;
    }
    if (written >= bs) {
      // memcpy fallback per block: raw pre-filter bytes
      std::memcpy(slot, src + i * block_size, (size_t)bs);
      out_sizes[i] = bs;
      out_memcpy[i] = 1;
    } else {
      out_sizes[i] = written;
      out_memcpy[i] = 0;
    }
  };

  if (codec == kCodecLz4 && depth <= 1) {
    // pair-interleaved greedy path: two blocks per iteration so the two
    // latency chains overlap (see lz4_compress_pair_impl); scan-encoded
    // blocks drop out of the pair and encode directly
    const int64_t npairs = (nb + 1) / 2;
#pragma omp parallel num_threads(nt)
    {
      BlockScratch scratch;
#pragma omp for schedule(dynamic)
      for (int64_t p = 0; p < npairs; p++) {
        if (err.load(std::memory_order_relaxed)) continue;
        const int64_t i0 = 2 * p, i1 = 2 * p + 1;
        const bool filtering = shuffle_mode != kNoShuffle && ts > 1;
        uint8_t *sb =
            filtering ? scratch.get(2 * block_size) : nullptr;
        if (filtering && !sb) {
          err.store(-2, std::memory_order_relaxed);
          continue;
        }
        int64_t bs0 = 0, bs1 = 0;
        const uint8_t *tc0 = prep(i0, scratch, sb, bs0);
        uint8_t *slot0 = out + i0 * slot_stride;
        if (i1 >= nb) {  // odd tail block: single path
          int64_t w = codec_compress(
              codec, 1, tc0, bs0, slot0, slot_stride, scratch.lz4_head(),
              nullptr, scratch.next_epoch(bs0), scratch.scan(bs0));
          finish(i0, w, bs0);
          continue;
        }
        const uint8_t *tc1 =
            prep(i1, scratch, sb ? sb + block_size : nullptr, bs1);
        uint8_t *slot1 = out + i1 * slot_stride;
        // scan attempts first: a scan-accepted block leaves the pair
        int64_t w0 = -2, w1 = -2;
        uint64_t *mask = scratch.scan(block_size);
        if (mask && bs0 >= kScanMinBytes) {
          w0 = lz4_scan_compress(tc0, bs0, slot0, slot_stride, mask);
          if (w0 >= 0 && w0 * 4 > bs0) w0 = -2;
        }
        if (mask && bs1 >= kScanMinBytes) {
          w1 = lz4_scan_compress(tc1, bs1, slot1, slot_stride, mask);
          if (w1 >= 0 && w1 * 4 > bs1) w1 = -2;
        }
        if (w0 < 0 && w1 < 0) {
          uint32_t ep = scratch.next_epoch(std::max(bs0, bs1));
          Lz4PairArgs A{tc0, bs0, slot0, slot_stride,
                        scratch.lz4_head(), ep, 0};
          Lz4PairArgs B{tc1, bs1, slot1, slot_stride,
                        scratch.lz4_head2(), ep, 0};
          if (ep > 0) {
            lz4_compress_pair_impl<true>(A, B);
          } else {
            std::memset(scratch.lz4_head(), 0, ((size_t)1 << kHashLog) * 4);
            std::memset(scratch.lz4_head2(), 0, ((size_t)1 << kHashLog) * 4);
            lz4_compress_pair_impl<false>(A, B);
          }
          w0 = A.result;
          w1 = B.result;
        } else {
          if (w0 < 0)
            w0 = lz4_compress_t(tc0, bs0, slot0, slot_stride, 1,
                                scratch.lz4_head(), nullptr,
                                scratch.next_epoch(bs0));
          if (w1 < 0)
            w1 = lz4_compress_t(tc1, bs1, slot1, slot_stride, 1,
                                scratch.lz4_head(), nullptr,
                                scratch.next_epoch(bs1));
        }
        finish(i0, w0, bs0);
        finish(i1, w1, bs1);
      }
    }
    return err.load(std::memory_order_relaxed);
  }

#pragma omp parallel num_threads(nt)
  {
    BlockScratch scratch;
#pragma omp for schedule(dynamic)
    for (int64_t i = 0; i < nb; i++) {
      if (err.load(std::memory_order_relaxed)) continue;
      const bool filtering = shuffle_mode != kNoShuffle && ts > 1;
      uint8_t *sb = filtering ? scratch.get(block_size) : nullptr;
      if (filtering && !sb) {
        err.store(-2, std::memory_order_relaxed);
        continue;
      }
      int64_t bs = 0;
      const uint8_t *to_compress = prep(i, scratch, sb, bs);
      uint8_t *slot = out + i * slot_stride;
      uint32_t ep =
          (codec == kCodecLz4 || codec == kCodecLz4Hc ||
           codec == kCodecBlosclz)
              ? scratch.next_epoch(bs)
              : 0;
      int64_t written = codec_compress(
          codec, depth, to_compress, bs, slot, slot_stride,
          scratch.lz4_head(), depth > 1 ? scratch.lz4_chain() : nullptr, ep,
          codec == kCodecLz4 ? scratch.scan(bs) : nullptr, nullptr,
          (filtering && bs >= ts) || prefiltered ? 1 : 0);
      finish(i, written, bs);
    }
  }
  return err.load(std::memory_order_relaxed);
}

// ---- chunk pipeline: decompress + unfilter every block in parallel ----
//
// payload offsets/sizes index into `payloads`; block i decodes to
// out[i*block_size : ...].  Returns total bytes written or negative error.
int64_t tpb_decompress_blocks(const uint8_t *payloads, const int64_t *offsets,
                              const int64_t *psizes, const uint8_t *is_memcpy,
                              int64_t nb, int64_t block_size, int64_t total_n,
                              int ts, int shuffle_mode, int codec,
                              uint8_t *out, int num_threads) {
  if (nb <= 0 || block_size <= 0) return -1;
#ifdef _OPENMP
  int nt = num_threads > 0 ? num_threads : omp_get_max_threads();
#else
  int nt = 1;
  (void)num_threads;
#endif
  (void)nt;
  std::atomic<int64_t> err{0};
#pragma omp parallel num_threads(nt)
  {
    BlockScratch scratch;
#pragma omp for schedule(dynamic)
    for (int64_t i = 0; i < nb; i++) {
      if (err.load(std::memory_order_relaxed)) continue;
      int64_t off = i * block_size;
      int64_t bs = std::min(block_size, total_n - off);
      if (bs <= 0) { err.store(-2, std::memory_order_relaxed); continue; }
      const uint8_t *p = payloads + offsets[i];
      int64_t psz = psizes[i];
      uint8_t *dst = out + off;
      if (is_memcpy[i]) {
        if (psz != bs) { err.store(-3, std::memory_order_relaxed); continue; }
        std::memcpy(dst, p, (size_t)bs);
        continue;
      }
      bool filtered = shuffle_mode != kNoShuffle && ts > 1 && bs >= ts;
      uint8_t *dec = dst;
      if (filtered) {
        dec = scratch.get(block_size);
        if (!dec) { err.store(-4, std::memory_order_relaxed); continue; }
      }
      int64_t got = codec_decompress(codec, p, psz, dec, bs);
      if (got != bs) {
        err.store(got < 0 ? got : -5, std::memory_order_relaxed);
        continue;
      }
      if (filtered) {
        if (shuffle_mode == kByteShuffle)
          unshuffle_full(dec, dst, bs, ts);
        else
          bitshuffle_full(dec, dst, bs, ts, true);
      }
    }
  }
  int64_t e = err.load(std::memory_order_relaxed);
  if (e) return e;
  return total_n;
}

// worst-case per-block slot size for tpb_compress_blocks
int64_t tpb_compress_bound(int64_t block_size, int codec) {
  return codec_bound(codec, block_size);
}

// ---- single-shot single-block frame (the reference's own benchmark
// shape: one call = filter + codec + memcpy fallback + 16-byte header,
// ≙ compressBackend blosc.go:319-374 collapsed into one C ABI crossing).
//
// dst capacity must be >= 16 + tpb_compress_bound(n, codec).  Returns the
// total frame size (header included), negative on error.  Shuffle flags
// are cleared on memcpy frames (deliberate interop divergence, api.py).
int64_t tpb_compress_frame(const uint8_t *src, int64_t n, int ts,
                           int shuffle_mode, int header_codec_id,
                           int codec, int depth, uint8_t *dst) {
  if (n <= 0 || n + 16 > (int64_t)0xFFFFFFFF) return -1;
  BlockScratch &scratch = frame_scratch();
  uint8_t *payload = dst + 16;
  int64_t written;
  int nseg = frame_segments(n, codec);
  int fused = 0;
  static const bool no_par =
      std::getenv("TPU_BLOSC_NO_FRAME_PARALLEL") != nullptr;
  if (nseg <= 1 && n >= kSmallFrameMin && n < kFrameSegMin && !no_par &&
      (codec == kCodecLz4 || codec == kCodecLz4Hc ||
       codec == kCodecSnappy || codec == kCodecBlosclz)) {
    // round-4 small-frame FUSED parallel encode (the reference's own
    // 100 KB benchmark shape is exactly this: LZ4-5, byte shuffle, ts=4).
    // Segmentation stays a pure function of (n, codec, ts, mode) — bytes
    // never depend on thread count.  Each slice extracts its own byte
    // PLANE from the shared read-only src and encodes it locally
    // (frame_fused_slice): plane slices carry near-identical work for ANY
    // data, which is what makes sub-256 KiB parallelism pay here —
    // measured 2026-08-19 at the C level (hot pool, 100 KB, ts=4):
    // LZ4 half-random 4.1->6.2 GB/s, i%256 ramp 7.7->15.6, noisy f32
    // 0.84->0.95; Python-level LZ4HC ramp 9.3->16.9 / half 0.20->1.64,
    // Snappy 7.9->13.1 / 5.7->6.9, BloscLZ 9.7->17.2 / 3.6->5.1 (decode
    // of the stitched/concat streams measured a wash for all of them).
    // CONTIGUOUS segments (noshuffle) were also tried and REJECTED:
    // unbalanced slices (50 KB ramp + 50 KB random) measured
    // 10.0->6.6 GB/s — worker wake latency makes stealing of unequal
    // tails ineffective at this scale, so only the balanced plane
    // decomposition wins.  (ZLIB is the exception that segments in both
    // modes — frame_segments — because its ~100+ us slices dwarf the
    // imbalance.)  Filtered modes that would need a serially-written sb
    // stay serial: pooled encode after a caller-serial filter measured
    // SLOWER than all-serial at this size (2-3 us of cross-core dirty
    // filtered-line pulls).
    // ts=8 was tried and REJECTED (2026-08-19): plane compressibility is
    // wildly uneven on real f64 (mantissa planes cost 10x the exponent
    // planes — 20.3 us of a 30.5 us total in one plane pair), so paired
    // slices (nseg=4) were an encode WASH; one plane per slice (nseg=8)
    // recovered 1.2-1.5x encode but its 7 seams cost a consistent
    // 13-26% on DECODE and +8% size on f64 — a bad trade for
    // write-once-read-many data.  ts=2 keeps nseg=2 (plane-boundary cut
    // only): sub-plane cuts (nseg=4) cost up to one data-period of
    // literals per seam (i16 ramp pin 824 -> 1288 measured) for little
    // extra encode speed.
    if (shuffle_mode == kByteShuffle && (ts == 2 || ts == 4) && n >= 64) {
      nseg = ts == 2 ? 2 : 4;
      fused = 1;
    }
  }
  // Round-4 session-2: the SAME fusion applies to the >= 256 KiB
  // segment-parallel path.  The two-stage filter+encode makes every
  // encode slice read a plane 3/4-written by OTHER cores (the filter
  // slices write plane-strided), so the encode stage starts with a
  // cross-core dirty-line pull of most of its input.  When
  // n % max(ts, nseg) == 0 the fused plane/sub-plane bounds coincide
  // exactly with the plain t*ceil(n/nseg) cuts, so each slice can
  // extract its own piece from the read-only src and encode it locally
  // with BYTE-IDENTICAL output (tests pin this via TPU_BLOSC_NO_FUSED_BIG
  // A/B).  The trade: fused extraction re-reads src once PER PLANE, so
  // it wins only while that redundancy stays cache-resident — measured
  // (interleaved A/B, best-of, this host): ts=2 wins everywhere
  // (256K 8.4-9.1 -> 18-22, 512K 11.6-13.2 -> 25-27.6, 1M 13.4-17.8 ->
  // 22-26, 4M wash-to-win GB/s; only 2x src reads), ts=4 wins +7-30%
  // up to 512 KiB and LOSES at >= 768 KiB (4x src reads stream from
  // memory; 4M two-stage 17-21 vs fused 14.8-15.8) — hence the ts=4
  // size cap.  zlib is excluded: its libz segments prime a 32 KiB
  // dictionary from the PREVIOUS segment's filtered bytes, which a
  // fused slice has not written yet.
  static const bool no_fused_big =
      std::getenv("TPU_BLOSC_NO_FUSED_BIG") != nullptr;
  if (nseg > 1 && !fused && !no_fused_big &&
      shuffle_mode == kByteShuffle &&
      (ts == 2 || (ts == 4 && n <= (512 << 10))) &&
      n % (nseg > ts ? (int64_t)nseg : (int64_t)ts) == 0 &&
      (codec == kCodecLz4 || codec == kCodecLz4Hc ||
       codec == kCodecSnappy || codec == kCodecBlosclz))
    fused = 1;
  if (nseg > 1 && codec != kCodecZstd) {
    // segment-concatenated parallel encode (see frame_compress_parallel).
    // ZSTD is decode-gated only: segmenting its encode costs up to tens
    // of percent of ratio (large-window format), breaking the
    // "compressed size <= reference" contract — measured and rejected.
    written = frame_compress_parallel(src, n, ts, shuffle_mode, codec, depth,
                                      nseg, payload, scratch, fused);
    if (written == -2) return -2;
  } else {
    const uint8_t *to_compress = src;
    if (shuffle_mode != kNoShuffle && ts > 1 && n >= ts) {
      uint8_t *sb = scratch.get(n);
      if (!sb) return -2;
      filter_buffer_pool(src, sb, n, ts, shuffle_mode, false);
      to_compress = sb;
    }
    int64_t cap = codec_bound(codec, n);
    uint32_t ep = (codec == kCodecLz4 || codec == kCodecLz4Hc ||
                   codec == kCodecBlosclz)
                      ? scratch.next_epoch(n)
                      : 0;
    written = codec_compress(
        codec, depth, to_compress, n, payload, cap,
        scratch.lz4_head(), depth > 1 ? scratch.lz4_chain() : nullptr, ep,
        codec == kCodecLz4 ? scratch.scan(n) : nullptr, nullptr,
        to_compress != src ? 1 : 0);
  }
  int flags = 0;
  if (written < 0 || written >= n) {
    // memcpy fallback: raw pre-filter bytes, shuffle flags cleared
    std::memcpy(payload, src, (size_t)n);
    written = n;
    flags = 0x2;
  } else if (shuffle_mode == kByteShuffle) {
    flags = 0x1;
  } else if (shuffle_mode == kBitShuffle) {
    flags = 0x4;
  }
  // 16-byte little-endian header (≙ Header.Bytes, blosc.go:188-198)
  uint32_t n32 = (uint32_t)n;
  uint32_t total = (uint32_t)(16 + written);
  dst[0] = 2;  // FormatVersion
  dst[1] = (uint8_t)header_codec_id;
  dst[2] = (uint8_t)flags;
  dst[3] = (uint8_t)(ts < 255 ? ts : 255);
  std::memcpy(dst + 4, &n32, 4);   // NBytesOrig
  std::memcpy(dst + 8, &n32, 4);   // BlockSize == n (single block)
  std::memcpy(dst + 12, &total, 4);  // NBytesComp incl. header
  return (int64_t)total;
}

// ---------------------------------------------------------------------------
// fused small-frame DECODE (round 5, VERDICT r4 item 1): one pool
// dispatch runs LZ4 chunk decode AND the unshuffle — the two stages that
// were separately below the dispatch floor (parallel LZ4 alone measured
// a wash, 4.6 vs 4.7 us; pooled unfilter alone a LOSS, 5.6 vs 3.5 us at
// 100 KB) share ONE dispatch + done-spin here, so the overhead is paid
// once for ~8 us of combined work.
//
// Decomposition: phase 1 decodes the encoder's plane-aligned chunks
// (fused_bounds cuts — the fused ENCODER's seams), phase 2 unshuffles
// ELEMENT ranges (contiguous out writes; a plane-wise unshuffle would
// false-share every out cache line between all lanes).  The phase
// boundary cannot be a barrier inside pool slices — the pool assigns
// slices dynamically, so a lane spinning in slice 0 while slices 1-3
// sit unclaimed (workers still napping) would deadlock.  Instead each
// lane HELPS: it claims unfinished phase-1 chunks via a CAS bitmask
// (single-owner writes — TSan-clean, no idempotent-rewrite races), then
// spins only for chunks some live lane is already executing.  A vCPU
// stall on one lane delays at most its own claimed chunk; every other
// lane keeps making progress (the straggler-tolerance VERDICT shape (a)
// asked for, without the data race re-execution would create).
// ---------------------------------------------------------------------------
// Decode slices carry ~3x less work per byte than encode slices, so the
// fused-decode floor sits higher than the encoder's 48 KiB: mixed
// ramp+noise data measured 0.78-0.84x at 48-64 KiB (dispatch+sync
// dominates the ~1 us chunks) but 1.09-1.34x from ~100 KiB up.
constexpr int64_t kFusedDecodeMin = 96 << 10;

// ---------------------------------------------------------------------------
// Adaptive fused-vs-serial decode dispatch.  The fused path's win is
// WINDOW-dependent on this shared host (measured 2026-08-20: 1.10-1.21x
// in one hour's scheduler window, 0.70-0.77x in another, on identical
// code and data — worker vCPUs sometimes carry quasi-persistent stall
// lotteries the static gates cannot see).  Both paths produce identical
// bytes, so the dispatcher simply samples each path periodically
// (slots 0/1 of every 32 calls) and routes the rest to whichever
// ns-per-MiB EWMA is currently lower, with 5% hysteresis toward fused.
// All state is relaxed-atomic and per-process; TPU_BLOSC_NO_ADAPTIVE_DECODE
// pins the dispatcher to always-try-fused (perf measurement),
// TPU_BLOSC_NO_FUSED_DECODE disables the fused path outright.
// ---------------------------------------------------------------------------
struct AdaptiveDecode {
  std::atomic<uint32_t> count{0};
  std::atomic<int64_t> fused_npm{-1};   // EWMA ns per MiB, -1 = no sample
  std::atomic<int64_t> serial_npm{-1};

  static void ewma(std::atomic<int64_t> &slot, int64_t sample) {
    const int64_t cur = slot.load(std::memory_order_relaxed);
    slot.store(cur < 0 ? sample : cur - cur / 8 + sample / 8,
               std::memory_order_relaxed);
  }
  // 0 = run serial sample, 1 = run fused sample, 2 = run preferred
  int slot() { return std::min(count.fetch_add(1, std::memory_order_relaxed) & 31u, 2u); }
  bool prefer_fused() const {
    const int64_t f = fused_npm.load(std::memory_order_relaxed);
    const int64_t se = serial_npm.load(std::memory_order_relaxed);
    if (f < 0) return true;          // unsampled: try it
    if (se < 0) return f >= 0;       // no serial sample yet: keep fused
    return f <= se + se / 20;        // 5% hysteresis toward fused
  }
};
static AdaptiveDecode g_adaptive_decode;

static inline int64_t now_ns() {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return (int64_t)t.tv_sec * 1000000000 + t.tv_nsec;
}

struct FusedDecCtx {
  const uint8_t *src;
  uint8_t *dec, *out;
  const int64_t *tok_ip, *lit_skip, *cuts;
  int64_t ns, n;
  int ts, nseg, codec;
  std::atomic<uint32_t> claim{0};
  std::atomic<int> done1{0};
  std::atomic<int> fail{0};
};

static void fused_dec_slice(void *p, int t) {
  FusedDecCtx &c = *(FusedDecCtx *)p;
  for (int k = 0; k < c.nseg; k++) {
    const int u = (t + k) % c.nseg;
    const uint32_t bit = 1u << u;
    if (c.claim.fetch_or(bit, std::memory_order_acq_rel) & bit) continue;
    const int64_t c0 = c.cuts[u], c1 = c.cuts[u + 1];
    bool ok;
    if (c.codec == kCodecSnappy)
      ok = snappy_decompress_chunk(c.src, c.ns, c.tok_ip[u], c.lit_skip[u],
                                   c.dec, c0, c1) == c1 - c0;
    else if (c.codec == kCodecBlosclz)
      ok = blosclz_decompress_chunk(c.src, c.ns, c.tok_ip[u], c.dec, c0, c1);
    else
      ok = lz4_decompress_chunk(c.src, c.ns, c.tok_ip[u], c.lit_skip[u],
                                c.dec, c0, c1) == c1 - c0;
    if (!ok) c.fail.fetch_add(1, std::memory_order_relaxed);
    c.done1.fetch_add(1, std::memory_order_release);
  }
  while (c.done1.load(std::memory_order_acquire) < c.nseg) cpu_relax();
  if (c.fail.load(std::memory_order_relaxed)) return;
  const int64_t ne = c.n / c.ts;
  const int64_t per = (ne + c.nseg - 1) / c.nseg;
  const int64_t a = (int64_t)t * per, b = std::min(ne, a + per);
  if (a < b) unshuffle_range(c.dec, c.out, ne, c.ts, a, b);
  if (t == c.nseg - 1 && ne * c.ts < c.n)
    std::memcpy(c.out + ne * c.ts, c.dec + ne * c.ts,
                (size_t)(c.n - ne * c.ts));
}

// Fused decode+unshuffle for byte-shuffled LZ4/LZ4HC/Snappy/BloscLZ
// small frames (96-256 KiB, ts 2/4 — the fused ENCODER's codecs).
// Returns n with ``out`` fully written (decoded AND unshuffled), or
// kSplitReject when the stream is not our plane-cut seam layout / the
// engagement heuristics say parallel cannot win / the pool is busy
// (caller runs the serial decode + unfilter, which also owns canonical
// error codes).
static int64_t fused_decode_unshuffle(const uint8_t *src, int64_t ns,
                                      uint8_t *dec, uint8_t *out,
                                      int64_t n, int ts, int codec) {
  const int nseg = ts;  // plane-boundary cuts only (see fused_bounds)
  int64_t cuts[kMaxDecodeSegments + 1];
  cuts[0] = 0;
  for (int t = 0; t < nseg; t++) {
    int64_t lo, hi;
    fused_bounds(n, ts, nseg, t, &lo, &hi);
    cuts[t + 1] = hi;
  }
  int64_t tok_ip[kMaxDecodeSegments], lit_skip[kMaxDecodeSegments];
  int64_t tok_cnt[kMaxDecodeSegments], min_off = 0;
  bool scanned;
  if (codec == kCodecSnappy)
    scanned = snappy_split_scan(src, ns, n, nseg, cuts, tok_ip, lit_skip,
                                tok_cnt, &min_off);
  else if (codec == kCodecBlosclz) {
    for (int k = 0; k < nseg; k++) lit_skip[k] = 0;
    scanned = blosclz_split_scan(src, ns, n, nseg, cuts, tok_ip, tok_cnt,
                                 &min_off);
  } else
    scanned = lz4_split_scan(src, ns, n, nseg, cuts, tok_ip, lit_skip,
                             tok_cnt, &min_off);
  if (!scanned) return kSplitReject;
  // Engagement heuristics (measured 2026-08-20, sweep in BASELINE.md):
  // parallel decode pays only when per-chunk work is BALANCED and
  // latency-bound.  (a) Token imbalance (f32-ramp planes: 865 vs ~2
  // tokens — one mantissa plane carries the whole decode) leaves max
  // chunk time ~= serial time, so dispatch+sync is pure loss (0.86x).
  // (b) Near-token-free chunks with LONG offsets are single giant
  // wild-copy cascades running at cache-store bandwidth — four cores
  // share that bandwidth, so parallel gains nothing (periodic data with
  // offset 512: 0.93-0.95x); SHORT offsets (<256) make the cascade a
  // dependency chain (latency-bound) where parallelism wins 1.10-1.21x.
  int64_t total_toks = 0, max_toks = 0;
  for (int k = 0; k < nseg; k++) {
    total_toks += tok_cnt[k];
    max_toks = std::max(max_toks, tok_cnt[k]);
  }
  const bool imbalanced = max_toks * nseg > 2 * total_toks + 8 * nseg;
  const bool bw_bound = total_toks <= 4 * nseg && min_off >= 256;
  if (std::getenv("TPU_BLOSC_DEBUG_FUSED"))
    fprintf(stderr,
            "fused-decode n=%lld toks=[%lld,%lld,%lld,%lld] min_off=%lld "
            "imbalanced=%d bw=%d\n",
            (long long)n, (long long)tok_cnt[0], (long long)tok_cnt[1],
            (long long)(nseg > 2 ? tok_cnt[2] : -1),
            (long long)(nseg > 3 ? tok_cnt[3] : -1), (long long)min_off,
            (int)imbalanced, (int)bw_bound);
  if (imbalanced || bw_bound) return kSplitReject;
  FusedDecCtx ctx;
  ctx.src = src;
  ctx.dec = dec;
  ctx.out = out;
  ctx.tok_ip = tok_ip;
  ctx.lit_skip = lit_skip;
  ctx.cuts = cuts;
  ctx.ns = ns;
  ctx.n = n;
  ctx.ts = ts;
  ctx.nseg = nseg;
  ctx.codec = codec;
  if (!spin_pool().run(fused_dec_slice, &ctx, nseg)) return kSplitReject;
  if (ctx.fail.load(std::memory_order_relaxed)) return kSplitReject;
  return n;
}

// Inverse body for a single-block frame: codec decode + unfilter straight
// into the caller's output (≙ decompressBackend blosc.go:393-426 minus
// header parsing, which stays in Python).  Returns n on success; negative
// codec error on malformed payload; the decoded count (>=0, != n) when
// the payload decodes cleanly to the wrong size (caller raises size
// mismatch, parity with blosc.go:429-431).
int64_t tpb_decompress_block_into(const uint8_t *frame, int64_t payload_off,
                                  int64_t psize, uint8_t *out, int64_t n,
                                  int ts, int shuffle_mode, int codec) {
  if (n <= 0) return -1;
  const uint8_t *payload = frame + payload_off;
  bool filtered = shuffle_mode != kNoShuffle && ts > 1 && n >= ts;
  uint8_t *dec = out;
  if (filtered) {
    dec = frame_scratch().get(n);
    if (!dec) return -2;
  }
  int64_t got = kSplitReject;
  // decode-side mirror of the segment-parallel encoder: same nseg policy,
  // engages only when the pre-scan proves the stream has our seam layout
  // NOTE (2026-08-19): extending this gate down to the fused small-frame
  // range (48 KiB, nseg=4) was measured a WASH on the LZ4 stage (4.6 vs
  // 4.7 us — 1 us chunks sit below the dispatch+scan floor) and the
  // pooled unfilter at that size was a clear LOSS (5.6 vs 3.5 us), so
  // small fused frames DECODE serially even though they encode fused.
  const int nseg = frame_segments(n, codec);
  if (nseg > 1) {
    if (codec == kCodecSnappy)
      got = snappy_decompress_parallel(payload, psize, dec, n, nseg);
    else if (codec == kCodecZstd)
      got = zstd_decompress_parallel(payload, psize, dec, n);
    else if (codec == kCodecBlosclz)
      got = blosclz_decompress_parallel(payload, psize, dec, n, nseg);
    else if (codec == kCodecZlib && filtered)
      // general inflate has no parallel form, but OUR pigz-layout streams
      // expose byte-aligned seams — scan, validate hard, fall back serial.
      // Gated on `filtered`: the encoder emits dictionary-FREE libdeflate
      // segments only for filtered payloads (level >= 4); noshuffle
      // frames always carry window-primed libz segments whose cross-seam
      // matches doom the raw per-piece inflate, so attempting them would
      // be deterministic wasted work on every decode
      got = zlib_decompress_parallel(payload, psize, dec, n, nseg,
                                     frame_scratch());
    else
      got = lz4_decompress_parallel(payload, psize, dec, n, nseg);
  } else if (filtered && shuffle_mode == kByteShuffle &&
             (ts == 2 || ts == 4) && n >= kFusedDecodeMin &&
             (codec == kCodecLz4 || codec == kCodecLz4Hc ||
              codec == kCodecBlosclz) &&
             // Snappy measured a clear LOSS here (0.58-0.79x, every
             // pattern/size): its clamped chunk decoder runs far below
             // the AVX2 serial decoder, and 4-way parallelism cannot
             // make that back at <256 KiB (2026-08-20 sweep)
             !std::getenv("TPU_BLOSC_NO_FUSED_DECODE") &&
             // batch slices run ON pool workers: the nested run() can
             // never engage, so don't pay the split scan (busy_hint)
             !spin_pool().busy_hint()) {
    // round 5: the fused small-frame DECODE mirror of the fused encoder
    // (one dispatch for chunk decode + unshuffle; see fused_dec_slice),
    // behind the adaptive window-tracking dispatcher (AdaptiveDecode).
    // Rejects (foreign seam layout, gated-out data class, busy pool)
    // fall through to the serial path below.
    static const bool pinned =
        std::getenv("TPU_BLOSC_NO_ADAPTIVE_DECODE") != nullptr;
    const int slot = pinned ? 1 : g_adaptive_decode.slot();
    const bool try_fused =
        slot == 1 || (slot == 2 && g_adaptive_decode.prefer_fused());
    if (try_fused) {
      const int64_t t0 = now_ns();
      got = fused_decode_unshuffle(payload, psize, dec, out, n, ts, codec);
      if (got == n) {
        if (!pinned)
          AdaptiveDecode::ewma(g_adaptive_decode.fused_npm,
                               (now_ns() - t0) * (1 << 20) / n);
        return n;  // out is already decoded AND unshuffled
      }
      got = kSplitReject;
    } else {
      const int64_t t0 = now_ns();
      got = codec_decompress(codec, payload, psize, dec, n);
      if (got == n) {
        filter_buffer_pool(dec, out, n, ts, shuffle_mode, true);
        AdaptiveDecode::ewma(g_adaptive_decode.serial_npm,
                             (now_ns() - t0) * (1 << 20) / n);
        return n;
      }
    }
  }
  if (got == kSplitReject)
    got = codec_decompress(codec, payload, psize, dec, n);
  if (got != n) return got;
  if (filtered) filter_buffer_pool(dec, out, n, ts, shuffle_mode, true);
  return n;
}

// Compact per-block slots into a contiguous destination (frame payload
// area) — parallel memcpy, the last copy of frame assembly.
// Returns 0 on success, -1 when the offsets scratch can't be allocated
// (caller must treat the destination as unwritten).
int64_t tpb_gather(const uint8_t *slots, const int64_t *sizes, int64_t nb,
                   int64_t slot_stride, uint8_t *dst) {
  int64_t *offs = (int64_t *)std::malloc((size_t)nb * sizeof(int64_t));
  if (!offs) return -1;
  int64_t acc = 0;
  for (int64_t i = 0; i < nb; i++) {
    offs[i] = acc;
    acc += sizes[i];
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nb; i++) {
    std::memcpy(dst + offs[i], slots + i * slot_stride, (size_t)sizes[i]);
  }
  std::free(offs);
  return 0;
}

// ---------------------------------------------------------------------------
// batch frame entry points — N independent single-block frames per crossing
//
// Per-frame parallelism has a hard floor on this host: below kFrameSegMin
// the 1-2 us intra-frame slices lose to random 5-9 us vCPU preemption
// stalls (see kFrameSegMin).  Whole frames are different: a 100 KB frame
// is a ~10 us unit of work, comfortably above the stall noise, so a batch
// of small frames scales across all lanes even though each frame alone
// would stay serial.  Frames BELOW kFrameSegMin therefore run as
// whole-frame SpinPool slices (at that size a nested pool use can never
// engage: frame_segments()==1 for encode, and the fused-decode branch
// skips itself via busy_hint() while a batch job is active — nested
// run() would fail its try_lock anyway); frames at/above it run
// on the calling thread through the normal segment-parallel path, outside
// the pool job.  Either way every frame takes exactly the code path the
// scalar entry points would take, so batch output bytes are IDENTICAL to
// per-frame calls at every size — batching changes scheduling, not bytes.
//
// The reference has no batch surface (its API is one frame per call,
// blosc.go:257-303); this is the host-side analogue of mapping the codec
// over a device mesh: same per-element semantics, executed data-parallel.

struct CompressBatchCtx {
  const uint8_t *const *srcs;
  const int64_t *ns;
  uint8_t *const *dsts;
  int64_t *results;
  const int64_t *idx;  // pool slice s -> frame index idx[s]
  int ts, shuffle, hdr_id, codec, depth;
};

static void compress_batch_slice(void *p, int s) {
  auto *c = (CompressBatchCtx *)p;
  const int64_t i = c->idx[s];
  c->results[i] = tpb_compress_frame(c->srcs[i], c->ns[i], c->ts, c->shuffle,
                                     c->hdr_id, c->codec, c->depth, c->dsts[i]);
}

struct DecompressBatchCtx {
  const uint8_t *const *frames;
  const int64_t *psizes;
  const int64_t *ns;
  const int32_t *tss;
  const int32_t *modes;
  const int32_t *codecs;
  uint8_t *const *outs;
  int64_t *results;
  const int64_t *idx;
};

static void decompress_batch_slice(void *p, int s) {
  auto *c = (DecompressBatchCtx *)p;
  const int64_t i = c->idx[s];
  c->results[i] =
      tpb_decompress_block_into(c->frames[i], 16, c->psizes[i], c->outs[i],
                                c->ns[i], (int)c->tss[i], (int)c->modes[i],
                                (int)c->codecs[i]);
}

// pool index space is 20 bits; run pooled slices in bounded windows
static const int64_t kBatchChunk = 1 << 19;

// Compress nf independent frames sharing one option set.  dsts[i] must
// have capacity >= 16 + tpb_compress_bound(ns[i], codec); results[i]
// receives the total frame size (negative on per-frame error).  idx_buf
// is caller-provided scratch of nf int64 (keeps this ABI allocation-free).
void tpb_compress_batch(const uint8_t *const *srcs, const int64_t *ns,
                        int64_t nf, int ts, int shuffle_mode,
                        int header_codec_id, int codec, int depth,
                        uint8_t *const *dsts, int64_t *results,
                        int64_t *idx_buf) {
  CompressBatchCtx c{srcs, ns,           dsts,            results, nullptr,
                     ts,   shuffle_mode, header_codec_id, codec,   depth};
  int64_t nsmall = 0;
  for (int64_t i = 0; i < nf; i++) {
    if (ns[i] >= kFrameSegMin)  // large: inline, segment-parallel internally
      results[i] = tpb_compress_frame(srcs[i], ns[i], ts, shuffle_mode,
                                      header_codec_id, codec, depth, dsts[i]);
    else
      idx_buf[nsmall++] = i;
  }
  for (int64_t base = 0; base < nsmall; base += kBatchChunk) {
    const int nrun = (int)std::min(kBatchChunk, nsmall - base);
    c.idx = idx_buf + base;
    if (!spin_pool().run(compress_batch_slice, &c, nrun))
      for (int s = 0; s < nrun; s++) compress_batch_slice(&c, s);
  }
}

// Decompress nf independent single-block frames (payload at offset 16).
// Per-frame header-derived params; results[i] = ns[i] on success, else
// the native status (caller maps to typed errors / refuses).
void tpb_decompress_batch(const uint8_t *const *frames, const int64_t *psizes,
                          const int64_t *ns, const int32_t *tss,
                          const int32_t *modes, const int32_t *codecs,
                          int64_t nf, uint8_t *const *outs, int64_t *results,
                          int64_t *idx_buf) {
  DecompressBatchCtx c{frames, psizes,  ns,     tss, modes,
                       codecs, outs,    results, nullptr};
  int64_t nsmall = 0;
  for (int64_t i = 0; i < nf; i++) {
    if (ns[i] >= kFrameSegMin)
      results[i] = tpb_decompress_block_into(frames[i], 16, psizes[i], outs[i],
                                             ns[i], (int)tss[i],
                                             (int)modes[i], (int)codecs[i]);
    else
      idx_buf[nsmall++] = i;
  }
  for (int64_t base = 0; base < nsmall; base += kBatchChunk) {
    const int nrun = (int)std::min(kBatchChunk, nsmall - base);
    c.idx = idx_buf + base;
    if (!spin_pool().run(decompress_batch_slice, &c, nrun))
      for (int s = 0; s < nrun; s++) decompress_batch_slice(&c, s);
  }
}

void tpb_set_num_threads(int n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
#endif
  if (n > 0) spin_pool().set_lanes(n);
}

int tpb_num_threads(void) {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
