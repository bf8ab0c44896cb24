// ThreadSanitizer driver for the native runtime (tpublosc.cpp).
//
// The honest analogue of the reference CI's `go test -race`
// (/root/reference/.github/workflows/ci.yml:36): the OpenMP block
// pipelines and the thread-local scratch reuse are the only places this
// framework has shared-memory concurrency, and ASan cannot see data
// races.  Running the whole Python test suite under an LD_PRELOADed TSan
// is impractical (instrumenting CPython+JAX takes tens of minutes), so
// this driver compiles the native source TOGETHER with the test code
// under -fsanitize=thread and exercises:
//   * tpb_compress_blocks / tpb_decompress_blocks (OpenMP teams)
//   * concurrent tpb_compress_frame / tpb_decompress_block_into from
//     std::threads (thread_local scratch isolation)
//   * concurrent one-shot codec entry points
//
// Build + run (CI "tsan" job):
//   g++ -O1 -g -fsanitize=thread -std=c++17 \
//       tests/native_tsan_driver.cpp tpu_blosc/native/tpublosc.cpp \
//       -o /tmp/tsan_driver -lz
//   /tmp/tsan_driver
//
// NOTE the build intentionally OMITS -fopenmp: GCC's libgomp synchronizes
// its barriers with raw futex syscalls that TSan cannot see, so every
// parallel region end reports false races against main's stack reuse
// (observed; clang's libomp has TSAN annotations but clang is not in this
// toolchain).  Without -fopenmp the pragmas compile to no-ops and the
// pipelines run sequentially — which matches what the reference's
// `go test -race` actually checks: its library is internally
// single-threaded too, and -race guards CONCURRENT CALLERS.  The
// std::thread scenarios below are exactly that surface (thread_local
// scratch isolation, shared epoch counters, zlib/zstd contexts).  The
// OpenMP pipelines' internal disjointness is covered by the ASan job and
// the block-slot roundtrip tests.
//
// Exits 0 on success; TSan aborts with a report on any race.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
int64_t tpb_compress_blocks(const uint8_t *src, int64_t n, int64_t block_size,
                            int ts, int shuffle_mode, int codec, int depth,
                            uint8_t *out, int64_t slot_stride,
                            int64_t *out_sizes, uint8_t *out_memcpy,
                            int num_threads);
int64_t tpb_decompress_blocks(const uint8_t *payloads, const int64_t *offsets,
                              const int64_t *sizes, const uint8_t *memcpy_f,
                              int64_t nb, int64_t block_size, int64_t total_n,
                              int ts, int shuffle_mode, int codec,
                              uint8_t *out, int num_threads);
int64_t tpb_compress_bound(int64_t block_size, int codec);
int64_t tpb_compress_frame(const uint8_t *src, int64_t n, int ts,
                           int shuffle_mode, int header_codec_id, int codec,
                           int depth, uint8_t *dst);
int64_t tpb_decompress_block_into(const uint8_t *frame, int64_t payload_off,
                                  int64_t psize, uint8_t *out, int64_t n,
                                  int ts, int shuffle_mode, int codec);
int64_t tpb_lz4_compress(const uint8_t *, int64_t, uint8_t *, int64_t, int);
int64_t tpb_lz4_decompress(const uint8_t *, int64_t, uint8_t *, int64_t);
int64_t tpb_snappy_compress(const uint8_t *, int64_t, uint8_t *, int64_t);
int64_t tpb_snappy_decompress(const uint8_t *, int64_t, uint8_t *, int64_t);
}

// codec ids must match tpublosc.cpp (kCodecLz4=1, HC=2, Snappy=3, Zlib=4,
// Zstd=5) and shuffle modes (0 none, 1 byte, 2 bit)
enum { BLOSCLZ = 0, LZ4 = 1, LZ4HC = 2, SNAPPY = 3, ZLIB = 4, ZSTD = 5 };

static void fill_pattern(std::vector<uint8_t> &v, int kind) {
  uint32_t x = 0x9E3779B9u;
  for (size_t i = 0; i < v.size(); i++) {
    switch (kind) {
      case 0: v[i] = (uint8_t)(i & 0xFF); break;               // ramp
      case 1: v[i] = (uint8_t)((i / 64) & 0xFF); break;        // runs
      case 2:                                                   // noise
        x = x * 1664525u + 1013904223u;
        v[i] = (uint8_t)(x >> 24);
        break;
      default: v[i] = (uint8_t)((i % 96) * 7); break;          // period 96
    }
  }
}

#define CHECK(cond)                                                     \
  do {                                                                  \
    if (!(cond)) {                                                      \
      std::fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__,     \
                   __LINE__, #cond);                                    \
      std::exit(1);                                                     \
    }                                                                   \
  } while (0)

static void pipeline_roundtrip(int kind, int codec, int shuffle_mode,
                               int depth) {
  const int64_t n = 3 * 262144 + 12345;  // ragged tail block
  const int64_t bs = 262144;
  const int64_t nb = (n + bs - 1) / bs;
  std::vector<uint8_t> src(n);
  fill_pattern(src, kind);
  const int64_t stride = tpb_compress_bound(bs, codec);
  std::vector<uint8_t> slots(nb * stride);
  std::vector<int64_t> sizes(nb);
  std::vector<uint8_t> memf(nb);
  int64_t rc = tpb_compress_blocks(src.data(), n, bs, 4, shuffle_mode, codec,
                                   depth, slots.data(), stride, sizes.data(),
                                   memf.data(), 4);
  CHECK(rc == 0);
  // compact payloads the way chunk.py does
  std::vector<uint8_t> joined;
  std::vector<int64_t> offs(nb);
  for (int64_t i = 0; i < nb; i++) {
    offs[i] = (int64_t)joined.size();
    joined.insert(joined.end(), slots.begin() + i * stride,
                  slots.begin() + i * stride + sizes[i]);
  }
  std::vector<uint8_t> out(n);
  rc = tpb_decompress_blocks(joined.data(), offs.data(), sizes.data(),
                             memf.data(), nb, bs, n, 4, shuffle_mode, codec,
                             out.data(), 4);
  CHECK(rc == n);
  CHECK(std::memcmp(src.data(), out.data(), n) == 0);
}

static void concurrent_frames() {
  // 8 threads hammer the single-shot frame path (thread_local scratch);
  // odd threads use >=512 KiB frames so the segment-parallel encoder's
  // OMP region runs concurrently from several caller threads
  std::vector<std::thread> ts;
  for (int t = 0; t < 8; t++) {
    ts.emplace_back([t]() {
      const int64_t n = (t & 1) ? (512 << 10) + t * 1337 : 100000 + t * 1337;
      // rotate LZ4 / BloscLZ / ZLIB: the even-t 100 KB zlib frames cover
      // the 48-255 KiB segment window (the round-4 dictionary-clamp
      // class) and the odd-t >=512 KiB ones the parallel seam inflate
      const int codec = (t % 4 == 2) ? BLOSCLZ : (t % 4 == 3) ? ZLIB : LZ4;
      const int depth = codec == ZLIB ? 5 : 1;
      std::vector<uint8_t> src(n);
      fill_pattern(src, t % 4);
      std::vector<uint8_t> frame(16 + tpb_compress_bound(n, codec));
      std::vector<uint8_t> out(n);
      for (int r = 0; r < 20; r++) {
        int64_t fsz = tpb_compress_frame(src.data(), n, 4, 1, codec, codec,
                                         depth, frame.data());
        CHECK(fsz > 16);
        if (frame[2] & 0x2) {  // memcpy frame: payload IS the data
          CHECK(fsz == 16 + n);
          std::memcpy(out.data(), frame.data() + 16, n);
        } else {
          int shuffle = (frame[2] & 0x1) ? 1 : 0;
          int64_t rc = tpb_decompress_block_into(
              frame.data(), 16, fsz - 16, out.data(), n, 4, shuffle, codec);
          CHECK(rc == n);
        }
        CHECK(std::memcmp(src.data(), out.data(), n) == 0);
      }
    });
  }
  for (auto &th : ts) th.join();
}

extern "C" void tpb_compress_batch(const uint8_t *const *srcs,
                                   const int64_t *ns, int64_t nf, int ts,
                                   int shuffle_mode, int header_codec_id,
                                   int codec, int depth,
                                   uint8_t *const *dsts, int64_t *results,
                                   int64_t *idx_buf);
extern "C" void tpb_decompress_batch(const uint8_t *const *frames,
                                     const int64_t *psizes, const int64_t *ns,
                                     const int32_t *tss, const int32_t *modes,
                                     const int32_t *codecs, int64_t nf,
                                     uint8_t *const *outs, int64_t *results,
                                     int64_t *idx_buf);

static void concurrent_batches() {
  // Two threads drive whole batches at once (the pool's try_lock makes
  // the loser run serially) while a third hammers scalar frames: the
  // batch slice functions run tpb_compress_frame on pool workers, so
  // this checks worker-side scratch isolation and the cursor publication
  // under contention.  Mixed sizes cross the kFrameSegMin split.
  auto batch_work = [](int seed) {
    const int nf = 12;
    std::vector<std::vector<uint8_t>> srcs(nf);
    std::vector<const uint8_t *> sp(nf);
    std::vector<int64_t> ns(nf), results(nf), idx(nf), psz(nf), dn(nf);
    std::vector<std::vector<uint8_t>> dsts(nf), outs(nf);
    std::vector<uint8_t *> dp(nf), op(nf);
    std::vector<const uint8_t *> fp(nf);
    std::vector<int32_t> tss(nf), modes(nf), codecs(nf);
    for (int i = 0; i < nf; i++) {
      int64_t n = (i % 3 == 0) ? (300 << 10) + i * 977 : 40000 + i * 1337;
      srcs[i].resize(n);
      fill_pattern(srcs[i], (seed + i) % 4);
      sp[i] = srcs[i].data();
      ns[i] = n;
      dsts[i].resize(16 + tpb_compress_bound(n, LZ4));
      dp[i] = dsts[i].data();
      outs[i].resize(n);
      op[i] = outs[i].data();
    }
    for (int r = 0; r < 10; r++) {
      tpb_compress_batch(sp.data(), ns.data(), nf, 4, 1, LZ4, LZ4, 1,
                         dp.data(), results.data(), idx.data());
      int nk = 0;  // compact out memcpy frames (batch decode is codec-only)
      std::vector<int> keep;
      for (int i = 0; i < nf; i++) {
        CHECK(results[i] > 16);
        if (dsts[i][2] & 0x2) continue;
        fp[nk] = dsts[i].data();
        psz[nk] = results[i] - 16;
        dn[nk] = ns[i];
        tss[nk] = 4;
        modes[nk] = (dsts[i][2] & 0x1) ? 1 : 0;
        codecs[nk] = LZ4;
        op[nk] = outs[i].data();
        keep.push_back(i);
        nk++;
      }
      tpb_decompress_batch(fp.data(), psz.data(), dn.data(), tss.data(),
                           modes.data(), codecs.data(), nk, op.data(),
                           results.data(), idx.data());
      for (int k = 0; k < nk; k++) {
        const int i = keep[k];
        CHECK(results[k] == ns[i]);
        CHECK(std::memcmp(srcs[i].data(), outs[i].data(), ns[i]) == 0);
      }
    }
  };
  std::thread a([&] { batch_work(0); });
  std::thread b([&] { batch_work(2); });
  std::thread c([] {
    const int64_t n = 120000;
    std::vector<uint8_t> src(n);
    fill_pattern(src, 1);
    std::vector<uint8_t> frame(16 + tpb_compress_bound(n, LZ4)), out(n);
    for (int r = 0; r < 30; r++) {
      int64_t fsz =
          tpb_compress_frame(src.data(), n, 4, 1, LZ4, LZ4, 1, frame.data());
      CHECK(fsz > 16);
      if (!(frame[2] & 0x2)) {
        CHECK(tpb_decompress_block_into(frame.data(), 16, fsz - 16,
                                        out.data(), n, 4,
                                        (frame[2] & 0x1) ? 1 : 0, LZ4) == n);
        CHECK(std::memcmp(src.data(), out.data(), n) == 0);
      }
    }
  });
  a.join();
  b.join();
  c.join();
}

static void concurrent_codecs() {
  std::vector<std::thread> ts;
  for (int t = 0; t < 6; t++) {
    ts.emplace_back([t]() {
      const int64_t n = 65536;
      std::vector<uint8_t> src(n);
      fill_pattern(src, t % 4);
      // snappy worst case is n + n/6 + header; be generous for both codecs
      std::vector<uint8_t> dst(n + n / 4 + 1024), back(n);
      for (int r = 0; r < 30; r++) {
        int64_t c = (t & 1)
                        ? tpb_snappy_compress(src.data(), n, dst.data(),
                                              (int64_t)dst.size())
                        : tpb_lz4_compress(src.data(), n, dst.data(),
                                           (int64_t)dst.size(), 1 + (r & 7));
        CHECK(c > 0);
        int64_t d = (t & 1)
                        ? tpb_snappy_decompress(dst.data(), c, back.data(), n)
                        : tpb_lz4_decompress(dst.data(), c, back.data(), n);
        CHECK(d == n);
        CHECK(std::memcmp(src.data(), back.data(), n) == 0);
      }
    });
  }
  for (auto &th : ts) th.join();
}

int main() {
  // OpenMP pipelines across codecs / filters / data kinds
  for (int kind = 0; kind < 4; kind++) {
    pipeline_roundtrip(kind, LZ4, 1, 1);
    pipeline_roundtrip(kind, LZ4HC, 1, 16);
    pipeline_roundtrip(kind, SNAPPY, 2, 0);
    pipeline_roundtrip(kind, ZSTD, 1, 3);
    pipeline_roundtrip(kind, ZLIB, 0, 5);
    pipeline_roundtrip(kind, BLOSCLZ, 1, 1);
  }
  // two OpenMP pipelines from two std::threads at once (nested teams)
  {
    std::thread a([] { pipeline_roundtrip(0, LZ4, 1, 1); });
    std::thread b([] { pipeline_roundtrip(2, LZ4, 2, 1); });
    a.join();
    b.join();
  }
  concurrent_frames();
  concurrent_batches();
  concurrent_codecs();
  std::puts("tsan driver: all roundtrips ok");
  return 0;
}
