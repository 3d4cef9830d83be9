// Native host runtime of the port (host C++, not a kernel): the packed
// FASTQ reader and the index build's k-mer helpers.
//
// The reader turns a gzip, BGZF or plain FASTQ file into batches already in
// the card's upload format: 2-bit packed base codes, an N-position bitmask
// and the read lengths, padded to a length that is a multiple of pad_to
// (reference: the kseq + zlib readers it replaces, src/kseq.h,
// src/ProcessReads.cpp:3128-3267).
//
// One pipeline per open file:
//   source -> chunk queue -> parse/pack thread -> batch queue -> ktio_next
//   * BGZF files (gzip members whose extra field carries the BC subfield
//     with the block size) are inflated block-parallel: an I/O thread walks
//     the block headers, n_threads - 1 workers inflate blocks at once, and
//     an emit thread puts them back in file order.
//   * Plain gzip (or uncompressed text) is read on one thread by zlib.
//   The parse/pack thread splits lines, checks each record's header and
//   separator, and packs bases to 2 bits (AVX2 where the build has it, else
//   the scalar loop); up to kQueueDepth batches are prefetched.
//
// Layout (io/fastx.py PackedBatch, the Python reader's pack_codes_host):
//   packed[i][j>>2] bits (2*(j&3), 2*(j&3)+1) = base code {A=0,C=1,G=2,T=3}
//   positions with non-ACGT bases or j >= len read as code 0 in packed and
//   have bit j set in nmask (little bit order within each byte)
//   Lp = round_up(max(max_len, min_len), pad_to)
// Every batch holds batch_reads reads but the last.  A record whose header
// does not start with '@' (after non-alphanumeric junk) or whose third line
// does not start with '+' ends the stream with an error (ktio_next -2).
//
// The build helpers (ktio_u64_lookup, ktio_kmer_scan, ktio_revcomp) split
// their input into n_threads contiguous ranges.
//
// Built with g++ -O3 -shared -fPIC at first use (io/native.py), linked
// with zlib and, where the build defines KTIO_LIBDEFLATE, libdeflate for
// the BGZF blocks; called through ctypes; plain C interface.

#include <zlib.h>

#ifdef KTIO_LIBDEFLATE
#include <libdeflate.h>
#endif

#ifdef __AVX2__
#include <immintrin.h>
#endif

#include <algorithm>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr size_t kChunk = 1 << 22;    // decompressed bytes per gzread
constexpr int kQueueDepth = 3;        // packed batches prefetched ahead
constexpr int kChunkQueueDepth = 64;  // decompressed chunks buffered ahead
constexpr int kJobQueueDepth = 128;   // compressed BGZF blocks in flight

struct Batch {
  std::vector<uint8_t> packed;    // [n][Lp/4]
  std::vector<uint8_t> nmask;     // [n][Lp/8]
  std::vector<int32_t> lens;      // [n]
  std::vector<uint8_t> names;     // concatenated name bytes (keep_names)
  std::vector<int32_t> name_off;  // [n+1] offsets into names
  int32_t n = 0;
  int32_t Lp = 0;
};

// ---------------------------------------------------------------------------
// Ordered chunk queue: decompressed byte chunks flowing to the parser.

struct ChunkQueue {
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<std::vector<uint8_t>> q;
  bool done = false;
  bool stop = false;
  std::string error;

  void put(std::vector<uint8_t>&& c) {
    std::unique_lock<std::mutex> lk(mu);
    cv_put.wait(lk, [this] { return stop || (int)q.size() < kChunkQueueDepth; });
    if (stop) return;
    q.push_back(std::move(c));
    cv_get.notify_one();
  }
  // false = end of stream (clean, or an error in `error`)
  bool get(std::vector<uint8_t>& out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_get.wait(lk, [this] { return done || stop || !q.empty(); });
    if (q.empty()) return false;
    out = std::move(q.front());
    q.pop_front();
    cv_put.notify_one();
    return true;
  }
  void finish(const std::string& err = "") {
    std::lock_guard<std::mutex> lk(mu);
    if (!err.empty() && error.empty()) error = err;
    done = true;
    cv_get.notify_all();
  }
  void shutdown() {
    std::lock_guard<std::mutex> lk(mu);
    stop = true;
    cv_put.notify_all();
    cv_get.notify_all();
  }
};

// ---------------------------------------------------------------------------
// BGZF block-parallel source.

struct BgzfJob {
  uint64_t seq = 0;
  std::vector<uint8_t> comp;  // raw deflate payload
  uint32_t isize = 0;         // uncompressed size from the gzip trailer
};

struct BgzfSource {
  FILE* f = nullptr;
  int n_workers = 2;
  ChunkQueue* out = nullptr;

  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<std::unique_ptr<BgzfJob>> jobs;
  bool io_done = false;
  bool stop = false;
  std::string error;

  // reorder buffer: seq -> inflated chunk
  std::mutex rmu;
  std::condition_variable rcv;
  std::map<uint64_t, std::vector<uint8_t>> ready;
  uint64_t next_emit = 0;
  int live_workers = 0;

  std::thread io_th;
  std::vector<std::thread> workers;
  std::thread emit_th;

  ~BgzfSource() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_put.notify_all();
    cv_get.notify_all();
    {
      std::lock_guard<std::mutex> lk(rmu);
      rcv.notify_all();
    }
    if (io_th.joinable()) io_th.join();
    for (auto& w : workers)
      if (w.joinable()) w.join();
    if (emit_th.joinable()) emit_th.join();
    if (f) fclose(f);
  }
};

// Parse one BGZF block header at the file position: the total block size
// (0 at EOF, -1 on a format error).
int read_bgzf_header(FILE* f, int* xlen_out, int* bsize_out) {
  uint8_t hdr[12];
  size_t got = fread(hdr, 1, 12, f);
  if (got == 0) return 0;
  if (got != 12 || hdr[0] != 0x1f || hdr[1] != 0x8b || hdr[2] != 8 ||
      !(hdr[3] & 4))
    return -1;
  int xlen = hdr[10] | (hdr[11] << 8);
  int bsize = -1;
  std::vector<uint8_t> extra(xlen);
  if ((int)fread(extra.data(), 1, xlen, f) != xlen) return -1;
  for (int i = 0; i + 4 <= xlen;) {
    int slen = extra[i + 2] | (extra[i + 3] << 8);
    if (extra[i] == 'B' && extra[i + 1] == 'C' && slen == 2 && i + 6 <= xlen)
      bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
    i += 4 + slen;
  }
  *xlen_out = xlen;
  *bsize_out = bsize;
  return bsize > 0 ? bsize : -1;
}

void bgzf_io_loop(BgzfSource* s) {
  uint64_t seq = 0;
  std::string err;
  while (true) {
    int xlen = 0, bsize = 0;
    int rc = read_bgzf_header(s->f, &xlen, &bsize);
    if (rc == 0) break;
    if (rc < 0) {
      err = "bgzf: malformed block header";
      break;
    }
    int payload = bsize - 12 - xlen - 8;
    if (payload < 0) {
      err = "bgzf: bad BSIZE";
      break;
    }
    auto job = std::make_unique<BgzfJob>();
    job->seq = seq++;
    job->comp.resize(payload);
    uint8_t trailer[8];
    if ((int)fread(job->comp.data(), 1, payload, s->f) != payload ||
        fread(trailer, 1, 8, s->f) != 8) {
      err = "bgzf: truncated block";
      break;
    }
    job->isize = (uint32_t)trailer[4] | ((uint32_t)trailer[5] << 8) |
                 ((uint32_t)trailer[6] << 16) | ((uint32_t)trailer[7] << 24);
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_put.wait(lk, [s] {
      return s->stop || (int)s->jobs.size() < kJobQueueDepth;
    });
    if (s->stop) return;
    s->jobs.push_back(std::move(job));
    s->cv_get.notify_one();
  }
  std::lock_guard<std::mutex> lk(s->mu);
  s->io_done = true;
  if (!err.empty()) s->error = err;
  s->cv_get.notify_all();
}

void bgzf_worker_loop(BgzfSource* s) {
#ifdef KTIO_LIBDEFLATE
  // a BGZF block is one whole deflate stream: libdeflate's whole-buffer
  // inflate applies directly (one decompressor per worker)
  struct libdeflate_decompressor* ld = libdeflate_alloc_decompressor();
#endif
  while (true) {
    std::unique_ptr<BgzfJob> job;
    {
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv_get.wait(lk, [s] {
        return s->stop || s->io_done || !s->jobs.empty();
      });
      if (s->stop || s->jobs.empty()) break;  // stopped, or read and drained
      job = std::move(s->jobs.front());
      s->jobs.pop_front();
      s->cv_put.notify_one();
    }
    std::vector<uint8_t> outbuf(job->isize);
    if (job->isize > 0) {
      bool ok;
#ifdef KTIO_LIBDEFLATE
      ok = libdeflate_deflate_decompress(
               ld, job->comp.data(), job->comp.size(), outbuf.data(),
               outbuf.size(), nullptr) == LIBDEFLATE_SUCCESS;
#else
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      inflateInit2(&zs, -15);
      zs.next_in = job->comp.data();
      zs.avail_in = (uInt)job->comp.size();
      zs.next_out = outbuf.data();
      zs.avail_out = (uInt)outbuf.size();
      int rc = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      ok = rc == Z_STREAM_END;
#endif
      if (!ok) {
        std::lock_guard<std::mutex> lk(s->mu);
        if (s->error.empty()) s->error = "bgzf: inflate failed";
        outbuf.clear();
      }
    }
    std::lock_guard<std::mutex> lk(s->rmu);
    s->ready.emplace(job->seq, std::move(outbuf));
    s->rcv.notify_all();
  }
#ifdef KTIO_LIBDEFLATE
  libdeflate_free_decompressor(ld);
#endif
  std::lock_guard<std::mutex> lk(s->rmu);
  s->live_workers--;
  s->rcv.notify_all();
}

void bgzf_emit_loop(BgzfSource* s) {
  while (true) {
    std::vector<uint8_t> chunk;
    {
      std::unique_lock<std::mutex> lk(s->rmu);
      s->rcv.wait(lk, [s] {
        return s->stop || s->ready.count(s->next_emit) ||
               (s->live_workers == 0 && s->ready.empty());
      });
      if (s->stop) return;
      auto it = s->ready.find(s->next_emit);
      if (it == s->ready.end()) break;  // every worker done, nothing left
      chunk = std::move(it->second);
      s->ready.erase(it);
      s->next_emit++;
    }
    if (!chunk.empty()) s->out->put(std::move(chunk));
  }
  std::string err;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    err = s->error;
  }
  s->out->finish(err);
}

// ---------------------------------------------------------------------------
// Plain-gzip (or uncompressed) serial source.

struct GzSource {
  gzFile f = nullptr;
  ChunkQueue* out = nullptr;
  std::thread th;
  bool stop = false;

  ~GzSource() {
    stop = true;
    out->shutdown();
    if (th.joinable()) th.join();
    if (f) gzclose(f);
  }
};

void gz_loop(GzSource* s) {
  while (!s->stop) {
    std::vector<uint8_t> chunk(kChunk);
    int got = gzread(s->f, chunk.data(), kChunk);
    if (got < 0) {
      int errnum = 0;
      s->out->finish(std::string("gzread: ") + gzerror(s->f, &errnum));
      return;
    }
    if (got == 0) {
      s->out->finish();
      return;
    }
    chunk.resize(got);
    s->out->put(std::move(chunk));
  }
}

// ---------------------------------------------------------------------------
// Reader: chunk queue -> parse/pack thread -> batch queue.

struct Reader {
  int batch_reads;
  int pad_to;
  int min_len;
  bool keep_names;

  ChunkQueue chunks;
  std::unique_ptr<BgzfSource> bgzf;
  std::unique_ptr<GzSource> gz;

  std::thread th;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::deque<std::unique_ptr<Batch>> queue;
  bool done = false;
  bool stop = false;
  std::string error;
  bool format_error = false;

  std::unique_ptr<Batch> current;

  // parse state
  std::vector<uint8_t> buf;
  size_t buf_pos = 0;
  int phase = 0;  // 0 header, 1 seq, 2 separator, 3 quality
  int64_t records = 0;  // headers read so far
  bool src_eof = false;

  ~Reader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    chunks.shutdown();
    cv_produce.notify_all();
    if (th.joinable()) th.join();
    bgzf.reset();
    gz.reset();
  }
};

const uint8_t* code_table() {
  static const struct Table {
    uint8_t t[256];
    Table() {
      memset(t, 4, sizeof(t));
      t[(int)'A'] = t[(int)'a'] = 0;
      t[(int)'C'] = t[(int)'c'] = 1;
      t[(int)'G'] = t[(int)'g'] = 2;
      t[(int)'T'] = t[(int)'t'] = 3;
    }
  } table;
  return table.t;
}

// Refill r->buf from the chunk queue; false at the end of the stream.
bool refill(Reader* r) {
  if (r->src_eof) return false;
  if (r->buf_pos > 0) {
    r->buf.erase(r->buf.begin(), r->buf.begin() + r->buf_pos);
    r->buf_pos = 0;
  }
  std::vector<uint8_t> chunk;
  if (!r->chunks.get(chunk)) {
    r->src_eof = true;
    if (!r->chunks.error.empty()) r->error = r->chunks.error;
    return false;
  }
  r->buf.insert(r->buf.end(), chunk.begin(), chunk.end());
  return true;
}

// A header line starts with '@', after junk that holds no letter or digit
// (the Python reader's rule, io/fastx.py FastqStream.next_batch).
bool good_header(const uint8_t* s, size_t n) {
  for (size_t i = 0; i < n; i++) {
    if (s[i] == '@') return true;
    if (isalnum(s[i])) return false;
  }
  return false;
}

// Parse up to batch_reads records from the chunk stream and pack them;
// nullptr at the end of the stream or on an error (r->error set).
std::unique_ptr<Batch> parse_batch(Reader* r) {
  std::vector<std::pair<size_t, int32_t>> seqs;  // (offset into seqbuf, len)
  std::vector<uint8_t> seqbuf;
  std::vector<uint8_t> names;
  std::vector<int32_t> name_off{0};
  seqbuf.reserve((size_t)r->batch_reads * 128);
  seqs.reserve(r->batch_reads);
  int& phase = r->phase;
  int32_t max_len = 0;

  while ((int)seqs.size() < r->batch_reads) {
    const uint8_t* base = r->buf.data();
    const uint8_t* nl = (const uint8_t*)memchr(
        base + r->buf_pos, '\n', r->buf.size() - r->buf_pos);
    if (nl == nullptr) {
      if (!refill(r)) {
        // the end: a last sequence line without a newline still counts
        size_t old = r->buf.size() - r->buf_pos;
        if (old > 0 && phase == 1) {
          const uint8_t* s0 = r->buf.data() + r->buf_pos;
          size_t len = old;
          if (s0[len - 1] == '\r') len--;
          seqs.emplace_back(seqbuf.size(), (int32_t)len);
          seqbuf.insert(seqbuf.end(), s0, s0 + len);
          max_len = std::max(max_len, (int32_t)len);
          phase = 2;
        }
        r->buf.clear();
        r->buf_pos = 0;
        break;
      }
      continue;
    }
    size_t line_start = r->buf_pos;
    size_t line_len = nl - base - line_start;
    r->buf_pos = (nl - base) + 1;
    if (line_len > 0 && base[line_start + line_len - 1] == '\r') line_len--;
    const uint8_t* line = base + line_start;

    if (phase == 0) {
      if (line_len == 0) continue;  // blank lines between records
      if (!good_header(line, line_len)) {
        r->error = "record ~" + std::to_string(r->records) +
                   ": bad header line";
        r->format_error = true;
        return nullptr;
      }
      r->records++;
      if (r->keep_names) {
        size_t c = 1;
        while (c < line_len && line[c] != ' ' && line[c] != '\t') c++;
        names.insert(names.end(), line + 1, line + std::max<size_t>(c, 1));
        name_off.push_back((int32_t)names.size());
      }
      phase = 1;
    } else if (phase == 1) {
      seqs.emplace_back(seqbuf.size(), (int32_t)line_len);
      seqbuf.insert(seqbuf.end(), line, line + line_len);
      max_len = std::max(max_len, (int32_t)line_len);
      phase = 2;
    } else if (phase == 2) {
      if (line_len == 0 || line[0] != '+') {
        r->error = "record ~" + std::to_string(r->records - 1) +
                   ": bad separator line";
        r->format_error = true;
        return nullptr;
      }
      phase = 3;
    } else {
      phase = 0;
    }
  }

  if (seqs.empty()) return nullptr;

  auto b = std::make_unique<Batch>();
  b->n = (int32_t)seqs.size();
  int32_t Lp = std::max(max_len, (int32_t)r->min_len);
  Lp = (Lp + r->pad_to - 1) / r->pad_to * r->pad_to;
  b->Lp = Lp;
  const int32_t pb = Lp / 4, nb = Lp / 8;
  b->packed.assign((size_t)b->n * pb, 0);
  b->nmask.assign((size_t)b->n * nb, 0);
  b->lens.resize(b->n);
  const uint8_t* ct = code_table();
#ifdef __AVX2__
  // 32 bases an iteration: codes from a low-nibble shuffle table (A->0
  // C->1 G->2 T->3; upper and lower case share low nibbles), validity from
  // an exact compare against the four lower-cased letters, 2-bit packing
  // as two multiply-add reductions
  const __m256i nib_lut = _mm256_setr_epi8(
      0, 0 /*A*/, 0, 1 /*C*/, 3, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0,
      0, 0, 0, 1, 3, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0);
  const __m256i lower = _mm256_set1_epi8(0x20);
  const __m256i ca = _mm256_set1_epi8('a');
  const __m256i cc = _mm256_set1_epi8('c');
  const __m256i cg = _mm256_set1_epi8('g');
  const __m256i ctt = _mm256_set1_epi8('t');
  const __m256i nibmask = _mm256_set1_epi8(0x0F);
  const __m256i w14 = _mm256_set1_epi16(0x0401);
  const __m256i w116 = _mm256_set1_epi32(0x00100001);
#endif
  for (int32_t i = 0; i < b->n; i++) {
    const uint8_t* s = seqbuf.data() + seqs[i].first;
    const int32_t len = seqs[i].second;
    b->lens[i] = len;
    uint8_t* pk = b->packed.data() + (size_t)i * pb;
    uint8_t* nm = b->nmask.data() + (size_t)i * nb;
    int32_t j = 0;
#ifdef __AVX2__
    for (; j + 32 <= len; j += 32) {
      __m256i v = _mm256_loadu_si256((const __m256i*)(s + j));
      __m256i lo = _mm256_or_si256(v, lower);
      __m256i ok = _mm256_or_si256(
          _mm256_or_si256(_mm256_cmpeq_epi8(lo, ca), _mm256_cmpeq_epi8(lo, cc)),
          _mm256_or_si256(_mm256_cmpeq_epi8(lo, cg), _mm256_cmpeq_epi8(lo, ctt)));
      __m256i code = _mm256_shuffle_epi8(nib_lut, _mm256_and_si256(v, nibmask));
      code = _mm256_and_si256(code, ok);
      __m256i p16 = _mm256_maddubs_epi16(code, w14);
      __m256i p32 = _mm256_madd_epi16(p16, w116);
      __m128i lo128 = _mm256_castsi256_si128(p32);
      __m128i hi128 = _mm256_extracti128_si256(p32, 1);
      __m128i b16 = _mm_packus_epi32(lo128, hi128);
      __m128i b8 = _mm_packus_epi16(b16, b16);
      uint64_t packed8 = (uint64_t)_mm_cvtsi128_si64(b8);
      memcpy(pk + (j >> 2), &packed8, 8);
      uint32_t bad = ~(uint32_t)_mm256_movemask_epi8(ok);
      memcpy(nm + (j >> 3), &bad, 4);
    }
#endif
    for (; j < len; j++) {
      uint8_t c = ct[s[j]];
      if (c == 4) {
        nm[j >> 3] |= (uint8_t)(1u << (j & 7));
      } else {
        pk[j >> 2] |= (uint8_t)(c << ((j & 3) * 2));
      }
    }
    for (int32_t j2 = len; j2 < Lp; j2++)
      nm[j2 >> 3] |= (uint8_t)(1u << (j2 & 7));
  }
  if (r->keep_names) {
    b->names = std::move(names);
    b->name_off = std::move(name_off);
  }
  return b;
}

void producer_loop(Reader* r) {
  while (true) {
    auto b = parse_batch(r);
    std::unique_lock<std::mutex> lk(r->mu);
    if (b == nullptr) {
      r->done = true;
      r->cv_consume.notify_all();
      return;
    }
    r->cv_produce.wait(lk, [r] {
      return r->stop || (int)r->queue.size() < kQueueDepth;
    });
    if (r->stop) return;
    r->queue.push_back(std::move(b));
    r->cv_consume.notify_all();
  }
}

// BGZF iff the file starts with a gzip header whose extra field holds BC.
bool is_bgzf(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  int xlen = 0, bsize = 0;
  int rc = read_bgzf_header(f, &xlen, &bsize);
  fclose(f);
  return rc > 0;
}

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

inline uint64_t revcomp_u64(uint64_t x, int k) {
  x = ~x;
  x = ((x & 0x3333333333333333ULL) << 2) | ((x >> 2) & 0x3333333333333333ULL);
  x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
  x = ((x & 0x00FF00FF00FF00FFULL) << 8) | ((x >> 8) & 0x00FF00FF00FF00FFULL);
  x = ((x & 0x0000FFFF0000FFFFULL) << 16) |
      ((x >> 16) & 0x0000FFFF0000FFFFULL);
  x = (x << 32) | (x >> 32);
  return x >> (64 - 2 * k);
}

// Run work(lo, hi) over [0, n) on n_threads contiguous ranges.
template <class F>
void parallel_ranges(int64_t n, int n_threads, F work) {
  int T = (int)std::max<int64_t>(1, std::min<int64_t>(n_threads, n));
  if (T == 1) {
    work((int64_t)0, n);
    return;
  }
  std::vector<std::thread> ths;
  int64_t per = (n + T - 1) / T;
  for (int t = 0; t < T; t++) {
    int64_t lo = t * per, hi = std::min<int64_t>(n, lo + per);
    if (lo < hi) ths.emplace_back(work, lo, hi);
  }
  for (auto& th : ths) th.join();
}

}  // namespace

extern "C" {

int ktio_abi_version() { return 1; }

// A reader over one file; nullptr when the file cannot be opened.
void* ktio_open(const char* path, int batch_reads, int pad_to, int min_len,
                int keep_names, int n_threads) {
  auto* r = new Reader();
  r->batch_reads = std::max(1, batch_reads);
  r->pad_to = pad_to > 0 ? pad_to : 8;
  r->min_len = min_len;
  r->keep_names = keep_names != 0;

  if (n_threads > 1 && is_bgzf(path)) {
    auto s = std::make_unique<BgzfSource>();
    s->f = fopen(path, "rb");
    if (!s->f) {
      delete r;
      return nullptr;
    }
    setvbuf(s->f, nullptr, _IOFBF, 1 << 20);
    s->n_workers = std::max(1, n_threads - 1);
    s->out = &r->chunks;
    s->live_workers = s->n_workers;
    s->io_th = std::thread(bgzf_io_loop, s.get());
    for (int i = 0; i < s->n_workers; i++)
      s->workers.emplace_back(bgzf_worker_loop, s.get());
    s->emit_th = std::thread(bgzf_emit_loop, s.get());
    r->bgzf = std::move(s);
  } else {
    auto s = std::make_unique<GzSource>();
    s->f = gzopen(path, "rb");
    if (!s->f) {
      delete r;
      return nullptr;
    }
    gzbuffer(s->f, 1 << 20);
    s->out = &r->chunks;
    s->th = std::thread(gz_loop, s.get());
    r->gz = std::move(s);
  }
  r->th = std::thread(producer_loop, r);
  return r;
}

// 1 with the pointers set, 0 at the end, -1 on an I/O error, -2 on a
// malformed record (ktio_error says which).  The pointers stay valid until
// the next ktio_next or ktio_close on the same handle.
int ktio_next(void* h, const uint8_t** packed, const uint8_t** nmask,
              const int32_t** lens, const uint8_t** names,
              const int32_t** name_off, int32_t* n, int32_t* Lp) {
  auto* r = (Reader*)h;
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_consume.wait(lk, [r] { return r->done || !r->queue.empty(); });
  if (r->queue.empty()) {
    if (r->error.empty()) return 0;
    return r->format_error ? -2 : -1;
  }
  r->current = std::move(r->queue.front());
  r->queue.pop_front();
  lk.unlock();
  r->cv_produce.notify_all();
  Batch* b = r->current.get();
  *packed = b->packed.data();
  *nmask = b->nmask.data();
  *lens = b->lens.data();
  *names = b->names.data();
  *name_off = b->name_off.data();
  *n = b->n;
  *Lp = b->Lp;
  return 1;
}

const char* ktio_error(void* h) { return ((Reader*)h)->error.c_str(); }

void ktio_close(void* h) { delete (Reader*)h; }

// Hashed membership for the index build: splitmix64 mix -> direct-address
// bucket (top p bits) -> binary search in the sorted mixed keys.
// keys_mixed [n] sorted, bucket_start [2^p + 1]; out_idx = the position in
// keys_mixed, n on a miss; out_hit 1/0.
void ktio_u64_lookup(const uint64_t* keys_mixed, int64_t n,
                     const int64_t* bucket_start, int p, const uint64_t* q,
                     int64_t m, int64_t* out_idx, uint8_t* out_hit,
                     int n_threads) {
  parallel_ranges(m, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      uint64_t mq = mix64(q[i]);
      uint64_t b = p ? (mq >> (64 - p)) : 0;
      int64_t s = bucket_start[b], e = bucket_start[b + 1];
      while (s < e) {
        int64_t mid = (s + e) >> 1;
        if (keys_mixed[mid] < mq)
          s = mid + 1;
        else
          e = mid;
      }
      bool hit = s < bucket_start[b + 1] && keys_mixed[s] == mq;
      out_idx[i] = hit ? s : n;
      out_hit[i] = hit ? 1 : 0;
    }
  });
}

// Canonical k-mers of every window of a base-code vector (0..3, 4 = N):
// canon = min(forward, reverse complement), is_fw, valid (no N inside).
// Each range seeds its rolling state from the k - 1 codes before it.
void ktio_kmer_scan(const uint8_t* codes, int64_t n, int k, uint64_t* canon,
                    uint8_t* is_fw, uint8_t* valid, int n_threads) {
  int64_t W = n - k + 1;
  if (W <= 0) return;
  const uint64_t mask = (1ULL << (2 * k)) - 1;
  parallel_ranges(W, n_threads, [&](int64_t lo, int64_t hi) {
    uint64_t fwd = 0, rc = 0;
    int64_t next_valid = lo;  // first window with no N in it
    for (int64_t j = lo; j < lo + k - 1; j++) {
      uint8_t c = codes[j];
      if (c >= 4) next_valid = j + 1;
      c &= 3;
      fwd = ((fwd << 2) | c) & mask;
      rc = (rc >> 2) | ((uint64_t)(3 - c) << (2 * (k - 1)));
    }
    for (int64_t w = lo; w < hi; w++) {
      uint8_t c = codes[w + k - 1];
      if (c >= 4) next_valid = w + k;
      c &= 3;
      fwd = ((fwd << 2) | c) & mask;
      rc = (rc >> 2) | ((uint64_t)(3 - c) << (2 * (k - 1)));
      bool fw = fwd <= rc;
      canon[w] = fw ? fwd : rc;
      is_fw[w] = fw ? 1 : 0;
      valid[w] = (w >= next_valid) ? 1 : 0;
    }
  });
}

// Reverse complements of packed k-mers (low 2k bits).
void ktio_revcomp(const uint64_t* x, int64_t n, int k, uint64_t* out,
                  int n_threads) {
  parallel_ranges(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) out[i] = revcomp_u64(x[i], k);
  });
}

}  // extern "C"
