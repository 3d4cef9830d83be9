// Host wave 1 of the two-wave anchor evaluation (host C++, not a kernel).
//
// Replaces the host probe of the JAX package (ops/hostprobe.py over its
// native wave-1 routine): a few k-mer lookups per mate, against the same
// sorted probe tables the card holds, either PROVE that the read matches
// one unitig stretch or send it to wave 2 on the card.  The proof is the
// anchor kernel's (ops/anchor.py): anchors w_j = (wlast * j) //
// (n_anchors - 1) are at most k apart, so when every anchor hits one
// unitig on one strand at exactly the interpolated position, their
// overlapping windows chain into read[0 : wlast + k] == that stretch and
// every window of the read hits it.  The read's distinct EC rows are then
// the block ECs of the contiguous block range [blo, bhi] (reference: the
// jump/skip heuristic, src/KmerIndex.cpp:1776-1887).
//
// Verified reads are reduced here to a key histogram in the resolver's
// exemplar layout (rows1, rows2, flags, tails; quant/ecmap.py
// _resolve_key), hashed with the host namespace's 128-bit column hash (its
// constants differ from kernel B's, so a host key never aliases a card
// key).  Each thread takes a contiguous range of reads and keeps its keys
// in first-seen order; the threads' lists are merged in range order, so
// keys come out in ascending first read whatever the thread count.
// Failing reads are listed in read order with their side (1/2: only that
// mate failed and the other packs into the 8-byte summary (blo, upos0<<5 |
// span<<1 | strand); 3: both go to the card).  With per-read outputs the
// probe also writes each verified read's key word h1, its mates' first
// hits (f_block, upos0<<1 | strand) and its mapPair fragment length.
//
// Built with g++ -O3 -shared -fPIC at first use (ops/hostprobe.py) and
// called through ctypes; plain C interface.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

const int32_t kRowPad = 0x7FFFFFFF;  // INT32_MAX row padding
const int kMaxR = 64;

struct Ctx {
  const uint64_t* mk;          // [N] sorted mixed canonical k-mers
  const int64_t* bucket_start; // [2^p + 1]
  int32_t p;
  const int32_t* kuid;
  const int32_t* kpos;
  const uint8_t* kfw;
  const int32_t* kblock;
  const int32_t* block_ec;
  const int32_t* pf_ptr;       // position-filter tables (single-end rank)
  const int32_t* pf_base;
  int64_t pf_np;
  int32_t Lp, rl, k, R, n_anchors, tail_mode, pos_fl;
  const int32_t* ws;           // anchor window starts
};

struct Mate {
  int nrows;
  int32_t rows[kMaxR];
  int32_t uid0, blk0, upos0, blo, bhi;
  int32_t strand0;
};

// 2-bit window [w, w+k) of a packed row: base w+i at bits 2i
inline uint64_t window2(const uint8_t* row, int rowb, int w, int k) {
  const int bit = 2 * w, byte = bit >> 3, sh = bit & 7;
  uint8_t tmp[16] = {0};
  int take = std::min(16, rowb - byte);
  if (take > 0) memcpy(tmp, row + byte, take);
  uint64_t lo, hi;
  memcpy(&lo, tmp, 8);
  memcpy(&hi, tmp + 8, 8);
  const uint64_t x = sh ? ((lo >> sh) | (hi << (64 - sh))) : lo;
  return x & ((k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1));
}

// whether the N mask has a bit in [w, w+k)
inline bool has_n(const uint8_t* nm, int nmb, int w, int k) {
  const int byte = w >> 3, sh = w & 7;
  uint8_t tmp[16] = {0};
  int take = std::min(16, nmb - byte);
  if (take > 0) memcpy(tmp, nm + byte, take);
  uint64_t lo, hi;
  memcpy(&lo, tmp, 8);
  memcpy(&hi, tmp + 8, 8);
  const uint64_t x = sh ? ((lo >> sh) | (hi << (64 - sh))) : lo;
  return (x & ((k >= 64) ? ~0ULL : ((1ULL << k) - 1))) != 0;
}

// reverses the order of the 32 2-bit groups of x
inline uint64_t rev2(uint64_t x) {
  x = ((x & 0x3333333333333333ULL) << 2) | ((x >> 2) & 0x3333333333333333ULL);
  x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
  x = ((x & 0x00FF00FF00FF00FFULL) << 8) | ((x >> 8) & 0x00FF00FF00FF00FFULL);
  x = ((x & 0x0000FFFF0000FFFFULL) << 16) |
      ((x >> 16) & 0x0000FFFF0000FFFFULL);
  return (x << 32) | (x >> 32);
}

// Wave 1 of one mate; false sends the mate to wave 2.
bool eval_mate(const Ctx& c, const uint8_t* pk, const uint8_t* nm, Mate* m) {
  const int rowb = c.Lp / 4, nmb = c.Lp / 8;
  const uint64_t kmask = (c.k == 32) ? ~0ULL : ((1ULL << (2 * c.k)) - 1);
  int32_t uid0 = 0, pos0 = 0, blo = 0, bhi = 0, strand0 = 0;
  for (int j = 0; j < c.n_anchors; j++) {
    const int w = c.ws[j];
    if (has_n(nm, nmb, w, c.k)) return false;
    const uint64_t x = window2(pk, rowb, w, c.k);
    const uint64_t f = rev2(x) >> (64 - 2 * c.k);
    const uint64_t r = (~x) & kmask;
    const bool fw = f <= r;
    const uint64_t q = mix64(fw ? f : r);
    const uint64_t b = c.p ? (q >> (64 - c.p)) : 0;
    const int64_t end = c.bucket_start[b + 1];
    const int64_t s = std::lower_bound(c.mk + c.bucket_start[b], c.mk + end,
                                       q) - c.mk;
    if (s >= end || c.mk[s] != q) return false;
    const int32_t uid = c.kuid[s], pos = c.kpos[s], blk = c.kblock[s];
    const int32_t strand = (fw == (bool)c.kfw[s]) ? 1 : 0;
    if (j == 0) {
      uid0 = uid;
      pos0 = pos;
      strand0 = strand;
      blo = bhi = blk;
      m->uid0 = uid;
      m->upos0 = pos;
      m->blk0 = blk;
      m->strand0 = strand;
    } else {
      if (uid != uid0 || strand != strand0) return false;
      if (pos != (strand0 ? pos0 + w : pos0 - w)) return false;
      blo = std::min(blo, blk);
      bhi = std::max(bhi, blk);
    }
  }
  if (blo < 0) return false;                    // D-list dummy unitig
  if (bhi - blo > 2 * c.rl + 16) return false;  // sanity cap on the span
  m->blo = blo;
  m->bhi = bhi;
  // distinct sorted non-empty EC rows of the block range, at most R
  int nr = 0;
  for (int32_t fid = blo; fid <= bhi; fid++) {
    const int32_t ec = c.block_ec[fid];
    if (ec < 0) continue;
    int q = nr;
    while (q > 0 && m->rows[q - 1] > ec) q--;
    if (q > 0 && m->rows[q - 1] == ec) continue;
    if (nr >= c.R) return false;  // row budget -> wave 2
    for (int t = nr; t > q; t--) m->rows[t] = m->rows[t - 1];
    m->rows[q] = ec;
    nr++;
  }
  m->nrows = nr;
  return true;
}

// single-end position-filter rank: lower bound over the first-hit block's
// sorted bases (ops/pseudoalign.py pos_filter_rank with f_rpos = 0)
int32_t pos_rank(const Ctx& c, const Mate& e) {
  const int32_t b = e.blk0 < 0 ? 0 : e.blk0;
  const int32_t lo0 = c.pf_ptr[b], hi = c.pf_ptr[b + 1];
  const int32_t* base = c.pf_base + (e.strand0 ? 0 : c.pf_np);
  const int32_t target = e.strand0 ? e.upos0 + c.pos_fl
                                   : e.upos0 - c.pos_fl + 1;
  return (int32_t)(std::lower_bound(base + lo0, base + hi, target) -
                   (base + lo0));
}

// host-namespace 128-bit column hash of an exemplar (+ the rank column)
void key_hash(const int32_t* ex, int W, int32_t extra, bool use_extra,
              uint64_t* h1o, uint64_t* h2o) {
  uint64_t h1 = 0x9AE16A3B2F90404FULL, h2 = 0xC3A5C85C97CB3127ULL;
  const uint64_t m1 = 0x100000001B3ULL, m2 = 0xC2B2AE3D27D4EB4FULL;
  auto mix_in = [&](int32_t v) {
    const uint64_t cu = (uint64_t)(int64_t)v;
    h1 = (h1 ^ cu) * m1;
    h2 = (h2 + cu) * m2;
    h2 ^= h2 >> 29;
  };
  for (int i = 0; i < W; i++) mix_in(ex[i]);
  if (use_extra) mix_in(extra);
  h1 ^= h1 >> 33;
  h2 *= m1;
  if (!(h1 | h2)) h1 = 1;
  *h1o = h1;
  *h2o = h2;
}

// Keys in first-seen order with an open-addressing index on h1.
struct KeyList {
  int W = 0;
  std::vector<uint64_t> h1, h2;
  std::vector<int64_t> first, count;
  std::vector<int32_t> ex;
  std::vector<int32_t> slot;  // key id + 1, 0 = empty
  size_t mask = 0;

  void init(int width) {
    W = width;
    slot.assign(1024, 0);
    mask = 1023;
  }
  void grow() {
    std::vector<int32_t> old(slot.size() * 2, 0);
    slot.swap(old);
    mask = slot.size() - 1;
    for (size_t id = 0; id < h1.size(); id++) {
      size_t i = (size_t)h1[id] & mask;
      while (slot[i]) i = (i + 1) & mask;
      slot[i] = (int32_t)id + 1;
    }
  }
  // adds cnt reads first seen at read idx; exemplar copied on a new key
  void add(uint64_t a, uint64_t b, int64_t idx, int64_t cnt,
           const int32_t* e) {
    if ((h1.size() + 1) * 4 >= slot.size() * 3) grow();
    size_t i = (size_t)a & mask;
    while (slot[i]) {
      const size_t id = (size_t)slot[i] - 1;
      if (h1[id] == a && h2[id] == b) {
        count[id] += cnt;
        if (idx < first[id]) first[id] = idx;
        return;
      }
      i = (i + 1) & mask;
    }
    slot[i] = (int32_t)h1.size() + 1;
    h1.push_back(a);
    h2.push_back(b);
    first.push_back(idx);
    count.push_back(cnt);
    ex.insert(ex.end(), e, e + W);
  }
};

struct Out {
  KeyList keys;
  std::vector<int32_t> fail_idx;
  std::vector<uint8_t> fail_side;
  std::vector<int32_t> fail_vsum;
};

}  // namespace

extern "C" {

int hostprobe_abi_version() { return 1; }

// Wave 1 of n reads (pairs when packed2 is not null).  Fails go to
// fail_idx / fail_side / fail_vsum ([n], [n], [n, 2]) with their count in
// *n_fail; keys are fetched from the returned handle.  out_h1 / out_vinfo
// / out_tl ([n], [n, 4], [n]; may be null) are the per-read outputs,
// filled for verified reads only (the caller zeroes them, tl = -1).
void* hostprobe_wave1(
    const uint64_t* mk, const int64_t* bucket_start, int32_t p,
    const int32_t* kuid, const int32_t* kpos, const uint8_t* kfw,
    const int32_t* kblock, const int32_t* block_ec, const int32_t* pf_ptr,
    const int32_t* pf_base, int64_t pf_np, const uint8_t* packed1,
    const uint8_t* nmask1, const uint8_t* packed2, const uint8_t* nmask2,
    int64_t n, int32_t Lp, int32_t rl, int32_t k, int32_t R,
    int32_t n_anchors, const int32_t* anchor_ws, int32_t min_range,
    int32_t tail_mode, int32_t pos_fl, int32_t n_threads, int32_t* fail_idx,
    uint8_t* fail_side, int32_t* fail_vsum, int64_t* n_fail,
    uint64_t* out_h1, int32_t* out_vinfo, int32_t* out_tl) {
  if (R < 1 || R > kMaxR) return nullptr;
  const Ctx c{mk, bucket_start, p, kuid, kpos, kfw, kblock, block_ec,
              pf_ptr, pf_base, pf_np, Lp, rl, k, R, n_anchors, tail_mode,
              pos_fl, anchor_ws};
  const bool paired = packed2 != nullptr;
  const int rowb = Lp / 4, nmb = Lp / 8;
  int W = paired ? 2 * R + 1 : R + 1;
  if (tail_mode >= 1) W += paired ? 4 : 2;
  if (tail_mode >= 2) W += paired ? 4 : 2;
  const bool rank_in_key = !paired && pos_fl >= 0;
  // the min_range veto is constant at a uniform length: a verified mate's
  // span is rl - k, so veto <=> rl < min_range
  const int32_t veto = (min_range > 1 && rl < min_range) ? 1 : 0;

  int T = n_threads > 0 ? n_threads : 1;
  if (n < (1 << 14)) T = 1;
  std::vector<Out> outs(T);
  auto work = [&](int t, int64_t lo, int64_t hi) {
    Out& o = outs[t];
    o.keys.init(W);
    std::vector<int32_t> ex(W);
    for (int64_t i = lo; i < hi; i++) {
      Mate e1, e2;
      const bool ok1 = eval_mate(c, packed1 + i * rowb, nmask1 + i * nmb, &e1);
      const bool ok2 =
          !paired || eval_mate(c, packed2 + i * rowb, nmask2 + i * nmb, &e2);
      if (!ok1 || !ok2) {
        uint8_t side = paired ? 3 : 1;
        int32_t v0 = 0, v1 = 0;
        if (paired && ok1 != ok2) {
          // the verified mate's summary packs when its block range fits
          // two 8-wide block_ec8 rows and upos0 fits 26 bits
          const Mate& v = ok1 ? e1 : e2;
          if ((v.bhi >> 3) <= (v.blo >> 3) + 1 && v.upos0 >= 0 &&
              v.upos0 < (1 << 26)) {
            side = ok1 ? 2 : 1;
            v0 = v.blo;
            v1 = (v.upos0 << 5) | ((v.bhi - v.blo) << 1) | v.strand0;
          }
        }
        o.fail_idx.push_back((int32_t)i);
        o.fail_side.push_back(side);
        o.fail_vsum.push_back(v0);
        o.fail_vsum.push_back(v1);
        continue;
      }
      int q = 0;
      for (int m = 0; m < R; m++) ex[q++] = m < e1.nrows ? e1.rows[m] : kRowPad;
      if (paired) {
        for (int m = 0; m < R; m++)
          ex[q++] = m < e2.nrows ? e2.rows[m] : kRowPad;
        ex[q++] = 1 + 2 + 16 * veto + 32 * veto;
      } else {
        ex[q++] = 1 + 16 * veto;
      }
      if (tail_mode >= 1) {
        ex[q++] = e1.blk0;
        ex[q++] = e1.strand0;
        if (paired) {
          ex[q++] = e2.blk0;
          ex[q++] = e2.strand0;
        }
      }
      if (tail_mode >= 2) {  // f_rpos is 0: the first hit is window 0
        ex[q++] = e1.upos0;
        ex[q++] = 0;
        if (paired) {
          ex[q++] = e2.upos0;
          ex[q++] = 0;
        }
      }
      uint64_t h1, h2;
      key_hash(ex.data(), W, rank_in_key ? pos_rank(c, e1) : 0, rank_in_key,
               &h1, &h2);
      o.keys.add(h1, h2, i, 1, ex.data());
      if (out_h1) {
        out_h1[i] = h1;
        out_vinfo[4 * i] = e1.strand0 ? e1.blo : e1.bhi;
        out_vinfo[4 * i + 1] = (e1.upos0 << 1) | e1.strand0;
        if (paired) {
          out_vinfo[4 * i + 2] = e2.strand0 ? e2.blo : e2.bhi;
          out_vinfo[4 * i + 3] = (e2.upos0 << 1) | e2.strand0;
        }
      }
      if (out_tl) {
        // mapPair (reference: KmerIndex::mapPair, src/KmerIndex.cpp:
        // 1622-1693): same unitig and block, opposite strands; the first
        // hits are at read position 0
        int32_t tl = -1;
        if (paired && e1.uid0 == e2.uid0 && e1.blk0 == e2.blk0 &&
            e1.strand0 != e2.strand0) {
          const int32_t p1 = e1.strand0 ? e1.upos0 : e1.upos0 + k;
          const int32_t p2 = e2.strand0 ? e2.upos0 : e2.upos0 + k;
          tl = p1 > p2 ? p1 - p2 : p2 - p1;
        }
        out_tl[i] = tl;
      }
    }
  };
  if (T == 1) {
    work(0, 0, n);
  } else {
    std::vector<std::thread> ths;
    const int64_t per = (n + T - 1) / T;
    for (int t = 0; t < T; t++) {
      const int64_t lo = t * per, hi = std::min<int64_t>(n, lo + per);
      if (lo < hi) ths.emplace_back(work, t, lo, hi);
    }
    for (auto& th : ths) th.join();
  }
  // merge in thread (= read range) order: keys stay in first-seen order
  Out* res = new Out();
  res->keys.init(W);
  int64_t nf = 0;
  for (int t = 0; t < T; t++) {
    const KeyList& kl = outs[t].keys;
    for (size_t id = 0; id < kl.h1.size(); id++)
      res->keys.add(kl.h1[id], kl.h2[id], kl.first[id], kl.count[id],
                    kl.ex.data() + id * W);
    const Out& o = outs[t];
    memcpy(fail_idx + nf, o.fail_idx.data(), o.fail_idx.size() * 4);
    memcpy(fail_side + nf, o.fail_side.data(), o.fail_side.size());
    memcpy(fail_vsum + 2 * nf, o.fail_vsum.data(), o.fail_vsum.size() * 4);
    nf += (int64_t)o.fail_idx.size();
  }
  *n_fail = nf;
  return res;
}

int64_t hostprobe_nkeys(void* h) {
  return (int64_t)((Out*)h)->keys.h1.size();
}

int32_t hostprobe_width(void* h) { return ((Out*)h)->keys.W; }

void hostprobe_fetch(void* h, uint64_t* h1, uint64_t* h2, int64_t* first,
                     int64_t* count, int32_t* ex) {
  const KeyList& kl = ((Out*)h)->keys;
  const size_t K = kl.h1.size();
  memcpy(h1, kl.h1.data(), K * 8);
  memcpy(h2, kl.h2.data(), K * 8);
  memcpy(first, kl.first.data(), K * 8);
  memcpy(count, kl.count.data(), K * 8);
  memcpy(ex, kl.ex.data(), kl.ex.size() * 4);
}

void hostprobe_free(void* h) { delete (Out*)h; }

}  // extern "C"
