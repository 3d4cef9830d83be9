// EC resolution of a batch's first-seen keys (host C++, not a kernel).
//
// A key is one read's (or one key histogram row's) distinct EC rows in the
// resolver's exemplar layout (quant/ecmap.py EcResolver._resolve_key):
// rows1 (R), rows2 (R if paired), flags, tail...; INT32_MAX pads a mate's
// rows, flags bit0 / bit1 say that mate 1 / mate 2 had any k-mer hit, and
// the tail is not read.  Each key resolves to a sorted transcript set by
// EcResolver.resolve_rows's rules:
//   - each mate's set is the intersection of its rows' transcript lists
//     (reference: MinCollector::intersectECs, src/MinCollector.cpp:425-496);
//   - non-strict pairing (MinCollector::intersectKmers, :160-218): a mate
//     with hits and an empty set vetoes the fragment, a mate with no hits
//     defers to the other, and two non-empty sets intersect;
//   - with the off-list mask on, targets >= num_onlist are dropped
//     (u &= onlist_sequences, ProcessReads.cpp:1072).
// The batch's distinct sets are kept in the order of their first key, so
// the caller numbers new ECs exactly as a key-by-key loop would.  The modes
// with further rules (union, shades, --dfk-onlist, per-key filters) stay on
// the Python resolver.
//
// Built with g++ -O3 -shared -fPIC at first use (quant/ecresolve.py) and
// called through ctypes; plain C interface.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int32_t kRowPad = 0x7FFFFFFF;  // INT32_MAX row padding

struct Resolver {
  const int64_t* ec_ptr;  // [n_rows + 1]
  const int32_t* ec_tx;   // [ec_ptr[n_rows]] sorted transcript ids per row
  int64_t n_rows;
  int32_t num_onlist;
  bool mask_offlist;
  // the last batch's distinct sets (CSR) and the dedup table
  std::vector<int64_t> set_ptr;
  std::vector<int32_t> set_tx;
  std::vector<uint64_t> set_hash;
  std::vector<int32_t> table;
  // scratch: one mate's running intersection, the pair's, the masked set
  std::vector<int32_t> a, b, c, d;
};

// A sorted id list: a view into ec_tx or into one of the scratch vectors.
struct Span {
  const int32_t* p;
  int64_t n;
};

Span intersect(Span x, Span y, std::vector<int32_t>& out) {
  if (x.n > y.n) std::swap(x, y);
  out.resize(x.n);
  int64_t k = 0;
  if (x.n == 0) return {out.data(), 0};
  if (y.n > 16 * x.n) {
    // few against many: binary search each of the few
    const int32_t* lo = y.p;
    const int32_t* end = y.p + y.n;
    for (int64_t i = 0; i < x.n && lo < end; ++i) {
      lo = std::lower_bound(lo, end, x.p[i]);
      if (lo < end && *lo == x.p[i]) out[k++] = x.p[i];
    }
  } else {
    int64_t i = 0, j = 0;
    while (i < x.n && j < y.n) {
      int32_t u = x.p[i], v = y.p[j];
      if (u < v) {
        ++i;
      } else if (v < u) {
        ++j;
      } else {
        out[k++] = u;
        ++i;
        ++j;
      }
    }
  }
  return {out.data(), k};
}

// The intersection of one mate's rows (skipping padding); empty without
// rows.  Returns 0, or -1 for a row index outside the index.
int mate_set(Resolver* r, const int32_t* rows, int R, std::vector<int32_t>& s1,
             std::vector<int32_t>& s2, Span* out) {
  Span u{nullptr, 0};
  bool first = true;
  bool in_s1 = false;
  for (int i = 0; i < R; ++i) {
    int32_t row = rows[i];
    if (row == kRowPad) continue;
    if (row < 0 || row >= r->n_rows) return -1;
    Span v{r->ec_tx + r->ec_ptr[row], r->ec_ptr[row + 1] - r->ec_ptr[row]};
    if (first) {
      u = v;
      first = false;
    } else if (u.n) {
      // alternate the two scratch vectors: the output never aliases u
      u = intersect(u, v, in_s1 ? s2 : s1);
      in_s1 = !in_s1;
    }
  }
  *out = u;
  return 0;
}

inline uint64_t hash_set(Span u) {
  uint64_t h = 0x9E3779B97F4A7C15ULL ^ static_cast<uint64_t>(u.n);
  for (int64_t i = 0; i < u.n; ++i) {
    h ^= static_cast<uint32_t>(u.p[i]);
    h *= 0xBF58476D1CE4E5B9ULL;
    h ^= h >> 29;
  }
  return h;
}

// The id of set u among the batch's distinct sets (new ones appended).
int32_t set_id(Resolver* r, Span u) {
  uint64_t h = hash_set(u);
  size_t mask = r->table.size() - 1;
  for (size_t s = h & mask;; s = (s + 1) & mask) {
    int32_t id = r->table[s];
    if (id < 0) {
      id = static_cast<int32_t>(r->set_hash.size());
      r->table[s] = id;
      r->set_hash.push_back(h);
      r->set_tx.insert(r->set_tx.end(), u.p, u.p + u.n);
      r->set_ptr.push_back(static_cast<int64_t>(r->set_tx.size()));
      return id;
    }
    int64_t lo = r->set_ptr[id], n = r->set_ptr[id + 1] - lo;
    if (r->set_hash[id] == h && n == u.n &&
        std::memcmp(r->set_tx.data() + lo, u.p, n * sizeof(int32_t)) == 0)
      return id;
  }
}

}  // namespace

extern "C" {

int ecr_abi_version() { return 1; }

void* ecr_new(const int64_t* ec_ptr, const int32_t* ec_tx, int64_t n_rows,
              int32_t num_onlist, int32_t mask_offlist) {
  Resolver* r = new Resolver();
  r->ec_ptr = ec_ptr;
  r->ec_tx = ec_tx;
  r->n_rows = n_rows;
  r->num_onlist = num_onlist;
  r->mask_offlist = mask_offlist != 0;
  return r;
}

// Resolve n keys (rows of `keys`, W int32 each; R rows a mate).  Writes
// key_set[i] = the index of key i's set among the batch's distinct sets, or
// -1 for none, and returns the number of distinct sets; -1 if a key names a
// row outside the index (nothing is then kept).  ecr_fetch copies the sets.
int64_t ecr_resolve(void* h, const int32_t* keys, int64_t n, int32_t W,
                    int32_t R, int32_t paired, int32_t* key_set) {
  Resolver* r = static_cast<Resolver*>(h);
  size_t cap = 16;
  while (cap < 2 * static_cast<size_t>(n)) cap <<= 1;
  r->table.assign(cap, -1);
  r->set_ptr.assign(1, 0);
  r->set_tx.clear();
  r->set_hash.clear();
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* key = keys + i * W;
    int32_t flags = key[paired ? 2 * R : R];
    bool hits1 = flags & 1, hits2 = paired && (flags & 2);
    Span u1, u2{nullptr, 0};
    if (mate_set(r, key, R, r->a, r->b, &u1) != 0) return -1;
    if (paired && mate_set(r, key + R, R, r->c, r->d, &u2) != 0) return -1;
    Span u{nullptr, 0};
    if (u1.n == 0) {
      if (!hits1) u = u2;
    } else if (u2.n == 0) {
      if (!hits2) u = u1;
    } else {
      // a and b hold mate 1's set at most; c is free once u2 is read
      std::vector<int32_t>& out =
          (u2.p == r->c.data()) ? r->d : r->c;
      u = intersect(u1, u2, out);
    }
    if (u.n && r->mask_offlist) {
      // sorted: the on-list members are a prefix
      u.n = std::lower_bound(u.p, u.p + u.n, r->num_onlist) - u.p;
    }
    key_set[i] = u.n ? set_id(r, u) : -1;
  }
  return static_cast<int64_t>(r->set_hash.size());
}

// Transcript ids in the last batch's distinct sets.
int64_t ecr_ntx(void* h) {
  return static_cast<int64_t>(static_cast<Resolver*>(h)->set_tx.size());
}

// Copy the last batch's distinct sets: set_ptr [nsets + 1], set_tx [ntx].
void ecr_fetch(void* h, int64_t* set_ptr, int32_t* set_tx) {
  Resolver* r = static_cast<Resolver*>(h);
  std::memcpy(set_ptr, r->set_ptr.data(), r->set_ptr.size() * sizeof(int64_t));
  if (!r->set_tx.empty())
    std::memcpy(set_tx, r->set_tx.data(), r->set_tx.size() * sizeof(int32_t));
}

void ecr_free(void* h) { delete static_cast<Resolver*>(h); }

}  // extern "C"
