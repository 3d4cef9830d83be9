// Kernel B: read_keys -- the 128-bit read key, its flag column and the
// mapPair fragment length, one thread per pair (or per read for single-end).
//
// Replaces the JAX device programs kallisto_tpu/ops/pseudoalign.py
// _hash_columns_128 (:567) as reached through pair_key_hash (:638) and
// single_key_hash (:649) on the per-read path, and through compact_pair_keys
// / compact_single_keys (:689, :716) on the steady state; the flag builders
// _pair_flags / _single_flags (:598, :616); the position-filter rank
// pos_filter_rank (:168) with pos_col_pair (:678); and pair_fragment_lengths
// (:1206).  The columns are hashed in JAX order:
//   rows1[0..R1), rows2[0..R2) (paired),
//   flags = has1 + 2*has2 + 4*ovf1 + 8*ovf2 (+ 16*veto1 + 32*veto2 when
//           min_range > 1, veto = has && rng + k < min_range),
//   [f_block1, f_strand1, (f_block2, f_strand2)] when strand_key or the
//           position column is on,
//   the position rank when it is on (pairs: only when exactly one mate hit,
//           from that mate; else -1).
// Every column is an int32, sign-extended to 64 bits as JAX's
// astype(uint64) does, and all arithmetic is unsigned 64-bit with wrap.  With
// every option off this is the per-read key of the full path.
//
// The rank is the fixed-depth lower_bound of pos_filter_rank over the read's
// first-hit block's sorted thresholds (pf_ptr / pf_base, forward half then
// reverse half), computed in the same thread so the key needs no second
// pass.
//
// What bounds it on the H100: memory.  Per pair it reads 4*(R1+R2) bytes of
// rows plus 2 flag bytes per mate, the first-hit fields it hashes (13 bytes
// per mate for the fragment length or the tail) and, with the rank on, depth
// 32-byte sectors of pf_base; it writes 16 bytes of key, 4 of flags and 4 of
// fragment length.  The hashing is ~8 integer operations per column.  Each
// thread reads its own contiguous row (64 B for R = 16), which the L1 serves
// after the first sector; the kernel is short next to kernels A and D and is
// kept simple.

#include <cuda_runtime.h>

#define KT_M1 0x100000001B3ULL
#define KT_M2 0xC2B2AE3D27D4EB4FULL

// One mate's SideResult fields (layout shared with ops/kernels.py KeySide).
struct KeySide {
    const int* rows;               // [B, R]
    const unsigned char* has;      // [B] bool
    const unsigned char* ovf;      // [B] bool
    const int* upos;
    const int* rpos;
    const int* block;
    const unsigned char* strand;   // [B] bool
    const int* rng;
    int R;
};

struct KeyOpts {
    const int* pf_ptr;    // [NB+1] or null: no position column
    const int* pf_base;   // [2*NP]
    long long NP;
    int k;
    int min_range;
    int strand_key;
    int pos_fl;
    int pos_depth;
};

struct KeyHash {
    unsigned long long h1, h2;
    __device__ void add(int c) {
        const unsigned long long u = (unsigned long long)(long long)c;
        h1 = (h1 ^ u) * KT_M1;
        h2 = (h2 + u) * KT_M2;
        h2 ^= h2 >> 29;
    }
};

// pos_filter_rank :168-193 for read i of one mate.
__device__ int kt_pos_rank(const KeySide& s, const KeyOpts& o, long long i) {
    if (!s.has[i]) return -1;
    const int b = s.block[i] > 0 ? s.block[i] : 0;
    const int lo0 = o.pf_ptr[b];
    int lo = lo0, hi = o.pf_ptr[b + 1];
    const int fw = s.strand[i] != 0;
    const long long off = fw ? 0 : o.NP;
    const int target = fw ? s.upos[i] - s.rpos[i] + o.pos_fl
                          : s.upos[i] + s.rpos[i] - o.pos_fl + 1;
    for (int d = 0; d < o.pos_depth; ++d) {
        if (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (o.pf_base[mid + off] < target) lo = mid + 1;
            else hi = mid;
        }
    }
    return lo - lo0;
}

__device__ __forceinline__ int kt_veto(const KeySide& s, const KeyOpts& o,
                                       long long i) {
    return o.min_range > 1 && s.has[i] && s.rng[i] + o.k < o.min_range;
}

__global__ void read_keys_kernel(KeySide s1, KeySide s2, int paired,
                                 KeyOpts o, long long B,
                                 unsigned long long* __restrict__ h_out,
                                 int* __restrict__ tl_out,
                                 int* __restrict__ flags_out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    KeyHash h{0xCBF29CE484222325ULL, 0x9E3779B97F4A7C15ULL};
    const int* r1 = s1.rows + i * s1.R;
    for (int j = 0; j < s1.R; ++j) h.add(r1[j]);
    int flags = (int)s1.has[i] + 4 * (int)s1.ovf[i] + 16 * kt_veto(s1, o, i);
    if (paired) {
        const int* r2 = s2.rows + i * s2.R;
        for (int j = 0; j < s2.R; ++j) h.add(r2[j]);
        flags += 2 * (int)s2.has[i] + 8 * (int)s2.ovf[i] +
                 32 * kt_veto(s2, o, i);
    }
    h.add(flags);
    const int pos_on = o.pf_ptr != 0;
    if (o.strand_key || pos_on) {
        h.add(s1.block[i]);
        h.add((int)s1.strand[i]);
        if (paired) {
            h.add(s2.block[i]);
            h.add((int)s2.strand[i]);
        }
    }
    if (pos_on) {
        int pc;
        if (paired) {
            const int a = s1.has[i] != 0, b = s2.has[i] != 0;
            pc = (a != b) ? (a ? kt_pos_rank(s1, o, i) : kt_pos_rank(s2, o, i))
                          : -1;
        } else {
            pc = kt_pos_rank(s1, o, i);
        }
        h.add(pc);
    }
    h_out[2 * i] = h.h1 ^ (h.h1 >> 33);
    h_out[2 * i + 1] = h.h2 * KT_M1;
    if (flags_out) flags_out[i] = flags;
    if (paired && tl_out) {
        // mapPair (reference: KmerIndex.cpp:1622-1693): same block, opposite
        // strands; the length is |p1 - p2| of the projected read ends
        const int k = o.k;
        const int t1 = s1.strand[i] != 0, t2 = s2.strand[i] != 0;
        const int p1 = t1 ? s1.upos[i] - s1.rpos[i] : s1.upos[i] + k + s1.rpos[i];
        const int p2 = t2 ? s2.upos[i] - s2.rpos[i] : s2.upos[i] + k + s2.rpos[i];
        const int ok = s1.has[i] && s2.has[i] && s1.block[i] == s2.block[i] &&
                       t1 != t2;
        const int d = p1 - p2;
        tl_out[i] = ok ? (d < 0 ? -d : d) : -1;
    }
}

extern "C" int read_keys(const KeySide* s1, const KeySide* s2,
                         const KeyOpts* opts, long long B, void* h_out,
                         void* tl_out, void* flags_out, void* stream) {
    if (B <= 0) return 0;
    if (s1 == 0 || opts == 0 || s1->R <= 0 || (s2 != 0 && s2->R <= 0) ||
        (opts->pf_ptr != 0 && (opts->pf_base == 0 || opts->pos_depth < 0)))
        return (int)cudaErrorInvalidValue;
    const int paired = s2 != 0;
    KeySide none = *s1;
    const int threads = 256;
    const long long blocks = (B + threads - 1) / threads;
    read_keys_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        *s1, paired ? *s2 : none, paired, *opts, B,
        (unsigned long long*)h_out, (int*)tl_out, (int*)flags_out);
    return (int)cudaGetLastError();
}
