// The read key shared by kernel B (csrc/read_keys.cu, per read) and
// kernel E's first pass (csrc/compact.cu, the compact key fused into the
// key table), and the SideResult view both they and kernel F read.
//
// The key is JAX's _hash_columns_128 (kallisto_tpu/ops/pseudoalign.py
// :567) over a read's int32 columns in JAX order: rows1[0..R1), rows2
// [0..R2) (paired), the flags, the [f_block, f_strand] tail of each mate
// (strand key or position column), the position rank.  Every column is
// sign-extended to 64 bits as JAX's astype(uint64) does, and all
// arithmetic is unsigned 64-bit with wrap.  Rows are read as 16-byte
// loads where the mate's row pointer and width allow it (kt_vec), else as
// 8- or 4-byte loads.

#pragma once

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

// The compact key's options (ops/kernels.py KeyOpts): the min_range veto
// bits, the strand tail and the position rank over pf_ptr / pf_base.
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
    __device__ KeyHash() : h1(0xCBF29CE484222325ULL), h2(0x9E3779B97F4A7C15ULL) {}
    __device__ __forceinline__ void add(int c) {
        const unsigned long long u = (unsigned long long)(long long)c;
        h1 = (h1 ^ u) * KT_M1;
        h2 = (h2 + u) * KT_M2;
        h2 ^= h2 >> 29;
    }
    __device__ __forceinline__ unsigned long long w0() const {
        return h1 ^ (h1 >> 33);
    }
    __device__ __forceinline__ unsigned long long w1() const {
        return h2 * KT_M1;
    }
};

// The widest load (4, 2 or 1 words) that a mate's rows allow: row width
// and base pointer aligned.
static inline int kt_vec(const KeySide* s) {
    const unsigned long long p = (unsigned long long)s->rows;
    if (s->R % 4 == 0 && p % 16 == 0) return 4;
    if (s->R % 2 == 0 && p % 8 == 0) return 2;
    return 1;
}

// One read's row (R words from `row`) into the hash, V words a load.
__device__ __forceinline__ void kt_add_row(KeyHash& h, const int* row, int R,
                                           int V) {
    if (V == 4) {
        const int4* r4 = (const int4*)row;
        for (int j = 0; j < R / 4; ++j) {
            const int4 v = __ldg(r4 + j);
            h.add(v.x);
            h.add(v.y);
            h.add(v.z);
            h.add(v.w);
        }
    } else if (V == 2) {
        const int2* r2 = (const int2*)row;
        for (int j = 0; j < R / 2; ++j) {
            const int2 v = __ldg(r2 + j);
            h.add(v.x);
            h.add(v.y);
        }
    } else {
        for (int j = 0; j < R; ++j) h.add(__ldg(row + j));
    }
}

__device__ __forceinline__ int kt_veto(const KeySide& s, int r, int k,
                                       int min_range) {
    return min_range > 1 && s.has[r] && s.rng[r] + k < min_range;
}

// pos_filter_rank (kallisto_tpu/ops/pseudoalign.py :168-193) of read i of
// one mate: the fixed-depth lower_bound over its first-hit block's sorted
// thresholds (forward half, then reverse half of pf_base).
__device__ int kt_pos_rank(const KeySide& s, const KeyOpts& o, int i) {
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

// The compact key of read i: its columns in JAX order into h; returns its
// flags (has1 + 2 has2 + 4 ovf1 + 8 ovf2, + 16 veto1 + 32 veto2 when
// min_range > 1).  With every option off this is the per-read key.
__device__ __forceinline__ int kt_compact_key(KeyHash& h, const KeySide& s1,
                                              const KeySide& s2, int paired,
                                              const KeyOpts& o, int i,
                                              int V1, int V2) {
    kt_add_row(h, s1.rows + (long long)i * s1.R, s1.R, V1);
    int flags = (int)s1.has[i] + 4 * (int)s1.ovf[i] +
                16 * kt_veto(s1, i, o.k, o.min_range);
    if (paired) {
        kt_add_row(h, s2.rows + (long long)i * s2.R, s2.R, V2);
        flags += 2 * (int)s2.has[i] + 8 * (int)s2.ovf[i] +
                 32 * kt_veto(s2, i, o.k, o.min_range);
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
            // the filter applies only when exactly one mate hit
            const int a = s1.has[i] != 0, b = s2.has[i] != 0;
            pc = (a != b) ? (a ? kt_pos_rank(s1, o, i) : kt_pos_rank(s2, o, i))
                          : -1;
        } else {
            pc = kt_pos_rank(s1, o, i);
        }
        h.add(pc);
    }
    return flags;
}
