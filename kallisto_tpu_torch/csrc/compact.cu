// Kernels E and F of the compact steady state (E also with per-read
// slots, F also in its slim layout).
//
// Kernel E, key_histogram, replaces kallisto_tpu/ops/pseudoalign.py
// _compact_keys (:733) and _ck_flat (:789): B read keys -> the flat
// [K+1, 5] int64 table whose row 0 is [n_uniq, n_fail = 0, 0, 0, 0] and
// whose rows 1..min(n_uniq, K) are [h0, h1, occ, first_idx, flags] of each
// distinct key.  As in JAX the dedup rides on h[:, 0] alone (two keys equal
// in h0 merge; h0 already hashes every key column), a key's payload is
// idx * 128 + flags and a key keeps its minimum payload, which gives its
// first read and that read's flags; both hash words come from that read.
// n_uniq is exact even past K.
//
// It is not a copy of the TPU's sort network.  Design:
//   1. insert: an open-addressing table of S >= 2B slots (a power of two)
//      with linear probing.  Each read claims its h0's slot with a 64-bit
//      atomicCAS on the key word (the all-ones word marks an empty slot; a
//      read whose h0 is all ones goes to the extra slot S), then atomicAdds
//      the slot's count and atomicMins its payload.
//   2. count: a read is its key's first read when the slot's payload >> 7
//      is its own index; each block of 1024 reads counts its first reads.
//   3. scan: one block turns the block counts into exclusive offsets and
//      writes n_uniq into the meta row.
//   4. write: each block ranks its first reads by a block-wide prefix sum;
//      the key with global rank r goes to row 1 + r when r < K.
//   5. slots (when asked): each read's row, the rank its key got in pass 4
//      (capped at K - 1 as in JAX), through a per-slot rank that pass 4
//      writes for every first read.
// So occupied rows come out in ascending first_idx (read order), which is
// deterministic.  JAX orders them by ascending signed h0; the host
// (quant/ecmap.py process_compact_parts) stable-sorts by first_idx anyway, so
// the outputs are identical.  Rows past min(n_uniq, K) are zero.
//
// With slots, E also replaces _compact_read_slots (:774), reached through
// compact_pair_keys(..., with_slots=True) (:691-713) on the wave-2 slices
// of host wave 1: per read the row of its key in THIS table.  JAX's slot is
// the key's rank in ascending signed h0, because its rows are in that
// order; here rows are in first-read order, so the slot is the row E gave
// the key, not JAX's rank -- the two name the same key.  Bound: bytes, 4 B
// per read read (its table slot) and written (its row), one random sector
// of the per-slot rank.
//
// What bounds E on the H100: bytes.  Per read it reads 12 B of input (h0 and
// flags; h1 only for first reads) and touches about three random 32 B
// sectors of the table (key, count, payload) in pass 1 and two in passes
// 2 and 4; it writes 40 B per distinct key.  The table for a 262,144-read
// batch is 12 MB, inside the 50 MB L2, so the random sectors mostly stay on
// chip.  Atomics on one hot key (the no-hit key of padding reads) serialise
// in the L2; at realistic size they are a small share of a batch.
//
// Kernel F, gather_exemplars, replaces the exemplar gathers of the compact
// path, kallisto_tpu/quant/pipeline.py _gather_pair_exemplars (:495) and
// _gather_single_exemplars (:524): for read indices idx it writes the int32
// key rows the host resolver reads -- rows1, rows2 (paired), flags with the
// min_range veto bits, [f_block, f_strand] per mate with strand_key or the
// position key, [f_upos, f_rpos] per mate with the position key.  An idx
// outside [0, B) gets a zero row.  Its slim layout, gather_slim, replaces
// _gather_pair_slim (pipeline.py:466) read through _make_pair_slim_fetcher
// (:484) on the anchor route and host wave 1's wave-2 slices: per key the
// first two rows of each mate and the flags has_hits1 + 2 has_hits2 + 4
// overflow1 + 8 overflow2, 20 B per key, which the resolver reads to
// resolve single-row keys in bulk (quant/ecmap.py process_compact_parts).
// The slim layout keeps its one thread a key (gather_slim_kernel): staged
// like F, it took 15-27 % longer on the card (PERF.md).
// What bounds it on the H100: bytes -- per key its row words (64 B a mate
// at R = 16, contiguous), a few 1-4 B fields of each mate, and the output
// row (Wd * 4 B, 132 B for a pair without options).  The first design ran
// one thread per output element (a 64-bit division, a branch chain and one
// 4-byte load each: ~100 GB/s at 89,000 keys).  Now a group of G lanes
// (the power of two >= the key's loads, 4-32) takes one key: its rows as
// 16-byte loads (8 bytes or 4 where the stride or pointer forbids), and
// the flags and each tail word one lane each; idx ascends in first-read
// order, so consecutive keys read nearby rows.  A block's 256 / G
// consecutive keys are staged in shared memory and written as one
// contiguous span of 16-byte stores (out is [n, Wd] row-major).  Index
// arithmetic is 32-bit (the wrapper's shapes fit).

#include <cuda_runtime.h>

#define KT_EMPTY 0xFFFFFFFFFFFFFFFFULL
#define KT_SCAN_THREADS 1024
#define KT_FULL 0xffffffffu

// ------------------------------------------------------------- kernel E

__global__ void kt_insert(const long long* __restrict__ h,
                          const int* __restrict__ flags, long long B,
                          unsigned long long* keys, unsigned int* occ,
                          unsigned long long* pay, long long S,
                          int* __restrict__ read_slot) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    const unsigned long long h0 = (unsigned long long)h[2 * i];
    long long s = S;
    if (h0 != KT_EMPTY) {
        s = (long long)(h0 & (unsigned long long)(S - 1));
        while (true) {
            const unsigned long long prev = atomicCAS(&keys[s], KT_EMPTY, h0);
            if (prev == KT_EMPTY || prev == h0) break;
            s = (s + 1) & (S - 1);
        }
    }
    atomicAdd(&occ[s], 1u);
    atomicMin(&pay[s], (unsigned long long)i * 128ULL +
                           (unsigned long long)(unsigned int)flags[i]);
    read_slot[i] = (int)s;
}

__device__ __forceinline__ int kt_is_first(const unsigned long long* pay,
                                           const int* read_slot,
                                           long long i, long long B) {
    return i < B && (long long)(pay[read_slot[i]] >> 7) == i;
}

__global__ void kt_count_first(const unsigned long long* __restrict__ pay,
                               const int* __restrict__ read_slot, long long B,
                               int* __restrict__ block_count) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int c = __syncthreads_count(kt_is_first(pay, read_slot, i, B));
    if (threadIdx.x == 0) block_count[blockIdx.x] = c;
}

// Exclusive prefix sum of v over the block; *total gets the block's sum.
// blockDim.x must be a multiple of 32, at most 1024.
__device__ int kt_block_scan(int v, int* total) {
    __shared__ int warp_sum[32];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(KT_FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[wid] = x;
    __syncthreads();
    if (wid == 0) {
        int w = lane < nw ? warp_sum[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(KT_FULL, w, o);
            if (lane >= o) w += y;
        }
        warp_sum[lane] = w;
    }
    __syncthreads();
    const int off = wid ? warp_sum[wid - 1] : 0;
    *total = warp_sum[nw - 1];
    __syncthreads();  // warp_sum is reused by the next call
    return off + x - v;
}

__global__ void kt_scan_counts(int* block_count, long long nb,
                               long long* __restrict__ ck) {
    long long carry = 0;
    for (long long base = 0; base < nb; base += blockDim.x) {
        const long long j = base + threadIdx.x;
        const int v = j < nb ? block_count[j] : 0;
        int total;
        const int ex = kt_block_scan(v, &total);
        if (j < nb) block_count[j] = (int)(carry + ex);
        carry += total;
    }
    if (threadIdx.x == 0) ck[0] = carry;  // meta row: n_uniq
}

__global__ void kt_write_rows(const long long* __restrict__ h,
                              const unsigned int* __restrict__ occ,
                              const unsigned long long* __restrict__ pay,
                              const int* __restrict__ read_slot, long long B,
                              const int* __restrict__ block_offset,
                              long long K, long long* __restrict__ ck,
                              int* __restrict__ slot_rank) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int first = kt_is_first(pay, read_slot, i, B);
    int total;
    const long long r =
        (long long)block_offset[blockIdx.x] + kt_block_scan(first, &total);
    if (first && slot_rank) slot_rank[read_slot[i]] = (int)r;
    if (first && r < K) {
        const int s = read_slot[i];
        long long* row = ck + 5 * (1 + r);
        row[0] = h[2 * i];
        row[1] = h[2 * i + 1];
        row[2] = (long long)occ[s];
        row[3] = i;
        row[4] = (long long)(pay[s] & 127ULL);
    }
}

__global__ void kt_read_slots(const int* __restrict__ read_slot,
                              const int* __restrict__ slot_rank, long long B,
                              long long K, int* __restrict__ slots) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    const long long r = slot_rank[read_slot[i]];
    slots[i] = (int)(r < K - 1 ? r : K - 1);
}

// slot_rank ([S + 1] int32 workspace) and slots ([B] int32) are both null,
// or both set for the per-read rows.
extern "C" int key_histogram(const void* h, const void* flags, long long B,
                             long long K, void* keys, void* occ, void* pay,
                             long long S, void* read_slot, void* block_count,
                             void* ck, void* slot_rank, void* slots,
                             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (K < 1 || S < 2 || (S & (S - 1)) != 0 || (B > 0 && S < 2 * B) ||
        (slot_rank == 0) != (slots == 0))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaMemsetAsync(ck, 0, (size_t)(K + 1) * 5 * 8, st);
    if (e != cudaSuccess) return (int)e;
    if (B <= 0) return 0;
    if ((e = cudaMemsetAsync(keys, 0xFF, (size_t)(S + 1) * 8, st)) ||
        (e = cudaMemsetAsync(occ, 0, (size_t)(S + 1) * 4, st)) ||
        (e = cudaMemsetAsync(pay, 0xFF, (size_t)(S + 1) * 8, st)))
        return (int)e;
    const int T = KT_SCAN_THREADS;
    const long long nb = (B + T - 1) / T;
    kt_insert<<<(unsigned int)((B + 255) / 256), 256, 0, st>>>(
        (const long long*)h, (const int*)flags, B, (unsigned long long*)keys,
        (unsigned int*)occ, (unsigned long long*)pay, S, (int*)read_slot);
    kt_count_first<<<(unsigned int)nb, T, 0, st>>>(
        (const unsigned long long*)pay, (const int*)read_slot, B,
        (int*)block_count);
    kt_scan_counts<<<1, T, 0, st>>>((int*)block_count, nb, (long long*)ck);
    kt_write_rows<<<(unsigned int)nb, T, 0, st>>>(
        (const long long*)h, (const unsigned int*)occ,
        (const unsigned long long*)pay, (const int*)read_slot, B,
        (const int*)block_count, K, (long long*)ck, (int*)slot_rank);
    if (slots)
        kt_read_slots<<<(unsigned int)((B + 255) / 256), 256, 0, st>>>(
            (const int*)read_slot, (const int*)slot_rank, B, K, (int*)slots);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------- kernel F

// One mate's SideResult fields (layout shared with ops/kernels.py KeySide
// and csrc/read_keys.cu).
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

__device__ __forceinline__ int kt_veto(const KeySide& s, int r, int k,
                                       int min_range) {
    return min_range > 1 && s.has[r] && s.rng[r] + k < min_range;
}

// Kernel F (see the file header): per key, each mate's R row words (V
// words a load), the flags word, then the tail words; G lanes a key, 256 /
// G keys a block staged in shared memory, then written as one contiguous
// span.  The stage starts g0 & 3 words in, so a stage word and its output
// word agree mod 4 and the span's aligned body moves as int4.
__global__ void __launch_bounds__(256) gather_exemplars_kernel(
    KeySide s1, KeySide s2, int paired, const long long* __restrict__ idx,
    int n, int Bsrc, int k, int min_range, int V, int G, int tail_bs,
    int Wd, int* __restrict__ out) {
    extern __shared__ int4 kf_stage4[];
    int* stage = (int*)kf_stage4;
    const int kpb = blockDim.x / G;
    const int key0 = blockIdx.x * kpb;
    const int nk = min(kpb, n - key0);
    const int g0 = key0 * Wd;
    const int sb = g0 & 3;
    const int q = threadIdx.x / G, j = threadIdx.x % G;
    if (q < nk) {
        const long long r64 = idx[key0 + q];
        int* o = stage + sb + q * Wd;
        if (r64 < 0 || r64 >= Bsrc) {
            for (int c = j; c < Wd; c += G) o[c] = 0;
        } else {
            const int r = (int)r64;
            const int ns = paired ? 2 : 1;
            const int nu1 = s1.R / V, nu = nu1 + (paired ? s2.R / V : 0);
            const int nrow = s1.R + (paired ? s2.R : 0);
            const int items = nu + (Wd - nrow);
            for (int it = j; it < items; it += G) {
                // fields are picked one by one: a reference to either
                // KeySide parameter would put both on the stack
                if (it < nu) {
                    const int m = it >= nu1;
                    const int u = it - (m ? nu1 : 0);
                    const int* src = (m ? s2.rows : s1.rows) +
                                     r * (m ? s2.R : s1.R) + u * V;
                    int* dst = o + (m ? s1.R : 0) + u * V;
                    if (V == 4) {
                        const int4 v = __ldg((const int4*)src);
                        dst[0] = v.x;
                        dst[1] = v.y;
                        dst[2] = v.z;
                        dst[3] = v.w;
                    } else if (V == 2) {
                        const int2 v = __ldg((const int2*)src);
                        dst[0] = v.x;
                        dst[1] = v.y;
                    } else {
                        dst[0] = __ldg(src);
                    }
                    continue;
                }
                int c = it - nu;
                int v;
                if (c == 0) {
                    v = (int)s1.has[r] + 4 * (int)s1.ovf[r] +
                        16 * kt_veto(s1, r, k, min_range);
                    if (paired)
                        v += 2 * (int)s2.has[r] + 8 * (int)s2.ovf[r] +
                             32 * kt_veto(s2, r, k, min_range);
                } else {
                    c -= 1;
                    if (tail_bs && c < 2 * ns) {
                        const int m = c >> 1;
                        v = (c & 1) ? (int)(m ? s2.strand : s1.strand)[r]
                                    : (m ? s2.block : s1.block)[r];
                    } else {
                        if (tail_bs) c -= 2 * ns;
                        const int m = c >> 1;
                        v = (c & 1) ? (m ? s2.rpos : s1.rpos)[r]
                                    : (m ? s2.upos : s1.upos)[r];
                    }
                }
                o[nrow + (it - nu)] = v;
            }
        }
    }
    __syncthreads();
    // the block's span [g0, g1): its unaligned head and tail a word a
    // thread, its body 16 bytes a thread
    const int g1 = g0 + nk * Wd;
    const int a0 = min((g0 + 3) & ~3, g1);
    const int a1 = max(g1 & ~3, a0);
    const int* st = stage + sb;  // st[g - g0] is output word g
    for (int g = g0 + (int)threadIdx.x; g < a0; g += blockDim.x)
        out[g] = st[g - g0];
    for (int g = a1 + (int)threadIdx.x; g < g1; g += blockDim.x)
        out[g] = st[g - g0];
    int4* o4 = (int4*)(out + a0);
    const int4* s4 = (const int4*)(st + (a0 - g0));
    for (int t = threadIdx.x; t < (a1 - a0) >> 2; t += blockDim.x) o4[t] = s4[t];
}

// The widest load (4, 2 or 1 words) that a mate's rows allow: row stride
// and base pointer aligned.
static int kf_vec(const KeySide* s) {
    const unsigned long long p = (unsigned long long)s->rows;
    if (s->R % 4 == 0 && p % 16 == 0) return 4;
    if (s->R % 2 == 0 && p % 8 == 0) return 2;
    return 1;
}

extern "C" int gather_exemplars(const KeySide* s1, const KeySide* s2,
                                const void* idx, long long n, long long Bsrc,
                                int k, int min_range, int tail_bs,
                                int tail_pos, int Wd, void* out,
                                void* stream) {
    const int paired = s2 != 0;
    const int ns = paired ? 2 : 1;
    const int nrow = s1->R + (paired ? s2->R : 0);
    const int want = nrow + 1 + (tail_bs ? 2 * ns : 0) + (tail_pos ? 2 * ns : 0);
    if (Wd != want || (tail_pos && !tail_bs)) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    if (n * Wd >= (1LL << 31) || Bsrc * s1->R >= (1LL << 31) ||
        (paired && Bsrc * s2->R >= (1LL << 31)) ||
        ((unsigned long long)out & 15))
        return (int)cudaErrorInvalidValue;
    int V = kf_vec(s1);
    if (paired) V = min(V, kf_vec(s2));
    const int items = nrow / V + (Wd - nrow);
    int G = 4;
    while (G < items && G < 32) G <<= 1;
    const int kpb = 256 / G;
    const size_t smem = ((size_t)kpb * Wd + 4) * sizeof(int);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            gather_exemplars_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    KeySide none = *s1;
    gather_exemplars_kernel<<<(unsigned int)((n + kpb - 1) / kpb), 256, smem,
                              (cudaStream_t)stream>>>(
        *s1, paired ? *s2 : none, paired, (const long long*)idx, (int)n,
        (int)Bsrc, k, min_range, V, G, tail_bs, Wd, (int*)out);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------ kernel F, slim

__global__ void gather_slim_kernel(KeySide s1, KeySide s2,
                                   const long long* __restrict__ idx,
                                   long long n, long long Bsrc,
                                   int* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long r = idx[i];
    int* o = out + 5 * i;
    if (r < 0 || r >= Bsrc) {
        o[0] = o[1] = o[2] = o[3] = o[4] = 0;
        return;
    }
    o[0] = s1.rows[r * s1.R];
    o[1] = s1.rows[r * s1.R + 1];
    o[2] = s2.rows[r * s2.R];
    o[3] = s2.rows[r * s2.R + 1];
    o[4] = (int)s1.has[r] + 2 * (int)s2.has[r] + 4 * (int)s1.ovf[r] +
           8 * (int)s2.ovf[r];
}

// Kernel F's slim layout: out [n, 5] int32 of the pair reads idx.
extern "C" int gather_slim(const KeySide* s1, const KeySide* s2,
                           const void* idx, long long n, long long Bsrc,
                           void* out, void* stream) {
    if (n <= 0) return 0;
    if (s1->R < 2 || s2->R < 2) return (int)cudaErrorInvalidValue;
    gather_slim_kernel<<<(unsigned int)((n + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(
        *s1, *s2, (const long long*)idx, n, Bsrc, (int*)out);
    return (int)cudaGetLastError();
}
