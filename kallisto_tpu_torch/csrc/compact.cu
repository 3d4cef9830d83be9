// Kernels E and F of the compact steady state (E also with per-read
// slots, F also in its slim layout).
//
// Kernel E, compact_keys, is the steady state's whole key step in one C
// call: JAX's compact_pair_keys / compact_single_keys (kallisto_tpu/ops/
// pseudoalign.py :689, :716), i.e. _hash_columns_128 (:567) of each read's
// compact key, _compact_keys (:733) and _ck_flat (:789), and with slots
// _compact_read_slots (:774).  From one or two mates' SideResults and the
// key options (min_range veto bits, strand tail, position rank) it writes
// the flat [K+1, 5] int64 table whose row 0 is [n_uniq, n_fail = 0, 0, 0,
// 0] and whose rows 1..min(n_uniq, K) are [h0, h1, occ, first_idx, flags]
// of each distinct key.  As in JAX the dedup rides on h0 alone (two keys
// equal in h0 merge; h0 already hashes every key column), a key's payload
// is idx * 128 + flags and a key keeps its minimum payload, which gives its
// first read and that read's flags; both hash words come from that read.
// n_uniq is exact even past K.  Its launches count as kernel E's,
// ops/kernels.py LAUNCHES["key_histogram"] ("key_histogram_slots" with
// slots): kernel B's compact form no longer runs apart.
//
// It is not a copy of the TPU's sort network.  One allocation holds the
// table, the workspace and the outputs; one memset clears the workspace's
// table and look-back state, where all-zero means empty (a key word of 0
// is a free slot, a read whose h0 is 0 goes to the extra slot S; payloads
// are stored complemented and merged with atomicMax).  Then:
//   1. ke_insert, a block of KE_TILE reads: each thread hashes its read's
//      key with kernel B's key function (csrc/keys.cuh: 16-byte row
//      loads, the rank in the same thread), writes h to the workspace,
//      and inserts h0 into the block's own open-addressing table in
//      shared memory (count, minimum payload).  Then one thread per
//      distinct key of the block makes one insert into the global table
//      (S >= 2B slots, a power of two, linear probing): the claim, the add
//      of the block's count, the max of its complemented payload; each
//      read takes its global slot through its block entry.  So global
//      atomics follow the distinct keys of each block, not the reads: a
//      hot key (the no-hit key, padding reads, an abundant fragment)
//      costs one global update per block.  The block also zeroes its
//      share of the output table (grid-stride), so the table needs no
//      memset.
//   2. ke_rows: tiles of KE_TILE reads taken in order from a counter in
//      the workspace (never from blockIdx, so the look-back always waits
//      on tiles that run).  A read is its key's first read when the
//      slot's payload >> 7 is its own index (read after pass 1 ended); a
//      tile ranks its first reads with a block scan and gets its offset
//      by a decoupled look-back over the earlier tiles' published counts
//      (one 64-bit word a tile: 2 status bits and the count); the key of
//      global rank r goes to row 1 + r when r < K, and the last tile
//      writes n_uniq into the meta row.
//   3. ke_slots (with slots only): each read's row, its key's rank
//      (capped at K - 1 as in JAX), through the per-slot rank pass 2
//      writes for every first read.
// So a call makes 1 memset and 2 launches (3 with slots).
// Occupied rows come out in ascending first_idx (read order), which is
// deterministic although the table's slots depend on the order of
// inserts.  JAX orders them by ascending signed h0; the host
// (quant/ecmap.py process_compact_parts) stable-sorts by first_idx anyway,
// so the outputs are identical.  Rows past min(n_uniq, K) are zero.
//
// With slots (the wave-2 slices of host wave 1) each read gets the row of
// its key in THIS table.  JAX's slot is the key's rank in ascending signed
// h0, because its rows are in that order; here rows are in first-read
// order, so the slot is the row E gave the key, not JAX's rank -- the two
// name the same key.
//
// Given h [B, 2] and flags [B] instead of SideResults (h_in), pass 1 takes
// those keys as they are: the tests hold the table on keys no read could
// be made to hash to (h0 = 0, h0 = -1, one key on most reads).
//
// What bounds E on the H100: bytes.  Per read it reads its key columns
// (64 B of rows a mate at R = 16, 2-3 flag bytes, the tail fields with
// options) and writes 16 B of h and 4 of slot; per distinct key of a block
// it touches about three random 32 B sectors of the global table, per read
// one in pass 2; it writes 40 B per distinct key.  The table for a
// 262,144-read batch is 10 MB, inside the 50 MB L2.  A hot key costs
// nothing extra: on chip_smoke.py phase 3b's batch (262,144 pairs, 89,250
// keys; NVIDIA H100 80GB HBM3, 700 W) E took 0.038 ms of device time on
// the batch's keys given as keys and 0.026 ms with 60 % of the reads moved
// onto one key -- fewer distinct keys, fewer global inserts.
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

#include "keys.cuh"

#define KT_FULL 0xffffffffu

// ------------------------------------------------------------- kernel E

#define KE_TILE 512  // reads of a block, in passes 1 and 2
// a block's own table: 2 x its reads, so a block (at most KE_TILE
// distinct keys) never fills it
#define KE_LSLOTS (2 * KE_TILE)
#define KE_AGG (1ULL << 62)  // look-back word: the tile's own count
#define KE_PRE (2ULL << 62)  // look-back word: the inclusive prefix
#define KE_VAL ((1ULL << 62) - 1)

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

// Pass 1 (see the file header): key, block table, one global insert per
// distinct key of the block; zeroes the output table's words (ck2 pairs,
// then the odd last word ck_tail).
__global__ void __launch_bounds__(KE_TILE) ke_insert(
    KeySide s1, KeySide s2, int paired, KeyOpts o, int V1, int V2,
    const ulonglong2* __restrict__ h_in, const int* __restrict__ flags_in,
    int B, long long S, unsigned long long* keys, unsigned int* cnt,
    unsigned long long* npay, int* __restrict__ read_slot,
    ulonglong2* __restrict__ h_ws, int* __restrict__ flags_out,
    ulonglong2* __restrict__ ck2, long long ck_pairs,
    long long* __restrict__ ck_tail) {
    __shared__ unsigned long long lkey[KE_LSLOTS + 1];
    __shared__ unsigned long long lpay[KE_LSLOTS + 1];
    __shared__ unsigned int lcnt[KE_LSLOTS + 1];
    __shared__ int lslot[KE_LSLOTS + 1];
    const int tid = threadIdx.x;
    for (int j = tid; j <= KE_LSLOTS; j += KE_TILE) {
        lkey[j] = 0;
        lpay[j] = 0;
        lcnt[j] = 0;
    }
    for (long long q = (long long)blockIdx.x * KE_TILE + tid; q < ck_pairs;
         q += (long long)gridDim.x * KE_TILE)
        ck2[q] = make_ulonglong2(0ULL, 0ULL);
    if (ck_tail && blockIdx.x == 0 && tid == 0) *ck_tail = 0;
    __syncthreads();
    const int i = blockIdx.x * KE_TILE + tid;
    int ls = KE_LSLOTS;
    if (i < B) {
        unsigned long long h0, h1;
        int flags;
        if (h_in) {
            const ulonglong2 v = h_in[i];
            h0 = v.x;
            h1 = v.y;
            flags = flags_in[i];
        } else {
            KeyHash h;
            flags = kt_compact_key(h, s1, s2, paired, o, i, V1, V2);
            h0 = h.w0();
            h1 = h.w1();
        }
        h_ws[i] = make_ulonglong2(h0, h1);
        if (flags_out) flags_out[i] = flags;
        if (h0 != 0) {
            ls = (int)(h0 & (KE_LSLOTS - 1));
            while (true) {
                const unsigned long long prev = atomicCAS(&lkey[ls], 0ULL, h0);
                if (prev == 0 || prev == h0) break;
                ls = (ls + 1) & (KE_LSLOTS - 1);
            }
        }
        atomicAdd(&lcnt[ls], 1u);
        atomicMax(&lpay[ls], ~((unsigned long long)i * 128ULL +
                               (unsigned long long)(unsigned int)flags));
    }
    __syncthreads();
    for (int j = tid; j <= KE_LSLOTS; j += KE_TILE) {
        const unsigned int c = lcnt[j];
        if (c == 0) continue;
        long long s = S;
        if (j < KE_LSLOTS) {
            const unsigned long long key = lkey[j];
            s = (long long)(key & (unsigned long long)(S - 1));
            while (true) {
                const unsigned long long prev = atomicCAS(&keys[s], 0ULL, key);
                if (prev == 0 || prev == key) break;
                s = (s + 1) & (S - 1);
            }
        }
        atomicAdd(&cnt[s], c);
        atomicMax(&npay[s], lpay[j]);
        lslot[j] = (int)s;
    }
    __syncthreads();
    if (i < B) read_slot[i] = lslot[ls];
}

// The decoupled look-back of tile t (warp 0 of its block): publishes the
// tile's count, sums the earlier tiles' words 32 at a time back to the
// nearest inclusive prefix, publishes its own inclusive prefix; returns
// the exclusive one.  Earlier tiles took their ids from the counter
// before t, so they run and publish without waiting on t.
__device__ long long ke_look_back(unsigned long long* tstate, int t,
                                  int total) {
    const int lane = threadIdx.x & 31;
    volatile unsigned long long* st = tstate;
    if (t == 0) {
        if (lane == 0) st[0] = KE_PRE | (unsigned long long)total;
        return 0;
    }
    if (lane == 0) st[t] = KE_AGG | (unsigned long long)total;
    long long excl = 0;
    int end = t;  // this window: tiles [end - 32, end)
    while (true) {
        const int j = end - 32 + lane;
        unsigned long long v;
        do {
            v = j >= 0 ? st[j] : KE_PRE;
        } while (__any_sync(KT_FULL, (v >> 62) == 0));
        const unsigned int pre = __ballot_sync(KT_FULL, (v >> 62) == 2);
        const int from = pre ? 31 - __clz(pre) : 0;
        long long x = lane >= from ? (long long)(v & KE_VAL) : 0;
        for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(KT_FULL, x, d);
        excl += x;
        if (pre) break;
        end -= 32;
    }
    if (lane == 0) st[t] = KE_PRE | (unsigned long long)(excl + total);
    return excl;
}

// Pass 2: first reads, their global rank and their rows.
__global__ void __launch_bounds__(KE_TILE) ke_rows(
    const ulonglong2* __restrict__ h_ws, const unsigned int* __restrict__ cnt,
    const unsigned long long* __restrict__ npay,
    const int* __restrict__ read_slot, int B, int nt, long long K,
    unsigned long long* tstate, unsigned int* tile_ctr,
    long long* __restrict__ ck, int* __restrict__ slot_rank) {
    __shared__ int s_tile;
    __shared__ long long s_excl;
    if (threadIdx.x == 0) s_tile = (int)atomicAdd(tile_ctr, 1u);
    __syncthreads();
    const int t = s_tile;
    const int i = t * KE_TILE + threadIdx.x;
    int s = 0, first = 0;
    unsigned long long pay = 0;
    if (i < B) {
        s = read_slot[i];
        pay = ~npay[s];
        first = (long long)(pay >> 7) == (long long)i;
    }
    int total;
    const int ex = kt_block_scan(first, &total);
    if (threadIdx.x < 32) {
        const long long excl = ke_look_back(tstate, t, total);
        if (threadIdx.x == 0) s_excl = excl;
    }
    __syncthreads();
    const long long excl = s_excl;
    if (first) {
        const long long r = excl + ex;
        if (slot_rank) slot_rank[s] = (int)r;
        if (r < K) {
            const ulonglong2 hh = h_ws[i];
            long long* row = ck + 5 * (1 + r);
            row[0] = (long long)hh.x;
            row[1] = (long long)hh.y;
            row[2] = (long long)cnt[s];
            row[3] = i;
            row[4] = (long long)(pay & 127ULL);
        }
    }
    if (t == nt - 1 && threadIdx.x == 0) ck[0] = excl + total;  // n_uniq
}

// Pass 3 (with slots): each read's row, capped at K - 1.
__global__ void ke_slots(const int* __restrict__ read_slot,
                         const int* __restrict__ slot_rank, int B,
                         long long K, int* __restrict__ slots) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    const long long r = slot_rank[read_slot[i]];
    slots[i] = (int)(r < K - 1 ? r : K - 1);
}

// Word offsets (8 bytes a word) of one call's allocation, which
// compact_keys_layout hands to ops/kernels.py.  The table ck comes first;
// [keys, h) is the workspace the memset clears.
struct KeLayout {
    long long keys, npay, ts, ctr, cnt, h, rslot, srank, slots, flags, end;
};

static KeLayout ke_layout(long long B, long long K, long long S,
                          int with_slots, int want_flags) {
    KeLayout l;
    const long long nt = (B + KE_TILE - 1) / KE_TILE;
    l.keys = 5 * (K + 1);
    l.npay = l.keys + S + 1;
    l.ts = l.npay + S + 1;
    l.ctr = l.ts + nt;
    l.cnt = l.ctr + 1;
    l.h = l.cnt + (S + 2) / 2;
    l.h += l.h & 1;  // 16-byte aligned
    l.rslot = l.h + 2 * B;
    l.srank = l.rslot + (B + 1) / 2;
    l.slots = l.srank + (with_slots ? (S + 2) / 2 : 0);
    l.flags = l.slots + (with_slots ? (B + 1) / 2 : 0);
    l.end = l.flags + (want_flags ? (B + 1) / 2 : 0);
    return l;
}

static long long ke_slots_of(long long B) {
    long long S = 2;
    while (S < 2 * B) S <<= 1;
    return S;
}

// The allocation compact_keys takes for B reads and K rows: out = {h,
// slots, flags, total} in 8-byte words (h, slots and flags as offsets).
extern "C" int compact_keys_layout(long long B, long long K, int with_slots,
                                   int want_flags, long long* out) {
    if (K < 1 || B < 0 || B >= (1LL << 30)) return (int)cudaErrorInvalidValue;
    const KeLayout l = ke_layout(B, K, ke_slots_of(B), with_slots, want_flags);
    out[0] = l.h;
    out[1] = l.slots;
    out[2] = l.flags;
    out[3] = l.end;
    return 0;
}

// Kernel E (see the file header).  ws: ws_words 8-byte words laid out by
// ke_layout (16-byte aligned): the table ck [K+1, 5] int64, the
// workspace, h [B, 2], the slots [B] int32 with with_slots and the flags
// [B] int32 with want_flags.  The keys come from s1 (and s2 when paired)
// under the options o, or, with h_in set, from h_in [B, 2] and flags_in [B].
extern "C" int compact_keys(const KeySide* s1, const KeySide* s2,
                            const KeyOpts* o, const void* h_in,
                            const void* flags_in, long long B, long long K,
                            int with_slots, int want_flags, void* ws,
                            long long ws_words, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (K < 1 || B < 0 || B >= (1LL << 30) || ((unsigned long long)ws & 15) ||
        ((unsigned long long)h_in & 15) || (h_in != 0) != (flags_in != 0))
        return (int)cudaErrorInvalidValue;
    if (h_in == 0 && (s1 == 0 || o == 0 || s1->R <= 0 ||
                      (s2 != 0 && s2->R <= 0) ||
                      (o->pf_ptr != 0 &&
                       (o->pf_base == 0 || o->pos_depth < 0))))
        return (int)cudaErrorInvalidValue;
    const long long S = ke_slots_of(B);
    const KeLayout l = ke_layout(B, K, S, with_slots, want_flags);
    if (ws_words != l.end) return (int)cudaErrorInvalidValue;
    long long* w = (long long*)ws;
    if (B == 0)
        return (int)cudaMemsetAsync(w, 0, (size_t)(5 * (K + 1)) * 8, st);
    cudaError_t e = cudaMemsetAsync(w + l.keys, 0, (size_t)(l.h - l.keys) * 8,
                                    st);
    if (e != cudaSuccess) return (int)e;
    const int paired = s2 != 0;
    KeySide none = {};
    KeyOpts no = {};
    const int V1 = h_in ? 1 : kt_vec(s1);
    const int V2 = (h_in == 0 && paired) ? kt_vec(s2) : 1;
    const long long ck_words = 5 * (K + 1);
    const int nt = (int)((B + KE_TILE - 1) / KE_TILE);
    ke_insert<<<(unsigned int)nt, KE_TILE, 0, st>>>(
        h_in ? none : *s1, (h_in == 0 && paired) ? *s2 : none, paired,
        h_in ? no : *o, V1, V2, (const ulonglong2*)h_in,
        (const int*)flags_in, (int)B, S, (unsigned long long*)(w + l.keys),
        (unsigned int*)(w + l.cnt), (unsigned long long*)(w + l.npay),
        (int*)(w + l.rslot), (ulonglong2*)(w + l.h),
        want_flags ? (int*)(w + l.flags) : 0, (ulonglong2*)w, ck_words / 2,
        (ck_words & 1) ? w + ck_words - 1 : 0);
    ke_rows<<<(unsigned int)nt, KE_TILE, 0, st>>>(
        (const ulonglong2*)(w + l.h), (const unsigned int*)(w + l.cnt),
        (const unsigned long long*)(w + l.npay), (const int*)(w + l.rslot),
        (int)B, nt, K, (unsigned long long*)(w + l.ts),
        (unsigned int*)(w + l.ctr), w,
        with_slots ? (int*)(w + l.srank) : 0);
    if (with_slots)
        ke_slots<<<(unsigned int)((B + 255) / 256), 256, 0, st>>>(
            (const int*)(w + l.rslot), (const int*)(w + l.srank), (int)B, K,
            (int*)(w + l.slots));
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------- kernel F

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
    int V = kt_vec(s1);
    if (paired) V = min(V, kt_vec(s2));
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
