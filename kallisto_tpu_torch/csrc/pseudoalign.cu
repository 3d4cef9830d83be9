// Kernels A, D, I, K and J: per-read k-mer -> sorted distinct EC rows;
// kernel L: the k-mer probe alone.
//
// The probe (kt_probe), K2 of the JAX package, in both index layouts:
//   bucketed -- kallisto_tpu/ops/pseudoalign.py lookup_kmers :367-382: a
//     bucket_start pair, then a fixed-depth lower_bound over the bucket's
//     sorted keys, then kmer_ec at the slot;
//   padded -- PaddedDeviceIndex (:60-84, built :275-300, probed :325-365;
//     the layout of indexes whose 2^p * S * 16 bytes of bucket rows fit
//     1 GiB): one [2S] u64 row per bucket, S keys then S EC rows.  The
//     lane reads its bucket's S keys as 16-byte vectors (S = 8: 64 bytes,
//     two sectors), compares its query with each, and on a match reads
//     the EC row from the same row's second half.
// The layout is a field of IndexView, the same for every lane of a
// launch, so kt_probe branches on it at run time (uniform over the warp):
// one body per kernel, no template instantiation.  The padded branch
// keeps no state across the kernels' loops (its S-key loop ends inside
// kt_probe), so it costs few registers: with it ptxas reports A 48, D 55,
// I 80, K 56, J 80 (a run of windows in registers) and L 34 registers and no spills (-Xptxas -v, which
// ops/kernels.py passes for this file; printed at every build), and the
// branch stays.
// What bounds the padded probe on the H100: per valid window, ceil(8S/32)
// key sectors plus one EC sector per hit, in a single dependent round
// (the EC sector lies in the row's own 128-byte line once S <= 8).  The
// bucketed probe reads a bucket_start sector, then 1-4 key sectors along
// a chain of up to 6 dependent steps, then a kmer_ec sector.  So the
// padded layout spends up to 2^p * S * 16 bytes of memory (at most 1 GiB)
// to replace two to eight dependent DRAM round trips by one.
//
// Kernel L, lookup_kmers, is K2 taken alone: a grid-stride kernel over
// [n] canonical k-mers and their valid mask that returns (slot int64, hit
// bool, EC row int32) through kt_probe, equal to the plain lookup_kmers
// of ops/pseudoalign.py in both layouts.  No run loop launches it; it is
// the yardstick of the probe (chip_smoke.py times it in both layouts).
//
// Kernel A, pseudoalign_side, replaces the JAX device program
// kallisto_tpu/ops/pseudoalign.py pseudoalign_batch_packed (:479) with its
// body: unpack_codes_device (:469), rolling_canonical_kmers (:385), the
// bucketed lookup_kmers (:316-382, with _mix64_jnp :109) and
// _pseudoalign_core (:504-564).
//
// Kernel D, pseudoalign_turbo, replaces the decode and core of the turbo
// steady state, kallisto_tpu/ops/turbo.py pair_turbo_core (:104) and
// single_turbo_core (:254) as reached through pseudoalign_pair_turbo(_varlen)
// and pseudoalign_single_turbo(_varlen) (:131-150, :268-289):
// _codes_and_lens (:74, with _codes_from_packed, pseudoalign.py:924) and the
// same _pseudoalign_core.  It takes one or two mates' packed codes without an
// N bitmask, and an aux vector [rlen, n_real, 0, 0, N positions ascending,
// INT64_MAX pad]; each read finds its own N positions by binary search, its
// length is (read % Bp < n_real) ? (lens ? lens[read] : rlen) : 0, and with
// 0 < rl < Lp only the first rl columns count.  Exception indices address the
// padded [ns*Bp, Lp] matrix (row stride Lp), so an exception at a column >= rl
// is dropped by the trim.
//
// Both produce the ten SideResult fields, equal in every bit to the plain
// PyTorch versions in kallisto_tpu_torch/ops/pseudoalign.py and ops/turbo.py.
// They share one per-read device function; only the decode into shared
// memory differs.
//
// Design: one warp per read (grid-stride over reads).  The warp decodes the
// read's codes into shared memory, then walks the W = Lc - k + 1 windows in
// chunks of 32 (one window per lane).  Each lane builds its window's forward
// and reverse-complement k-mers directly from the shared codes, takes
// canon = min(f, r), mixes it with splitmix64 and probes the index with
// kt_probe (the bucket's row, or the lower_bound inside the bucket).  The window's EC row goes to
// shared memory; ballots give has_hits, the leftmost hit (its slot and
// orientation come over a shuffle) and the last hit.  The R = min(16, W)
// smallest distinct rows then come from R rounds of masked warp minimum
// (__reduce_min_sync) over the shared rows, and one more pass decides
// `overflow` exactly as _pseudoalign_core :534-536.
//
// What bounds them on the H100: the random reads into the k-mer table.  Per
// valid window of a bucketed index: one 32-byte sector of bucket_start, the
// 1-4 sectors of the bucket's sorted keys that the binary search touches (a
// bucket holds < 64 keys, <= 512 contiguous bytes), and for a hit one
// sector of kmer_ec; of a padded index the row's key and EC sectors (see
// kt_probe).  At realistic size the table (~1 GB) does not fit in the
// 50 MB L2, so these are DRAM sector reads; the k-mer build itself is a
// few hundred integer operations per window and never the limit.  What
// the design does about it: a large index keeps the unpadded bucketed
// layout (8N + 4N bytes), invalid windows skip the lookup entirely, the
// search stops as
// soon as its range is empty, and all 32 lanes of a warp issue their
// lookups together so the memory system sees 32 independent requests per
// warp.  Kernel D also trims the padding columns that a byte-aligned Lp
// adds (rl < Lp), which removes their probes, and reads 25 bytes per
// 100 bp read instead of 25 + 13.  A simple kernel that is right comes
// first; see PERF.md.
//
// Trap kept on purpose: a read without hits still reports f_strand from
// window 0's lookup slot (JAX argmax of an all-false row is 0), so window 0
// is always looked up (with q = mix64(0) when it is invalid).  Padding reads
// of kernel D have length 0 and follow the same rule.
//
// Kernel I, pseudoalign_anchor, replaces the two-wave anchor program,
// kallisto_tpu/ops/anchor.py _anchor_canon (:66), _anchor_side (:85) and
// _apply_aux (:189) as reached through pseudoalign_pair_anchor (:218) and
// pseudoalign_single_anchor (:249); the keys and the table after it are
// kernels B and E.  It takes kernel D's inputs (uniform length: rlen and
// n_real from the aux vector) and shares its decode.  Per read, one warp:
//   wave 1 -- lanes 0..n_anchors-1 (32 at a time) each build one anchor's
//     window w_j = (wlast * j) / (n_anchors - 1), wlast = max(rlen - k, 0),
//     look it up (anchor 0 even when invalid, for f_strand), and read its
//     uid, pos, fw and block on a hit.  __all_sync gives "every anchor hits
//     one unitig on one strand at upos_0 + sgn * w_j"; warp min/max give
//     the block range [blo, bhi].  A verified read (also blo >= 0, the
//     range within two 8-wide rows of block_ec8, the read real and >= k
//     long) takes the sorted distinct block ECs of that range, 16 lanes
//     loading the two rows and R rounds of __reduce_min_sync; its first
//     hit is anchor 0 with f_rpos = 0 and rng = wlast.
//   wave 2 -- any other real read of length >= k goes straight on into
//     kt_side_read, kernel D's per-read core.  JAX packs these reads into a
//     fixed-size sub-batch with a stable argsort, for the TPU's static
//     shapes; a warp per read needs neither.  The core's rows number
//     min(R, W); a one-slot row fills all R slots, as JAX's broadcast does
//     (the wrapper refuses 1 < min(R, W) < R, where JAX raises).
//   n_fail -- wave-2 reads, counted per block in shared memory and added
//     once per block into an int64 on the card (the anchor functions put
//     it in the key table's meta row).  There is no wave-2 capacity: JAX's
//     overflow marker and redo exist only for its fixed-size sub-batch.
// What bounds it: the same random table reads as D, for n_anchors lookups
// per verified read instead of W, plus D's per-window reads for the
// wave-2 share (51 % of reads on the smoke's simulated 2x100 bp data).
// What the design does about it: verified reads cost n_anchors lookups
// and two 32-byte block_ec8 rows; a failing read pays what kernel D pays
// and nothing more (no second pass, no compaction).  Warps of verified and
// failing reads finish at different times; balancing them is later work.
//
// Kernel K, pseudoalign_halffail, replaces the half-fail wave 2 of host
// wave 1, kallisto_tpu/ops/turbo.py _verified_side_from_summary (:153) and
// halffail_core (:203) as reached through pseudoalign_pair_halffail (:244);
// the keys, the table and the per-read slots after it are kernels B and E.
// Its pairs had exactly one mate fail the host probe (ops/hostprobe.py):
// only that mate's packed codes come up ([Bp, Lp/4], kernel D's aux vector
// for its Ns and n_real, uniform length), with the other mate's 8-byte
// summary (blo; upos0<<5 | span<<1 | strand) and sidev (1: mate 1 failed,
// anything else: mate 2).  Per pair, one warp:
//   the failed mate -- kernel D's decode and kt_side_read, R = min(max_rows,
//     W) rows (the core's clamp);
//   the verified mate -- rebuilt as kernel I rebuilds a verified read: the
//     sorted distinct block ECs of [blo, blo + span], 16 lanes loading the
//     two block_ec8 rows of r0 = max(blo, 0) >> 3 and min(R, 16) rounds of
//     __reduce_min_sync, the rest of the R slots INT32_MAX, with the SAME
//     width R as the failed mate (JAX turbo.py:215-221); first hit block
//     blo (forward) or blo + span (reverse), upos0, f_rpos 0, f_uid 0, rng
//     len - k.  A padding pair (row >= n_real) stays no-hit on both mates.
// What bounds it: the failed mate's table reads, as kernel D's; the
// verified mate costs one 64-byte read of block_ec8 and 8 bytes of summary
// instead of W lookups.  Only the failed mate uploads, so the batch moves
// Lp/4 + 12 bytes per pair instead of Lp/2.
//
// Kernel J, pseudoalign_long, replaces the long-read program,
// kallisto_tpu/ops/pseudoalign.py pseudoalign_long_packed (:1082-1151).
// Per read of a [B, Lp] packed batch (kernel A's packed codes + N bitmask)
// it gives, with W = Lp - k + 1: unmapped (valid windows minus hits; every
// window is evaluated, --no-jump semantics), the first R = min(64, W) of
// the sorted distinct non-empty EC rows of the hits with their exact count
// n_rows, has_hits, and the ordered (uid, EC row) groups -- a hit opens a
// group when no earlier hit exists or its uid or EC row differs from the
// LAST EARLIER HIT's -- written at their index below G (-2 elsewhere),
// with their exact count n_groups.
// Design: a persistent grid (the blocks of 256 threads that the SMs hold
// at once) whose blocks take reads from a counter on the card, so a long
// read holds one block while the others go on with the rest.  A block
// walks its read's own windows (w < len - k + 1: the batch's padded tail
// windows are never valid) in tiles of 1,024: it decodes the tile's
// codes into shared memory, then each thread takes a run of 4
// consecutive windows, builds the first k-mer once and rolls the forward
// and reverse-complement k-mers one base at a time, and issues the
// run's probes (kt_probe, then kmer_uid on a hit) before it looks at any
// of them, holding each window's (uid, EC row) or miss in registers.
// Then ONE scan runs over the tile in window order: each thread finds
// its run's first and last hit and the groups that its later hits open;
// a block-wide max-scan of "run has a hit" gives each run its previous
// hit (the last hit of the runs before it, or of earlier tiles: a
// carry), which decides whether its first hit opens a group; one
// add-scan of the packed counts (groups, groups with EC row >= 0) gives
// each opener its group index and its slot in the read's row list.  So
// a tile of 1,024 windows pays one set of barriers where the first
// design paid one per 256.  Every hit's EC row equals its group's, so
// the distinct rows of the hits are the distinct rows of the group
// openers: only those are listed -- the first 512 in shared memory, any
// more in the block's slice of a global spill (mosaic reads) -- then
// bitonic-sorted in place, and an add-scan of "differs from its left
// neighbour" gives n_rows and each distinct row's rank.  Scans are warp
// shuffles plus one pass over the eight warp totals.  The block's shared
// memory is fixed (~6 KB) whatever the batch's padded length.
// What bounds it: as kernel A, the random reads into the k-mer table (a
// padded bucket row's key sectors, or a bucket_start sector and the
// search's key sectors, and an EC sector per hit), plus a kmer_uid sector
// per hit; chip_smoke.py counts each table sector once (_sector_ids).
// What the design does about it: the padded tail windows of short reads
// cost nothing, invalid windows skip the lookup, and no barrier stands
// between a tile's 1,024 probes.  On the card (PERF.md) the time hardly
// moved with the run length (2, 4 or 8 windows), with a register cap for
// more resident blocks, or with the run's probes issued in lockstep
// (each tried, not kept): what is left is the latency of the
// dependent random table reads of each window (bucket_start, key, EC row,
// kmer_uid), several times the bound that counts each sector once.

#include <cuda_runtime.h>

#define KT_INT32_MAX 2147483647
#define KT_DEPTH 6
#define KT_FULL 0xffffffffu

// The device index in either layout (struct IndexView in ops/kernels.py,
// passed by pointer).  Bucketed (S == 0): hkeys, bucket_start and ec, N
// keys.  Padded (S > 0): rows, 2^p buckets of S slots, N = 2^p * S.  The
// payloads uid, pos, fw and block have N entries in slot order.
struct IndexView {
    const unsigned long long* hkeys;  // bucketed: [N] mixed keys, sorted
    const int* bucket_start;          // bucketed: [2^p + 1]
    const int* ec;                    // bucketed: [N] EC row, -1 = wildcard
    const unsigned long long* rows;   // padded: [2^p, 2S] S keys, S EC rows
    const int* uid;                   // [N]
    const int* pos;                   // [N]
    const unsigned char* fw;          // [N] bool
    const int* block;                 // [N]
    long long N;
    int p;
    int S;                            // padded slots per bucket, 0 = bucketed
};

struct SideOut {
    int* rows;                        // [B, R]
    int* n_rows;
    unsigned char* has_hits;
    unsigned char* overflow;
    int* f_uid;
    int* f_block;
    int* f_upos;
    int* f_rpos;
    unsigned char* f_strand;
    int* rng;
};

__device__ __forceinline__ unsigned long long kt_mix64(unsigned long long x) {
    x ^= x >> 30;
    x *= 0xBF58476D1CE4E5B9ULL;
    x ^= x >> 27;
    x *= 0x94D049BB133111EBULL;
    x ^= x >> 31;
    return x;
}

// Branchless-equivalent bucketed lower_bound of lookup_kmers :367-382; the
// loop stops once the range is empty, which changes no result.
__device__ __forceinline__ long long kt_lookup(const IndexView& ix,
                                               unsigned long long q) {
    long long b = (long long)(q >> (64 - ix.p));
    long long lo = ix.bucket_start[b];
    long long n = (long long)ix.bucket_start[b + 1] - lo;
    for (int s = 0; s < KT_DEPTH && n > 0; ++s) {
        long long half = n >> 1;
        long long m = lo + half;
        if (m > ix.N - 1) m = ix.N - 1;
        if (ix.hkeys[m] < q) {
            lo = m + 1;
            n = n - half - 1;
        } else {
            n = half;
        }
    }
    return lo < ix.N - 1 ? lo : ix.N - 1;
}

// K2's probe in either layout: the slot of mixed key q in *idx, its EC
// row in *ec (-1 on a miss), and whether q is in the index.  The layout
// is a kernel argument, so the branch is uniform over the whole launch.
// Padded: the S keys of q's bucket row, 16 bytes a load; a match at j
// gives the slot b * S + j and the EC row from the low word of entry
// S + j of the same row; a miss gives b * S (JAX's argmax of an
// all-false row).  The mixed keys are distinct, so at most one slot
// matches a key of the index.
__device__ __forceinline__ int kt_probe(const IndexView& ix,
                                        unsigned long long q, long long* idx,
                                        int* ec) {
    if (ix.S) {
        const int S = ix.S;
        const long long b = (long long)(q >> (64 - ix.p));
        const unsigned long long* row = ix.rows + b * 2 * S;
        int j = -1;
        if (S == 1) {
            if (__ldg(row) == q) j = 0;
        } else {
            const ulonglong2* r2 = (const ulonglong2*)row;
#pragma unroll 4
            for (int h = 0; h < (S >> 1); ++h) {
                const ulonglong2 v = __ldg(r2 + h);
                if (j < 0 && v.x == q) j = 2 * h;
                if (j < 0 && v.y == q) j = 2 * h + 1;
            }
        }
        *idx = b * S + (j < 0 ? 0 : j);
        *ec = j < 0 ? -1 : (int)(unsigned int)__ldg(row + S + j);
        return j >= 0;
    }
    const long long i = kt_lookup(ix, q);
    const int hit = ix.hkeys[i] == q;
    *idx = i;
    *ec = hit ? ix.ec[i] : -1;
    return hit;
}

// One read, one warp: codes (W + k - 1 of them) are in shared memory;
// wrows is W ints of shared scratch.  Writes the read's SideResult row: R
// row slots at a row stride of RS >= R.
__device__ void kt_side_read(const IndexView& ix,
                             const unsigned char* codes, int* wrows,
                             long long read, int len, int W, int k, int R,
                             int RS, const SideOut& o) {
    const int lane = threadIdx.x & 31;
    int has = 0, first = 0, last = 0;
    long long fidx = 0;
    int ffw = 0;
    for (int base = 0; base < W; base += 32) {
        const int w = base + lane;
        int hit = 0;
        long long idx = 0;
        int isfw = 0;
        if (w < W) {
            unsigned long long f = 0, r = 0;
            int bad = 0;
            for (int d = 0; d < k; ++d) {
                const int c = codes[w + d];
                bad |= c >> 2;
                const unsigned long long cc = (unsigned long long)(c & 3);
                f = (f << 2) | cc;
                r |= (3ULL - cc) << (2 * d);
            }
            const int valid = !bad && (w + k <= len);
            isfw = f <= r;
            int ecv = -1;
            if (valid || w == 0) {
                const unsigned long long q =
                    kt_mix64(valid ? (isfw ? f : r) : 0ULL);
                int e;
                hit = kt_probe(ix, q, &idx, &e) && valid;
                if (hit) ecv = e;
            }
            wrows[w] = (hit && ecv >= 0) ? ecv : KT_INT32_MAX;
        }
        const unsigned int hb = __ballot_sync(KT_FULL, hit);
        // window 0 stands in for the first hit of a read without hits
        const int src = hb ? __ffs(hb) - 1 : 0;
        const long long sidx = __shfl_sync(KT_FULL, idx, src);
        const int sfw = __shfl_sync(KT_FULL, isfw, src);
        if ((base == 0) || (hb && !has)) {
            fidx = sidx;
            ffw = sfw;
        }
        if (hb) {
            if (!has) first = base + src;
            has = 1;
            last = base + 31 - __clz(hb);
        }
    }
    __syncwarp();

    // R smallest distinct non-empty rows: R rounds of masked warp minimum
    int prev = -1, nr = 0;
    for (int s = 0; s < R; ++s) {
        int m = KT_INT32_MAX;
        if (prev != KT_INT32_MAX) {
            for (int w = lane; w < W; w += 32) {
                const int v = wrows[w];
                if (v > prev && v < m) m = v;
            }
            m = __reduce_min_sync(KT_FULL, m);
        }
        if (lane == 0) o.rows[read * RS + s] = m;
        if (m != KT_INT32_MAX) {
            prev = m;
            ++nr;
        } else {
            prev = KT_INT32_MAX;  // nothing left: fill the rest
        }
    }
    // overflow: a distinct row beyond the R smallest (core :534-536).
    // Only possible when all R rounds found a row; prev is then the R-th.
    int ov = 0;
    if (nr == R) {
        for (int w = lane; w < W; w += 32) {
            const int v = wrows[w];
            ov |= (v > prev) && (v != KT_INT32_MAX);
        }
    }
    ov = __any_sync(KT_FULL, ov);

    if (lane == 0) {
        o.n_rows[read] = nr;
        o.has_hits[read] = (unsigned char)has;
        o.overflow[read] = (unsigned char)ov;
        o.f_strand[read] = (unsigned char)(ffw == (int)(ix.fw[fidx] != 0));
        o.f_uid[read] = has ? ix.uid[fidx] : -1;
        o.f_block[read] = has ? ix.block[fidx] : -1;
        o.f_upos[read] = has ? ix.pos[fidx] : -1;
        o.f_rpos[read] = has ? first : -1;
        o.rng[read] = has ? last - first : -1;
    }
    __syncwarp();
}

__global__ void pseudoalign_side_kernel(
    IndexView ix,
    const unsigned char* __restrict__ packed,  // [B, Lp/4]
    const unsigned char* __restrict__ nmask,   // [B, Lp/8]
    const int* __restrict__ lens,              // [B]
    int B, int Lp, int k, int R, int warp_bytes, SideOut o) {
    extern __shared__ int kt_smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wpb = blockDim.x >> 5;
    const int W = Lp - k + 1;
    const int code_bytes = (Lp + 15) & ~15;
    unsigned char* codes = (unsigned char*)kt_smem + (long long)warp * warp_bytes;
    int* wrows = (int*)(codes + code_bytes);
    const int LB = Lp >> 2;
    const int NB = Lp >> 3;

    for (long long read = (long long)blockIdx.x * wpb + warp; read < B;
         read += (long long)gridDim.x * wpb) {
        const unsigned char* pk = packed + read * LB;
        const unsigned char* nm = nmask + read * NB;
        for (int j = lane; j < Lp; j += 32) {
            int c = (pk[j >> 2] >> ((j & 3) * 2)) & 3;
            int isn = (nm[j >> 3] >> (j & 7)) & 1;
            codes[j] = (unsigned char)(isn ? 4 : c);
        }
        __syncwarp();
        kt_side_read(ix, codes, wrows, read, lens[read], W, k, R, R, o);
    }
}

// Kernel D's decode (also kernel I's): row `row` of one mate's packed
// codes, first Lc columns, into the warp's shared codes; this read's N
// positions [read * Lp, read * Lp + Lp) are found in the sorted exception
// list by binary search and set to 4 (columns >= Lc are dropped).
__device__ void kt_turbo_decode(unsigned char* codes,
                                const unsigned char* __restrict__ packed,
                                const long long* __restrict__ exc,
                                long long n_exc, long long read,
                                long long row, int Lp, int Lc) {
    const int lane = threadIdx.x & 31;
    const unsigned char* pk = packed + row * (Lp >> 2);
    for (int j = lane; j < Lc; j += 32)
        codes[j] = (unsigned char)((pk[j >> 2] >> ((j & 3) * 2)) & 3);
    __syncwarp();
    const long long lo_key = read * (long long)Lp;
    long long a = 0, n = n_exc;
    while (n > 0) {
        const long long half = n >> 1;
        if (exc[a + half] < lo_key) {
            a += half + 1;
            n -= half + 1;
        } else {
            n = half;
        }
    }
    for (long long e = a + lane; e < n_exc; e += 32) {
        const long long col = exc[e] - lo_key;
        if (col >= Lp) break;
        if (col < Lc) codes[col] = 4;
    }
    __syncwarp();
}

__global__ void pseudoalign_turbo_kernel(
    IndexView ix,
    const unsigned char* __restrict__ p1,      // [Bp, Lp/4] mate 1
    const unsigned char* __restrict__ p2,      // [Bp, Lp/4] mate 2 or null
    const long long* __restrict__ aux,         // [4 + n_exc]
    long long n_exc,
    const unsigned short* __restrict__ lens,   // [ns*Bp] or null
    long long Bp, int ns, int Lp, int Lc, int k, int R, int warp_bytes,
    SideOut o) {
    extern __shared__ int kt_smem[];
    const int warp = threadIdx.x >> 5;
    const int wpb = blockDim.x >> 5;
    const int W = Lc - k + 1;
    const int code_bytes = (Lc + 15) & ~15;
    unsigned char* codes = (unsigned char*)kt_smem + (long long)warp * warp_bytes;
    int* wrows = (int*)(codes + code_bytes);
    const long long rlen = aux[0];
    const long long n_real = aux[1];
    const long long* exc = aux + 4;
    const long long B = Bp * ns;

    for (long long read = (long long)blockIdx.x * wpb + warp; read < B;
         read += (long long)gridDim.x * wpb) {
        const long long row = read % Bp;
        kt_turbo_decode(codes, read < Bp ? p1 : p2, exc, n_exc, read, row, Lp,
                        Lc);
        int len = 0;
        if (row < n_real) len = lens ? (int)lens[read] : (int)rlen;
        kt_side_read(ix, codes, wrows, read, len, W, k, R, R, o);
    }
}

// Kernel I: one warp per read of the ns*Bp turbo reads (see the file header).
__global__ void pseudoalign_anchor_kernel(
    IndexView ix,
    const int* __restrict__ be8,               // [n_be8] block_ec8, flat
    long long n_be8,
    const unsigned char* __restrict__ p1,      // [Bp, Lp/4] mate 1
    const unsigned char* __restrict__ p2,      // [Bp, Lp/4] mate 2 or null
    const long long* __restrict__ aux,         // [4 + n_exc]
    long long n_exc, long long Bp, int ns, int Lp, int Lc, int k, int R,
    int Rc, int n_anchors, int warp_bytes, SideOut o,
    unsigned long long* __restrict__ n_fail) {
    extern __shared__ int kt_smem[];
    __shared__ unsigned int blk_fail;
    if (threadIdx.x == 0) blk_fail = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wpb = blockDim.x >> 5;
    const int W = Lc - k + 1;
    const int code_bytes = (Lc + 15) & ~15;
    unsigned char* codes = (unsigned char*)kt_smem + (long long)warp * warp_bytes;
    int* wrows = (int*)(codes + code_bytes);
    const int rlen = (int)aux[0];
    const long long n_real = aux[1];
    const long long* exc = aux + 4;
    const long long B = Bp * ns;
    const int long_enough = rlen >= k;
    const int wlast = rlen - k > 0 ? rlen - k : 0;
    const int n_gaps = n_anchors - 1;

    for (long long read = (long long)blockIdx.x * wpb + warp; read < B;
         read += (long long)gridDim.x * wpb) {
        const long long row = read % Bp;
        kt_turbo_decode(codes, read < Bp ? p1 : p2, exc, n_exc, read, row, Lp,
                        Lc);
        const int real = row < n_real;

        // wave 1: one anchor per lane, 32 at a time
        int all_ok = 1, blo = KT_INT32_MAX, bhi = -KT_INT32_MAX - 1;
        int uid0 = 0, upos0 = 0, str0 = 0, blk0 = 0, sgn = 1;
        for (int base = 0; base < n_anchors; base += 32) {
            const int j = base + lane;
            const int act = j < n_anchors;
            int hit = 0, uid = -1, upos = 0, strand = 0, blk = 0, w = 0;
            if (act) {
                w = (int)(((long long)wlast * j) / n_gaps);
                unsigned long long f = 0, r = 0;
                int bad = 0;
                for (int d = 0; d < k; ++d) {
                    const int c = codes[w + d];
                    bad |= c >> 2;
                    const unsigned long long cc = (unsigned long long)(c & 3);
                    f = (f << 2) | cc;
                    r |= (3ULL - cc) << (2 * d);
                }
                const int valid = !bad && long_enough && real;
                const int isfw = f <= r;
                // anchor 0 is looked up even when invalid: its strand
                // stands in for f_strand of reads without a result
                if (valid || j == 0) {
                    const unsigned long long q =
                        kt_mix64(valid ? (isfw ? f : r) : 0ULL);
                    long long idx;
                    int e;
                    hit = kt_probe(ix, q, &idx, &e) && valid;
                    strand = isfw == (int)(ix.fw[idx] != 0);
                    if (hit) {
                        uid = ix.uid[idx];
                        upos = ix.pos[idx];
                        blk = ix.block[idx];
                    }
                }
                blo = min(blo, blk);
                bhi = max(bhi, blk);
            }
            if (base == 0) {
                uid0 = __shfl_sync(KT_FULL, uid, 0);
                upos0 = __shfl_sync(KT_FULL, upos, 0);
                str0 = __shfl_sync(KT_FULL, strand, 0);
                blk0 = __shfl_sync(KT_FULL, blk, 0);
                sgn = str0 ? 1 : -1;
            }
            const int lane_ok = !act || (hit && uid == uid0 && strand == str0 &&
                                         upos == upos0 + sgn * w);
            all_ok &= __all_sync(KT_FULL, lane_ok);
        }
        blo = __reduce_min_sync(KT_FULL, blo);
        bhi = __reduce_max_sync(KT_FULL, bhi);
        const int ok = all_ok && (bhi >> 3) <= (blo >> 3) + 1 && blo >= 0 &&
                       real && long_enough;

        if (ok) {
            // the stretch's distinct block ECs: two 8-wide rows of block_ec8
            // restricted to block ids [blo, bhi], R rounds of warp minimum
            const int r0 = blo >> 3;
            int v = KT_INT32_MAX;
            if (lane < 16) {
                const long long fid = (long long)r0 * 8 + lane;
                if (fid >= blo && fid <= bhi && fid < n_be8) {
                    const int c = be8[fid];
                    if (c >= 0) v = c;
                }
            }
            int prev = -1, nr = 0;
            const int Rv = R < 16 ? R : 16;
            for (int s = 0; s < Rv; ++s) {
                const int m = __reduce_min_sync(KT_FULL,
                                                v > prev ? v : KT_INT32_MAX);
                if (lane == 0) o.rows[read * R + s] = m;
                if (m != KT_INT32_MAX) {
                    prev = m;
                    ++nr;
                }
            }
            for (int s = Rv + lane; s < R; s += 32)
                o.rows[read * R + s] = KT_INT32_MAX;
            const int ov = __any_sync(KT_FULL, v > prev && v != KT_INT32_MAX);
            if (lane == 0) {
                o.n_rows[read] = nr;
                o.has_hits[read] = 1;
                o.overflow[read] = (unsigned char)ov;
                o.f_uid[read] = uid0;
                o.f_block[read] = blk0;
                o.f_upos[read] = upos0;
                o.f_rpos[read] = 0;
                o.f_strand[read] = (unsigned char)str0;
                o.rng[read] = wlast;
            }
        } else if (real && long_enough) {
            // wave 2, inline: every window of this read
            kt_side_read(ix, codes, wrows, read, rlen, W, k, Rc, R, o);
            if (lane == 0) {
                // a one-slot core row fills every slot (JAX's broadcast)
                for (int s = Rc; s < R; ++s)
                    o.rows[read * R + s] = o.rows[read * R];
                atomicAdd(&blk_fail, 1u);
            }
        } else {
            // padding reads (and every read when rlen < k)
            for (int s = lane; s < R; s += 32)
                o.rows[read * R + s] = KT_INT32_MAX;
            if (lane == 0) {
                o.n_rows[read] = 0;
                o.has_hits[read] = 0;
                o.overflow[read] = 0;
                o.f_uid[read] = -1;
                o.f_block[read] = -1;
                o.f_upos[read] = -1;
                o.f_rpos[read] = -1;
                o.f_strand[read] = (unsigned char)str0;
                o.rng[read] = -1;
            }
        }
        __syncwarp();
    }
    __syncthreads();
    if (threadIdx.x == 0 && blk_fail)
        atomicAdd(n_fail, (unsigned long long)blk_fail);
}

// ------------------------------------------------------------- kernel K

// Kernel K: one warp per pair of the Bp half-fail pairs (file header).
__global__ void pseudoalign_halffail_kernel(
    IndexView ix,
    const int* __restrict__ be8,               // [n_be8] block_ec8, flat
    long long n_be8,
    const unsigned char* __restrict__ pkf,     // [Bp, Lp/4] failed mates
    const int* __restrict__ vsum,              // [Bp, 2] verified summaries
    const int* __restrict__ sidev,             // [Bp] 1 = mate 1 failed
    const long long* __restrict__ aux,         // [4 + n_exc]
    long long n_exc, long long Bp, int Lp, int Lc, int k, int R,
    int warp_bytes, SideOut o1, SideOut o2) {
    extern __shared__ int kt_smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wpb = blockDim.x >> 5;
    const int W = Lc - k + 1;
    const int code_bytes = (Lc + 15) & ~15;
    unsigned char* codes = (unsigned char*)kt_smem + (long long)warp * warp_bytes;
    int* wrows = (int*)(codes + code_bytes);
    const int rlen = (int)aux[0];
    const long long n_real = aux[1];
    const long long* exc = aux + 4;
    const int Rv = R < 16 ? R : 16;

    for (long long read = (long long)blockIdx.x * wpb + warp; read < Bp;
         read += (long long)gridDim.x * wpb) {
        const int m1 = sidev[read] == 1;
        const SideOut of = m1 ? o1 : o2;
        const SideOut ov = m1 ? o2 : o1;
        const int len = read < n_real ? rlen : 0;

        // the failed mate: kernel D's decode and per-read core
        kt_turbo_decode(codes, pkf, exc, n_exc, read, read, Lp, Lc);
        kt_side_read(ix, codes, wrows, read, len, W, k, R, R, of);

        // the verified mate from its summary
        const int blo = vsum[2 * read];
        const int meta = vsum[2 * read + 1];
        const int real = len > 0;
        const int strand = meta & 1;
        const int bhi = blo + ((meta >> 1) & 15);
        const int upos0 = meta >> 5;
        const int r0 = (blo > 0 ? blo : 0) >> 3;
        int v = KT_INT32_MAX;
        if (lane < 16 && real) {
            const long long fid = (long long)r0 * 8 + lane;
            if (fid >= blo && fid <= bhi && fid < n_be8) {
                const int c = be8[fid];
                if (c >= 0) v = c;
            }
        }
        int prev = -1, nr = 0;
        for (int s = 0; s < Rv; ++s) {
            const int m = __reduce_min_sync(KT_FULL,
                                            v > prev ? v : KT_INT32_MAX);
            if (lane == 0) ov.rows[read * R + s] = m;
            if (m != KT_INT32_MAX) {
                prev = m;
                ++nr;
            }
        }
        for (int s = Rv + lane; s < R; s += 32)
            ov.rows[read * R + s] = KT_INT32_MAX;
        if (lane == 0) {
            ov.n_rows[read] = nr;
            ov.has_hits[read] = (unsigned char)real;
            ov.overflow[read] = 0;
            ov.f_uid[read] = real ? 0 : -1;
            ov.f_block[read] = real ? (strand ? blo : bhi) : -1;
            ov.f_upos[read] = real ? upos0 : -1;
            ov.f_rpos[read] = real ? 0 : -1;
            ov.f_strand[read] = (unsigned char)strand;
            ov.rng[read] = real ? len - k : -1;
        }
        __syncwarp();
    }
}

// ------------------------------------------------------------- kernel J

#define KJ_THREADS 256
#define KJ_WARPS (KJ_THREADS / 32)
#define KJ_RUN 4                       // windows of a thread in a tile
#define KJ_TILE (KJ_THREADS * KJ_RUN)  // windows probed before one scan
// KJ_SLIST, the row-list entries of a read in shared memory, comes from
// the build (ops/kernels.py LONG_SLIST, which also plans the spill)
#ifndef KJ_SLIST
#error "KJ_SLIST is given by ops/kernels.py"
#endif

struct LongOut {
    int* rows;                        // [B, R]
    int* n_rows;
    unsigned char* has_hits;
    unsigned char* overflow;
    int* unmapped;
    int* groups;                      // [B, G]
    int* n_groups;
    unsigned char* g_overflow;
};

// Block-wide inclusive scan (sum, or maximum with MAX) of one int per
// thread; *total gets the block's reduction.  Every thread of the block
// calls it; wt is KJ_WARPS ints of shared scratch.
template <bool MAX>
__device__ __forceinline__ int kj_scan(int v, int* wt, int* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(KT_FULL, v, o);
        if (lane >= o) v = MAX ? max(v, t) : v + t;
    }
    if (lane == 31) wt[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int t = lane < KJ_WARPS ? wt[lane] : (MAX ? -KT_INT32_MAX - 1 : 0);
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(KT_FULL, t, o);
            if (lane >= o) t = MAX ? max(t, u) : t + u;
        }
        if (lane < KJ_WARPS) wt[lane] = t;
    }
    __syncthreads();
    if (warp > 0) v = MAX ? max(v, wt[warp - 1]) : v + wt[warp - 1];
    *total = wt[KJ_WARPS - 1];
    __syncthreads();
    return v;
}

// A listed row at position pos: the first KJ_SLIST in shared memory, the
// rest in the block's global spill at the same position.
__device__ __forceinline__ void kj_list_put(int* slist, int* spill, int pos,
                                            int v) {
    if (pos < KJ_SLIST)
        slist[pos] = v;
    else
        spill[pos] = v;
}

__global__ void __launch_bounds__(KJ_THREADS) pseudoalign_long_kernel(
    IndexView ix,
    const unsigned char* __restrict__ packed,  // [B, Lp/4]
    const unsigned char* __restrict__ nmask,   // [B, Lp/8]
    const int* __restrict__ lens,              // [B]
    int B, int Lp, int k, int R, int G,
    int* next_read,                            // [1], 0 at launch
    int* spill, long long cap,                 // [grid, cap] or null
    LongOut o) {
    __shared__ unsigned char s_codes[KJ_TILE + 32];
    __shared__ int s_list[KJ_SLIST];
    __shared__ int s_luid[KJ_THREADS];
    __shared__ int s_lec[KJ_THREADS];
    __shared__ int s_last[KJ_THREADS];
    __shared__ int wt[KJ_WARPS];
    __shared__ int s_read;
    const int tid = threadIdx.x;
    const int W = Lp - k + 1;
    const int LB = Lp >> 2;
    const int NB = Lp >> 3;
    const unsigned long long kmask =
        k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1ULL);
    const int rshift = 2 * (k - 1);
    int* gl = spill ? spill + (long long)blockIdx.x * cap : 0;

    for (;;) {
        if (tid == 0) s_read = atomicAdd(next_read, 1);
        __syncthreads();
        const int read = s_read;
        if (read >= B) break;
        const int len = lens[read];
        int wr = len - k + 1;
        wr = wr < 0 ? 0 : (wr > W ? W : wr);
        const unsigned char* pk = packed + (long long)read * LB;
        const unsigned char* nm = nmask + (long long)read * NB;
        const int ncodes = len < Lp ? len : Lp;
        for (int g = tid; g < G; g += KJ_THREADS)
            o.groups[(long long)read * G + g] = -2;

        // carries across tiles: the last hit so far, groups and listed rows
        int c_has = 0, c_uid = 0, c_ec = 0, c_gid = 0, c_lst = 0;
        int n_valid = 0, n_hit = 0;
        for (int base = 0; base < wr; base += KJ_TILE) {
            // the tile's codes: its windows read codes [base, base + TILE + k - 1)
            int nc = ncodes - base;
            nc = nc < KJ_TILE + k - 1 ? nc : KJ_TILE + k - 1;
            for (int j = tid; j < nc; j += KJ_THREADS) {
                const int p = base + j;
                const int c = (pk[p >> 2] >> ((p & 3) * 2)) & 3;
                const int isn = (nm[p >> 3] >> (p & 7)) & 1;
                s_codes[j] = (unsigned char)(isn ? 4 : c);
            }
            __syncthreads();

            // probes: the thread's run of KJ_RUN windows, its k-mers rolled
            // one base at a time, every probe of the run issued before any
            // of them is scanned
            const int o0 = tid * KJ_RUN;
            int nw = wr - (base + o0);
            nw = nw < 0 ? 0 : (nw > KJ_RUN ? KJ_RUN : nw);
            unsigned int validm = 0, hitm;
            unsigned long long q[KJ_RUN];
            int uid[KJ_RUN], ecv[KJ_RUN];
#pragma unroll
            for (int j = 0; j < KJ_RUN; ++j) q[j] = 0;
            if (nw > 0) {
                unsigned long long f = 0, r = 0;
                int lastn = -1;  // tile offset of the last N read so far
                for (int d = 0; d < k - 1; ++d) {
                    const int c = s_codes[o0 + d];
                    if (c > 3) lastn = o0 + d;
                    const unsigned long long cc = (unsigned long long)(c & 3);
                    f = ((f << 2) | cc) & kmask;
                    r = (r >> 2) | ((3ULL - cc) << rshift);
                }
#pragma unroll
                for (int j = 0; j < KJ_RUN; ++j) {
                    if (j < nw) {
                        const int c = s_codes[o0 + j + k - 1];
                        if (c > 3) lastn = o0 + j + k - 1;
                        const unsigned long long cc = (unsigned long long)(c & 3);
                        f = ((f << 2) | cc) & kmask;
                        r = (r >> 2) | ((3ULL - cc) << rshift);
                        if (lastn < o0 + j) {
                            validm |= 1u << j;
                            q[j] = kt_mix64(f <= r ? f : r);
                        }
                    }
                }
            }
            hitm = 0;
#pragma unroll
            for (int j = 0; j < KJ_RUN; ++j) {
                uid[j] = -1;
                ecv[j] = -1;
                if ((validm >> j) & 1) {
                    long long idx;
                    int e;
                    if (kt_probe(ix, q[j], &idx, &e)) {
                        hitm |= 1u << j;
                        uid[j] = ix.uid[idx];
                        ecv[j] = e;
                    }
                }
            }
            n_valid += __popc(validm);
            n_hit += __popc(hitm);

            // the run's first and last hit, and the groups its later hits open
            int fuid = 0, fec = 0, luid = 0, lec = 0, nb = 0, nl = 0;
            {
                int seen = 0;
#pragma unroll
                for (int j = 0; j < KJ_RUN; ++j) {
                    if ((hitm >> j) & 1) {
                        if (!seen) {
                            fuid = uid[j];
                            fec = ecv[j];
                            seen = 1;
                        } else if (uid[j] != luid || ecv[j] != lec) {
                            ++nb;
                            nl += ecv[j] >= 0;
                        }
                        luid = uid[j];
                        lec = ecv[j];
                    }
                }
            }
            // one scan over the tile in window order: each run's previous
            // hit is the last hit of the runs before it (or of earlier tiles)
            s_luid[tid] = luid;
            s_lec[tid] = lec;
            int tot;
            const int last = kj_scan<true>(hitm ? tid : -1, wt, &tot);
            s_last[tid] = last;
            __syncthreads();
            const int pl = tid > 0 ? s_last[tid - 1] : -1;
            int has_prev = c_has, puid = c_uid, pec = c_ec;
            if (pl >= 0) {
                has_prev = 1;
                puid = s_luid[pl];
                pec = s_lec[pl];
            }
            const int fb = hitm && (!has_prev || fuid != puid || fec != pec);
            nb += fb;
            nl += fb && fec >= 0;
            const int flags = nb | (nl << 16);
            const int excl = kj_scan<false>(flags, wt, &tot) - flags;
            int gid = c_gid + (excl & 0xffff);
            int lst = c_lst + (excl >> 16);
#pragma unroll
            for (int j = 0; j < KJ_RUN; ++j) {
                if ((hitm >> j) & 1) {
                    if (!has_prev || uid[j] != puid || ecv[j] != pec) {
                        if (gid < G) o.groups[(long long)read * G + gid] = ecv[j];
                        ++gid;
                        if (ecv[j] >= 0) kj_list_put(s_list, gl, lst++, ecv[j]);
                    }
                    has_prev = 1;
                    puid = uid[j];
                    pec = ecv[j];
                }
            }
            const int tile_last = s_last[KJ_THREADS - 1];
            if (tile_last >= 0) {
                c_has = 1;
                c_uid = s_luid[tile_last];
                c_ec = s_lec[tile_last];
            }
            c_gid += tot & 0xffff;
            c_lst += tot >> 16;
            __syncthreads();  // the tile's shared arrays are rewritten next
        }
        int tot_valid, tot_hit;
        kj_scan<false>(n_valid, wt, &tot_valid);
        kj_scan<false>(n_hit, wt, &tot_hit);

        // the listed rows sorted ascending (bitonic, INT32_MAX padded to a
        // power of two) in shared memory, or in the block's spill once they
        // pass KJ_SLIST; then the distinct ones ranked by an add-scan
        const int n = c_lst;
        int* list = s_list;
        if (n > KJ_SLIST) {
            for (int i = tid; i < KJ_SLIST; i += KJ_THREADS) gl[i] = s_list[i];
            list = gl;
        }
        int npow = 1;
        while (npow < n) npow <<= 1;
        if (n > 1) {
            for (int i = n + tid; i < npow; i += KJ_THREADS)
                list[i] = KT_INT32_MAX;
            __syncthreads();
            for (int size = 2; size <= npow; size <<= 1) {
                for (int stride = size >> 1; stride > 0; stride >>= 1) {
                    for (int i = tid; i < npow; i += KJ_THREADS) {
                        const int j = i ^ stride;
                        if (j > i) {
                            const int a = list[i], b = list[j];
                            if ((a > b) == ((i & size) == 0)) {
                                list[i] = b;
                                list[j] = a;
                            }
                        }
                    }
                    __syncthreads();
                }
            }
        }
        int nr = 0;
        for (int base = 0; base < n; base += KJ_THREADS) {
            const int i = base + tid;
            const int isnew = i < n && (i == 0 || list[i] != list[i - 1]);
            int tot;
            const int rank = nr + kj_scan<false>(isnew, wt, &tot) - isnew;
            if (isnew && rank < R) o.rows[(long long)read * R + rank] = list[i];
            nr += tot;
        }
        for (int s = (nr < R ? nr : R) + tid; s < R; s += KJ_THREADS)
            o.rows[(long long)read * R + s] = KT_INT32_MAX;
        if (tid == 0) {
            o.n_rows[read] = nr;
            o.has_hits[read] = (unsigned char)(tot_hit > 0);
            o.overflow[read] = (unsigned char)(nr > R);
            o.unmapped[read] = tot_valid - tot_hit;
            o.n_groups[read] = c_gid;
            o.g_overflow[read] = (unsigned char)(c_gid > G);
        }
        __syncthreads();  // s_read and the row list are reused by the next read
    }
}

// The caller's index view, checked: the payloads, and either layout's
// tables with N consistent with p and S.
static int kt_index_view(IndexView* ix, const IndexView* in) {
    if (in == 0) return (int)cudaErrorInvalidValue;
    *ix = *in;
    const int payloads = ix->uid && ix->pos && ix->fw && ix->block;
    if (!payloads || ix->N <= 0 || ix->p < 1 || ix->p > 63)
        return (int)cudaErrorInvalidValue;
    if (ix->S) {
        if (ix->S < 0 || ix->S > 64 || (ix->S & (ix->S - 1)) || !ix->rows ||
            ix->p > 40 ||
            ix->N != ((long long)ix->S << ix->p))
            return (int)cudaErrorInvalidValue;
    } else if (!ix->hkeys || !ix->bucket_start || !ix->ec) {
        return (int)cudaErrorInvalidValue;
    }
    return 0;
}

static SideOut kt_side_out(void* rows, void* n_rows, void* has_hits,
                           void* overflow, void* f_uid, void* f_block,
                           void* f_upos, void* f_rpos, void* f_strand,
                           void* rng) {
    SideOut o;
    o.rows = (int*)rows;
    o.n_rows = (int*)n_rows;
    o.has_hits = (unsigned char*)has_hits;
    o.overflow = (unsigned char*)overflow;
    o.f_uid = (int*)f_uid;
    o.f_block = (int*)f_block;
    o.f_upos = (int*)f_upos;
    o.f_rpos = (int*)f_rpos;
    o.f_strand = (unsigned char*)f_strand;
    o.rng = (int*)rng;
    return o;
}

// Warps per block and the per-warp shared bytes for Lc code columns;
// returns 0 when one warp's share does not fit.
template <typename K>
static int kt_launch_shape(K kernel, int Lc, int W, int* wpb_out,
                           int* warp_bytes_out, long long* smem_out) {
    const int code_bytes = (Lc + 15) & ~15;
    const int warp_bytes = (code_bytes + 4 * W + 15) & ~15;
    const int max_smem = 227 * 1024;
    int wpb = 4;
    while (wpb > 1 && wpb * warp_bytes > max_smem) wpb >>= 1;
    const long long smem = (long long)wpb * warp_bytes;
    if (smem > max_smem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    *wpb_out = wpb;
    *warp_bytes_out = warp_bytes;
    *smem_out = smem;
    return 0;
}

static unsigned int kt_blocks(long long B, int wpb) {
    long long blocks = (B + wpb - 1) / wpb;
    if (blocks > 1048576) blocks = 1048576;
    return (unsigned int)blocks;
}

extern "C" int pseudoalign_side(
    const IndexView* index,
    const void* packed, const void* nmask, const void* lens,
    int B, int Lp, int k, int R,
    void* rows, void* n_rows, void* has_hits, void* overflow,
    void* f_uid, void* f_block, void* f_upos, void* f_rpos,
    void* f_strand, void* rng, void* stream) {
    if (B <= 0) return 0;
    if (Lp < k || (Lp & 7) != 0 || R <= 0 || R > Lp - k + 1 || k > 32)
        return (int)cudaErrorInvalidValue;
    IndexView ix;
    int err = kt_index_view(&ix, index);
    if (err) return err;
    const int W = Lp - k + 1;
    int wpb, warp_bytes;
    long long smem;
    err = kt_launch_shape(pseudoalign_side_kernel, Lp, W, &wpb, &warp_bytes,
                          &smem);
    if (err) return err;
    pseudoalign_side_kernel<<<kt_blocks(B, wpb), wpb * 32, (size_t)smem,
                              (cudaStream_t)stream>>>(
        ix, (const unsigned char*)packed, (const unsigned char*)nmask,
        (const int*)lens, B, Lp, k, R, warp_bytes,
        kt_side_out(rows, n_rows, has_hits, overflow, f_uid, f_block, f_upos,
                    f_rpos, f_strand, rng));
    return (int)cudaGetLastError();
}

extern "C" int pseudoalign_turbo(
    const IndexView* index,
    const void* p1, const void* p2, const void* aux, long long n_exc,
    const void* lens, long long Bp, int ns, int Lp, int rl, int k, int R,
    void* rows, void* n_rows, void* has_hits, void* overflow,
    void* f_uid, void* f_block, void* f_upos, void* f_rpos,
    void* f_strand, void* rng, void* stream) {
    if (Bp <= 0) return 0;
    const int Lc = (rl > 0 && rl < Lp) ? rl : Lp;
    if (ns < 1 || ns > 2 || (ns == 2 && p2 == 0) || n_exc < 0 ||
        Lc < k || (Lp & 3) != 0 || R <= 0 || R > Lc - k + 1 || k > 32)
        return (int)cudaErrorInvalidValue;
    IndexView ix;
    int err = kt_index_view(&ix, index);
    if (err) return err;
    const int W = Lc - k + 1;
    int wpb, warp_bytes;
    long long smem;
    err = kt_launch_shape(pseudoalign_turbo_kernel, Lc, W, &wpb, &warp_bytes,
                          &smem);
    if (err) return err;
    pseudoalign_turbo_kernel<<<kt_blocks(Bp * ns, wpb), wpb * 32,
                               (size_t)smem, (cudaStream_t)stream>>>(
        ix, (const unsigned char*)p1, (const unsigned char*)p2,
        (const long long*)aux, n_exc, (const unsigned short*)lens, Bp, ns, Lp,
        Lc, k, R, warp_bytes,
        kt_side_out(rows, n_rows, has_hits, overflow, f_uid, f_block, f_upos,
                    f_rpos, f_strand, rng));
    return (int)cudaGetLastError();
}

extern "C" int pseudoalign_anchor(
    const IndexView* index, const void* block_ec8, long long n_be8,
    const void* p1, const void* p2, const void* aux, long long n_exc,
    long long Bp, int ns, int Lp, int rl, int k, int R, int n_anchors,
    void* rows, void* n_rows, void* has_hits, void* overflow,
    void* f_uid, void* f_block, void* f_upos, void* f_rpos,
    void* f_strand, void* rng, void* n_fail, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(n_fail, 0, 8, st);
    if (e != cudaSuccess) return (int)e;
    if (Bp <= 0) return 0;
    const int Lc = (rl > 0 && rl < Lp) ? rl : Lp;
    const int W = Lc - k + 1;
    const int Rc = R < W ? R : W;
    if (ns < 1 || ns > 2 || (ns == 2 && p2 == 0) || n_exc < 0 ||
        Lc < k || (Lp & 3) != 0 || R <= 0 || (Rc != R && Rc != 1) ||
        k > 32 || n_anchors < 2 || n_be8 < 16)
        return (int)cudaErrorInvalidValue;
    IndexView ix;
    int err = kt_index_view(&ix, index);
    if (err) return err;
    int wpb, warp_bytes;
    long long smem;
    err = kt_launch_shape(pseudoalign_anchor_kernel, Lc, W, &wpb, &warp_bytes,
                          &smem);
    if (err) return err;
    pseudoalign_anchor_kernel<<<kt_blocks(Bp * ns, wpb), wpb * 32,
                                (size_t)smem, st>>>(
        ix, (const int*)block_ec8, n_be8, (const unsigned char*)p1,
        (const unsigned char*)p2, (const long long*)aux, n_exc, Bp, ns, Lp,
        Lc, k, R, Rc, n_anchors, warp_bytes,
        kt_side_out(rows, n_rows, has_hits, overflow, f_uid, f_block, f_upos,
                    f_rpos, f_strand, rng),
        (unsigned long long*)n_fail);
    return (int)cudaGetLastError();
}

// Kernel K.  Outputs: mate 1's ten SideResult fields, then mate 2's, each
// [Bp] with R row slots.
extern "C" int pseudoalign_halffail(
    const IndexView* index, const void* block_ec8, long long n_be8,
    const void* pkf, const void* vsum, const void* sidev, const void* aux,
    long long n_exc, long long Bp, int Lp, int rl, int k, int R,
    void* rows1, void* n_rows1, void* has_hits1, void* overflow1,
    void* f_uid1, void* f_block1, void* f_upos1, void* f_rpos1,
    void* f_strand1, void* rng1,
    void* rows2, void* n_rows2, void* has_hits2, void* overflow2,
    void* f_uid2, void* f_block2, void* f_upos2, void* f_rpos2,
    void* f_strand2, void* rng2, void* stream) {
    if (Bp <= 0) return 0;
    const int Lc = (rl > 0 && rl < Lp) ? rl : Lp;
    const int W = Lc - k + 1;
    if (n_exc < 0 || Lc < k || (Lp & 3) != 0 || R <= 0 || R > W || k > 32 ||
        n_be8 < 16)
        return (int)cudaErrorInvalidValue;
    IndexView ix;
    int err = kt_index_view(&ix, index);
    if (err) return err;
    int wpb, warp_bytes;
    long long smem;
    err = kt_launch_shape(pseudoalign_halffail_kernel, Lc, W, &wpb,
                          &warp_bytes, &smem);
    if (err) return err;
    pseudoalign_halffail_kernel<<<kt_blocks(Bp, wpb), wpb * 32, (size_t)smem,
                                  (cudaStream_t)stream>>>(
        ix, (const int*)block_ec8, n_be8, (const unsigned char*)pkf,
        (const int*)vsum, (const int*)sidev, (const long long*)aux, n_exc, Bp,
        Lp, Lc, k, R, warp_bytes,
        kt_side_out(rows1, n_rows1, has_hits1, overflow1, f_uid1, f_block1,
                    f_upos1, f_rpos1, f_strand1, rng1),
        kt_side_out(rows2, n_rows2, has_hits2, overflow2, f_uid2, f_block2,
                    f_upos2, f_rpos2, f_strand2, rng2));
    return (int)cudaGetLastError();
}

// Kernel J's persistent grid on the current device: the SMs times the
// blocks of KJ_THREADS that one SM holds at once.
extern "C" int pseudoalign_long_grid(int* blocks) {
    int dev, sms, per;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, pseudoalign_long_kernel, KJ_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    *blocks = sms * per;
    return 0;
}

// Kernel J.  grid blocks of KJ_THREADS threads take reads from next_read
// (one int, 0 at launch).  The row list of a read lives in shared memory
// up to KJ_SLIST entries; cap is the power of two >= Lp - k + 1 (the most
// a read can list, padded for the sort), and spill, [grid, cap] ints, is
// given exactly when cap > KJ_SLIST (ops/kernels.py long_plan).
extern "C" int pseudoalign_long(
    const IndexView* index,
    const void* packed, const void* nmask, const void* lens,
    long long B, int Lp, int k, int R, int G, int grid,
    void* next_read, void* spill, long long cap,
    void* rows, void* n_rows, void* has_hits, void* overflow,
    void* unmapped, void* groups, void* n_groups, void* g_overflow,
    void* stream) {
    if (B <= 0) return 0;
    const int W = Lp - k + 1;
    long long need = 1;
    while (need < W) need <<= 1;
    if (Lp < k || (Lp & 7) != 0 || k > 32 || R <= 0 || R > W || G <= 0 ||
        B > 0x7fffffffLL || grid <= 0 || grid > B ||
        !next_read || cap != need || (cap > KJ_SLIST) != (spill != 0))
        return (int)cudaErrorInvalidValue;
    IndexView ix;
    int err = kt_index_view(&ix, index);
    if (err) return err;
    LongOut o;
    o.rows = (int*)rows;
    o.n_rows = (int*)n_rows;
    o.has_hits = (unsigned char*)has_hits;
    o.overflow = (unsigned char*)overflow;
    o.unmapped = (int*)unmapped;
    o.groups = (int*)groups;
    o.n_groups = (int*)n_groups;
    o.g_overflow = (unsigned char*)g_overflow;
    pseudoalign_long_kernel<<<grid, KJ_THREADS, 0, (cudaStream_t)stream>>>(
        ix, (const unsigned char*)packed, (const unsigned char*)nmask,
        (const int*)lens, (int)B, Lp, k, R, G, (int*)next_read, (int*)spill,
        cap, o);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------- kernel L

// Kernel L: one thread per query of n canonical k-mers, grid-stride;
// invalid queries are probed with canon 0 and never hit (lookup_kmers).
__global__ void lookup_kmers_kernel(IndexView ix,
                                    const long long* __restrict__ canon,
                                    const unsigned char* __restrict__ valid,
                                    long long n, long long* __restrict__ idx,
                                    unsigned char* __restrict__ hit,
                                    int* __restrict__ ec) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        const int v = valid[i] != 0;
        const unsigned long long q =
            kt_mix64(v ? (unsigned long long)canon[i] : 0ULL);
        long long s;
        int e;
        const int h = kt_probe(ix, q, &s, &e) && v;
        idx[i] = s;
        hit[i] = (unsigned char)h;
        ec[i] = h ? e : -1;
    }
}

// Kernel L: (idx int64, hit bool, ec int32) of n queries.
extern "C" int lookup_kmers(const IndexView* index, const void* canon,
                            const void* valid, long long n, void* idx,
                            void* hit, void* ec, void* stream) {
    if (n <= 0) return 0;
    IndexView ix;
    int err = kt_index_view(&ix, index);
    if (err) return err;
    long long blocks = (n + 255) / 256;
    if (blocks > 132 * 32) blocks = 132 * 32;
    lookup_kmers_kernel<<<(unsigned int)blocks, 256, 0,
                          (cudaStream_t)stream>>>(
        ix, (const long long*)canon, (const unsigned char*)valid, n,
        (long long*)idx, (unsigned char*)hit, (int*)ec);
    return (int)cudaGetLastError();
}
