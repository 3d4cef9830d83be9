// Kernels A, D, I, K and J: per-read k-mer -> sorted distinct EC rows;
// kernel L: the k-mer probe alone.
//
// The probe (kt_probe; kt_probe_n for several queries of one lane), K2 of
// the JAX package, in both index layouts:
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
// launch, so the probe branches on it at run time (uniform over the
// warp): one body per kernel, no template instantiation.
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
// bool, EC row int32), four queries a lane, equal to the plain
// lookup_kmers of ops/pseudoalign.py in both layouts: the wrapper probes
// a padded index through kt_probe_n (C function lookup_kmers) and a
// bucketed one through its packed (key, EC row) entries (kt_probe_ent,
// lookup_kmers_packed).  No run loop launches it; it is the yardstick of
// the probe (chip_smoke.py times it in both layouts; probe_ab.py also
// calls lookup_kmers on a bucketed index, the form without entries).
//
// One per-read core, kt_core, serves kernels A's wave 2, D and I's wave
// 2, and its covered-interval form (below) A on codes' wave 2 and K's
// failed mate; only the decode in front of them differs:
//   A's wave 2 (pseudoalign_side_wave2_kernel) -- the JAX device program
//     kallisto_tpu/ops/pseudoalign.py pseudoalign_batch_packed (:479):
//     unpack_codes_device (:469), rolling_canonical_kmers (:385),
//     lookup_kmers (:316-382) and _pseudoalign_core (:504-564), on packed
//     codes with an N bitmask, for the reads that A's wave 1 (below)
//     could not verify;
//   A on codes, pseudoalign_codes -- pseudoalign_batch (:493), the same
//     core on unpacked [B, L] uint8 codes (any L >= k; a code above 3 is
//     an N), packed per read in the warp by three ballots per 32 columns,
//     for the reads that its wave 1 (A's wave 1 on codes, below) could
//     not verify;
//   D, pseudoalign_turbo -- the decode and core of the turbo steady state,
//     kallisto_tpu/ops/turbo.py pair_turbo_core (:104) and
//     single_turbo_core (:254) as reached through
//     pseudoalign_pair_turbo(_varlen) and pseudoalign_single_turbo(_varlen)
//     (:131-150, :268-289): _codes_and_lens (:74, with _codes_from_packed,
//     pseudoalign.py:924) and _pseudoalign_core.  It takes one or two
//     mates' packed codes without an N bitmask, and an aux vector [rlen,
//     n_real, 0, 0, N positions ascending, INT64_MAX pad]; each read finds
//     its own N positions (kt_exc_lower: 2,048 splitters of the list in the
//     block's shared memory, then one segment), its length is (read % Bp < n_real) ? (lens ?
//     lens[read] : rlen) : 0, and with 0 < rl < Lp only the first rl
//     columns count.  Exception indices address the padded [ns*Bp, Lp]
//     matrix (row stride Lp), so an exception at a column >= rl is dropped
//     by the trim.
// They produce the ten SideResult fields, equal in every bit to the plain
// PyTorch versions in kallisto_tpu_torch/ops/pseudoalign.py and
// ops/turbo.py.
//
// The core, one warp per read (grid-stride over a grid sized by the
// occupancy of the built kernel, kt_grid).  The decode leaves the read in
// the warp's shared memory as 2-bit codes packed 32 to a word (N bases
// cleared to 0, the low bits of code 4) and an N bitmask.  Lane l owns
// windows l and l + 32 of each pass of 64 (KT_PER = 2).  Each window's
// k-mers come from words, not bytes: the 64 bits at bit 2w (two shared
// words and a shift) hold the window's bases low base first, so the
// reverse complement is their complement under the k-mer mask and the
// forward k-mer their 2-bit groups reversed (__brevll and a swap of
// adjacent bits); the window is valid when its k bits of the N mask are 0
// and w + k <= len.  The lane then probes its windows together
// (kt_probe_n: each dependent step of the probe is issued for every query
// before the next step; a bucketed query whose bucket is empty, or whose
// key the search met, reads no key at the end), and no warp-wide step
// stands between a pass's probes.  Each window's EC row goes to the lane's
// own slots of a shared scratch; the lane keeps its first hit (window,
// slot, orientation) and last hit, and one warp minimum and maximum give
// the read's first and last hit, whose slot and orientation come over a
// shuffle.  The R = min(16, W) smallest distinct rows then come from
// rounds of masked warp minimum over the lanes' own rows that stop once
// nothing is left (a read with n distinct rows pays n + 1 rounds, the
// (R+1)-th round deciding `overflow` exactly as _pseudoalign_core
// :534-536), and the row slots are written by one lane a round.
//
// What bounds them on the H100: the rate of random requests into the
// k-mer table.  Per valid window of a bucketed index: a 32-byte sector of
// bucket_start, the sectors of the bucket's sorted keys that the search
// touches (a bucket holds < 64 keys, 0.2 on average at the smoke's p),
// and for a hit one sector of kmer_ec -- three dependent requests for a
// typical hit; of a padded index the row's two key sectors and its EC
// sector.  Repeated k-mers of a batch request their sectors again, so a
// batch of 2 x 262,144 reads of 100 bp makes ~110 M requests where the
// distinct sectors number ~25 M.  A table that fits in the 50 MB L2
// serves them from L2, a larger one from DRAM, and the time follows the
// table's size at one batch shape (chip_smoke.py phase 3g; PERF.md), not
// the probe passes, the resident warps or the block size (each tried on
// the card).  What the design does about it: invalid
// windows and empty buckets skip table reads, the search stops as soon as
// its range is empty, kernel D trims the padding columns that a
// byte-aligned Lp adds (rl < Lp), which removes their probes, and reads
// 25 bytes per 100 bp read instead of 25 + 13.
//
// The covered-interval core (A on codes' wave 2, K's failed mate) gives
// kt_core's fields bit for bit from fewer probes.  A read of le = min(len,
// W + k - 1) >= k columns has na = n_anchors_for(le, k) anchors at w_j =
// (wlast * j) / (na - 1), wlast = le - k, at most k apart (a shorter read:
// window 0 alone).  The anchors are probed in one round, with uid, pos,
// block and strand read on a hit; then the lane of anchor j decides
// interval [w_j, w_j+1] with anchor j + 1's lane over a shuffle.  It is
// covered when both anchors hit one unitig on one strand with upos_j+1 =
// upos_j + sgn * (w_j+1 - w_j) and their block range lies in two 8-wide
// rows of block_ec8: the two k-mers then overlap or abut on that unitig,
// so read[w_j, w_j+1 + k) is that stretch, every window between them hits
// it (valid, one k-mer each), and its EC rows are the block ECs of the
// blocks between the anchors' (blocks are unitig-major, consecutive and
// position-ascending), which the lane writes into the skipped windows'
// slots (at most w_j+1 - w_j - 1 of them) from block_ec8, INT32_MAX into
// the rest.  An open interval -- a miss, an N or a disagreement at either
// end, a range past two rows -- marks its windows KT_NEED; rounds of a
// ballot and a prefix over the slots hand its valid windows to the whole
// warp, 64 a round (kt_probe_n, two a lane), so a read left with at most
// 64 pays one probe round where kt_core pays W / 64 rounded up.  The first
// and last hits are probed windows (window 0 is anchor 0, and a covered
// interval's ends are hits), so the first/last hits, window 0's slot and
// the distinct-row rounds after them (kt_core_out) are kt_core's.  Two
// forms: kt_core_skip, one read a warp (A on codes' wave 2), and, for K,
// kt_skip_anchors on the G = 32 / g reads of a warp at once (g lanes a
// read, as wave 1's groups; each read's first/last anchor hits and window
// 0's slot kept in its slot's KtSkipMeta) followed by kt_skip_finish read
// by read -- the anchor round of one read keeps only its na requests in
// flight, so K runs it for eight 100 bp reads together (9-11 % less device
// time than one read a warp on an H100, probe_ab.py; A on codes was
// fastest one read a warp).  ops/anchor.py skip_core_plain is the same in
// plain PyTorch, its mask of probed windows the count the card tests hold
// the kernels' probes (an optional counter) against.  What bounds it: the
// anchors' probes and payload reads, then the open intervals' probes and
// the covered intervals' block_ec8 sectors; the measured times follow the
// DRAM requests more than the probes skipped (PERF.md).
//
// Trap kept on purpose: a read without hits still reports f_strand from
// window 0's lookup slot (JAX argmax of an all-false row is 0), so window 0
// is always looked up (with q = mix64(0) when it is invalid), and its
// orientation comes from its bases with N read as 0.  Padding reads of
// kernel D have length 0 and follow the same rule.
//
// Kernel A, pseudoalign_side (wave 1, pseudoalign_side_kernel, then wave
// 2, pseudoalign_side_wave2_kernel, from one C call), and A on codes,
// pseudoalign_codes (pseudoalign_codes_kernel, then
// pseudoalign_codes_wave2_kernel: its wave 1 builds an anchor's k-mer
// from the aligned 4-byte words that hold its k codes, a code above 3
// failing the read, and its wave 2 runs kt_core_skip), share wave 1's
// body (kt_verify_reads).  Kernel A is
// pseudoalign_batch_packed as two launches on one stream, in the manner of
// kernel I below, and gives every read the dense core's ten fields bit for
// bit; its wave 1 shares kernel I's anchor check, block rows and failure
// list (kt_anchor_check, kt_block_rows, kt_fail_append).  Wave 1: a group of g lanes per read (g the power of two >=
// n_anchors_for(Lp, k), at most 32: eight 100 bp reads a warp).  Each
// read uses its own length: wlast = len - k, n_anchors_for(len, k)
// anchors at w_j = (wlast * j) / (n_anchors - 1), lanes past its count
// idle.  Lane j builds anchor j's k-mers from the 8-9 packed bytes that
// hold them and reads the window's k bits of the N bitmask (an N fails
// the read), probes (kt_probe) and reads uid, pos, fw and block on a hit.
// A read is verified when every anchor hits one unitig on one strand at
// upos_0 + sgn * w_j, its block range [blo, bhi] lies in two 8-wide rows
// of block_ec8 and, where R = min(max_rows, Lp - k + 1) < 16, holds at
// most R candidates.  Consecutive anchors are at most k apart, so their
// windows cover the read: it equals a stretch of that unitig, every
// window hits it where the anchors say, and its distinct EC rows are the
// block ECs of [blo, bhi] (never more than R, so overflow is 0); its first
// hit is anchor 0 (f_rpos 0) and rng = wlast.  A verified read writes all
// ten fields; every other read -- shorter than k or longer than Lp,
// length 0, an N in the read, a miss or a disagreement, a range past two
// rows -- goes to a list on the card (one warp-aggregated atomic a warp),
// so the core's traps (window 0's f_strand of a hitless read) stay the
// core's own.  Wave 2 (a grid sized by occupancy that reads the list's
// count on the card, no host round trip) runs A's decode (kt_decode_nmask)
// and the core on each listed read.  ops/anchor.py side_waves_plain is
// the same split in plain PyTorch (the tests hold it equal to the dense
// plain version).  What bounds it: as kernel I, n_anchors lookups and
// two 32-byte block_ec8 rows a verified read, and the core's per-window
// table reads for the wave-2 share.
//
// Kernel I, pseudoalign_anchor (wave 1) and pseudoalign_anchor_wave2,
// replaces the two-wave anchor program, kallisto_tpu/ops/anchor.py
// _anchor_canon (:66), _anchor_side (:85) and _apply_aux (:189) as
// reached through pseudoalign_pair_anchor (:218) and
// pseudoalign_single_anchor (:249); the keys and the table after it are
// kernels B and E.  It takes kernel D's inputs (uniform length: rlen and
// n_real from the aux vector).
//   wave 1 -- a group of g lanes per read (g the power of two >= n_anchors,
//     at most 32: 100 bp reads have 4 anchors, so a warp holds 8 reads;
//     past 32 anchors the group is the warp and loops).  Lane j of the
//     group takes anchor j's window w_j = (wlast * j) / (n_anchors - 1),
//     wlast = max(rlen - k, 0), builds its k-mers from the 9 bytes of the
//     packed row in device memory that hold them (the read's N positions
//     from kt_exc_lower over the group, cleared and marking the window
//     invalid), looks it up (anchor 0 even when invalid, for f_strand),
//     and reads its uid, pos, fw and block on a hit.  A vote over the
//     group gives "every anchor hits one unitig on one strand at upos_0 +
//     sgn * w_j", shuffle minimum and maximum over the group the block
//     range [blo, bhi].  A verified read (also blo >= 0, the range within
//     two 8-wide rows of block_ec8, the read real and >= k long) takes
//     the sorted distinct block ECs of that range from the two rows
//     spread over the group, by rounds of group minimum; its first hit is
//     anchor 0 with f_rpos = 0 and rng = wlast.  Padding reads (and every
//     read when rlen < k) are written as reads without hits.  Any other
//     read is failing: its index is appended to a list on the card with a
//     warp-aggregated atomic on the counter n_fail.
//   wave 2 -- a second launch on the same stream: a grid of warps sized
//     by occupancy takes the listed reads in list order and runs kernel
//     D's decode and core on each (the list's order is free: outputs are
//     indexed by read).  JAX packs these reads into a fixed-size
//     sub-batch for the TPU's static shapes; here every failing read gets
//     its result and no capacity exists.  The core's rows number min(R,
//     W); a one-slot row fills all R slots, as JAX's broadcast does (the
//     wrapper refuses 1 < min(R, W) < R, where JAX raises).
//   n_fail -- the wave-2 read count (an int64 on the card, zeroed before
//     wave 1); the anchor functions put it in the key table's meta row.
// What bounds it: the same random table reads as D, for n_anchors lookups
// per verified read instead of W, plus D's per-window reads for the
// wave-2 share (51 % of reads on the smoke's simulated 2x100 bp data).
// What the design does about it: verified reads cost n_anchors lookups
// and two 32-byte block_ec8 rows, eight reads to a warp; failing reads pay
// what kernel D pays, in warps of their own, so a warp of verified reads
// never waits on a failing one.
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
//   the failed mate -- kernel D's decode (kt_decode_exc_group: the
//     warp's G failed mates together) and the covered-interval core
//     (kt_skip_anchors for the G reads, then kt_skip_finish for each),
//     R = min(max_rows, W) rows (the core's clamp);
//   the verified mate -- rebuilt as kernel I rebuilds a verified read: the
//     sorted distinct block ECs of [blo, blo + span], 16 lanes loading the
//     two block_ec8 rows of r0 = max(blo, 0) >> 3 and up to min(R, 16)
//     rounds of __reduce_min_sync (until nothing is left: the core's
//     lower residency left K 9-15 % slower while they ran all 16), the
//     rest of the R slots INT32_MAX, with the SAME
//     width R as the failed mate (JAX turbo.py:215-221); first hit block
//     blo (forward) or blo + span (reverse), upos0, f_rpos 0, f_uid 0, rng
//     len - k.  A padding pair (row >= n_real) stays no-hit on both mates.
// What bounds it: the failed mate's table reads, the covered-interval
// core's (its mates failed the host probe, so a whole-read check cannot
// help them; one error or one unitig boundary leaves covered intervals
// between its agreeing anchors); the verified mate costs one 64-byte
// read of block_ec8 and 8 bytes of summary
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
//
// Registers and spills of every kernel are printed at each build
// (-Xptxas -v, which ops/kernels.py passes for this file); PERF.md keeps
// the counts of the measured build.

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

#define KT_PER 2    // windows of a lane probed together (a pass: 64)
#define KT_WPB 8    // warps per block, fewer when shared memory runs short

// The warp's shared words for a read of Lc code columns: the 2-bit codes
// (32 a word) and the N mask (64 a word), each with one spare word.
__host__ __device__ static inline int kt_pkw(int Lc) { return (Lc + 31) / 32 + 1; }
__host__ __device__ static inline int kt_nmw(int Lc) { return (Lc + 63) / 64 + 1; }

// Bits [bit, bit + 64) of the little-endian bit string a (its word
// bit >> 6 and the next one).
__device__ __forceinline__ unsigned long long kt_bits(
    const unsigned long long* a, int bit) {
    const int wi = bit >> 6, s = bit & 63;
    const unsigned long long lo = a[wi];
    return s ? (lo >> s) | (a[wi + 1] << (64 - s)) : lo;
}

// Bits [bit, bit + nbits) (nbits <= 64) of a packed row of LB bytes in
// device memory; bytes past the row read as 0.
__device__ __forceinline__ unsigned long long kt_row_bits(
    const unsigned char* __restrict__ row, int LB, int bit, int nbits) {
    const int b0 = bit >> 3, s = bit & 7;
    const int nb = (s + nbits + 7) >> 3;
    unsigned long long lo = 0, hi = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
        if (t < nb && b0 + t < LB) {
            const unsigned long long v = __ldg(row + b0 + t);
            if (t < 8)
                lo |= v << (8 * t);
            else
                hi = v;
        }
    }
    return s ? (lo >> s) | (hi << (64 - s)) : lo;
}

// The 32 2-bit groups of x in reverse order.
__device__ __forceinline__ unsigned long long kt_rev2(unsigned long long x) {
    x = __brevll(x);
    return ((x >> 1) & 0x5555555555555555ULL) |
           ((x & 0x5555555555555555ULL) << 1);
}

// Bit i of v moved to bit 2i.
__device__ __forceinline__ unsigned long long kt_spread(unsigned int v) {
    unsigned long long x = v;
    x = (x | (x << 16)) & 0x0000FFFF0000FFFFULL;
    x = (x | (x << 8)) & 0x00FF00FF00FF00FFULL;
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0FULL;
    x = (x | (x << 2)) & 0x3333333333333333ULL;
    x = (x | (x << 1)) & 0x5555555555555555ULL;
    return x;
}

// Minimum, maximum and "all" over the aligned group of g lanes (g a power
// of two <= 32) that holds this lane; every lane of the warp calls them.
__device__ __forceinline__ int kt_group_min(int v, int g) {
    for (int o = g >> 1; o > 0; o >>= 1)
        v = min(v, __shfl_xor_sync(KT_FULL, v, o));
    return v;
}
__device__ __forceinline__ int kt_group_max(int v, int g) {
    for (int o = g >> 1; o > 0; o >>= 1)
        v = max(v, __shfl_xor_sync(KT_FULL, v, o));
    return v;
}
__device__ __forceinline__ int kt_group_all(int p, int g) {
    const int gbase = (threadIdx.x & 31) & ~(g - 1);
    const unsigned gm = g == 32 ? KT_FULL : ((1u << g) - 1u) << gbase;
    return (__ballot_sync(KT_FULL, p) & gm) == gm;
}

// ------------------------------------------- anchor waves (kernels A and I)

// One read's anchors, checked by its group of g lanes (wave 1 of kernels A
// and I).  The read has na anchors (0 for none) at w_j = (wlast * j) /
// (na - 1), NA the most any read of the warp has; lane jl takes anchors
// jl, jl + g, ...  fetch(j, w, hit, uid, upos, strand, blk) builds and
// probes anchor j at window w, setting the payload on a hit (and strand
// as its kernel wants it on a miss).  all_ok: every anchor hits one unitig
// on one strand at upos_0 + sgn * w_j; [blo, bhi]: the anchors' blocks (a
// miss counts block 0); uid0 ... blk0: anchor 0's payload.
struct KtAnchors {
    int all_ok, blo, bhi, uid0, upos0, str0, blk0;
};

template <typename Fetch>
__device__ __forceinline__ KtAnchors kt_anchor_check(int NA, int na, int wlast,
                                                     int g, int jl,
                                                     Fetch fetch) {
    KtAnchors r = {1, KT_INT32_MAX, -KT_INT32_MAX - 1, 0, 0, 0, 0};
    for (int base = 0; base < NA; base += g) {
        const int j = base + jl;
        const int a = j < na;
        int hit = 0, uid = -1, upos = 0, strand = 0, blk = 0, w = 0;
        if (a) {
            w = (int)(((long long)wlast * j) / (na - 1));
            fetch(j, w, hit, uid, upos, strand, blk);
            r.blo = min(r.blo, blk);
            r.bhi = max(r.bhi, blk);
        }
        if (base == 0) {
            r.uid0 = __shfl_sync(KT_FULL, uid, 0, g);
            r.upos0 = __shfl_sync(KT_FULL, upos, 0, g);
            r.str0 = __shfl_sync(KT_FULL, strand, 0, g);
            r.blk0 = __shfl_sync(KT_FULL, blk, 0, g);
        }
        const int sgn = r.str0 ? 1 : -1;
        const int lane_ok = !a || (hit && uid == r.uid0 && strand == r.str0 &&
                                   upos == r.upos0 + sgn * w);
        r.all_ok &= kt_group_all(lane_ok, g);
    }
    r.blo = kt_group_min(r.blo, g);
    r.bhi = kt_group_max(r.bhi, g);
    return r;
}

// A verified read's rows (ok; wave 1 of kernels A and I): the block ECs of
// [blo, bhi], which lie in two 8-wide rows of block_ec8, spread over the
// group (entry c in cv[c / g] of lane c mod g), then written in ascending
// order by rounds of group minimum to rows[0, Rv), lane s mod g writing
// slot s where `write`.  Returns how many; *last is the largest (-1 for
// none), so cv's entries above it are the ones past Rv.
__device__ __forceinline__ int kt_block_rows(const int* __restrict__ be8,
                                             long long n_be8, int ok, int blo,
                                             int bhi, int g, int jl, int Rv,
                                             int write, int* rows, int (&cv)[8],
                                             int* last) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
        const int c = jl + g * t;
        cv[t] = KT_INT32_MAX;
        if (ok && c < 16) {
            const long long fid = (long long)(blo >> 3) * 8 + c;
            if (fid <= bhi && fid >= blo && fid < n_be8) {
                const int e = be8[fid];
                if (e >= 0) cv[t] = e;
            }
        }
    }
    int prev = -1, nr = 0;
    for (int s = 0; s < Rv; ++s) {
        int mm = KT_INT32_MAX;
#pragma unroll
        for (int t = 0; t < 8; ++t)
            if (cv[t] > prev && cv[t] < mm) mm = cv[t];
        mm = kt_group_min(mm, g);
        if (mm != KT_INT32_MAX) {
            if (write && jl == s % g) rows[s] = mm;
            prev = mm;
            ++nr;
        }
        if (__all_sync(KT_FULL, mm == KT_INT32_MAX)) break;
    }
    *last = prev;
    return nr;
}

// The failing reads of a warp's groups (fail, voted by lane jl 0 of each)
// appended to fail_list, counted in n_fail: one atomic per warp.
__device__ __forceinline__ void kt_fail_append(int fail, int jl, long long read,
                                               int* __restrict__ fail_list,
                                               unsigned long long* n_fail) {
    const int lane = threadIdx.x & 31;
    const unsigned lead = __ballot_sync(KT_FULL, fail && jl == 0);
    if (lead) {
        const int leader = __ffs(lead) - 1;
        unsigned long long at = 0;
        if (lane == leader)
            at = atomicAdd(n_fail, (unsigned long long)__popc(lead));
        at = __shfl_sync(KT_FULL, at, leader);
        if (fail && jl == 0)
            fail_list[at + __popc(lead & ((1u << lane) - 1u))] = (int)read;
    }
}

// The exception list's splitters in shared memory: s[i] = exc[min((i + 1)
// * st, n) - 1], the last entry of segment i, for the ns = ceil(n / st)
// segments of st = ceil(n / KT_SPLIT) entries.  Every thread of the block
// calls kt_split_init (one barrier).
#define KT_SPLIT 2048

struct KtSplit {
    const long long* s;
    int ns;
    long long st;
};

__device__ KtSplit kt_split_init(long long* s, const long long* __restrict__ exc,
                                 long long n) {
    KtSplit sp;
    sp.st = n > 0 ? (n + KT_SPLIT - 1) / KT_SPLIT : 1;
    sp.ns = (int)((n + sp.st - 1) / sp.st);
    for (int i = threadIdx.x; i < sp.ns; i += blockDim.x) {
        const long long e = (long long)(i + 1) * sp.st;
        s[i] = exc[(e < n ? e : n) - 1];
    }
    __syncthreads();
    sp.s = s;
    return sp;
}

// First index of the sorted exc[0, n) whose value is >= key: a binary
// search over the splitters in shared memory, then over one segment.
__device__ __forceinline__ long long kt_exc_lower(
    const KtSplit& sp, const long long* __restrict__ exc, long long n,
    long long key) {
    int lo = 0, hi = sp.ns;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sp.s[mid] < key)
            lo = mid + 1;
        else
            hi = mid;
    }
    long long a = (long long)lo * sp.st;
    long long b = a + sp.st < n ? a + sp.st : n;
    if (a > n) a = n;
    while (a < b) {
        const long long mid = (a + b) >> 1;
        if (exc[mid] < key)
            a = mid + 1;
        else
            b = mid;
    }
    return a;
}

// The probes of NQ queries of one lane (bit j of act: query j is probed),
// each dependent step issued for every query before the next step: slot
// idx[j] and EC row ec[j] (-1 on a miss) as kt_probe gives them; returns
// the hit bits.  Padded rows wider than 8 slots probe one query at a time.
template <int NQ>
__device__ __forceinline__ unsigned kt_probe_n(const IndexView& ix,
                                               const unsigned long long* q,
                                               unsigned act, long long* idx,
                                               int* ec) {
    unsigned hit = 0;
    const int sh = 64 - ix.p;
    if (ix.S > 8) {
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            long long t = 0;
            int e = -1;
            if (((act >> j) & 1) && kt_probe(ix, q[j], &t, &e)) hit |= 1u << j;
            idx[j] = t;
            ec[j] = e;
        }
        return hit;
    }
    if (ix.S) {
        const int S = ix.S;
        int jm[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            const long long b = (long long)(q[j] >> sh);
            idx[j] = b * S;
            jm[j] = -1;
            if ((act >> j) & 1) {
                const ulonglong2* r2 = (const ulonglong2*)(ix.rows + b * 2 * S);
                ulonglong2 v[4];
#pragma unroll
                for (int h = 0; h < 4; ++h)
                    if (2 * h < S) v[h] = __ldg(r2 + h);
                // the first matching slot, as kt_probe and JAX's argmax
#pragma unroll
                for (int h = 3; h >= 0; --h) {
                    if (2 * h + 1 < S && v[h].y == q[j]) jm[j] = 2 * h + 1;
                    if (2 * h < S && v[h].x == q[j]) jm[j] = 2 * h;
                }
            }
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            ec[j] = -1;
            if (jm[j] >= 0) {
                ec[j] = (int)(unsigned int)__ldg(ix.rows + 2 * idx[j] + S + jm[j]);
                idx[j] += jm[j];
                hit |= 1u << j;
            }
        }
        return hit;
    }
    const int nm1 = (int)(ix.N - 1);
    int lo[NQ], n[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
        lo[j] = 0;
        n[j] = 0;
        if ((act >> j) & 1) {
            const long long b = (long long)(q[j] >> sh);
            lo[j] = ix.bucket_start[b];
            n[j] = ix.bucket_start[b + 1] - lo[j];
        }
    }
    // a query whose bucket is empty misses; one whose key the search
    // meets is a hit at that slot (the keys are distinct, so it is the
    // lower bound): neither reads the key at the end
    unsigned live = 0, eq = 0;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
        if (((act >> j) & 1) && n[j] > 0) live |= 1u << j;
    for (int s = 0; s < KT_DEPTH; ++s) {
        unsigned more = 0;
#pragma unroll
        for (int j = 0; j < NQ; ++j)
            if (((act >> j) & 1) && n[j] > 0) more |= 1u << j;
        if (!more) break;
        int m[NQ];
        unsigned long long key[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            m[j] = min(lo[j] + (n[j] >> 1), nm1);
            key[j] = ((more >> j) & 1) ? ix.hkeys[m[j]] : 0ULL;
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            if ((more >> j) & 1) {
                const int half = n[j] >> 1;
                if (key[j] < q[j]) {
                    lo[j] = m[j] + 1;
                    n[j] = n[j] - half - 1;
                } else {
                    n[j] = half;
                    if (key[j] == q[j]) eq |= 1u << j;
                }
            }
        }
    }
    const unsigned rest = live & ~eq;
    unsigned long long key[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
        idx[j] = min(lo[j], nm1);
        key[j] = ((rest >> j) & 1) ? ix.hkeys[idx[j]] : 0ULL;
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
        ec[j] = -1;
        if (((eq >> j) & 1) || (((rest >> j) & 1) && key[j] == q[j])) {
            ec[j] = ix.ec[idx[j]];
            hit |= 1u << j;
        }
    }
    return hit;
}

// The end of a read in the per-read cores (kt_core, kt_core_skip,
// kt_skip_finish): every window's slot of wrows holds its EC row
// (INT32_MAX: none); each lane
// brings its first hit (window lfirst, slot lidx, orientation lfw; lfirst
// INT32_MAX for none) and last hit llast, and lane 0 window 0's slot idx0
// and orientation fw0.  Writes the read's SideResult (R row slots at row
// stride RS) and returns its first row slot (the same in every lane).
__device__ __forceinline__ int kt_core_out(const IndexView& ix,
                                           const int* wrows, long long read,
                                           int W, int R, int RS,
                                           const SideOut& o, int lfirst,
                                           int llast, long long lidx, int lfw,
                                           long long idx0, int fw0) {
    const int lane = threadIdx.x & 31;
    // window 0 stands in for the first hit of a read without hits
    const int first = __reduce_min_sync(KT_FULL, lfirst);
    const int last = __reduce_max_sync(KT_FULL, llast);
    const int has = first != KT_INT32_MAX;
    // the lane that holds the first hit (in kt_core, lane first & 31)
    const int src =
        has ? __ffs(__ballot_sync(KT_FULL, lfirst == first)) - 1 : 0;
    const long long fidx = __shfl_sync(KT_FULL, has ? lidx : idx0, src);
    const int ffw = __shfl_sync(KT_FULL, has ? lfw : fw0, src);

    // the R smallest distinct non-empty rows, then one more round for
    // `overflow`: a distinct row beyond the R-th (core :534-536)
    int prev = -1, nr = 0, ov = 0, row0 = KT_INT32_MAX;
    for (int s = 0; s <= R; ++s) {
        int m = KT_INT32_MAX;
        for (int w = lane; w < W; w += 32) {
            const int v = wrows[w];
            if (v > prev && v < m) m = v;
        }
        m = __reduce_min_sync(KT_FULL, m);
        if (m == KT_INT32_MAX) break;
        if (s == R) {
            ov = 1;
            break;
        }
        if (lane == (s & 31)) o.rows[read * RS + s] = m;
        if (s == 0) row0 = m;
        prev = m;
        ++nr;
    }
    for (int s = nr + lane; s < R; s += 32) o.rows[read * RS + s] = KT_INT32_MAX;
    if (lane == 0) {
        o.n_rows[read] = nr;
        o.has_hits[read] = (unsigned char)has;
        o.overflow[read] = (unsigned char)ov;
        o.f_strand[read] = (unsigned char)(ffw == (int)(ix.fw[fidx] != 0));
        o.f_rpos[read] = has ? first : -1;
        o.rng[read] = has ? last - first : -1;
    } else if (lane == 1) {
        o.f_uid[read] = has ? ix.uid[fidx] : -1;
    } else if (lane == 2) {
        o.f_block[read] = has ? ix.block[fidx] : -1;
    } else if (lane == 3) {
        o.f_upos[read] = has ? ix.pos[fidx] : -1;
    }
    __syncwarp();  // the next read's decode rewrites the warp's words
    return row0;
}

// One read, one warp (see the file header).  pk holds the read's 2-bit
// codes (base j at bits 2j, 2j + 1 of the little-endian words, N bases
// 0), nm its N mask (bit j), each with a spare word; wrows is W ints of
// the warp's shared scratch, of which lane l uses the slots w = l mod 32.
// Writes the read's SideResult: R row slots at a row stride of RS >= R.
// Returns the read's first row slot (the same in every lane).
__device__ int kt_core(const IndexView& ix, const unsigned long long* pk,
                       const unsigned long long* nm, int* wrows,
                       long long read, int len, int W, int k, int R, int RS,
                       const SideOut& o) {
    const int lane = threadIdx.x & 31;
    const unsigned long long kmask =
        k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1ULL);
    const unsigned long long nmk = (1ULL << k) - 1ULL;
    const int fsh = 64 - 2 * k;
    int lfirst = KT_INT32_MAX, llast = -1, lfw = 0, fw0 = 0;
    long long lidx = 0, idx0 = 0;
    for (int base = 0; base < W; base += 32 * KT_PER) {
        unsigned long long q[KT_PER];
        unsigned act = 0, val = 0, fwm = 0;
#pragma unroll
        for (int j = 0; j < KT_PER; ++j) {
            const int w = base + 32 * j + lane;
            q[j] = 0;
            if (w < W) {
                const unsigned long long x = kt_bits(pk, 2 * w);
                const unsigned long long f = kt_rev2(x) >> fsh;
                const unsigned long long r = ~x & kmask;
                const int valid = (kt_bits(nm, w) & nmk) == 0 && w + k <= len;
                const int isfw = f <= r;
                fwm |= (unsigned)isfw << j;
                val |= (unsigned)valid << j;
                if (valid || w == 0) {
                    act |= 1u << j;
                    q[j] = kt_mix64(valid ? (isfw ? f : r) : 0ULL);
                }
            }
        }
        long long idx[KT_PER];
        int ec[KT_PER];
        const unsigned hm = kt_probe_n<KT_PER>(ix, q, act, idx, ec) & val;
#pragma unroll
        for (int j = 0; j < KT_PER; ++j) {
            const int w = base + 32 * j + lane;
            if (w < W) {
                const int hit = (hm >> j) & 1;
                wrows[w] = (hit && ec[j] >= 0) ? ec[j] : KT_INT32_MAX;
                if (hit) {
                    if (lfirst == KT_INT32_MAX) {
                        lfirst = w;
                        lidx = idx[j];
                        lfw = (fwm >> j) & 1;
                    }
                    llast = w;
                }
                if (w == 0) {
                    idx0 = idx[j];
                    fw0 = fwm & 1;
                }
            }
        }
    }
    return kt_core_out(ix, wrows, read, W, R, RS, o, lfirst, llast, lidx, lfw,
                       idx0, fw0);
}

// Position of the n-th set bit (from 0) of m; n < popc(m).
__device__ __forceinline__ int kt_select(unsigned m, int n) {
    int p = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        const int c = __popc(m & ((1u << s) - 1u));
        if (n >= c) {
            n -= c;
            m >>= s;
            p += s;
        }
    }
    return p;
}

#define KT_NEED (-2)  // a window's slot while it waits for its probe

// What the anchor phase of the covered-interval core leaves a read: its
// first anchor hit (window first_w, INT32_MAX for none; slot first_idx,
// orientation first_fw), its last anchor hit and window 0's slot and
// orientation.
struct KtSkipMeta {
    long long first_idx, idx0;
    int first_w, first_fw, last, fw0;
};

// The covered-interval core's shared memory: a warp holds G reads of Lc
// code columns, read r in slot r of the warp's share: its 2-bit codes (pk,
// kt_pkw words), N mask (nm, kt_nmw words), row scratch (wrows, W ints)
// and KtSkipMeta.
__host__ __device__ static inline int kt_slot_bytes(int Lc, int W) {
    return 8 * (kt_pkw(Lc) + kt_nmw(Lc)) + ((4 * W + 7) & ~7) +
           (int)sizeof(KtSkipMeta);
}

struct KtSlots {
    unsigned char* base;
    int bytes, PKW, NMW;
    __device__ unsigned long long* pk(int r) const {
        return (unsigned long long*)(base + (long long)r * bytes);
    }
    __device__ unsigned long long* nm(int r) const { return pk(r) + PKW; }
    __device__ int* wrows(int r) const { return (int*)(nm(r) + NMW); }
    __device__ KtSkipMeta* meta(int r) const {
        return (KtSkipMeta*)(base + (long long)(r + 1) * bytes) - 1;
    }
};

__device__ __forceinline__ KtSlots kt_slots(int Lc, int W, int G) {
    extern __shared__ unsigned long long kt_smem[];
    KtSlots sl;
    sl.bytes = kt_slot_bytes(Lc, W);
    sl.base = (unsigned char*)kt_smem +
              (long long)(threadIdx.x >> 5) * G * sl.bytes;
    sl.PKW = kt_pkw(Lc);
    sl.NMW = kt_nmw(Lc);
    return sl;
}

// One pass of a read's anchors in the covered-interval core (see the
// file header), by the g lanes of its group: lane jl takes anchor j (< na:
// w_j = (wlast * j) / (na - 1), window 0 alone when na is 1), probes it
// (window 0 also when invalid) and on a hit reads its uid, pos, block and
// strand; with the next lane's anchor over a shuffle of width g it decides
// interval [w_j, w_j+1] (jl < g - 1): a covered interval writes the block
// ECs of the blocks strictly between its anchors' blocks (be8, block_ec8
// flat) into its skipped windows' slots and INT32_MAX into the rest, an
// open one marks its windows KT_NEED.  The lane's first and last hits,
// window 0's slot and its probe count (an anchor that two passes share,
// or window 0 twice, counts once) are updated.
__device__ __forceinline__ void kt_skip_pass(
    const IndexView& ix, const int* __restrict__ be8, long long n_be8,
    const unsigned long long* pk, const unsigned long long* nm, int* wrows,
    int j, int jl, int g, int na, int wlast, int k, int& lfirst, int& llast,
    long long& lidx, int& lfw, long long& idx0, int& fw0, int& nprobe) {
    const unsigned long long kmask =
        k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1ULL);
    const unsigned long long nmk = (1ULL << k) - 1ULL;
    const int fsh = 64 - 2 * k;
    int w = 0, hit = 0, uid = -1, upos = 0, str = 0, blk = 0;
    if (j < na) {
        w = na > 1 ? (int)(((long long)wlast * j) / (na - 1)) : 0;
        const unsigned long long x = kt_bits(pk, 2 * w);
        const unsigned long long f = kt_rev2(x) >> fsh;
        const unsigned long long rc = ~x & kmask;
        const int valid = wlast >= 0 && (kt_bits(nm, w) & nmk) == 0;
        const int isfw = f <= rc;
        long long idx = 0;
        int ec = -1;
        if (valid || w == 0) {
            hit = kt_probe(ix, kt_mix64(valid ? (isfw ? f : rc) : 0ULL), &idx,
                           &ec) && valid;
            if ((jl < g - 1 || j == na - 1) &&
                (j == 0 || w > (int)(((long long)wlast * (j - 1)) / (na - 1))))
                ++nprobe;
        }
        if (hit) {
            uid = ix.uid[idx];
            upos = ix.pos[idx];
            blk = ix.block[idx];
            str = isfw == (int)(ix.fw[idx] != 0);
            if (w < lfirst) {
                lfirst = w;
                lidx = idx;
                lfw = isfw;
            }
            llast = max(llast, w);
        }
        if (w == 0) {
            idx0 = idx;
            fw0 = isfw;
        }
        wrows[w] = (hit && ec >= 0) ? ec : KT_INT32_MAX;
    }
    const int w2 = __shfl_down_sync(KT_FULL, w, 1, g);
    const int hit2 = __shfl_down_sync(KT_FULL, hit, 1, g);
    const int uid2 = __shfl_down_sync(KT_FULL, uid, 1, g);
    const int upos2 = __shfl_down_sync(KT_FULL, upos, 1, g);
    const int str2 = __shfl_down_sync(KT_FULL, str, 1, g);
    const int blk2 = __shfl_down_sync(KT_FULL, blk, 1, g);
    if (jl < g - 1 && j + 1 < na) {
        const int blo = min(blk, blk2), bhi = max(blk, blk2);
        const int cov = hit && hit2 && uid == uid2 && str == str2 &&
                        upos2 == upos + (str ? w2 - w : w - w2) && blo >= 0 &&
                        (bhi >> 3) <= (blo >> 3) + 1;
        int t = w + 1;
        if (cov) {
            // at most w2 - w - 1 blocks lie strictly between
            for (int b = blo + 1; b < bhi && t < w2; ++b, ++t) {
                const int e = b < n_be8 ? __ldg(be8 + b) : -1;
                wrows[t] = e >= 0 ? e : KT_INT32_MAX;
            }
        }
        for (; t < w2; ++t) wrows[t] = cov ? KT_INT32_MAX : KT_NEED;
    }
}

// After a read's anchor passes, by the whole warp: rounds of compaction (a
// ballot and a prefix per 32 windows) hand the read's valid KT_NEED
// windows to the lanes, 32 * KT_PER a round, each probed by kt_probe_n;
// the other KT_NEED windows become INT32_MAX.  Updates the lane's first
// and last hits and probe count.
__device__ __forceinline__ void kt_skip_rest(
    const IndexView& ix, const unsigned long long* pk,
    const unsigned long long* nm, int* wrows, int W, int k, int& lfirst,
    int& llast, long long& lidx, int& lfw, int& nprobe) {
    const int lane = threadIdx.x & 31;
    const unsigned long long kmask =
        k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1ULL);
    const unsigned long long nmk = (1ULL << k) - 1ULL;
    const int fsh = 64 - 2 * k;
    for (;;) {
        int wq[KT_PER];
#pragma unroll
        for (int j = 0; j < KT_PER; ++j) wq[j] = -1;
        int off = 0, c = 0;
        for (; 32 * c < W && off < 32 * KT_PER; ++c) {
            const int w = 32 * c + lane;
            int need = 0;
            if (w < W && wrows[w] == KT_NEED) {
                need = (kt_bits(nm, w) & nmk) == 0;
                if (!need) wrows[w] = KT_INT32_MAX;
            }
            const unsigned m = __ballot_sync(KT_FULL, need);
#pragma unroll
            for (int j = 0; j < KT_PER; ++j) {
                const int t = 32 * j + lane - off;
                if (t >= 0 && t < __popc(m)) wq[j] = 32 * c + kt_select(m, t);
            }
            off += __popc(m);
        }
        if (off == 0) break;
        unsigned long long q[KT_PER];
        unsigned act = 0, fwm = 0;
#pragma unroll
        for (int j = 0; j < KT_PER; ++j) {
            q[j] = 0;
            if (wq[j] >= 0) {
                const unsigned long long x = kt_bits(pk, 2 * wq[j]);
                const unsigned long long f = kt_rev2(x) >> fsh;
                const unsigned long long rc = ~x & kmask;
                const int isfw = f <= rc;
                fwm |= (unsigned)isfw << j;
                act |= 1u << j;
                q[j] = kt_mix64(isfw ? f : rc);
            }
        }
        long long idx[KT_PER];
        int ec[KT_PER];
        const unsigned hm = kt_probe_n<KT_PER>(ix, q, act, idx, ec);
#pragma unroll
        for (int j = 0; j < KT_PER; ++j) {
            const int w = wq[j];
            if (w >= 0) {
                const int hit = (hm >> j) & 1;
                wrows[w] = (hit && ec[j] >= 0) ? ec[j] : KT_INT32_MAX;
                ++nprobe;
                if (hit) {
                    if (w < lfirst) {
                        lfirst = w;
                        lidx = idx[j];
                        lfw = (fwm >> j) & 1;
                    }
                    llast = max(llast, w);
                }
            }
        }
        __syncwarp();
        if (32 * c >= W && off <= 32 * KT_PER) break;
    }
    __syncwarp();
}

// The covered-interval core on one read, one warp (A on codes' wave 2;
// see the file header): kt_core's result, bit for bit, from the anchors
// and the windows of the intervals that no pair of agreeing anchors
// covers.  Its steps are those of kt_skip_pass (31 intervals a pass: lane
// l's anchor and lane l + 1's bound interval base + l) and kt_skip_rest,
// written out in one function: built from those helpers it took 96
// registers instead of 76 and A on codes 1.09 ms of device time instead of
// 0.89 on an H100 (probe_ab.py).  n_probed (may be null) gains the windows
// probed.
__device__ int kt_core_skip(const IndexView& ix, const int* __restrict__ be8,
                            long long n_be8, const unsigned long long* pk,
                            const unsigned long long* nm, int* wrows,
                            long long read, int len, int W, int k, int R,
                            int RS, const SideOut& o,
                            unsigned long long* n_probed) {
    const int lane = threadIdx.x & 31;
    const unsigned long long kmask =
        k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1ULL);
    const unsigned long long nmk = (1ULL << k) - 1ULL;
    const int fsh = 64 - 2 * k;
    const int Lc = W + k - 1;
    const int wlast = (len < Lc ? len : Lc) - k;  // < 0: no valid window
    const int na = wlast < 0 ? 1 : max(2, (wlast + k - 1) / k + 1);
    int lfirst = KT_INT32_MAX, llast = -1, lfw = 0, fw0 = 0, nprobe = 0;
    long long lidx = 0, idx0 = 0;

    // windows past the read's last: invalid, no row
    for (int w = (wlast > 0 ? wlast : 0) + 1 + lane; w < W; w += 32)
        wrows[w] = KT_INT32_MAX;

    for (int base = 0; base == 0 || base < na - 1; base += 31) {
        const int j = base + lane;
        int w = 0, hit = 0, uid = -1, upos = 0, str = 0, blk = 0;
        if (j < na) {
            w = na > 1 ? (int)(((long long)wlast * j) / (na - 1)) : 0;
            const unsigned long long x = kt_bits(pk, 2 * w);
            const unsigned long long f = kt_rev2(x) >> fsh;
            const unsigned long long r = ~x & kmask;
            const int valid = wlast >= 0 && (kt_bits(nm, w) & nmk) == 0;
            const int isfw = f <= r;
            long long idx = 0;
            int ec = -1;
            if (valid || w == 0) {
                hit = kt_probe(ix, kt_mix64(valid ? (isfw ? f : r) : 0ULL),
                               &idx, &ec) && valid;
                // an anchor that two passes share, or window 0 twice
                // (wlast = 0), counts once
                if ((lane < 31 || j == na - 1) &&
                    (j == 0 ||
                     w > (int)(((long long)wlast * (j - 1)) / (na - 1))))
                    ++nprobe;
            }
            if (hit) {
                uid = ix.uid[idx];
                upos = ix.pos[idx];
                blk = ix.block[idx];
                str = isfw == (int)(ix.fw[idx] != 0);
                if (w < lfirst) {
                    lfirst = w;
                    lidx = idx;
                    lfw = isfw;
                }
                llast = max(llast, w);
            }
            if (w == 0) {
                idx0 = idx;
                fw0 = isfw;
            }
            wrows[w] = (hit && ec >= 0) ? ec : KT_INT32_MAX;
        }
        // interval [w, w2] with the next lane's anchor
        const int w2 = __shfl_down_sync(KT_FULL, w, 1);
        const int hit2 = __shfl_down_sync(KT_FULL, hit, 1);
        const int uid2 = __shfl_down_sync(KT_FULL, uid, 1);
        const int upos2 = __shfl_down_sync(KT_FULL, upos, 1);
        const int str2 = __shfl_down_sync(KT_FULL, str, 1);
        const int blk2 = __shfl_down_sync(KT_FULL, blk, 1);
        if (lane < 31 && j + 1 < na) {
            const int blo = min(blk, blk2), bhi = max(blk, blk2);
            const int cov = hit && hit2 && uid == uid2 && str == str2 &&
                            upos2 == upos + (str ? w2 - w : w - w2) &&
                            blo >= 0 && (bhi >> 3) <= (blo >> 3) + 1;
            int t = w + 1;
            if (cov) {
                // at most w2 - w - 1 blocks lie strictly between
                for (int b = blo + 1; b < bhi && t < w2; ++b, ++t) {
                    const int e = b < n_be8 ? __ldg(be8 + b) : -1;
                    wrows[t] = e >= 0 ? e : KT_INT32_MAX;
                }
            }
            for (; t < w2; ++t) wrows[t] = cov ? KT_INT32_MAX : KT_NEED;
        }
    }
    __syncwarp();

    // the open intervals' valid windows, compacted onto the lanes
    for (;;) {
        int wq[KT_PER];
#pragma unroll
        for (int j = 0; j < KT_PER; ++j) wq[j] = -1;
        int off = 0, c = 0;
        for (; 32 * c < W && off < 32 * KT_PER; ++c) {
            const int w = 32 * c + lane;
            int need = 0;
            if (w < W && wrows[w] == KT_NEED) {
                need = (kt_bits(nm, w) & nmk) == 0;
                if (!need) wrows[w] = KT_INT32_MAX;
            }
            const unsigned m = __ballot_sync(KT_FULL, need);
#pragma unroll
            for (int j = 0; j < KT_PER; ++j) {
                const int t = 32 * j + lane - off;
                if (t >= 0 && t < __popc(m)) wq[j] = 32 * c + kt_select(m, t);
            }
            off += __popc(m);
        }
        if (off == 0) break;
        unsigned long long q[KT_PER];
        unsigned act = 0, fwm = 0;
#pragma unroll
        for (int j = 0; j < KT_PER; ++j) {
            q[j] = 0;
            if (wq[j] >= 0) {
                const unsigned long long x = kt_bits(pk, 2 * wq[j]);
                const unsigned long long f = kt_rev2(x) >> fsh;
                const unsigned long long r = ~x & kmask;
                const int isfw = f <= r;
                fwm |= (unsigned)isfw << j;
                act |= 1u << j;
                q[j] = kt_mix64(isfw ? f : r);
            }
        }
        long long idx[KT_PER];
        int ec[KT_PER];
        const unsigned hm = kt_probe_n<KT_PER>(ix, q, act, idx, ec);
#pragma unroll
        for (int j = 0; j < KT_PER; ++j) {
            const int w = wq[j];
            if (w >= 0) {
                const int hit = (hm >> j) & 1;
                wrows[w] = (hit && ec[j] >= 0) ? ec[j] : KT_INT32_MAX;
                ++nprobe;
                if (hit) {
                    if (w < lfirst) {
                        lfirst = w;
                        lidx = idx[j];
                        lfw = (fwm >> j) & 1;
                    }
                    llast = max(llast, w);
                }
            }
        }
        __syncwarp();
        if (32 * c >= W && off <= 32 * KT_PER) break;
    }
    __syncwarp();
    if (n_probed) {
        const int n = __reduce_add_sync(KT_FULL, nprobe);
        if (lane == 0) atomicAdd(n_probed, (unsigned long long)n);
    }
    return kt_core_out(ix, wrows, read, W, R, RS, o, lfirst, llast, lidx, lfw,
                       idx0, fw0);
}

// The covered-interval core's anchor passes for the nr <= G = 32 / g reads
// of a warp (kernel K's failed mates), decoded in slots 0 .. nr - 1: g
// lanes a read (lane r * g + jl takes read r, of length len), NA the most
// anchors a read of the batch has (more than 32: one read, passes of 31
// intervals).  Leaves each read's first and last anchor hits and window
// 0's slot in its KtSkipMeta; nprobe counts the lane's probes.
__device__ void kt_skip_anchors(const IndexView& ix,
                                const int* __restrict__ be8, long long n_be8,
                                const KtSlots& sl, int nr, int len, int W,
                                int k, int NA, int g, int& nprobe) {
    const int lane = threadIdx.x & 31;
    const int r = lane / g, jl = lane & (g - 1);
    const int act = r < nr;
    const int Lc = W + k - 1;
    const int wlast = act ? (len < Lc ? len : Lc) - k : -1;
    const int na = !act ? 0 : wlast < 0 ? 1 : max(2, (wlast + k - 1) / k + 1);
    const int ra = act ? r : 0;
    int* wrows = sl.wrows(ra);
    int lfirst = KT_INT32_MAX, llast = -1, lfw = 0, fw0 = 0;
    long long lidx = 0, idx0 = 0;
    if (act)
        for (int w = (wlast > 0 ? wlast : 0) + 1 + jl; w < W; w += g)
            wrows[w] = KT_INT32_MAX;
    for (int base = 0; base == 0 || base < NA - 1; base += g - 1)
        kt_skip_pass(ix, be8, n_be8, sl.pk(ra), sl.nm(ra), wrows, base + jl,
                     jl, g, na, wlast, k, lfirst, llast, lidx, lfw, idx0, fw0,
                     nprobe);
    // the read's first anchor hit from its lowest lane that holds it
    const int first = kt_group_min(lfirst, g);
    const int last = kt_group_max(llast, g);
    const unsigned gm = g == 32 ? KT_FULL : ((1u << g) - 1u) << (lane & ~(g - 1));
    const unsigned own = __ballot_sync(KT_FULL, lfirst == first) & gm;
    KtSkipMeta* mt = sl.meta(ra);
    if (act && lane == __ffs(own) - 1) {
        mt->first_w = first;
        mt->first_idx = lidx;
        mt->first_fw = lfw;
        mt->last = last;
    }
    if (act && jl == 0) {
        mt->idx0 = idx0;
        mt->fw0 = fw0;
    }
    __syncwarp();
}

// The rest of the covered-interval core for read `read` in slot r after
// kt_skip_anchors, by the whole warp: kt_skip_rest from the read's
// KtSkipMeta, then kt_core_out.  Returns the read's first row slot.
__device__ int kt_skip_finish(const IndexView& ix, const KtSlots& sl, int r,
                              long long read, int W, int k, int R, int RS,
                              const SideOut& o, int& nprobe) {
    const int lane = threadIdx.x & 31;
    const KtSkipMeta mt = *sl.meta(r);
    int lfirst = lane == 0 ? mt.first_w : KT_INT32_MAX;
    int llast = lane == 0 ? mt.last : -1;
    long long lidx = mt.first_idx;
    int lfw = mt.first_fw;
    kt_skip_rest(ix, sl.pk(r), sl.nm(r), sl.wrows(r), W, k, lfirst, llast,
                 lidx, lfw, nprobe);
    return kt_core_out(ix, sl.wrows(r), read, W, R, RS, o, lfirst, llast, lidx,
                       lfw, mt.idx0, mt.fw0);
}

// The warp's nprobe into *n_probed (may be null); every lane calls it.
__device__ __forceinline__ void kt_count_probes(unsigned long long* n_probed,
                                                int nprobe) {
    if (n_probed) {
        const int n = __reduce_add_sync(KT_FULL, nprobe);
        if ((threadIdx.x & 31) == 0) atomicAdd(n_probed, (unsigned long long)n);
    }
}

// The warp's share of the block's dynamic shared memory for reads of Lc
// code columns: pk, nm and the row scratch (kt_launch_shape sizes it).
struct KtWarpMem {
    unsigned long long* pk;
    unsigned long long* nm;
    int* wrows;
};

__device__ __forceinline__ KtWarpMem kt_warp_mem(int Lc, int warp_bytes) {
    extern __shared__ unsigned long long kt_smem[];
    unsigned char* base =
        (unsigned char*)kt_smem + (long long)(threadIdx.x >> 5) * warp_bytes;
    KtWarpMem m;
    m.pk = (unsigned long long*)base;
    m.nm = m.pk + kt_pkw(Lc);
    m.wrows = (int*)(m.nm + kt_nmw(Lc));
    return m;
}

// Kernel A's decode: Lp columns of a packed row and its N bitmask (both
// rows of device memory) into the warp's words, the codes under N
// cleared (unpack_codes gives them 4, whose low bits are 0).
__device__ void kt_decode_nmask(const KtWarpMem& m, int Lp,
                                const unsigned char* __restrict__ pkr,
                                const unsigned char* __restrict__ nmr) {
    const int lane = threadIdx.x & 31;
    const int PKW = kt_pkw(Lp), NMW = kt_nmw(Lp);
    unsigned char* pb = (unsigned char*)m.pk;
    unsigned char* nb = (unsigned char*)m.nm;
    for (int t = lane; t < 8 * PKW; t += 32) pb[t] = t < (Lp >> 2) ? pkr[t] : 0;
    for (int t = lane; t < 8 * NMW; t += 32) nb[t] = t < (Lp >> 3) ? nmr[t] : 0;
    __syncwarp();
    unsigned int* p32 = (unsigned int*)m.pk;
    const unsigned int* n32 = (const unsigned int*)m.nm;
    for (int t = lane; t < 2 * PKW; t += 32) {
        const unsigned int n16 = (n32[t >> 1] >> (16 * (t & 1))) & 0xffffu;
        if (n16) {
            const unsigned int e = (unsigned int)kt_spread(n16);
            p32[t] &= ~(e | (e << 1));
        }
    }
    __syncwarp();
}

// A on codes: L columns of a row of unpacked codes (a code above 3 is an
// N) into the warp's words: per 32 columns, three ballots give the low
// and high code bits and the N bits.
__device__ void kt_decode_codes(const KtWarpMem& m, int L,
                                const unsigned char* __restrict__ cr) {
    const int lane = threadIdx.x & 31;
    const int PKW = kt_pkw(L), NMW = kt_nmw(L);
    unsigned int* n32 = (unsigned int*)m.nm;
    for (int t = lane; t < 2 * NMW; t += 32) n32[t] = 0;
    __syncwarp();
    for (int c0 = 0; c0 < 32 * PKW; c0 += 32) {
        const int j = c0 + lane;
        const int c = j < L ? cr[j] : 0;
        const unsigned int lo = __ballot_sync(KT_FULL, c & 1);
        const unsigned int hi = __ballot_sync(KT_FULL, (c >> 1) & 1);
        const unsigned int nn = __ballot_sync(KT_FULL, c > 3);
        if (lane == 0) {
            m.pk[c0 >> 5] = kt_spread(lo) | (kt_spread(hi) << 1);
            n32[c0 >> 5] = nn;
        }
    }
    __syncwarp();
}

// Kernel D's decode (also I's wave 2 and K's failed mate): row `row` of
// one mate's packed codes, first Lc columns, into the warp's words; this
// read's N positions [read * Lp, read * Lp + Lp) come from the sorted
// exception list (kt_exc_lower), cleared in the codes and
// set in the N mask (columns >= Lc are dropped).
__device__ void kt_decode_exc(const KtWarpMem& m, int Lc,
                              const unsigned char* __restrict__ packed,
                              const KtSplit& sp,
                              const long long* __restrict__ exc,
                              long long n_exc, long long read, long long row,
                              int Lp) {
    const int lane = threadIdx.x & 31;
    const int PKW = kt_pkw(Lc), NMW = kt_nmw(Lc);
    const unsigned char* src = packed + row * (Lp >> 2);
    unsigned char* pb = (unsigned char*)m.pk;
    const int nb = (Lc + 3) >> 2;
    for (int t = lane; t < 8 * PKW; t += 32) pb[t] = t < nb ? src[t] : 0;
    for (int t = lane; t < NMW; t += 32) m.nm[t] = 0;
    const long long lo_key = read * (long long)Lp;
    const long long a = kt_exc_lower(sp, exc, n_exc, lo_key);
    __syncwarp();
    for (long long e = a + lane; e < n_exc; e += 32) {
        const long long col = exc[e] - lo_key;
        if (col >= Lp) break;
        if (col < Lc) {
            atomicAnd((unsigned int*)m.pk + (col >> 4),
                      ~(3u << (2 * (col & 15))));
            atomicOr((unsigned int*)m.nm + (col >> 5), 1u << (col & 31));
        }
    }
    __syncwarp();
}

// Kernel D's decode for the nr reads read0 .. read0 + nr - 1 of a warp
// (kernel K's failed mates, rows of `packed` at the reads' own indexes)
// into slots 0 .. nr - 1: the rows' first Lc columns, eight byte loads in
// flight a lane; then lane r finds read r's first exception
// (kt_exc_lower) and the g lanes of read r clear and mark its N positions
// (columns >= Lc are dropped).
__device__ void kt_decode_exc_group(const KtSlots& sl, int Lc,
                                    const unsigned char* __restrict__ packed,
                                    const KtSplit& sp,
                                    const long long* __restrict__ exc,
                                    long long n_exc, long long read0, int nr,
                                    int Lp, int g) {
    const int lane = threadIdx.x & 31;
    const int nb = (Lc + 3) >> 2, per = 8 * sl.PKW, n = nr * per;
    const int LB = Lp >> 2;
    for (int t0 = 0; t0 < n; t0 += 256) {
        unsigned int v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int t = t0 + 32 * i + lane;
            const int r = t / per, c = t - r * per;
            v[i] = (t < n && c < nb) ? __ldg(packed + (read0 + r) * LB + c) : 0;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int t = t0 + 32 * i + lane;
            const int r = t / per;
            if (t < n) ((unsigned char*)sl.pk(r))[t - r * per] = (unsigned char)v[i];
        }
    }
    for (int t = lane; t < nr * sl.NMW; t += 32) sl.nm(t / sl.NMW)[t % sl.NMW] = 0;
    long long a = 0;
    if (lane < nr) a = kt_exc_lower(sp, exc, n_exc, (read0 + lane) * (long long)Lp);
    const int r = lane / g, jl = lane & (g - 1);
    a = __shfl_sync(KT_FULL, a, r);
    __syncwarp();
    if (r < nr) {
        const long long lo_key = (read0 + r) * (long long)Lp;
        for (long long e = a + jl; e < n_exc; e += g) {
            const long long col = exc[e] - lo_key;
            if (col >= Lp) break;
            if (col < Lc) {
                atomicAnd((unsigned int*)sl.pk(r) + (col >> 4),
                          ~(3u << (2 * (col & 15))));
                atomicOr((unsigned int*)sl.nm(r) + (col >> 5), 1u << (col & 31));
            }
        }
    }
    __syncwarp();
}

// Wave 1 of kernel A and of A on codes: a group of g lanes per read of the
// B reads (see the file header); failing reads go to fail_list, counted
// in n_fail.  NA is the anchor count at the batch's width L, the most a
// read has.  kmer(rd, w, x) builds the k-mer of read rd's window w into x
// and returns non-zero when the window holds an N (which fails the read:
// the anchors' windows cover the read, so a verified read has none).
template <typename Kmer>
__device__ __forceinline__ void kt_verify_reads(
    const IndexView& ix, const int* __restrict__ be8, long long n_be8,
    const int* __restrict__ lens, int B, int L, int k, int R, int NA, int g,
    const SideOut& o, int* __restrict__ fail_list,
    unsigned long long* __restrict__ n_fail, Kmer kmer) {
    const int lane = threadIdx.x & 31;
    const int jl = lane & (g - 1);
    const int rpw = 32 / g;
    const int gw = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
    const int nw = (int)(((long long)gridDim.x * blockDim.x) >> 5);
    const unsigned long long kmask =
        k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1ULL);
    const int fsh = 64 - 2 * k;
    const int Rv = R < 16 ? R : 16;

    for (int rb = gw * rpw; rb < B; rb += nw * rpw) {
        const int read = rb + lane / g;
        const int act = read < B;
        const int rd = act ? read : B - 1;  // writes nothing
        const int len = lens[rd];
        // a read of k to L bases has anchors; any other goes to wave 2
        const int cand = act && len >= k && len <= L;
        const int wlast = cand ? len - k : 0;
        const int na = cand ? max(2, (wlast + k - 1) / k + 1) : 0;

        const KtAnchors an = kt_anchor_check(
            NA, na, wlast, g, jl,
            [&](int, int w, int& hit, int& uid, int& upos, int& strand,
                int& blk) {
                unsigned long long x;
                if (kmer(rd, w, x)) return;
                const unsigned long long f = kt_rev2(x) >> fsh;
                const unsigned long long r = ~x & kmask;
                const int isfw = f <= r;
                long long idx;
                int e;
                hit = kt_probe(ix, kt_mix64(isfw ? f : r), &idx, &e);
                if (hit) {
                    strand = isfw == (int)(ix.fw[idx] != 0);
                    uid = ix.uid[idx];
                    upos = ix.pos[idx];
                    blk = ix.block[idx];
                }
            });
        // verified: the range within two 8-wide rows of block_ec8 and, where
        // R < 16, no more candidates than R (then the read cannot overflow)
        const int ok = cand && an.all_ok && an.blo >= 0 &&
                       (an.bhi >> 3) <= (an.blo >> 3) + 1 &&
                       (R >= 16 || an.bhi - an.blo < R);
        int* rrow = o.rows + (long long)read * R;
        int cv[8], last;
        const int nr = kt_block_rows(be8, n_be8, ok, an.blo, an.bhi, g, jl, Rv,
                                     ok, rrow, cv, &last);
        if (ok) {
            for (int s = nr + jl; s < R; s += g) rrow[s] = KT_INT32_MAX;
            if (jl == 0) {
                o.n_rows[read] = nr;
                o.has_hits[read] = 1;
                o.overflow[read] = 0;
                o.f_uid[read] = an.uid0;
                o.f_block[read] = an.blk0;
                o.f_upos[read] = an.upos0;
                o.f_rpos[read] = 0;
                o.f_strand[read] = (unsigned char)an.str0;
                o.rng[read] = wlast;
            }
        }
        kt_fail_append(act && !ok, jl, read, fail_list, n_fail);
    }
}

// Kernel A, wave 1, on the B packed reads: k-mers from the 8-9 packed
// bytes that hold them, N windows from the row's N bitmask.
__global__ void pseudoalign_side_kernel(
    IndexView ix,
    const int* __restrict__ be8,               // [n_be8] block_ec8, flat
    long long n_be8,
    const unsigned char* __restrict__ packed,  // [B, Lp/4]
    const unsigned char* __restrict__ nmask,   // [B, Lp/8]
    const int* __restrict__ lens,              // [B]
    int B, int Lp, int k, int R, int NA, int g, SideOut o,
    int* __restrict__ fail_list, unsigned long long* __restrict__ n_fail) {
    const int LB = Lp >> 2, NB = Lp >> 3;
    const unsigned long long nmk = (1ULL << k) - 1ULL;
    kt_verify_reads(ix, be8, n_be8, lens, B, Lp, k, R, NA, g, o, fail_list,
                    n_fail, [&](int rd, int w, unsigned long long& x) {
                        if ((kt_row_bits(nmask + (long long)rd * NB, NB, w,
                                         k) & nmk) != 0)
                            return 1;
                        x = kt_row_bits(packed + (long long)rd * LB, LB,
                                        2 * w, 2 * k);
                        return 0;
                    });
}

// Kernel A, wave 2: its decode and the core on every read of
// fail_list[0, *n_fail), one warp a read.
__global__ void pseudoalign_side_wave2_kernel(
    IndexView ix,
    const unsigned char* __restrict__ packed,  // [B, Lp/4]
    const unsigned char* __restrict__ nmask,   // [B, Lp/8]
    const int* __restrict__ lens,              // [B]
    int Lp, int k, int R, int warp_bytes, SideOut o,
    const int* __restrict__ fail_list,
    const unsigned long long* __restrict__ n_fail) {
    const KtWarpMem m = kt_warp_mem(Lp, warp_bytes);
    const int wpb = blockDim.x >> 5;
    const int W = Lp - k + 1;
    const long long n = (long long)*n_fail;
    for (long long i = (long long)blockIdx.x * wpb + (threadIdx.x >> 5); i < n;
         i += (long long)gridDim.x * wpb) {
        const long long read = fail_list[i];
        kt_decode_nmask(m, Lp, packed + read * (Lp >> 2),
                        nmask + read * (Lp >> 3));
        kt_core(ix, m.pk, m.nm, m.wrows, read, lens[read], W, k, R, R, o);
    }
}

// The k codes at columns [w, w + k) of a row of unpacked codes in device
// memory as 2-bit groups (column w + i at bits 2i, 2i + 1, as kt_bits
// gives them) into *x; returns non-zero when one of them is above 3 (an
// N).  Reads the aligned 4-byte words that hold them (at most 9).
__device__ __forceinline__ int kt_codes_kmer(const unsigned char* __restrict__ p,
                                             int k, unsigned long long* x) {
    const int s = (int)((unsigned long long)p & 3);
    const unsigned int* a = (const unsigned int*)(p - s);
    const int nw = (s + k + 3) >> 2;
    unsigned long long lo = 0, nb = 0;
    unsigned int hi = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        if (i < nw) {
            const unsigned int v = __ldg(a + i);
            // the 2-bit codes of the 4 bytes, low byte first
            const unsigned int t = v & 0x03030303u;
            const unsigned int c8 = (t | (t >> 6) | (t >> 12) | (t >> 18)) & 0xffu;
            // one bit a byte above 3
            const unsigned int f = __vcmpgtu4(v, 0x03030303u) & 0x01010101u;
            nb |= (unsigned long long)((f | (f >> 7) | (f >> 14) | (f >> 21)) & 0xfu)
                  << (4 * i);
            if (i < 8)
                lo |= (unsigned long long)c8 << (8 * i);
            else
                hi = c8;
        }
    }
    *x = s ? (lo >> (2 * s)) | ((unsigned long long)hi << (64 - 2 * s)) : lo;
    return ((nb >> s) & ((1ULL << k) - 1ULL)) != 0;
}

// Kernel A on codes, wave 1, on the B rows of [B, L] unpacked codes.
__global__ void pseudoalign_codes_kernel(
    IndexView ix,
    const int* __restrict__ be8,               // [n_be8] block_ec8, flat
    long long n_be8,
    const unsigned char* __restrict__ codes,   // [B, L]
    const int* __restrict__ lens,              // [B]
    int B, int L, int k, int R, int NA, int g, SideOut o,
    int* __restrict__ fail_list, unsigned long long* __restrict__ n_fail) {
    kt_verify_reads(ix, be8, n_be8, lens, B, L, k, R, NA, g, o, fail_list,
                    n_fail, [&](int rd, int w, unsigned long long& x) {
                        return kt_codes_kmer(codes + (long long)rd * L + w, k,
                                             &x);
                    });
}

// Kernel A on codes, wave 2: its decode and the covered-interval core on
// every read of fail_list[0, *n_fail), one warp a read.
__global__ void pseudoalign_codes_wave2_kernel(
    IndexView ix,
    const int* __restrict__ be8,               // [n_be8] block_ec8, flat
    long long n_be8,
    const unsigned char* __restrict__ codes,   // [B, L]
    const int* __restrict__ lens,              // [B]
    int L, int k, int R, int warp_bytes, SideOut o,
    const int* __restrict__ fail_list,
    const unsigned long long* __restrict__ n_fail,
    unsigned long long* __restrict__ n_probed) {
    const KtWarpMem m = kt_warp_mem(L, warp_bytes);
    const int wpb = blockDim.x >> 5;
    const int W = L - k + 1;
    const long long n = (long long)*n_fail;
    for (long long i = (long long)blockIdx.x * wpb + (threadIdx.x >> 5); i < n;
         i += (long long)gridDim.x * wpb) {
        const long long read = fail_list[i];
        kt_decode_codes(m, L, codes + read * L);
        kt_core_skip(ix, be8, n_be8, m.pk, m.nm, m.wrows, read, lens[read], W,
                     k, R, R, o, n_probed);
    }
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
    const KtWarpMem m = kt_warp_mem(Lc, warp_bytes);
    const int wpb = blockDim.x >> 5;
    const int W = Lc - k + 1;
    const long long rlen = aux[0];
    const long long n_real = aux[1];
    const long long* exc = aux + 4;
    const long long B = Bp * ns;
    __shared__ long long s_split[KT_SPLIT];
    const KtSplit sp = kt_split_init(s_split, exc, n_exc);
    for (long long read = (long long)blockIdx.x * wpb + (threadIdx.x >> 5);
         read < B; read += (long long)gridDim.x * wpb) {
        const long long row = read % Bp;
        kt_decode_exc(m, Lc, read < Bp ? p1 : p2, sp, exc, n_exc, read, row,
                      Lp);
        int len = 0;
        if (row < n_real) len = lens ? (int)lens[read] : (int)rlen;
        kt_core(ix, m.pk, m.nm, m.wrows, read, len, W, k, R, R, o);
    }
}

// Kernel I, wave 1: a group of g lanes per read of the ns*Bp turbo reads
// (see the file header); failing reads go to fail_list, counted in n_fail.
__global__ void pseudoalign_anchor_kernel(
    IndexView ix,
    const int* __restrict__ be8,               // [n_be8] block_ec8, flat
    long long n_be8,
    const unsigned char* __restrict__ p1,      // [Bp, Lp/4] mate 1
    const unsigned char* __restrict__ p2,      // [Bp, Lp/4] mate 2 or null
    const long long* __restrict__ aux,         // [4 + n_exc]
    long long n_exc, long long Bp, int ns, int Lp, int Lc, int k, int R,
    int n_anchors, int g, SideOut o, int* __restrict__ fail_list,
    unsigned long long* __restrict__ n_fail) {
    const int lane = threadIdx.x & 31;
    const int jl = lane & (g - 1);
    const int rpw = 32 / g;
    const long long gw =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const long long nw = ((long long)gridDim.x * blockDim.x) >> 5;
    const int rlen = (int)aux[0];
    const long long n_real = aux[1];
    const long long* exc = aux + 4;
    const long long B = Bp * ns;
    const int long_enough = rlen >= k;
    const int wlast = rlen - k > 0 ? rlen - k : 0;
    const int LB = Lp >> 2;
    const unsigned long long kmask =
        k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1ULL);
    const int fsh = 64 - 2 * k;
    const int Rv = R < 16 ? R : 16;
    __shared__ long long s_split[KT_SPLIT];
    const KtSplit sp = kt_split_init(s_split, exc, n_exc);

    for (long long rb = gw * rpw; rb < B; rb += nw * rpw) {
        const long long read = rb + lane / g;
        const int act = read < B;
        const long long rd = act ? read : B - 1;  // writes nothing
        const long long row = rd % Bp;
        const int real = row < n_real;
        const unsigned char* src = (rd < Bp ? p1 : p2) + row * LB;
        const long long lo_key = rd * (long long)Lp;
        const long long ea = kt_exc_lower(sp, exc, n_exc, lo_key);

        const KtAnchors an = kt_anchor_check(
            n_anchors, n_anchors, wlast, g, jl,
            [&](int j, int w, int& hit, int& uid, int& upos, int& strand,
                int& blk) {
                unsigned long long x = kt_row_bits(src, LB, 2 * w, 2 * k);
                int bad = 0;
                for (long long e = ea; e < n_exc; ++e) {
                    const long long col = exc[e] - lo_key;
                    if (col >= Lp) break;
                    if (col < Lc && col >= w && col < w + k) {
                        x &= ~(3ULL << (2 * (col - w)));
                        bad = 1;
                    }
                }
                const unsigned long long f = kt_rev2(x) >> fsh;
                const unsigned long long r = ~x & kmask;
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
            });
        const int ok = an.all_ok && (an.bhi >> 3) <= (an.blo >> 3) + 1 &&
                       an.blo >= 0 && real && long_enough;
        int* rrow = o.rows + read * R;
        int cv[8], last;
        const int nr = kt_block_rows(be8, n_be8, ok, an.blo, an.bhi, g, jl, Rv,
                                     act, rrow, cv, &last);
        int ovl = 0;
#pragma unroll
        for (int t = 0; t < 8; ++t)
            ovl |= cv[t] > last && cv[t] != KT_INT32_MAX;
        const int ov = !kt_group_all(!ovl, g);

        const int fail = act && !ok && real && long_enough;
        if (act && !fail) {
            // verified, or padding (and every read when rlen < k)
            for (int s = (ok ? nr : 0) + jl; s < R; s += g)
                rrow[s] = KT_INT32_MAX;
            if (jl == 0) {
                o.n_rows[read] = ok ? nr : 0;
                o.has_hits[read] = (unsigned char)ok;
                o.overflow[read] = (unsigned char)(ok && ov);
                o.f_uid[read] = ok ? an.uid0 : -1;
                o.f_block[read] = ok ? an.blk0 : -1;
                o.f_upos[read] = ok ? an.upos0 : -1;
                o.f_rpos[read] = ok ? 0 : -1;
                o.f_strand[read] = (unsigned char)an.str0;
                o.rng[read] = ok ? wlast : -1;
            }
        }
        kt_fail_append(fail, jl, read, fail_list, n_fail);
    }
}

// Kernel I, wave 2: kernel D's decode and core on every read of
// fail_list[0, *n_fail), one warp a read.  The core gives min(R, W) = Rc
// rows; a one-slot row fills all R slots (JAX's broadcast).
__global__ void pseudoalign_anchor_wave2_kernel(
    IndexView ix,
    const unsigned char* __restrict__ p1,      // [Bp, Lp/4] mate 1
    const unsigned char* __restrict__ p2,      // [Bp, Lp/4] mate 2 or null
    const long long* __restrict__ aux,         // [4 + n_exc]
    long long n_exc, long long Bp, int Lp, int Lc, int k, int R, int Rc,
    int warp_bytes, SideOut o, const int* __restrict__ fail_list,
    const unsigned long long* __restrict__ n_fail) {
    const KtWarpMem m = kt_warp_mem(Lc, warp_bytes);
    const int lane = threadIdx.x & 31;
    const int wpb = blockDim.x >> 5;
    const int W = Lc - k + 1;
    const int rlen = (int)aux[0];
    const long long* exc = aux + 4;
    const long long n = (long long)*n_fail;
    __shared__ long long s_split[KT_SPLIT];
    const KtSplit sp = kt_split_init(s_split, exc, n_exc);
    for (long long i = (long long)blockIdx.x * wpb + (threadIdx.x >> 5); i < n;
         i += (long long)gridDim.x * wpb) {
        const long long read = fail_list[i];
        kt_decode_exc(m, Lc, read < Bp ? p1 : p2, sp, exc, n_exc, read,
                      read % Bp, Lp);
        const int row0 =
            kt_core(ix, m.pk, m.nm, m.wrows, read, rlen, W, k, Rc, R, o);
        for (int s = Rc + lane; s < R; s += 32) o.rows[read * R + s] = row0;
    }
}

// ------------------------------------------------------------- kernel K

// Kernel K: G = 32 / g pairs of the Bp half-fail pairs a warp (file
// header; g = anchor_group_width(n_anchors_for(Lc, k))): their failed
// mates decoded together (kt_decode_exc_group), the covered-interval
// core's anchor passes for all of them, then pair by pair its finish and
// the verified mate.  Two resident blocks of KT_WPB warps an SM (116
// registers, no spill): capped for three it spilled and ran slower on an
// H100 (probe_ab.py).
__global__ void __launch_bounds__(KT_WPB * 32, 2) pseudoalign_halffail_kernel(
    IndexView ix,
    const int* __restrict__ be8,               // [n_be8] block_ec8, flat
    long long n_be8,
    const unsigned char* __restrict__ pkf,     // [Bp, Lp/4] failed mates
    const int* __restrict__ vsum,              // [Bp, 2] verified summaries
    const int* __restrict__ sidev,             // [Bp] 1 = mate 1 failed
    const long long* __restrict__ aux,         // [4 + n_exc]
    long long n_exc, long long Bp, int Lp, int Lc, int k, int R, int NA,
    int g, SideOut o1, SideOut o2, unsigned long long* __restrict__ n_probed) {
    const int lane = threadIdx.x & 31;
    const int wpb = blockDim.x >> 5;
    const int W = Lc - k + 1, G = 32 / g;
    const KtSlots sl = kt_slots(Lc, W, G);
    const int rlen = (int)aux[0];
    const long long n_real = aux[1];
    const long long* exc = aux + 4;
    const int Rv = R < 16 ? R : 16;
    __shared__ long long s_split[KT_SPLIT];
    const KtSplit sp = kt_split_init(s_split, exc, n_exc);
    int nprobe = 0;

    for (long long p0 = ((long long)blockIdx.x * wpb + (threadIdx.x >> 5)) * G;
         p0 < Bp; p0 += (long long)gridDim.x * wpb * G) {
        const int nr = (int)(Bp - p0 < G ? Bp - p0 : G);
        // the failed mates: kernel D's decode, the covered-interval core
        kt_decode_exc_group(sl, Lc, pkf, sp, exc, n_exc, p0, nr, Lp, g);
        kt_skip_anchors(ix, be8, n_be8, sl, nr,
                        p0 + lane / g < n_real ? rlen : 0, W, k, NA, g,
                        nprobe);
        for (int r = 0; r < nr; ++r) {
            const long long read = p0 + r;
            const int m1 = sidev[read] == 1;
            const SideOut of = m1 ? o1 : o2;
            const SideOut ov = m1 ? o2 : o1;
            const int len = read < n_real ? rlen : 0;
            kt_skip_finish(ix, sl, r, read, W, k, R, R, of, nprobe);

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
            int prev = -1, nv = 0;
            for (int s = 0; s < Rv; ++s) {
                const int m = __reduce_min_sync(KT_FULL,
                                                v > prev ? v : KT_INT32_MAX);
                if (m == KT_INT32_MAX) break;
                if (lane == 0) ov.rows[read * R + s] = m;
                prev = m;
                ++nv;
            }
            for (int s = nv + lane; s < R; s += 32)
                ov.rows[read * R + s] = KT_INT32_MAX;
            if (lane == 0) {
                ov.n_rows[read] = nv;
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
    kt_count_probes(n_probed, nprobe);
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

// The grid of `kernel` for `blocks` blocks of `threads` threads with
// `smem` bytes of dynamic shared memory: at most the blocks that the SMs
// of the current device hold at once (the built kernel's occupancy), the
// kernels' grid-stride loops taking the rest.
template <typename K>
static int kt_grid(K kernel, int threads, long long smem, long long blocks,
                   unsigned int* grid) {
    int dev, sms, per;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads,
                                                          (size_t)smem);
    if (e != cudaSuccess) return (int)e;
    const long long cap = (long long)sms * (per > 0 ? per : 1);
    if (blocks > cap) blocks = cap;
    *grid = (unsigned int)(blocks > 0 ? blocks : 1);
    return 0;
}

// The per-warp shared bytes of kt_core for reads of Lc code columns: pk,
// nm and the row scratch (kt_warp_mem).
static int kt_core_bytes(int Lc, int W) {
    return 8 * (kt_pkw(Lc) + kt_nmw(Lc)) + ((4 * W + 15) & ~15);
}

// Warps per block (KT_WPB, halved while the block's shared memory does
// not fit beside the kernel's static_bytes) for warp_bytes of shared
// memory a warp, and the grid for `reads` reads (rpw a warp); returns
// non-zero when one warp's share does not fit.
template <typename K>
static int kt_launch_shape(K kernel, int warp_bytes, int rpw, long long reads,
                           int static_bytes, int* wpb_out, long long* smem_out,
                           unsigned int* grid_out) {
    const int max_smem = 227 * 1024 - static_bytes;
    int wpb = KT_WPB;
    while (wpb > 1 && (long long)wpb * warp_bytes > max_smem) wpb >>= 1;
    const long long smem = (long long)wpb * warp_bytes;
    if (smem > max_smem) return (int)cudaErrorInvalidValue;
    // past 48 KB of static and dynamic shared memory a kernel must opt in
    if (smem + static_bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    *wpb_out = wpb;
    *smem_out = smem;
    const long long per_block = (long long)wpb * rpw;
    return kt_grid(kernel, wpb * 32, smem, (reads + per_block - 1) / per_block,
                   grid_out);
}

// Kernel A (file header), one call for its two launches on one stream:
// waves & 1 zeroes n_fail and launches wave 1, which writes every verified
// read in full and lists the others (fail_list, [B] ints); waves & 2
// launches wave 2 on the listed reads, on a grid of as many warps as the
// SMs hold at once (the list's length is read on the card, so nothing
// waits on the host between them).  waves 1 or 2 alone time the waves
// apart.  NA = n_anchors_for(Lp, k); g, the lanes of a read, is a power of
// two in [2, 32] with g >= NA unless g is 32.  B = 0 launches nothing.
extern "C" int pseudoalign_side(
    const IndexView* index, const void* block_ec8, long long n_be8,
    const void* packed, const void* nmask, const void* lens,
    int B, int Lp, int k, int R, int NA, int g, int waves,
    void* rows, void* n_rows, void* has_hits, void* overflow,
    void* f_uid, void* f_block, void* f_upos, void* f_rpos,
    void* f_strand, void* rng, void* fail_list, void* n_fail, void* stream) {
    if (Lp < k || (Lp & 7) != 0 || R <= 0 || R > Lp - k + 1 || k > 32 ||
        B < 0 || waves < 1 || waves > 3)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    if (NA < 2 || n_be8 < 16 || g < 2 || g > 32 || (g & (g - 1)) ||
        (g < NA && g != 32) || !fail_list || !n_fail)
        return (int)cudaErrorInvalidValue;
    IndexView ix;
    int err = kt_index_view(&ix, index);
    if (err) return err;
    cudaStream_t st = (cudaStream_t)stream;
    const SideOut o = kt_side_out(rows, n_rows, has_hits, overflow, f_uid,
                                  f_block, f_upos, f_rpos, f_strand, rng);
    if (waves & 1) {
        const cudaError_t e = cudaMemsetAsync(n_fail, 0, 8, st);
        if (e != cudaSuccess) return (int)e;
        const int threads = KT_WPB * 32;
        const long long warps = ((long long)B + 32 / g - 1) / (32 / g);
        unsigned int grid;
        err = kt_grid(pseudoalign_side_kernel, threads, 0,
                      (warps + KT_WPB - 1) / KT_WPB, &grid);
        if (err) return err;
        pseudoalign_side_kernel<<<grid, threads, 0, st>>>(
            ix, (const int*)block_ec8, n_be8, (const unsigned char*)packed,
            (const unsigned char*)nmask, (const int*)lens, B, Lp, k, R, NA, g,
            o, (int*)fail_list, (unsigned long long*)n_fail);
        err = (int)cudaGetLastError();
        if (err) return err;
    }
    if (waves & 2) {
        const int warp_bytes = kt_core_bytes(Lp, Lp - k + 1);
        int wpb;
        long long smem;
        unsigned int grid;
        err = kt_launch_shape(pseudoalign_side_wave2_kernel, warp_bytes, 1, B,
                              0, &wpb, &smem, &grid);
        if (err) return err;
        pseudoalign_side_wave2_kernel<<<grid, wpb * 32, (size_t)smem, st>>>(
            ix, (const unsigned char*)packed, (const unsigned char*)nmask,
            (const int*)lens, Lp, k, R, warp_bytes, o,
            (const int*)fail_list, (const unsigned long long*)n_fail);
        err = (int)cudaGetLastError();
    }
    return err;
}

// Kernel A on unpacked codes [B, L] uint8 (any L >= k), in the manner of
// pseudoalign_side: waves & 1 zeroes n_fail and launches wave 1, waves & 2
// launches wave 2 (the covered-interval core) on the listed reads, on a
// grid of as many warps as the SMs hold at once.  n_probed (may be null)
// gains the windows that wave 2 probed.  B = 0 launches nothing.
extern "C" int pseudoalign_codes(
    const IndexView* index, const void* block_ec8, long long n_be8,
    const void* codes, const void* lens, int B, int L, int k, int R, int NA,
    int g, int waves,
    void* rows, void* n_rows, void* has_hits, void* overflow,
    void* f_uid, void* f_block, void* f_upos, void* f_rpos,
    void* f_strand, void* rng, void* fail_list, void* n_fail, void* n_probed,
    void* stream) {
    if (L < k || R <= 0 || R > L - k + 1 || k > 32 || B < 0 || waves < 1 ||
        waves > 3)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    if (NA < 2 || n_be8 < 16 || g < 2 || g > 32 || (g & (g - 1)) ||
        (g < NA && g != 32) || !fail_list || !n_fail)
        return (int)cudaErrorInvalidValue;
    IndexView ix;
    int err = kt_index_view(&ix, index);
    if (err) return err;
    cudaStream_t st = (cudaStream_t)stream;
    const SideOut o = kt_side_out(rows, n_rows, has_hits, overflow, f_uid,
                                  f_block, f_upos, f_rpos, f_strand, rng);
    if (waves & 1) {
        const cudaError_t e = cudaMemsetAsync(n_fail, 0, 8, st);
        if (e != cudaSuccess) return (int)e;
        const int threads = KT_WPB * 32;
        const long long warps = ((long long)B + 32 / g - 1) / (32 / g);
        unsigned int grid;
        err = kt_grid(pseudoalign_codes_kernel, threads, 0,
                      (warps + KT_WPB - 1) / KT_WPB, &grid);
        if (err) return err;
        pseudoalign_codes_kernel<<<grid, threads, 0, st>>>(
            ix, (const int*)block_ec8, n_be8, (const unsigned char*)codes,
            (const int*)lens, B, L, k, R, NA, g, o, (int*)fail_list,
            (unsigned long long*)n_fail);
        err = (int)cudaGetLastError();
        if (err) return err;
    }
    if (waves & 2) {
        const int warp_bytes = kt_core_bytes(L, L - k + 1);
        int wpb;
        long long smem;
        unsigned int grid;
        err = kt_launch_shape(pseudoalign_codes_wave2_kernel, warp_bytes, 1, B,
                              0, &wpb, &smem, &grid);
        if (err) return err;
        pseudoalign_codes_wave2_kernel<<<grid, wpb * 32, (size_t)smem, st>>>(
            ix, (const int*)block_ec8, n_be8, (const unsigned char*)codes,
            (const int*)lens, L, k, R, warp_bytes, o, (const int*)fail_list,
            (const unsigned long long*)n_fail, (unsigned long long*)n_probed);
        err = (int)cudaGetLastError();
    }
    return err;
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
    const int warp_bytes = kt_core_bytes(Lc, Lc - k + 1);
    int wpb;
    long long smem;
    unsigned int grid;
    err = kt_launch_shape(pseudoalign_turbo_kernel, warp_bytes, 1, Bp * ns,
                          8 * KT_SPLIT, &wpb, &smem, &grid);
    if (err) return err;
    pseudoalign_turbo_kernel<<<grid, wpb * 32, (size_t)smem,
                               (cudaStream_t)stream>>>(
        ix, (const unsigned char*)p1, (const unsigned char*)p2,
        (const long long*)aux, n_exc, (const unsigned short*)lens, Bp, ns, Lp,
        Lc, k, R, warp_bytes,
        kt_side_out(rows, n_rows, has_hits, overflow, f_uid, f_block, f_upos,
                    f_rpos, f_strand, rng));
    return (int)cudaGetLastError();
}

// Kernel I's checks shared by its two launches: Lc and Rc = min(R, W),
// which must be R or 1.
static int kt_anchor_shape(int ns, const void* p2, long long n_exc, int Lp,
                           int rl, int k, int R, int* Lc_out, int* Rc_out) {
    const int Lc = (rl > 0 && rl < Lp) ? rl : Lp;
    const int W = Lc - k + 1;
    const int Rc = R < W ? R : W;
    if (ns < 1 || ns > 2 || (ns == 2 && p2 == 0) || n_exc < 0 || Lc < k ||
        (Lp & 3) != 0 || R <= 0 || (Rc != R && Rc != 1) || k > 32)
        return (int)cudaErrorInvalidValue;
    *Lc_out = Lc;
    *Rc_out = Rc;
    return 0;
}

// Kernel I, wave 1: zeroes n_fail, then writes every verified and padding
// read in full and lists the failing ones (fail_list, [ns*Bp] ints).  g,
// the lanes of a read, is a power of two in [2, 32] with g >= n_anchors
// unless g is 32.
extern "C" int pseudoalign_anchor(
    const IndexView* index, const void* block_ec8, long long n_be8,
    const void* p1, const void* p2, const void* aux, long long n_exc,
    long long Bp, int ns, int Lp, int rl, int k, int R, int n_anchors, int g,
    void* rows, void* n_rows, void* has_hits, void* overflow,
    void* f_uid, void* f_block, void* f_upos, void* f_rpos,
    void* f_strand, void* rng, void* fail_list, void* n_fail, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(n_fail, 0, 8, st);
    if (e != cudaSuccess) return (int)e;
    if (Bp <= 0) return 0;
    int Lc, Rc;
    int err = kt_anchor_shape(ns, p2, n_exc, Lp, rl, k, R, &Lc, &Rc);
    if (err) return err;
    if (n_anchors < 2 || n_be8 < 16 || g < 2 || g > 32 || (g & (g - 1)) ||
        (g < n_anchors && g != 32) || Bp * ns > 0x7fffffffLL || !fail_list)
        return (int)cudaErrorInvalidValue;
    IndexView ix;
    err = kt_index_view(&ix, index);
    if (err) return err;
    const int threads = KT_WPB * 32;
    const long long warps = (Bp * ns + 32 / g - 1) / (32 / g);
    unsigned int grid;
    err = kt_grid(pseudoalign_anchor_kernel, threads, 0,
                  (warps + KT_WPB - 1) / KT_WPB, &grid);
    if (err) return err;
    pseudoalign_anchor_kernel<<<grid, threads, 0, st>>>(
        ix, (const int*)block_ec8, n_be8, (const unsigned char*)p1,
        (const unsigned char*)p2, (const long long*)aux, n_exc, Bp, ns, Lp,
        Lc, k, R, n_anchors, g,
        kt_side_out(rows, n_rows, has_hits, overflow, f_uid, f_block, f_upos,
                    f_rpos, f_strand, rng),
        (int*)fail_list, (unsigned long long*)n_fail);
    return (int)cudaGetLastError();
}

// Kernel I, wave 2: the reads wave 1 listed, through kernel D's decode and
// core, on a grid of as many warps as the SMs hold at once (the list's
// length is on the card).
extern "C" int pseudoalign_anchor_wave2(
    const IndexView* index, const void* p1, const void* p2, const void* aux,
    long long n_exc, long long Bp, int ns, int Lp, int rl, int k, int R,
    void* rows, void* n_rows, void* has_hits, void* overflow,
    void* f_uid, void* f_block, void* f_upos, void* f_rpos,
    void* f_strand, void* rng, void* fail_list, void* n_fail, void* stream) {
    if (Bp <= 0) return 0;
    int Lc, Rc;
    int err = kt_anchor_shape(ns, p2, n_exc, Lp, rl, k, R, &Lc, &Rc);
    if (err) return err;
    if (!fail_list || !n_fail) return (int)cudaErrorInvalidValue;
    IndexView ix;
    err = kt_index_view(&ix, index);
    if (err) return err;
    const int warp_bytes = kt_core_bytes(Lc, Lc - k + 1);
    int wpb;
    long long smem;
    unsigned int grid;
    err = kt_launch_shape(pseudoalign_anchor_wave2_kernel, warp_bytes, 1,
                          Bp * ns, 8 * KT_SPLIT, &wpb, &smem, &grid);
    if (err) return err;
    pseudoalign_anchor_wave2_kernel<<<grid, wpb * 32, (size_t)smem,
                                      (cudaStream_t)stream>>>(
        ix, (const unsigned char*)p1, (const unsigned char*)p2,
        (const long long*)aux, n_exc, Bp, Lp, Lc, k, R, Rc, warp_bytes,
        kt_side_out(rows, n_rows, has_hits, overflow, f_uid, f_block, f_upos,
                    f_rpos, f_strand, rng),
        (const int*)fail_list, (const unsigned long long*)n_fail);
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
    void* f_strand2, void* rng2, void* n_probed, void* stream) {
    if (Bp <= 0) return 0;
    const int Lc = (rl > 0 && rl < Lp) ? rl : Lp;
    const int W = Lc - k + 1;
    if (n_exc < 0 || Lc < k || (Lp & 3) != 0 || R <= 0 || R > W || k > 32 ||
        n_be8 < 16)
        return (int)cudaErrorInvalidValue;
    // the failed mates' anchors (n_anchors_for(Lc, k)) and their lanes
    const int NA = Lc > k ? (Lc - 1) / k + 1 : 2;
    int g = 2;
    while (g < NA && g < 32) g <<= 1;
    IndexView ix;
    int err = kt_index_view(&ix, index);
    if (err) return err;
    int wpb;
    long long smem;
    unsigned int grid;
    const int G = 32 / g;
    err = kt_launch_shape(pseudoalign_halffail_kernel,
                          G * kt_slot_bytes(Lc, W), G, Bp, 8 * KT_SPLIT, &wpb,
                          &smem, &grid);
    if (err) return err;
    pseudoalign_halffail_kernel<<<grid, wpb * 32, (size_t)smem,
                                  (cudaStream_t)stream>>>(
        ix, (const int*)block_ec8, n_be8, (const unsigned char*)pkf,
        (const int*)vsum, (const int*)sidev, (const long long*)aux, n_exc, Bp,
        Lp, Lc, k, R, NA, g,
        kt_side_out(rows1, n_rows1, has_hits1, overflow1, f_uid1, f_block1,
                    f_upos1, f_rpos1, f_strand1, rng1),
        kt_side_out(rows2, n_rows2, has_hits2, overflow2, f_uid2, f_block2,
                    f_upos2, f_rpos2, f_strand2, rng2),
        (unsigned long long*)n_probed);
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

#define KL_NQ 4      // queries of a lane, probed together (kt_probe_n)

// The probes of NQ bucketed queries over packed (mixed key, EC row)
// entries ent [N] (16 bytes each, slot order): kt_probe_n's bucketed
// search step for step, each key read as its whole entry, so that a hit
// finds its EC row in the key's own 16 bytes and reads no kmer_ec sector.
template <int NQ>
__device__ __forceinline__ unsigned kt_probe_ent(const IndexView& ix,
                                                 const ulonglong2* __restrict__ ent,
                                                 const unsigned long long* q,
                                                 unsigned act, long long* idx,
                                                 int* ec) {
    const int sh = 64 - ix.p;
    const int nm1 = (int)(ix.N - 1);
    int lo[NQ], n[NQ], e[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
        lo[j] = 0;
        n[j] = 0;
        e[j] = -1;
        if ((act >> j) & 1) {
            const long long b = (long long)(q[j] >> sh);
            lo[j] = ix.bucket_start[b];
            n[j] = ix.bucket_start[b + 1] - lo[j];
        }
    }
    unsigned live = 0, eq = 0;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
        if (((act >> j) & 1) && n[j] > 0) live |= 1u << j;
    for (int s = 0; s < KT_DEPTH; ++s) {
        unsigned more = 0;
#pragma unroll
        for (int j = 0; j < NQ; ++j)
            if (((act >> j) & 1) && n[j] > 0) more |= 1u << j;
        if (!more) break;
        int m[NQ];
        ulonglong2 v[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            m[j] = min(lo[j] + (n[j] >> 1), nm1);
            v[j] = ((more >> j) & 1) ? ent[m[j]] : make_ulonglong2(0, 0);
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            if ((more >> j) & 1) {
                const int half = n[j] >> 1;
                if (v[j].x < q[j]) {
                    lo[j] = m[j] + 1;
                    n[j] = n[j] - half - 1;
                } else {
                    n[j] = half;
                    if (v[j].x == q[j]) {
                        eq |= 1u << j;
                        e[j] = (int)(unsigned int)v[j].y;
                    }
                }
            }
        }
    }
    const unsigned rest = live & ~eq;
    ulonglong2 v[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
        idx[j] = min(lo[j], nm1);
        v[j] = ((rest >> j) & 1) ? ent[idx[j]] : make_ulonglong2(0, 0);
    }
    unsigned hit = eq;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
        if (((rest >> j) & 1) && v[j].x == q[j]) {
            e[j] = (int)(unsigned int)v[j].y;
            hit |= 1u << j;
        }
        ec[j] = e[j];
    }
    return hit;
}

// Kernel L: KL_NQ consecutive queries a lane, grid-stride over the
// groups; invalid queries are probed with canon 0 and never hit
// (lookup_kmers).  The lane's queries go through one kt_probe_n (or, with
// ent, kt_probe_ent), so each dependent step of their probes is issued
// for all of them together.  VEC: canon as two 16-byte loads, valid as
// one 4-byte word, the slots and EC rows as 16-byte stores and the hits
// as one 4-byte store (every pointer aligned, a whole group); else one
// element at a time.  The query and result streams use streaming loads
// and stores (ld/st.global.cs), which mark their lines first to be
// evicted, so that the stream does not push the table out of the L2.
template <int VEC, int ENT>
__global__ void __launch_bounds__(256) lookup_kmers_kernel(
    IndexView ix, const ulonglong2* __restrict__ ent,
    const long long* __restrict__ canon,
    const unsigned char* __restrict__ valid, long long n,
    long long* __restrict__ idx, unsigned char* __restrict__ hit,
    int* __restrict__ ec) {
    const long long ng = (n + KL_NQ - 1) / KL_NQ;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         g < ng; g += (long long)gridDim.x * blockDim.x) {
        const long long i0 = g * KL_NQ;
        const int m = n - i0 < KL_NQ ? (int)(n - i0) : KL_NQ;
        const int whole = VEC && m == KL_NQ;
        unsigned long long q[KL_NQ];
        unsigned v = 0;
        if (whole) {
            const longlong2* c2 = (const longlong2*)(canon + i0);
            const longlong2 a = __ldcs(c2), b = __ldcs(c2 + 1);
            q[0] = a.x;
            q[1] = a.y;
            q[2] = b.x;
            q[3] = b.y;
            const unsigned w = __ldcs((const unsigned int*)(valid + i0));
#pragma unroll
            for (int j = 0; j < KL_NQ; ++j)
                v |= (((w >> (8 * j)) & 0xFF) != 0) << j;
        } else {
#pragma unroll
            for (int j = 0; j < KL_NQ; ++j) {
                q[j] = 0;
                if (j < m) {
                    q[j] = (unsigned long long)__ldcs(canon + i0 + j);
                    v |= (__ldcs(valid + i0 + j) != 0) << j;
                }
            }
        }
#pragma unroll
        for (int j = 0; j < KL_NQ; ++j)
            q[j] = kt_mix64(((v >> j) & 1) ? q[j] : 0ULL);
        const unsigned act = (1u << m) - 1;
        long long s[KL_NQ];
        int e[KL_NQ];
        unsigned h;
        if (ENT)
            h = kt_probe_ent<KL_NQ>(ix, ent, q, act, s, e) & v;
        else
            h = kt_probe_n<KL_NQ>(ix, q, act, s, e) & v;
#pragma unroll
        for (int j = 0; j < KL_NQ; ++j)
            if (!((h >> j) & 1)) e[j] = -1;
        if (whole) {
            longlong2* s2 = (longlong2*)(idx + i0);
            __stcs(s2, make_longlong2(s[0], s[1]));
            __stcs(s2 + 1, make_longlong2(s[2], s[3]));
            __stcs((unsigned int*)(hit + i0),
                   (h & 1) | ((h >> 1) & 1) << 8 | ((h >> 2) & 1) << 16 |
                       ((h >> 3) & 1) << 24);
            __stcs((int4*)(ec + i0), make_int4(e[0], e[1], e[2], e[3]));
        } else {
#pragma unroll
            for (int j = 0; j < KL_NQ; ++j) {
                if (j < m) {
                    __stcs(idx + i0 + j, s[j]);
                    __stcs((char*)(hit + i0 + j), (char)((h >> j) & 1));
                    __stcs(ec + i0 + j, e[j]);
                }
            }
        }
    }
}

static int kl_launch(const IndexView* index, const void* ent,
                     const void* canon, const void* valid, long long n,
                     void* idx, void* hit, void* ec, void* stream) {
    if (n <= 0) return 0;
    IndexView ix;
    int err = kt_index_view(&ix, index);
    if (err) return err;
    // the bucketed search keeps slots in 32 bits, as A's core does
    if ((!ix.S && ix.N >= (1LL << 31)) ||
        (ent != 0 && (ix.S || ((unsigned long long)ent & 15))))
        return (int)cudaErrorInvalidValue;
    const int vec = !(((unsigned long long)canon | (unsigned long long)idx |
                       (unsigned long long)ec) & 15) &&
                    !(((unsigned long long)valid |
                       (unsigned long long)hit) & 3);
    long long blocks = ((n + KL_NQ - 1) / KL_NQ + 255) / 256;
    if (blocks > 132 * 32) blocks = 132 * 32;
    auto kern = ent ? (vec ? lookup_kmers_kernel<1, 1> : lookup_kmers_kernel<0, 1>)
                    : (vec ? lookup_kmers_kernel<1, 0> : lookup_kmers_kernel<0, 0>);
    kern<<<(unsigned int)blocks, 256, 0, (cudaStream_t)stream>>>(
        ix, (const ulonglong2*)ent, (const long long*)canon,
        (const unsigned char*)valid, n, (long long*)idx, (unsigned char*)hit,
        (int*)ec);
    return (int)cudaGetLastError();
}

// Kernel L: (idx int64, hit bool, ec int32) of n queries through the
// index's own tables (any layout).
extern "C" int lookup_kmers(const IndexView* index, const void* canon,
                            const void* valid, long long n, void* idx,
                            void* hit, void* ec, void* stream) {
    return kl_launch(index, 0, canon, valid, n, idx, hit, ec, stream);
}

// Kernel L over packed entries ent [N, 2] int64 (mixed key, EC row) of a
// bucketed index (16-byte aligned): the same results.
extern "C" int lookup_kmers_packed(const IndexView* index, const void* ent,
                                   const void* canon, const void* valid,
                                   long long n, void* idx, void* hit,
                                   void* ec, void* stream) {
    if (ent == 0) return (int)cudaErrorInvalidValue;
    return kl_launch(index, ent, canon, valid, n, idx, hit, ec, stream);
}
