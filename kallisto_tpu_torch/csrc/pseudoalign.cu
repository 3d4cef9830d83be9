// Kernel A: pseudoalign_side -- per-read k-mer -> sorted distinct EC rows.
//
// Replaces the JAX device program kallisto_tpu/ops/pseudoalign.py
// pseudoalign_batch_packed (:479) with its body: unpack_codes_device (:469),
// rolling_canonical_kmers (:385), the bucketed lookup_kmers (:316-382, with
// _mix64_jnp :109) and _pseudoalign_core (:504-564).  Outputs are the ten
// SideResult fields, equal in every bit to the plain PyTorch version in
// kallisto_tpu_torch/ops/pseudoalign.py.
//
// Design: one warp per read (grid-stride over reads).  The warp unpacks the
// read's 2-bit codes and N bitmask into shared memory, then walks the
// W = Lp - k + 1 windows in chunks of 32 (one window per lane).  Each lane
// builds its window's forward and reverse-complement k-mers directly from
// the shared codes, takes canon = min(f, r), mixes it with splitmix64 and
// runs the fixed-depth (6-step) lower_bound inside its hash bucket.  The
// window's EC row goes to shared memory; ballots give has_hits, the leftmost
// hit (its slot and orientation come over a shuffle) and the last hit.  The
// R = min(16, W) smallest distinct rows then come from R rounds of masked
// warp minimum (__reduce_min_sync) over the shared rows, and one more pass
// decides `overflow` exactly as _pseudoalign_core :534-536.
//
// What bounds it on the H100: the random reads into the k-mer table.  Per
// valid window: one 32-byte sector of bucket_start, the 1-4 sectors of the
// bucket's sorted keys that the binary search touches (a bucket holds < 64
// keys, <= 512 contiguous bytes), and for a hit one sector of kmer_ec.  At
// realistic size the table (~1 GB) does not fit in the 50 MB L2, so these
// are DRAM sector reads; the k-mer build itself is a few hundred integer
// operations per window and never the limit.  What the design does about
// it: no bucket padding (the bucketed layout keeps the table at 8N + 4N
// bytes), invalid windows skip the lookup entirely, the search stops as
// soon as its range is empty, and all 32 lanes of a warp issue their
// lookups together so the memory system sees 32 independent requests per
// warp.  A simple kernel that is right comes first; see PERF.md.
//
// Trap kept on purpose: a read without hits still reports f_strand from
// window 0's lookup slot (JAX argmax of an all-false row is 0), so window 0
// is always looked up (with q = mix64(0) when it is invalid).

#include <cuda_runtime.h>

#define KT_INT32_MAX 2147483647
#define KT_DEPTH 6
#define KT_FULL 0xffffffffu

struct IndexView {
    const unsigned long long* hkeys;  // [N] mixed canonical k-mers, sorted
    const int* bucket_start;          // [2^p + 1]
    const int* uid;                   // [N]
    const int* pos;                   // [N]
    const unsigned char* fw;          // [N] bool
    const int* block;                 // [N]
    const int* ec;                    // [N] EC row, -1 = wildcard
    long long N;
    int p;
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

__global__ void pseudoalign_side_kernel(
    IndexView ix,
    const unsigned char* __restrict__ packed,  // [B, Lp/4]
    const unsigned char* __restrict__ nmask,   // [B, Lp/8]
    const int* __restrict__ lens,              // [B]
    int B, int Lp, int k, int R, int warp_bytes,
    int* __restrict__ rows,                    // [B, R]
    int* __restrict__ n_rows,
    unsigned char* __restrict__ has_hits,
    unsigned char* __restrict__ overflow,
    int* __restrict__ f_uid,
    int* __restrict__ f_block,
    int* __restrict__ f_upos,
    int* __restrict__ f_rpos,
    unsigned char* __restrict__ f_strand,
    int* __restrict__ rng) {
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
        const int len = lens[read];

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
                    idx = kt_lookup(ix, q);
                    hit = valid && ix.hkeys[idx] == q;
                    if (hit) ecv = ix.ec[idx];
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
            if (lane == 0) rows[read * R + s] = m;
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
            n_rows[read] = nr;
            has_hits[read] = (unsigned char)has;
            overflow[read] = (unsigned char)ov;
            f_strand[read] = (unsigned char)(ffw == (int)(ix.fw[fidx] != 0));
            f_uid[read] = has ? ix.uid[fidx] : -1;
            f_block[read] = has ? ix.block[fidx] : -1;
            f_upos[read] = has ? ix.pos[fidx] : -1;
            f_rpos[read] = has ? first : -1;
            rng[read] = has ? last - first : -1;
        }
        __syncwarp();
    }
}

extern "C" int pseudoalign_side(
    const void* hkeys, const void* bucket_start, const void* uid,
    const void* pos, const void* fw, const void* block, const void* ec,
    long long N, int p,
    const void* packed, const void* nmask, const void* lens,
    int B, int Lp, int k, int R,
    void* rows, void* n_rows, void* has_hits, void* overflow,
    void* f_uid, void* f_block, void* f_upos, void* f_rpos,
    void* f_strand, void* rng, void* stream) {
    if (B <= 0) return 0;
    if (N <= 0 || Lp < k || (Lp & 7) != 0 || R <= 0 || R > Lp - k + 1 ||
        k > 32 || p < 1 || p > 63)
        return (int)cudaErrorInvalidValue;
    IndexView ix;
    ix.hkeys = (const unsigned long long*)hkeys;
    ix.bucket_start = (const int*)bucket_start;
    ix.uid = (const int*)uid;
    ix.pos = (const int*)pos;
    ix.fw = (const unsigned char*)fw;
    ix.block = (const int*)block;
    ix.ec = (const int*)ec;
    ix.N = N;
    ix.p = p;
    const int W = Lp - k + 1;
    const int code_bytes = (Lp + 15) & ~15;
    const int warp_bytes = (code_bytes + 4 * W + 15) & ~15;
    const int max_smem = 227 * 1024;
    int wpb = 4;
    while (wpb > 1 && wpb * warp_bytes > max_smem) wpb >>= 1;
    const long long smem = (long long)wpb * warp_bytes;
    if (smem > max_smem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            pseudoalign_side_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    long long blocks = ((long long)B + wpb - 1) / wpb;
    if (blocks > 1048576) blocks = 1048576;
    pseudoalign_side_kernel<<<(unsigned int)blocks, wpb * 32, (size_t)smem,
                              (cudaStream_t)stream>>>(
        ix, (const unsigned char*)packed, (const unsigned char*)nmask,
        (const int*)lens, B, Lp, k, R, warp_bytes, (int*)rows, (int*)n_rows,
        (unsigned char*)has_hits, (unsigned char*)overflow, (int*)f_uid,
        (int*)f_block, (int*)f_upos, (int*)f_rpos, (unsigned char*)f_strand,
        (int*)rng);
    return (int)cudaGetLastError();
}
