// Kernel B: read_keys -- the per-read 128-bit key and the mapPair fragment
// length, one thread per pair (or per read for single-end); with the bias
// tables also kernel H, each read's 5' hexamer id, as an epilogue of the
// same thread.
//
// Replaces the JAX device programs kallisto_tpu/ops/pseudoalign.py
// _hash_columns_128 (:567) as reached through pair_key_hash (:638) and
// single_key_hash (:649) on the per-read path, the flag builders
// _pair_flags / _single_flags (:598, :616) with every option off,
// pair_fragment_lengths (:1206) and, under --bias, bias_hexamers (:1172).
// The columns are hashed in JAX order,
// rows1[0..R1), rows2[0..R2) (paired), flags = has1 + 2*has2 + 4*ovf1 +
// 8*ovf2, by the key function kernel E's first pass shares
// (csrc/keys.cuh).  The steady state's compact key (veto bits, strand
// tail, position rank) is not computed here: kernel E computes it in its
// first pass, fused into the key table (csrc/compact.cu compact_keys).
//
// What bounds it on the H100: memory.  Per pair it reads 4*(R1+R2) bytes
// of rows plus 2 flag bytes per mate and, for the fragment length, 13
// bytes of first-hit fields per mate; it writes 16 bytes of key and 4 of
// fragment length.  The hashing is ~8 integer operations per column.
// Each thread takes its row as 16-byte loads (4 at R = 16; 8- or 4-byte
// loads where the mate's row width or pointer forbids 16), and writes its
// key as one 16-byte store.  A staged form -- a warp's 32 rows copied
// through shared memory with coalesced 16-byte loads, then hashed a read a
// lane -- was slower on the card in device time, so each thread loads its
// own row.
//
// Kernel H (the reference's MinCollector::countBias getPreSeq +
// hexamerToInt, src/MinCollector.cpp:653-721; plain version
// ops/pseudoalign.py bias_hexamers_plain): from mate 1's first hit, the
// fragment-start context on the unitig with pre = 2 bases before the read
// and post = 4 after its first k-mer; a read mapping forward reads the
// 6-mer at (upos - rpos - 2) reverse-complemented, a read mapping in
// reverse the 6-mer at (upos + rpos + k - 4) forward; -1 where mate 1 has
// no hit, where the read is not valid (a pair whose mate 2 has no hit;
// every single-end read is valid) or where the context leaves the mosaic
// block.  The start is clipped to [0, S - 6] as JAX clips it.  H was a
// launch of its own that read mate 1's fields again; as B's epilogue the
// thread adds a load of f_uid, then block_start, block_end and
// unitig_seq_off issued together, then the six bases as one or two
// aligned 8-byte words of unitig_seq (the host pads its storage to a
// multiple of 8 bytes, so a word never leaves the allocation).

#include "keys.cuh"

// Kernel H's tables (struct BiasView in ops/kernels.py), built once per
// BiasTables on the host.
struct BiasView {
    const int* block_start;           // [NB] first k-mer pos of a block
    const int* block_end;             // [NB] exclusive end
    const long long* useq_off;        // [U+1] unitig offsets in useq
    const unsigned long long* useq;   // unitig base codes, 8 a word
    long long S;                      // bases in useq (its logical length)
};

// Kernel H for read i (see the header): mate 1's hexamer id or -1.
__device__ __forceinline__ int kt_hexamer(const KeySide& s1, const int* uid,
                                          const BiasView& bv, int valid,
                                          int k, int i) {
    const int pre = 2, post = 4;
    if (!(valid && s1.has[i])) return -1;
    const int b = __ldg(s1.block + i), u = __ldg(uid + i);
    const int upos = __ldg(s1.upos + i), p = __ldg(s1.rpos + i);
    const int fw = __ldg(s1.strand + i) != 0;
    const int blk = b > 0 ? b : 0;
    const int cstart = __ldg(bv.block_start + blk);
    const int cend = __ldg(bv.block_end + blk);
    const long long base = __ldg(bv.useq_off + (u > 0 ? u : 0));
    const int clen = cend - cstart;
    const int pos = upos - cstart;
    const int fw_ok = fw && (pos - p >= pre);
    const int rc_ok = !fw && (clen - 1 - pos - p >= pre);
    if (!fw_ok && !rc_ok) return -1;
    long long start = fw_ok ? base + (long long)(upos - p - pre)
                            : base + (long long)(upos + p + k - post);
    if (start > bv.S - 6) start = bv.S - 6;
    if (start < 0) start = 0;
    // bytes [start, start + 6): the word holding start, and the next one
    // when they cross it (that word holds byte start + 5 < S)
    const long long w = start >> 3;
    const int sh = (int)(start & 7) * 8;
    unsigned long long v = __ldg(bv.useq + w) >> sh;
    if (sh > 16) v |= __ldg(bv.useq + w + 1) << (64 - sh);
    int hex = 0;
#pragma unroll
    for (int m = 0; m < 6; ++m) {
        const int c = (int)((v >> (8 * m)) & 0xFF);
        hex |= fw_ok ? ((3 - c) << (2 * m))     // revcomp read
                     : (c << (2 * (5 - m)));    // forward read
    }
    return hex;
}

// BIAS = 0: B alone (B's option-off form); 1: with kernel H's epilogue.
template <int BIAS>
__global__ void __launch_bounds__(256) read_keys_kernel(
    KeySide s1, KeySide s2, int paired, int k, int B, int V1, int V2,
    ulonglong2* __restrict__ h_out, int* __restrict__ tl_out, BiasView bv,
    const int* __restrict__ uid, int* __restrict__ hx_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    KeyOpts o = {};
    o.k = k;
    KeyHash h;
    kt_compact_key(h, s1, s2, paired, o, i, V1, V2);
    h_out[i] = make_ulonglong2(h.w0(), h.w1());
    if (paired && tl_out) {
        // mapPair (reference: KmerIndex.cpp:1622-1693): same block, opposite
        // strands; the length is |p1 - p2| of the projected read ends
        const int t1 = s1.strand[i] != 0, t2 = s2.strand[i] != 0;
        const int p1 = t1 ? s1.upos[i] - s1.rpos[i] : s1.upos[i] + k + s1.rpos[i];
        const int p2 = t2 ? s2.upos[i] - s2.rpos[i] : s2.upos[i] + k + s2.rpos[i];
        const int ok = s1.has[i] && s2.has[i] && s1.block[i] == s2.block[i] &&
                       t1 != t2;
        const int d = p1 - p2;
        tl_out[i] = ok ? (d < 0 ? -d : d) : -1;
    }
    // valid: mate 2 has hits (JAX :937), every single-end read (:1403)
    if (BIAS)
        hx_out[i] = kt_hexamer(s1, uid, bv, paired ? s2.has[i] != 0 : 1, k, i);
}

// h_out [B, 2] int64 (16-byte aligned); tl_out [B] int32 or null (paired
// only; s2 null for single-end).  bias (null: no hexamers) with uid
// (mate 1's f_uid [B] int32) and hx_out [B] int32: kernel H's epilogue.
extern "C" int read_keys(const KeySide* s1, const KeySide* s2, long long B,
                         int k, void* h_out, void* tl_out,
                         const BiasView* bias, const void* uid, void* hx_out,
                         void* stream) {
    if (B <= 0) return 0;
    if (s1 == 0 || s1->R <= 0 || (s2 != 0 && s2->R <= 0) ||
        B >= (1LL << 31) || ((unsigned long long)h_out & 15))
        return (int)cudaErrorInvalidValue;
    if (bias != 0 &&
        (uid == 0 || hx_out == 0 || bias->S < 6 ||
         ((unsigned long long)bias->useq & 7) || s1->upos == 0))
        return (int)cudaErrorInvalidValue;
    const int paired = s2 != 0;
    KeySide none = *s1;
    const int V1 = kt_vec(s1), V2 = paired ? kt_vec(s2) : 1;
    const int threads = 256;
    const unsigned int blocks = (unsigned int)((B + threads - 1) / threads);
    const BiasView bv = bias != 0 ? *bias : BiasView{};
    auto kern = bias != 0 ? read_keys_kernel<1> : read_keys_kernel<0>;
    kern<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        *s1, paired ? *s2 : none, paired, k, (int)B, V1, V2,
        (ulonglong2*)h_out, (int*)tl_out, bv, (const int*)uid, (int*)hx_out);
    return (int)cudaGetLastError();
}
