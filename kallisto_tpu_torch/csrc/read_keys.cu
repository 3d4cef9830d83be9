// Kernel B: read_keys -- the per-read 128-bit key and the mapPair fragment
// length, one thread per pair (or per read for single-end).
//
// Replaces the JAX device programs kallisto_tpu/ops/pseudoalign.py
// _hash_columns_128 (:567) as reached through pair_key_hash (:638) and
// single_key_hash (:649) on the per-read path, the flag builders
// _pair_flags / _single_flags (:598, :616) with every option off, and
// pair_fragment_lengths (:1206).  The columns are hashed in JAX order,
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

#include "keys.cuh"

__global__ void __launch_bounds__(256) read_keys_kernel(
    KeySide s1, KeySide s2, int paired, int k, int B, int V1, int V2,
    ulonglong2* __restrict__ h_out, int* __restrict__ tl_out) {
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
}

// h_out [B, 2] int64 (16-byte aligned); tl_out [B] int32 or null (paired
// only; s2 null for single-end).
extern "C" int read_keys(const KeySide* s1, const KeySide* s2, long long B,
                         int k, void* h_out, void* tl_out, void* stream) {
    if (B <= 0) return 0;
    if (s1 == 0 || s1->R <= 0 || (s2 != 0 && s2->R <= 0) ||
        B >= (1LL << 31) || ((unsigned long long)h_out & 15))
        return (int)cudaErrorInvalidValue;
    const int paired = s2 != 0;
    KeySide none = *s1;
    const int V1 = kt_vec(s1), V2 = paired ? kt_vec(s2) : 1;
    const int threads = 256;
    const unsigned int blocks = (unsigned int)((B + threads - 1) / threads);
    read_keys_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        *s1, paired ? *s2 : none, paired, k, (int)B, V1, V2,
        (ulonglong2*)h_out, (int*)tl_out);
    return (int)cudaGetLastError();
}
