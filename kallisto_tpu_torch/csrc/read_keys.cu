// Kernel B: read_keys -- the 128-bit read key and the mapPair fragment
// length, one thread per pair (or per read for single-end).
//
// Replaces the JAX device programs kallisto_tpu/ops/pseudoalign.py
// _hash_columns_128 (:567) as reached through pair_key_hash (:638) and
// single_key_hash (:649), and pair_fragment_lengths (:1206).  The columns
// are hashed in JAX order: rows1[0..R1), rows2[0..R2), then the flag
// column has1 + 2*has2 + 4*ovf1 + 8*ovf2 (single-end: has + 4*ovf).  Every
// column is a non-negative int32, sign-extended to 64 bits as JAX's
// astype(uint64) does, and all arithmetic is unsigned 64-bit with wrap.
//
// What bounds it on the H100: memory.  Per pair it reads 4*(R1+R2) bytes of
// rows plus 2 flag bytes per mate (plus 13 bytes per mate of first-hit
// fields in paired mode) and writes 16 + 4 bytes; the hashing is ~8 integer
// operations per column.  Each thread reads its own contiguous row (64 B
// for R = 16), which the L1 serves after the first sector; the kernel is
// trivially short next to kernel A and is kept simple.

#include <cuda_runtime.h>

#define KT_M1 0x100000001B3ULL
#define KT_M2 0xC2B2AE3D27D4EB4FULL

__global__ void read_keys_kernel(
    const int* __restrict__ rows1, int R1,
    const unsigned char* __restrict__ has1,
    const unsigned char* __restrict__ ovf1,
    const int* __restrict__ rows2, int R2,
    const unsigned char* __restrict__ has2,
    const unsigned char* __restrict__ ovf2,
    const int* __restrict__ upos1, const int* __restrict__ rpos1,
    const int* __restrict__ block1, const unsigned char* __restrict__ strand1,
    const int* __restrict__ upos2, const int* __restrict__ rpos2,
    const int* __restrict__ block2, const unsigned char* __restrict__ strand2,
    int k, int B, unsigned long long* __restrict__ h_out,
    int* __restrict__ tl_out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    unsigned long long h1 = 0xCBF29CE484222325ULL;
    unsigned long long h2 = 0x9E3779B97F4A7C15ULL;
    const int* r1 = rows1 + i * R1;
    for (int j = 0; j < R1; ++j) {
        const unsigned long long c = (unsigned long long)(long long)r1[j];
        h1 = (h1 ^ c) * KT_M1;
        h2 = (h2 + c) * KT_M2;
        h2 ^= h2 >> 29;
    }
    const int paired = rows2 != 0;
    long long flags = (long long)has1[i] + 4 * (long long)ovf1[i];
    if (paired) {
        const int* r2 = rows2 + i * R2;
        for (int j = 0; j < R2; ++j) {
            const unsigned long long c = (unsigned long long)(long long)r2[j];
            h1 = (h1 ^ c) * KT_M1;
            h2 = (h2 + c) * KT_M2;
            h2 ^= h2 >> 29;
        }
        flags += 2 * (long long)has2[i] + 8 * (long long)ovf2[i];
    }
    {
        const unsigned long long c = (unsigned long long)flags;
        h1 = (h1 ^ c) * KT_M1;
        h2 = (h2 + c) * KT_M2;
        h2 ^= h2 >> 29;
    }
    h1 ^= h1 >> 33;
    h2 *= KT_M1;
    h_out[2 * i] = h1;
    h_out[2 * i + 1] = h2;
    if (paired) {
        // mapPair (reference: KmerIndex.cpp:1622-1693): same block, opposite
        // strands; the length is |p1 - p2| of the projected read ends
        const int s1 = strand1[i] != 0, s2 = strand2[i] != 0;
        const int p1 = s1 ? upos1[i] - rpos1[i] : upos1[i] + k + rpos1[i];
        const int p2 = s2 ? upos2[i] - rpos2[i] : upos2[i] + k + rpos2[i];
        const int ok = has1[i] && has2[i] && block1[i] == block2[i] && s1 != s2;
        const int d = p1 - p2;
        tl_out[i] = ok ? (d < 0 ? -d : d) : -1;
    }
}

extern "C" int read_keys(
    const void* rows1, int R1, const void* has1, const void* ovf1,
    const void* rows2, int R2, const void* has2, const void* ovf2,
    const void* upos1, const void* rpos1, const void* block1,
    const void* strand1, const void* upos2, const void* rpos2,
    const void* block2, const void* strand2, int k, int B, void* h_out,
    void* tl_out, void* stream) {
    if (B <= 0) return 0;
    if (R1 <= 0 || (rows2 != 0 && (R2 <= 0 || tl_out == 0)))
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long blocks = ((long long)B + threads - 1) / threads;
    read_keys_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)rows1, R1, (const unsigned char*)has1,
        (const unsigned char*)ovf1, (const int*)rows2, R2,
        (const unsigned char*)has2, (const unsigned char*)ovf2,
        (const int*)upos1, (const int*)rpos1, (const int*)block1,
        (const unsigned char*)strand1, (const int*)upos2, (const int*)rpos2,
        (const int*)block2, (const unsigned char*)strand2, k, B,
        (unsigned long long*)h_out, (int*)tl_out);
    return (int)cudaGetLastError();
}
