// Kernel H: bias_hexamers -- the 5' hexamer id of each read for the
// sequence-bias model, equal to the plain PyTorch version
// (ops/pseudoalign.py bias_hexamers_plain).
//
// Replaces the JAX device program kallisto_tpu/ops/pseudoalign.py
// bias_hexamers (:1172), itself the reference's MinCollector::countBias
// getPreSeq + hexamerToInt (src/MinCollector.cpp:653-721): from mate 1's
// first hit, the fragment-start context on the unitig with pre = 2 bases
// before the read and post = 4 after its first k-mer; a read mapping
// forward reads the 6-mer at (upos - rpos - 2) reverse-complemented, a
// read mapping in reverse the 6-mer at (upos + rpos + k - 4) forward; -1
// where the read (or its pair, through `valid`) has no hit or the context
// leaves the mosaic block.  The start is clipped to [0, S - 6] as JAX
// clips it, so an out-of-range start reads the same bytes.
//
// One thread per read.  What bounds it on the H100: bytes -- seven
// per-read fields in, one int32 out, and per read with a hit one sector
// each of block_start, block_end, unitig_seq_off and unitig_seq.  There is
// no arithmetic worth fusing; the kernel is a gather.

#include <cuda_runtime.h>

__global__ void bias_hexamers_kernel(
    const int* __restrict__ f_block, const int* __restrict__ f_upos,
    const int* __restrict__ f_rpos, const int* __restrict__ f_uid,
    const bool* __restrict__ f_strand, const bool* __restrict__ has_hits,
    const bool* __restrict__ valid, const int* __restrict__ block_start,
    const int* __restrict__ block_end, const long long* __restrict__ useq_off,
    const unsigned char* __restrict__ useq, long long S, long long B, int k,
    int* __restrict__ out) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    const int pre = 2, post = 4;
    if (!(valid[r] && has_hits[r])) {
        out[r] = -1;
        return;
    }
    const int blk = f_block[r] > 0 ? f_block[r] : 0;
    const int cstart = block_start[blk];
    const int clen = block_end[blk] - cstart;
    const int upos = f_upos[r];
    const int pos = upos - cstart;
    const int p = f_rpos[r];
    const bool fw = f_strand[r];
    const bool fw_ok = fw && (pos - p >= pre);
    const bool rc_ok = !fw && (clen - 1 - pos - p >= pre);
    if (!fw_ok && !rc_ok) {
        out[r] = -1;
        return;
    }
    const long long base = useq_off[f_uid[r] > 0 ? f_uid[r] : 0];
    long long start = fw_ok ? base + (long long)(upos - p - pre)
                            : base + (long long)(upos + p + k - post);
    if (start > S - 6) start = S - 6;
    if (start < 0) start = 0;
    int hex = 0;
    for (int m = 0; m < 6; ++m) {
        const int c = (int)useq[start + m];
        hex |= fw_ok ? ((3 - c) << (2 * m))     // revcomp read
                     : (c << (2 * (5 - m)));    // forward read
    }
    out[r] = hex;
}

extern "C" int bias_hexamers(
    const void* f_block, const void* f_upos, const void* f_rpos,
    const void* f_uid, const void* f_strand, const void* has_hits,
    const void* valid, const void* block_start, const void* block_end,
    const void* useq_off, const void* useq, long long S, long long B, int k,
    void* out, void* stream) {
    if (B <= 0) return 0;
    if (S < 6) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long blocks = (B + threads - 1) / threads;
    bias_hexamers_kernel<<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const int*)f_block, (const int*)f_upos, (const int*)f_rpos,
        (const int*)f_uid, (const bool*)f_strand, (const bool*)has_hits,
        (const bool*)valid, (const int*)block_start, (const int*)block_end,
        (const long long*)useq_off, (const unsigned char*)useq, S, B, k,
        (int*)out);
    return (int)cudaGetLastError();
}
