// Kernel G: em_step_batch -- one float64 EM update of each of Bb replicates
// that share one EC structure, with the reference's change count per
// replicate, deterministic and bitwise equal to the plain PyTorch version
// (quant/em.py em_step_batch_plain).  The main EM is its Bb = 1 case; the
// bootstraps run every replicate in one launch per round.
//
// Replaces the JAX device programs kallisto_tpu/quant/em.py _em_iteration
// (:112) with the body of _em_loop (:125-166), and _run_em_batch_jax
// (:236), a vmap of _em_full over replicates.  Per replicate b:
//
//   s_ec   = segment_sum(alpha[b, tx] * inv_eff[tx], flat_ec)
//   valid  = (count[b] > 0) & (count[b] * s_ec >= denorm_min)
//   scale  = valid ? count[b] / (s_ec > 0 ? s_ec : 1) : 0
//   next   = singleton[b] + segment_sum(alpha[b, tx] * inv_eff[tx] * scale[ec], tx)
//   changed[b] = #{t : next > 1e-2 and |next - alpha| / next > 1e-2}
//
// The vmapped while-loop's per-member predicate becomes `mode` (0 = frozen:
// the row is copied and counts no change; 1 = update; 2 = update from the
// zeroed alpha), set by the host loop.  Mode 2 applies the reference's
// final-round zeroing (alpha below EM_ALPHA_LIMIT / 10 becomes 0, em.py
// :162-164) to the INPUT alpha as it is read, so the loop needs no separate
// pass: the host keeps the raw output of the update that started the final
// round as alpha_before_zeroes.
//
// Two passes, no atomics on floating point, the replicate as the slow
// index: pass 1 is one thread per (replicate, multi-transcript EC) summing
// its contiguous flat_ec run in ascending flat order from 0.0; pass 2 is
// one thread per (replicate, transcript) summing its entries over a
// transposed CSR (flat positions of that transcript in ascending order,
// built once on the host by a stable argsort), then adding the singleton
// count.  Those are exactly the orders of a sequential segment_sum /
// index_add_ on the CPU, so the result is bitwise equal.  The file is
// compiled with --fmad=false: a contracted a*b + c would round differently.
// The change count is the only atomic (an integer); pass 1's first thread of
// each replicate zeroes it.  inv_eff is one shared [T] row, or one row per
// replicate when batched_eff.  Float64 throughout: the H100 has native
// double precision, so the card's replicates equal the float64 CPU leg (the
// JAX package used float32 on the TPU only for lack of float64).
//
// What bounds it on the H100: at Bb = 1 (~30k targets) a round is a few
// microseconds of work, so the two launches and the host's read of the
// change count are what the loop pays; at Bb = 100, memory: per round it
// reads alpha, the singletons and the counts of every running replicate
// once, gathers alpha (pass 1) and scale (pass 2) through the shared CSR,
// and writes scale and next (see PERF.md).

#include <cuda_runtime.h>

#define KT_EM_TOLERANCE 4.9406564584124654e-324  // denorm_min
#define KT_EM_ALPHA_LIMIT 1e-7
#define KT_EM_CHANGE_LIMIT 1e-2
#define KT_EM_CHANGE 1e-2

__device__ __forceinline__ double kt_alpha(const double* alpha, int t,
                                           int zero_input) {
    const double a = alpha[t];
    return (zero_input && a < KT_EM_ALPHA_LIMIT / 10.0) ? 0.0 : a;
}

// grid over Bb * E1 threads, E1 = max(E, 1), so that every replicate has a
// thread e == 0 to zero its change count even when there is no multi EC
__global__ void em_batch_pass1_kernel(
    const double* __restrict__ alpha, const double* __restrict__ inv_eff,
    const int* __restrict__ flat_tx, const long long* __restrict__ ec_ptr,
    const double* __restrict__ multi_counts, double* __restrict__ scale,
    const int* __restrict__ mode, int* __restrict__ changed, int Bb, int T,
    int E, int E1, int batched_eff) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= (long long)Bb * E1) return;
    const int b = (int)(g / E1);
    const long long e = g - (long long)b * E1;
    if (e == 0) changed[b] = 0;
    const int m = mode[b];
    if (m == 0 || e >= E) return;
    const double* a_b = alpha + (long long)b * T;
    const double* ie_b = inv_eff + (batched_eff ? (long long)b * T : 0);
    double s = 0.0;
    for (long long j = ec_ptr[e]; j < ec_ptr[e + 1]; ++j) {
        const int t = flat_tx[j];
        s = __dadd_rn(s, __dmul_rn(kt_alpha(a_b, t, m == 2), ie_b[t]));
    }
    const long long be = (long long)b * E + e;
    const double mc = multi_counts[be];
    const double denom = __dmul_rn(mc, s);
    const int valid = (mc > 0.0) && (denom >= KT_EM_TOLERANCE);
    scale[be] = valid ? __ddiv_rn(mc, s > 0.0 ? s : 1.0) : 0.0;
}

__global__ void em_batch_pass2_kernel(
    const double* __restrict__ alpha, double* __restrict__ next,
    const double* __restrict__ singleton_alpha,
    const double* __restrict__ inv_eff, const long long* __restrict__ tx_ptr,
    const int* __restrict__ tx_ec, const double* __restrict__ scale,
    const int* __restrict__ mode, int* __restrict__ changed, int Bb, int T,
    int E, int batched_eff) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= (long long)Bb * T) return;
    const int b = (int)(g / T);
    const int t = (int)(g - (long long)b * T);
    const int m = mode[b];
    if (m == 0) {
        next[g] = alpha[g];
        return;
    }
    const double a = kt_alpha(alpha + (long long)b * T, t, m == 2);
    const double ie = inv_eff[(batched_eff ? (long long)b * T : 0) + t];
    const double aol = __dmul_rn(a, ie);
    const double* sc_b = scale + (long long)b * E;
    double acc = 0.0;
    for (long long j = tx_ptr[t]; j < tx_ptr[t + 1]; ++j)
        acc = __dadd_rn(acc, __dmul_rn(aol, sc_b[tx_ec[j]]));
    const double nx = __dadd_rn(singleton_alpha[g], acc);
    next[g] = nx;
    const double diff = nx - a;
    const double rel = __ddiv_rn(diff < 0.0 ? -diff : diff, nx > 0.0 ? nx : 1.0);
    if (nx > KT_EM_CHANGE_LIMIT && rel > KT_EM_CHANGE) atomicAdd(changed + b, 1);
}

extern "C" int em_step_batch(
    const void* alpha, void* next, const void* singleton_alpha,
    const void* inv_eff, const void* flat_tx, const void* ec_ptr,
    const void* multi_counts, const void* tx_ptr, const void* tx_ec,
    void* scale, const void* mode, void* changed, int Bb, int T, int E,
    int batched_eff, void* stream) {
    if (Bb <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    const int E1 = E > 0 ? E : 1;
    const long long b1 = ((long long)Bb * E1 + threads - 1) / threads;
    em_batch_pass1_kernel<<<(unsigned int)b1, threads, 0, st>>>(
        (const double*)alpha, (const double*)inv_eff, (const int*)flat_tx,
        (const long long*)ec_ptr, (const double*)multi_counts,
        (double*)scale, (const int*)mode, (int*)changed, Bb, T, E, E1,
        batched_eff);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long b2 = ((long long)Bb * T + threads - 1) / threads;
    em_batch_pass2_kernel<<<(unsigned int)b2, threads, 0, st>>>(
        (const double*)alpha, (double*)next, (const double*)singleton_alpha,
        (const double*)inv_eff, (const long long*)tx_ptr, (const int*)tx_ec,
        (const double*)scale, (const int*)mode, (int*)changed, Bb, T, E,
        batched_eff);
    return (int)cudaGetLastError();
}
