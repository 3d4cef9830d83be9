// Kernel C: em_step -- one float64 EM update with the reference's change
// count, deterministic and bitwise equal to the plain PyTorch version.
//
// Replaces the JAX device program kallisto_tpu/quant/em.py _em_iteration
// (:112) and the body of _em_loop (:125-166):
//
//   s_ec   = segment_sum(alpha[tx] * inv_eff[tx], flat_ec)
//   valid  = (count > 0) & (count * s_ec >= denorm_min)
//   scale  = valid ? count / (s_ec > 0 ? s_ec : 1) : 0
//   next   = singleton + segment_sum(alpha[tx] * inv_eff[tx] * scale[ec], tx)
//   changed = #{t : next > 1e-2 and |next - alpha| / next > 1e-2}
//
// Two passes, no atomics on floating point: pass 1 is one thread per
// multi-transcript EC summing its contiguous flat_ec run in ascending flat
// order from 0.0; pass 2 is one thread per transcript summing its entries
// over a transposed CSR (flat positions of that transcript in ascending
// order, built once on the host by a stable argsort), then adding the
// singleton count.  Those are exactly the orders of a sequential
// segment_sum/index_add_ on the CPU, so the result is bitwise equal.  The
// file is compiled with --fmad=false: a contracted a*b + c would round
// differently.  The change count is the only atomic (an integer).
//
// `zero_input` applies the reference's final-round zeroing (alpha below
// EM_ALPHA_LIMIT / 10 becomes 0, em.py :162-164) to the INPUT alpha as it is
// read, so the loop needs no separate pass: the host passes the raw output
// of the iteration that started the final round and keeps that raw buffer
// as alpha_before_zeroes.
//
// What bounds it on the H100: memory, and launch latency at small sizes.
// Per iteration it reads flat_tx and the transposed EC ids (4 B each per
// flat entry), alpha, inv_eff, the singletons and the CSR pointers, and
// writes next and scale; the gathers alpha[tx] in pass 1 are random but
// the [T] vectors stay in L2.  At ~30k targets an iteration is a few
// microseconds of work, so the two launches and the host read of the
// change count per iteration are what the loop pays (see PERF.md).

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

__global__ void em_pass1_kernel(
    const double* __restrict__ alpha, const double* __restrict__ inv_eff,
    const int* __restrict__ flat_tx, const long long* __restrict__ ec_ptr,
    const double* __restrict__ multi_counts, double* __restrict__ scale,
    int* __restrict__ changed, int E, int zero_input) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e == 0) *changed = 0;
    if (e >= E) return;
    double s = 0.0;
    for (long long j = ec_ptr[e]; j < ec_ptr[e + 1]; ++j) {
        const int t = flat_tx[j];
        s = __dadd_rn(s, __dmul_rn(kt_alpha(alpha, t, zero_input), inv_eff[t]));
    }
    const double mc = multi_counts[e];
    const double denom = __dmul_rn(mc, s);
    const int valid = (mc > 0.0) && (denom >= KT_EM_TOLERANCE);
    scale[e] = valid ? __ddiv_rn(mc, s > 0.0 ? s : 1.0) : 0.0;
}

__global__ void em_pass2_kernel(
    const double* __restrict__ alpha, double* __restrict__ next,
    const double* __restrict__ singleton_alpha,
    const double* __restrict__ inv_eff, const long long* __restrict__ tx_ptr,
    const int* __restrict__ tx_ec, const double* __restrict__ scale,
    int* __restrict__ changed, int T, int zero_input) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= T) return;
    const double a = kt_alpha(alpha, (int)t, zero_input);
    const double aol = __dmul_rn(a, inv_eff[t]);
    double acc = 0.0;
    for (long long j = tx_ptr[t]; j < tx_ptr[t + 1]; ++j)
        acc = __dadd_rn(acc, __dmul_rn(aol, scale[tx_ec[j]]));
    const double nx = __dadd_rn(singleton_alpha[t], acc);
    next[t] = nx;
    const double diff = nx - a;
    const double rel = __ddiv_rn(diff < 0.0 ? -diff : diff, nx > 0.0 ? nx : 1.0);
    if (nx > KT_EM_CHANGE_LIMIT && rel > KT_EM_CHANGE) atomicAdd(changed, 1);
}

extern "C" int em_step(
    const void* alpha, void* next, const void* singleton_alpha,
    const void* inv_eff, const void* flat_tx, const void* ec_ptr,
    const void* multi_counts, const void* tx_ptr, const void* tx_ec,
    void* scale, void* changed, int T, int E, int zero_input, void* stream) {
    if (T <= 0) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long b1 = ((long long)(E > 0 ? E : 1) + threads - 1) / threads;
    em_pass1_kernel<<<(unsigned int)b1, threads, 0, (cudaStream_t)stream>>>(
        (const double*)alpha, (const double*)inv_eff, (const int*)flat_tx,
        (const long long*)ec_ptr, (const double*)multi_counts,
        (double*)scale, (int*)changed, E, zero_input);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long b2 = ((long long)T + threads - 1) / threads;
    em_pass2_kernel<<<(unsigned int)b2, threads, 0, (cudaStream_t)stream>>>(
        (const double*)alpha, (double*)next, (const double*)singleton_alpha,
        (const double*)inv_eff, (const long long*)tx_ptr, (const int*)tx_ec,
        (const double*)scale, (int*)changed, T, zero_input);
    return (int)cudaGetLastError();
}
