// Kernel G: em_step_batch -- the float64 EM of Bb replicates that share
// one EC structure, N rounds captured as one CUDA graph and replayed,
// deterministic and bitwise equal to the plain PyTorch versions
// (quant/em.py em_step_batch_plain, em_round_plain, em_stop_plain).  The
// main EM is its Bb = 1 case; the bootstraps and quant-tcc's cells run
// every replicate in the same rounds.

// Replaces the JAX device programs kallisto_tpu/quant/em.py _em_iteration
// (:112) with the whole while-loop of _em_loop (:125-177), and
// _run_em_batch_jax (:236), a vmap of _em_full over replicates.  Per
// replicate b and round i:
//
//   s_ec   = segment_sum(alpha[tx, b] * inv_eff[tx], flat_ec)
//   valid  = (count[b] > 0) & (count[b] * s_ec >= denorm_min)
//   scale  = valid ? count[b] / (s_ec > 0 ? s_ec : 1) : 0
//   next   = singleton[b] + segment_sum(alpha[tx, b] * inv_eff[tx] * scale[ec], tx)
//   changed[b] = #{t : next > 1e-2 and |next - alpha| / next > 1e-2}
//
// and then the stop rule of the reference (EMAlgorithm.h:171-222, JAX's
// loop body): after round min_rounds, a running replicate (mode 1) that
// changed nothing starts its final round (mode 2: the update reads its
// alpha zeroed below EM_ALPHA_LIMIT / 10, em.py:162-164); a replicate in
// its final round ends (mode 0, done_at = i + 1).  A round runs while
// i < bound and some replicate is not frozen; a round that does not run
// changes nothing and does not advance i.
//
// State on the card (the layout that ops/kernels.py EmGraph checks):
//   bufs    [2, T, Bb] alpha, ping-pong: round i reads bufs[i & 1] and
//           writes the running replicates' columns of bufs[(i & 1) ^ 1];
//           a frozen column is never written again, so a replicate that
//           ended after round done_at - 1 holds alpha in bufs[done_at & 1]
//           and its alpha_before_zeroes (the raw input of its final round)
//           in the other buffer -- no copy;
//   st      [4 + 3 Bb] int64: i, bound, running, 0, mode[Bb], done_at[Bb],
//           last[Bb] (the change counts of the last round that ran);
//   changed [Bb] int32, the round's counts, moved to last and zeroed by
//           the stop step.
//
// Design.  Replicate-minor lanes: alpha, next, the singletons, the multi
// counts and scale are [item, Bb] rows (inv_eff too when each replicate
// has its own lengths), and thread g takes item g / Bb and replicate
// g % Bb, so a warp covers one or two items: each CSR index (flat_tx,
// tx_ec, the run bounds) is one broadcast read per warp, and each gather
// reads 8 Bb contiguous bytes.  At Bb = 1 this is one thread per item.
// Pass 1 is one thread per (multi EC, replicate) summing its contiguous
// flat_ec run in ascending flat order from 0.0; pass 2 one thread per
// (transcript, replicate) summing its entries over a transposed CSR (flat
// positions of that transcript in ascending order, built once on the host
// by a stable argsort), then adding the singleton count.  Those are
// exactly the orders of a sequential segment_sum / index_add_ on the CPU,
// so the result is bitwise equal; the file is compiled with --fmad=false
// (a contracted a*b + c would round differently), and no floating-point
// value is summed by an atomic.  Pass 2 counts changes per block in
// shared memory and adds them with one integer atomic per (block,
// replicate).  The stop step is one block over the replicates.  The loop
// runs N rounds (pass 1, pass 2, stop) captured once into a CUDA graph
// (em_graph_create, on a private stream in thread-local capture mode, so
// that quant-tcc's shard threads may capture at the same time) and
// replayed per chunk; the host reads the small state once per chunk.
// Float64 throughout: the H100 has native double precision, so the card's
// replicates equal the float64 CPU leg (the JAX package used float32 on
// the TPU only for lack of float64).
//
// What bounds it on the H100 (PERF.md, chip_smoke.py phases 5e, 6, 6b):
// at Bb = 1 (~30k targets) a round is a few microseconds of work under
// the cost of its three graph nodes -- 0.0101 ms a round against a
// 0.0007 ms byte bound, where the first design's two launches, three
// allocations and host read took 0.0358 ms an update -- and the host
// reads the state once per 32 rounds (24 reads for the main EM's 712
// rounds).  At Bb = 100 and 256, memory: per round it reads alpha, the
// singletons and the counts of every running replicate once, gathers
// 8 Bb-byte rows of alpha (pass 1) and scale (pass 2) through the shared
// CSR (mostly from L2), and writes scale and next: 0.121 and 0.316 ms a
// round, 24 and 29 % of the byte bound (the first design: 0.2405 and
// 0.5254 ms).

#include <cuda_runtime.h>

#define KT_EM_TOLERANCE 4.9406564584124654e-324  // denorm_min
#define KT_EM_ALPHA_LIMIT 1e-7
#define KT_EM_CHANGE_LIMIT 1e-2
#define KT_EM_CHANGE 1e-2
#define KT_EM_THREADS 256

// The loop's tensors (struct EmArgs in ops/kernels.py, passed by pointer;
// each kernel takes it by value).
struct EmArgs {
    double* bufs;               // [2, T, Bb]
    const double* singleton;    // [T, Bb]
    const double* inv_eff;      // [T] shared, or [T, Bb] (batched_eff)
    const int* flat_tx;         // [M]
    const long long* ec_ptr;    // [E + 1]
    const double* multi;        // [E, Bb]
    const long long* tx_ptr;    // [T + 1]
    const int* tx_ec;           // [M]
    double* scale;              // [E, Bb]
    long long* st;              // [4 + 3 Bb]
    int* changed;               // [Bb]
    int Bb, T, E, batched_eff, min_rounds;
};

__device__ __forceinline__ int kt_em_go(const long long* st) {
    return st[0] < st[1] && st[2] > 0;
}

__device__ __forceinline__ double kt_alpha(double a, int zero_input) {
    return (zero_input && a < KT_EM_ALPHA_LIMIT / 10.0) ? 0.0 : a;
}

// one thread per (multi EC e, replicate b), g = e * Bb + b
__global__ void __launch_bounds__(KT_EM_THREADS) em_pass1_kernel(EmArgs a) {
    const long long* st = a.st;
    if (!kt_em_go(st)) return;
    const int Bb = a.Bb;
    const int g = blockIdx.x * KT_EM_THREADS + threadIdx.x;
    if (g >= a.E * Bb) return;
    const int e = g / Bb;
    const int b = g - e * Bb;
    const long long m = st[4 + b];
    if (m == 0) return;
    const double* al = a.bufs + (st[0] & 1) * (long long)a.T * Bb;
    const int zero = m == 2;
    double s = 0.0;
    const long long j1 = a.ec_ptr[e + 1];
    for (long long j = a.ec_ptr[e]; j < j1; ++j) {
        const long long t = a.flat_tx[j];
        const double ie = a.batched_eff ? a.inv_eff[t * Bb + b] : a.inv_eff[t];
        s = __dadd_rn(s, __dmul_rn(kt_alpha(al[t * Bb + b], zero), ie));
    }
    const double mc = a.multi[g];
    const double denom = __dmul_rn(mc, s);
    const int valid = (mc > 0.0) && (denom >= KT_EM_TOLERANCE);
    a.scale[g] = valid ? __ddiv_rn(mc, s > 0.0 ? s : 1.0) : 0.0;
}

// one thread per (transcript t, replicate b), g = t * Bb + b; the block's
// change counts go to shared slot (g - g0) % Bb, one per replicate
__global__ void __launch_bounds__(KT_EM_THREADS) em_pass2_kernel(EmArgs a) {
    __shared__ int cnt[KT_EM_THREADS];
    const long long* st = a.st;
    if (!kt_em_go(st)) return;  // uniform over the block
    const int tid = threadIdx.x;
    cnt[tid] = 0;
    __syncthreads();
    const int Bb = a.Bb;
    const int n = a.T * Bb;
    const int g0 = blockIdx.x * KT_EM_THREADS;
    const int g = g0 + tid;
    if (g < n) {
        const int t = g / Bb;
        const int b = g - t * Bb;
        const long long m = st[4 + b];
        if (m != 0) {
            const long long par = st[0] & 1;
            const double* al = a.bufs + par * n;
            double* nx_out = a.bufs + (par ^ 1) * n;
            const double av = kt_alpha(al[g], m == 2);
            const double ie = a.batched_eff ? a.inv_eff[g] : a.inv_eff[t];
            const double aol = __dmul_rn(av, ie);
            double acc = 0.0;
            const long long j1 = a.tx_ptr[t + 1];
            for (long long j = a.tx_ptr[t]; j < j1; ++j)
                acc = __dadd_rn(acc,
                                __dmul_rn(aol, a.scale[(long long)a.tx_ec[j] * Bb + b]));
            const double nx = __dadd_rn(a.singleton[g], acc);
            nx_out[g] = nx;
            const double diff = nx - av;
            const double rel =
                __ddiv_rn(diff < 0.0 ? -diff : diff, nx > 0.0 ? nx : 1.0);
            if (nx > KT_EM_CHANGE_LIMIT && rel > KT_EM_CHANGE)
                atomicAdd(cnt + (g - g0) % Bb, 1);
        }
    }
    __syncthreads();
    if (tid < Bb && cnt[tid] > 0) atomicAdd(a.changed + (g0 + tid) % Bb, cnt[tid]);
}

// the stop rule, one block over the replicates; then i += 1
__global__ void __launch_bounds__(KT_EM_THREADS) em_stop_kernel(EmArgs a) {
    __shared__ int ended;
    long long* st = a.st;
    const long long i = st[0];
    const int go = kt_em_go(st);
    if (threadIdx.x == 0) ended = 0;
    __syncthreads();  // every thread has read i, bound and running
    if (!go) return;
    const int Bb = a.Bb;
    for (int b = threadIdx.x; b < Bb; b += KT_EM_THREADS) {
        const long long m = st[4 + b];
        if (m != 0 && i > a.min_rounds) {
            if (m == 2) {
                st[4 + b] = 0;
                st[4 + Bb + b] = i + 1;
                atomicAdd(&ended, 1);
            } else if (a.changed[b] == 0) {
                st[4 + b] = 2;
            }
        }
        st[4 + 2 * Bb + b] = a.changed[b];
        a.changed[b] = 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        st[2] -= ended;
        st[0] = i + 1;
    }
}

static int kt_em_check(const EmArgs* a) {
    if (a == 0 || a->Bb <= 0 || a->T <= 0 || a->E < 0 ||
        (long long)a->T * a->Bb > 0x7fffffffLL ||
        (long long)a->E * a->Bb > 0x7fffffffLL || !a->bufs || !a->st ||
        !a->changed || !a->singleton || !a->inv_eff || !a->tx_ptr)
        return (int)cudaErrorInvalidValue;
    return 0;
}

// one round: the two passes and the stop step
static int kt_em_round(const EmArgs& a, cudaStream_t st) {
    if (a.E > 0) {
        const int b1 = (a.E * a.Bb + KT_EM_THREADS - 1) / KT_EM_THREADS;
        em_pass1_kernel<<<b1, KT_EM_THREADS, 0, st>>>(a);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const int b2 = (a.T * a.Bb + KT_EM_THREADS - 1) / KT_EM_THREADS;
    em_pass2_kernel<<<b2, KT_EM_THREADS, 0, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    em_stop_kernel<<<1, KT_EM_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
}

// `rounds` rounds captured into an executable graph, on a private stream
// in thread-local capture mode; *out gets the cudaGraphExec_t.  Nothing
// runs until em_step_batch replays it.
extern "C" int em_graph_create(const EmArgs* args, int rounds, void** out) {
    int err = kt_em_check(args);
    if (err) return err;
    if (rounds <= 0 || out == 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s;
    cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
    if (e != cudaSuccess) return (int)e;
    e = cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
    if (e != cudaSuccess) {
        cudaStreamDestroy(s);
        return (int)e;
    }
    for (int r = 0; r < rounds && !err; ++r) err = kt_em_round(*args, s);
    cudaGraph_t g = 0;
    e = cudaStreamEndCapture(s, &g);
    cudaStreamDestroy(s);
    if (err || e != cudaSuccess) {
        if (g) cudaGraphDestroy(g);
        return err ? err : (int)e;
    }
    cudaGraphExec_t ex;
    e = cudaGraphInstantiateWithFlags(&ex, g, 0);
    cudaGraphDestroy(g);
    if (e != cudaSuccess) return (int)e;
    *out = (void*)ex;
    return 0;
}

// Kernel G: one replay of a graph of em_graph_create on `stream`.
extern "C" int em_step_batch(void* exec, void* stream) {
    if (exec == 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
    return (int)e;
}

extern "C" int em_graph_destroy(void* exec) {
    if (exec == 0) return 0;
    return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}
