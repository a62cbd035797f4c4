// K3: the log/sign-domain sum-product BP decoder as one CUDA launch.
//
// What it replaces.  The JAX package decodes with
// gr_dtl_tpu/ops/ldpc.py::decode_mm (:249-353): a lax.scan of max_iters
// message updates over a flat [B, E] edge tensor, every gather a 0/1
// incidence matmul, each update behind a lax.cond that skips it once every
// codeword of the batch has passed its syndrome check.  XLA compiles it into
// one loop.  Its plain PyTorch version,
// gr_dtl_tpu_torch/ops/ldpc.py::_bp, is a Python loop of ~40 launches an
// update and reads `done.all()` back to the host after each one.
//
// What it computes.  Per codeword b (a row of llr [B, N]), with the check to
// variable messages c2v [E] starting at 0 and it = 0:
//   1. total[v] = llr[v] + sum_d c2v[var_edges[v, d]]  and  hard[v] = total[v] < 0;
//   2. ok = every check's parity over hard[chk_vars[c, :]] is even;
//   3. stop if done_in[b] or ok, or if it == max_iters;
//   4. per edge e: v2c = total[edge_var[e]] - c2v[e], t = tanh(clamp(v2c, +-20) / 2),
//      mag[e] = log(max(|t|, 1e-12)), neg[e] = t < 0;
//   5. per check c: sum_mag[c] and sum_neg[c] over its edges chk_edges[c, :];
//   6. per edge e: loo = (-1)^(sum_neg - neg) exp(sum_mag - mag), clamped to
//      +-0.999999, c2v[e] = 2 atanh(loo);
//   7. it += 1, back to 1.
// Outputs hard [B, N] int32, iters [B] int32 (the updates taken), ok [B]
// (done_in, or the last syndrome check passed) and, when asked, the last
// totals [B, N] float32.  A done_in row takes no update: its c2v stay 0.
//
// Why a codeword may stop on its own.  The reference's exit is batch-wide,
// but its iters_used counts per codeword (ldpc.py:321), done is sticky, and a
// converged codeword's messages are frozen (:310): the update it would still
// take changes nothing it returns.  So stopping each codeword at its own
// syndrome pass gives the reference's (hard, iters_used, ok) exactly, with no
// barrier across blocks and nothing read back to the host.
//
// What bounds it.  Bytes: a codeword reads N float32 LLRs and writes N int32
// hard bits (and 5 bytes of iters and ok), 32.0 MB at 13,312 codewords of
// n = 300, 9.5 us at 3.35 TB/s; the operations of the updates that the data
// needs (~1.7 a codeword at the coded path's waterfall) come to fewer.  What
// stands in the way is the tail: a codeword that never converges runs
// max_iters updates one after another, each four block-wide barriers deep.
//
// Design.  One block of kThreads threads a codeword; the codeword's LLRs,
// messages, totals and the per-edge and per-check scratch live in shared
// memory for the whole decode (~12 KB at n = 300, so 16 codewords share an
// SM), and the LLRs are read from device memory once.  Each step is a loop
// of the block's threads over variables, checks or edges, separated by
// __syncthreads; the syndrome is one __syncthreads_and.  Every loop trip
// count and every exit is the same for the whole block.  The Tanner-graph
// tables are int16 copies (ops/ldpc_cuda.py builds and caches them) read
// through the caches.  Padded slots of var_edges / chk_edges index E and of
// chk_vars index N: the kernel keeps c2v[E] = mag[E] = neg[E] = 0 and
// hard[N] = 0, so a pad reads 0 as the plain version's gather does.
//
// Arithmetic.  The plain version is a chain of PyTorch kernels, each rounding
// its result to float32, so every sum or difference here is __fadd_rn /
// __fsub_rn (never contracted into an FMA), a degree sum adds its slots left
// to right from slot 0 as _bp's _slot_sum does, x / 2.0 is the exact product
// x * 0.5, clamp keeps a NaN as torch.clamp does, and tanhf, logf, expf and
// atanhf are the accurate functions PyTorch's kernels call (no
// --use_fast_math).  With kBf16 (GR_DTL_TPU_BP_BF16) the operands _bp rounds
// to bfloat16 are rounded here at the same places, to nearest even.
//
// Limits (the wrapper raises above them): N, E <= kMaxIndex (int16 tables),
// column and row degree <= kMaxDeg, the shared memory of bp_smem_bytes <=
// kMaxSmem.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // a block: one codeword
constexpr int kMaxIndex = 32767;   // N and E, so that every index and pad fits int16
constexpr int kMaxDeg = 64;        // column and row degree: a thread's serial sum in steps 1, 2, 5
constexpr int kMaxSmem = 232448;   // shared memory a block may use on sm_90 (227 KB)

template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
    if constexpr (kBf16) {
        return __bfloat162float(__float2bfloat16_rn(x));
    } else {
        return x;
    }
}

// torch.clamp: a NaN stays NaN (fminf / fmaxf alone would drop it)
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

template <bool kBf16>
__global__ void __launch_bounds__(kThreads) bp_kernel(
    const float* __restrict__ llr, const uint8_t* __restrict__ done_in,
    const int16_t* __restrict__ var_edges, int dv, const int16_t* __restrict__ chk_edges,
    const int16_t* __restrict__ chk_vars, int dc, const int16_t* __restrict__ edge_var,
    const int16_t* __restrict__ edge_chk, int N, int M, int E, int max_iters, int* __restrict__ hard,
    int* __restrict__ iters, uint8_t* __restrict__ ok_out, float* __restrict__ total_out) {
    extern __shared__ float smem[];
    float* c2v = smem;                              // [E + 1], c2v[E] = 0
    float* mag = c2v + (E + 1);                     // [E + 1], mag[E] = 0
    float* total = mag + (E + 1);                   // [N]
    float* lr = total + N;                          // [N]
    float* sum_mag = lr + N;                        // [M]
    int* sum_neg = (int*)(sum_mag + M);             // [M]
    uint8_t* neg = (uint8_t*)(sum_neg + M);         // [E + 1], neg[E] = 0
    uint8_t* hb = neg + (E + 1);                    // [N + 1], hb[N] = 0

    const long long b = blockIdx.x;
    const int tid = threadIdx.x;
    for (int v = tid; v < N; v += kThreads) lr[v] = llr[b * N + v];
    for (int e = tid; e <= E; e += kThreads) {
        c2v[e] = 0.0f;
        mag[e] = 0.0f;
        neg[e] = 0;
    }
    if (tid == 0) hb[N] = 0;
    const bool skip = done_in != nullptr && done_in[b] != 0;
    __syncthreads();

    int it = 0;
    bool ok = true;
    for (;;) {
        // 1. totals and hard decisions (_var_totals)
        for (int v = tid; v < N; v += kThreads) {
            const int16_t* ve = var_edges + v * dv;
            float s = rnd<kBf16>(c2v[ve[0]]);
            for (int d = 1; d < dv; ++d) s = __fadd_rn(s, rnd<kBf16>(c2v[ve[d]]));
            const float t = __fadd_rn(lr[v], s);
            total[v] = t;
            hb[v] = t < 0.0f;
        }
        __syncthreads();
        if (skip) break;  // ok stays true, it 0
        // 2. syndrome (_syndrome_ok)
        int even = 1;
        for (int c = tid; c < M; c += kThreads) {
            const int16_t* cv = chk_vars + c * dc;
            int p = 0;
            for (int r = 0; r < dc; ++r) p ^= hb[cv[r]];
            even &= p == 0;
        }
        ok = __syncthreads_and(even) != 0;
        // 3. this codeword's exit
        if (ok || it == max_iters) break;
        // 4. variable to check, in log/sign form (_check_update)
        for (int e = tid; e < E; e += kThreads) {
            const float v2c = __fsub_rn(rnd<kBf16>(total[edge_var[e]]), c2v[e]);
            const float t = tanhf(__fmul_rn(clampf(v2c, -20.0f, 20.0f), 0.5f));
            mag[e] = logf(clamp_min(fabsf(t), 1e-12f));
            neg[e] = t < 0.0f;
        }
        __syncthreads();
        // 5. per-check sums, slots left to right
        for (int c = tid; c < M; c += kThreads) {
            const int16_t* ce = chk_edges + c * dc;
            float s = rnd<kBf16>(mag[ce[0]]);
            int n = neg[ce[0]];
            for (int r = 1; r < dc; ++r) {
                s = __fadd_rn(s, rnd<kBf16>(mag[ce[r]]));
                n += neg[ce[r]];
            }
            sum_mag[c] = s;
            sum_neg[c] = n;
        }
        __syncthreads();
        // 6. leave-one-out at the checks, back to check to variable
        for (int e = tid; e < E; e += kThreads) {
            const int c = edge_chk[e];
            const float m = expf(__fsub_rn(rnd<kBf16>(sum_mag[c]), mag[e]));
            const float loo = clampf(((sum_neg[c] - neg[e]) & 1) ? -m : m, -0.999999f, 0.999999f);
            c2v[e] = __fmul_rn(2.0f, atanhf(loo));
        }
        __syncthreads();
        ++it;  // 7.
    }

    for (int v = tid; v < N; v += kThreads) {
        hard[b * N + v] = hb[v];
        if (total_out != nullptr) total_out[b * N + v] = total[v];
    }
    if (tid == 0) {
        iters[b] = it;
        ok_out[b] = ok;
    }
}

// Shared memory a block takes for a code of N variables, M checks and E edges
// (ops/ldpc_cuda.py::smem_bytes).
long long bp_smem_bytes(int N, int M, int E) {
    return 4LL * (2LL * (E + 1) + 2LL * N + 2LL * M) + (E + 1) + (N + 1);
}

}  // namespace

// llr [B, N] float32; done_in [B] bytes or null; var_edges [N, dv], chk_edges
// and chk_vars [M, dc], edge_var and edge_chk [E] int16 (pads E, E and N);
// all contiguous.  Writes hard [B, N] int32, iters [B] int32, ok [B] bytes and,
// if total is not null, total [B, N] float32.  bf16: the bfloat16 rounding of
// GR_DTL_TPU_BP_BF16.  Returns the CUDA error of the launch.
extern "C" int bp_decode_launch(const void* llr, const void* done_in, const void* var_edges, int dv,
                                const void* chk_edges, const void* chk_vars, int dc,
                                const void* edge_var, const void* edge_chk, int B, int N, int M,
                                int E, int max_iters, int bf16, void* hard, void* iters, void* ok,
                                void* total, void* stream) {
    const long long smem = bp_smem_bytes(N, M, E);
    if (B < 1 || N < 1 || M < 1 || E < 1 || N > kMaxIndex || E > kMaxIndex || dv < 1 ||
        dv > kMaxDeg || dc < 1 || dc > kMaxDeg || max_iters < 0 || smem > kMaxSmem)
        return (int)cudaErrorInvalidValue;
    auto kernel = bf16 ? bp_kernel<true> : bp_kernel<false>;
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<B, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)llr, (const uint8_t*)done_in, (const int16_t*)var_edges, dv,
        (const int16_t*)chk_edges, (const int16_t*)chk_vars, dc, (const int16_t*)edge_var,
        (const int16_t*)edge_chk, N, M, E, max_iters, (int*)hard, (int*)iters, (uint8_t*)ok,
        (float*)total);
    return (int)cudaGetLastError();
}
