// K3: the log/sign-domain sum-product BP decoder as one CUDA launch, for one
// code or for a bank of codes with a code id a codeword; and K8, the gather
// form's tanh-product decoder in the same frame (below).
//
// What it replaces.  The JAX package decodes with
// gr_dtl_tpu/ops/ldpc.py::decode_mm (:249-353): a lax.scan of max_iters
// message updates over a flat [B, E] edge tensor, every gather a 0/1
// incidence matmul, each update behind a lax.cond that skips it once every
// codeword of the batch has passed its syndrome check; decode_bank_mm
// (:545-572) runs it once a code of the bank and keeps each codeword's own
// code's result.  XLA compiles each into one loop.  Their plain PyTorch
// version, gr_dtl_tpu_torch/ops/ldpc.py::_bp, is a Python loop of ~40
// launches an update and reads `done.all()` back to the host after each one.
//
// What it computes.  Per codeword b (a row of llr [B, N]) of code c(b), with
// the check to variable messages c2v [E] starting at 0 and it = 0:
//   1. total[v] = llr[v] + sum_d c2v[var_edges[d, v]]  and  hard[v] = total[v] < 0;
//   2. ok = every check's parity over hard[chk_vars[:, c]] is even;
//   3. stop if done_in[b] or ok, or if it == max_iters;
//   4. per check c and each of its edges e = chk_edges[r, c] (variable
//      chk_vars[r, c]): v2c = total[var] - c2v[e], t = tanh(clamp(v2c, +-20) / 2),
//      mag = log(max(|t|, 1e-12)), neg = t < 0; the check's sums of mag and
//      neg over its slots; then per edge loo = (-1)^(sum_neg - neg)
//      exp(sum_mag - mag), clamped to +-0.999999, c2v[e] = 2 atanh(loo);
//   5. it += 1, back to 1.
// Outputs hard [B, N] int32, iters [B] int32 (the updates taken), ok [B]
// (done_in, or the last syndrome check passed) and, when asked, the last
// totals [B, N] float32.  A done_in row takes no update.
//
// Why a codeword may stop on its own.  The reference's exit is batch-wide,
// but its iters_used counts per codeword (ldpc.py:321), done is sticky, and a
// converged codeword's messages are frozen (:310): the update it would still
// take changes nothing it returns.  So stopping each codeword at its own
// syndrome pass gives the reference's (hard, iters_used, ok) exactly, with no
// barrier across blocks and nothing read back to the host.  decode_bank_mm's
// rows do not depend on each other either, so one launch decodes every row
// with its own code (c(b) = clamp(code_idx[b], 1, C) - 1, the reference's
// selection) where the reference runs every code over every row.
//
// What bounds it.  Bytes: a codeword reads N float32 LLRs and writes N int32
// hard bits (and 5 bytes of iters and ok), 32.0 MB at 13,312 codewords of
// n = 300, 9.6 us at 3.35 TB/s.  Issue: the accurate tanhf, logf, expf and
// atanhf are tens of instructions each, so a message update issues ~140 an
// edge (tools/bench_k3.py counts them in this source's SASS), and 2048
// codewords of n = 300 at 15 updates (27.6 M edge updates) are bound by it.
// And the tail: a codeword that never converges runs max_iters updates one
// after another, so its update's latency is what a batch of a few such
// codewords waits for.
//
// Design.  One block a codeword, of 1 to 8 warps (the wrapper's choice: a
// thread a check of the largest code, 5 warps at n = 300); a thread holds up
// to 80 registers.  The block keeps the codeword's LLRs, totals and messages
// in shared memory (bp_smem_bytes, 6,008 bytes at n = 300) for the whole
// decode; its threads take checks for the syndrome and the update and
// variables for the totals, and an update waits at three barriers: the
// syndrome's __syncthreads_and, one after the check update, one after the
// totals.  A thread holds a check's edges, message magnitudes and signs and
// its sums in registers, unrolled over exactly the call's row slots (every
// code's row tables are padded to them) with no branch, so the slots' chains
// interleave; nothing but c2v and the totals goes through shared memory.
// Every message is 0 until a codeword's first update, so the first totals
// are llr + 0 with no gather, and the first update reads no message: c2v is
// never zeroed, a codeword that converges at once touches no message, and a
// done row computes that pass, writes its outputs and stops.  The tables of
// every code of a call are one int16 array, slot-major ([dv, N], [dc, M]:
// neighbouring threads read neighbouring entries of a slot), found through a
// header a code (ops/ldpc_cuda.py builds and caches both); padded slots of
// var_edges / chk_edges index E and of chk_vars index N, and the kernel keeps
// c2v[E] = total[N] = 0, so a pad reads 0 as the plain version's gather does.
// Rows wider than kRegSlots take the kMaxDeg instantiation, whose slots are
// guarded and whose thread holds up to 255 registers.
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
// K8: the gather form, the same frame with a tanh-product check update.
// It replaces gr_dtl_tpu/ops/ldpc.py::decode (:154-246) and decode_bank
// (:574-645): a lax.scan of message updates over [B, M, R] check messages
// (M checks of up to R slots), the tables one code's or a row of code ids'
// each; their plain PyTorch version, ops/ldpc.py::_bp_gather, is a Python
// loop of ~30 launches an update with a host read after each.  Step 4
// becomes, per check and its slots r (a pad slot has t = 1):
//      t_r = tanh(clamp(v2c_r, +-20) / 2), prod = the product of the t_r,
//      t_safe = |t_r| < 1e-12 ? sign(t_r) 1e-12 + 1e-30 : t_r,
//      c2v[e_r] = 2 atanh(clamp(prod / t_safe, +-0.999999)).
// The gather form's slot [m, r] is K3's edge chk_edges[r, m], and a
// variable's gather slots list its checks in increasing order, as
// var_edges does (both come from a row-major np.nonzero of H; a bank's
// padded layout keeps the order), so K8 reads K3's tables unchanged; where
// the gather form adds more masked zeros than K3's tables hold pads, only
// the sign of a zero total can differ, which no output sees.  The exit
// argument above holds word for word (done is sticky, a converged row's
// messages are frozen, and the converging iteration skips the update).  A
// bank row takes decode_bank's code: the id as jnp indexes the C + 1 table
// rows (a negative id plus C + 1 once, then clamped to [0, C]; row 0 is code
// 1), not decode_bank_mm's clamp to [1, C].  Its arithmetic follows
// _bp_gather as K3's follows _bp: the product left to right from slot 0 as
// _slot_prod takes it, each product, sum and the guard's two operations
// rounded alone, the division the IEEE __fdiv_rn, the guard's and clamp's
// constants the Python scalars rounded to float32, accurate tanhf and
// atanhf.  What bounds it is what bounds K3, with fewer transcendentals an
// edge (tanh and atanh, and a division, against tanh, log, exp and atanh).
//
// K8's frame.  K8 first ran K3's frame, a block a codeword: it waited on a
// chain of dependent global reads before its first barrier (code id,
// header, row), made a pass of first totals and a barrier before its first
// syndrome pass, and read its code's int16 tables from global memory at
// every pass, three an update (tools/bench_k3.py --timeline placed the
// time; --variants times each choice below against its alternative).
//   - Where B fills kWalkWaves waves of resident blocks, a wave of them
//     walks the codewords (bp_gather_launch): block g starts at codeword g
//     and takes each next one from a counter of the launching stream's
//     (work; the last block to leave checks the counts, trapping on any
//     but a clean walk's, and sets them back to 0, so a call is one kernel
//     and no memset).  After a codeword that took no update, thread
//     0 takes the next one at the current one's start, so its atomic hides
//     behind the row's read and a block holds two codewords; after one that
//     took updates, at its end, so a long codeword holds no other behind it.
//     With fewer codewords a block, holding two costs more balance than the
//     walk saves (2,048 codewords with updates), so there a block decodes
//     one and takes no counter.
//   - The row is in flight (cp.async, 16 bytes a copy where it starts on 16
//     bytes, else 4) while the code id and header are read.
//   - The first syndrome pass reads the LLRs themselves (llr + 0 has their
//     signs) and chk_vars from global memory, each entry once, so a codeword
//     that converges at entry makes no pass of totals, stages nothing and
//     waits at two barriers.
//   - A codeword that takes an update stages its code's three tables in
//     shared memory (stage_table: 4-byte words, a table may start between
//     words) and reads them there at every pass after.
// The update is the first kernel's, at 56 registers a thread (7 blocks of 5
// warps an SM), and so are the outputs, bit for bit.
//
// Limits (the wrapper raises above them): N, E <= kMaxIndex (int16 tables),
// column and row degree <= kMaxDeg, the shared memory of bp_smem_bytes (K8:
// gather_smem_bytes) <= kMaxSmem.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;   // a block: one codeword, 1 to 8 warps (the wrapper picks)
constexpr int kMinBlocks = 3;      // so that a thread may hold 80 registers (85 of 65,536 / (3 x 256))
constexpr int kMaxIndex = 32767;   // N and E, so that every index and pad fits int16
constexpr int kMaxDeg = 64;        // column and row degree
constexpr int kRegSlots = 8;       // row degree up to which a lane's slots are unrolled with no guard
constexpr int kMaxSmem = 232448;   // shared memory a block may use on sm_90 (227 KB)
constexpr int kHeader = 7;         // ints a code in the header: M, E, dv, dc, and the offsets of
                                   // var_edges, chk_edges and chk_vars in the tables
constexpr int kGatherRegs = 56;    // K8's registers a thread (rows of up to kRegSlots): 7 blocks of 5 warps an SM
constexpr int kWalkWaves = 4;      // K8's blocks walk codewords from B = kWalkWaves waves of resident blocks up
// K8's guard and clamp: the gather form's Python scalars, each rounded to float32 as PyTorch rounds them
constexpr float kTiny = (float)1e-12;     // |t| below it is replaced by sign(t) kTiny + kTinier
constexpr float kTinier = (float)1e-30;
constexpr float kLooMax = (float)0.999999;

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

// One check's message update: its slots' v2c, tanh and log, the check's sums
// left to right from slot 0, then each edge's leave-one-out message.  A pad
// slot (edge E, variable N) reads total[N] = c2v[E] = 0, adds log 0 = 0 and
// no sign, as mag[E] = neg[E] = 0 did, and stores nothing.  With kSlots <=
// kRegSlots every row has exactly kSlots slots (the tables are padded to
// them) and no slot is guarded, so the slots' chains interleave; wider rows
// guard their slots past dc.
template <bool kBf16, int kSlots>
__device__ __forceinline__ void check_update(int M, int E, int dc, const int16_t* __restrict__ ce,
                                             const int16_t* __restrict__ cv, const float* total, float* c2v,
                                             bool first) {
    float mag[kSlots];
    int edge[kSlots];
    unsigned long long negs = 0;
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
        if (kSlots > kRegSlots && r >= dc) break;
        const int e = ce[r * M];
        const float old = first ? 0.0f : c2v[e];  // every message is 0 before the first update
        const float v2c = __fsub_rn(rnd<kBf16>(total[cv[r * M]]), old);
        const float t = tanhf(__fmul_rn(clampf(v2c, -20.0f, 20.0f), 0.5f));
        const bool real = e < E;
        const float lg = logf(clamp_min(fabsf(t), 1e-12f));  // taken at a pad too: no branch in the slots
        const float m = real ? lg : 0.0f;
        negs |= (unsigned long long)(real && t < 0.0f) << r;
        edge[r] = e;
        mag[r] = m;
        s = r == 0 ? rnd<kBf16>(m) : __fadd_rn(s, rnd<kBf16>(m));
    }
    const float sum_mag = rnd<kBf16>(s);
    const int parity = __popcll(negs) & 1;
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
        if (kSlots > kRegSlots && r >= dc) break;
        const float m = expf(__fsub_rn(sum_mag, mag[r]));
        const float loo = clampf((parity ^ (int)(negs >> r)) & 1 ? -m : m, -0.999999f, 0.999999f);
        const float msg = __fmul_rn(2.0f, atanhf(loo));
        if (edge[r] < E) c2v[edge[r]] = msg;
    }
}

// torch.sign: 1, -1, or 0 at +-0 (a NaN never reaches it: |NaN| < kTiny is false)
__device__ __forceinline__ float sign_of(float x) { return (float)((x > 0.0f) - (x < 0.0f)); }

// One check's tanh-product update (K8, the gather form's check_update): its
// slots' v2c and t = tanh(clamp(v2c, +-20) / 2), 1 at a pad; their product
// left to right from slot 0; then each edge's leave-one-out message
// 2 atanh(clamp(prod / t_safe, +-0.999999)), t_safe the guarded t.  A pad
// slot (edge E, variable N) reads total[N] = c2v[E] = 0, multiplies by 1.0
// (exact) and stores nothing.  Slots as in check_update.
template <int kSlots>
__device__ __forceinline__ void check_update_tanh(int M, int E, int dc, const int16_t* __restrict__ ce,
                                                  const int16_t* __restrict__ cv, const float* total, float* c2v,
                                                  bool first) {
    float t[kSlots];
    int edge[kSlots];
    float prod = 1.0f;
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
        if (kSlots > kRegSlots && r >= dc) break;
        const int e = ce[r * M];
        const float old = first ? 0.0f : c2v[e];  // every message is 0 before the first update
        const float v2c = __fsub_rn(total[cv[r * M]], old);
        const float th = tanhf(__fmul_rn(clampf(v2c, -20.0f, 20.0f), 0.5f));  // taken at a pad too: no branch
        const float tr = e < E ? th : 1.0f;
        edge[r] = e;
        t[r] = tr;
        prod = r == 0 ? tr : __fmul_rn(prod, tr);
    }
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
        if (kSlots > kRegSlots && r >= dc) break;
        const float tr = t[r];
        const float safe = fabsf(tr) < kTiny ? __fadd_rn(__fmul_rn(sign_of(tr), kTiny), kTinier) : tr;
        const float loo = clampf(__fdiv_rn(prod, safe), -kLooMax, kLooMax);
        const float msg = __fmul_rn(2.0f, atanhf(loo));
        if (edge[r] < E) c2v[edge[r]] = msg;
    }
}

// One codeword a block: K3's frame.
template <bool kBf16, int kSlots>
__device__ __forceinline__ void decode_codeword(
    const float* __restrict__ llr, const uint8_t* __restrict__ done_in, const void* __restrict__ code_idx,
    int idx64, int n_codes, const int* __restrict__ header, const int16_t* __restrict__ tab, int N,
    int max_iters, int* __restrict__ hard, int* __restrict__ iters, uint8_t* __restrict__ ok_out,
    float* __restrict__ total_out) {
    extern __shared__ float smem[];
    const long long b = blockIdx.x;
    const int tid = threadIdx.x, nt = blockDim.x;
    int code = 0;
    if (code_idx != nullptr) {
        const long long id = idx64 ? ((const long long*)code_idx)[b] : ((const int*)code_idx)[b];
        code = (int)(min(max(id, 1LL), (long long)n_codes) - 1);
    }
    const int* h = header + code * kHeader;
    const int M = h[0], E = h[1], dv = h[2], dc = h[3];
    const int16_t* var_edges = tab + h[4];  // [dv, N], pads E
    const int16_t* chk_edges = tab + h[5];  // [dc, M], pads E
    const int16_t* chk_vars = tab + h[6];   // [dc, M], pads N
    float* lr = smem;                       // [N]
    float* total = lr + N;                  // [N + 1], total[N] = 0
    float* c2v = total + N + 1;             // [E + 1], c2v[E] = 0

    // the first totals: every message is 0, so llr + 0 (which makes -0.0 +0.0, as _bp's sum does)
    const float* row = llr + b * N;
    for (int v = tid; v < N; v += nt) {
        const float x = row[v];
        lr[v] = x;
        total[v] = __fadd_rn(x, 0.0f);
    }
    if (tid == 0) {
        total[N] = 0.0f;
        c2v[E] = 0.0f;
    }
    __syncthreads();

    int it = 0;
    bool ok = true;  // a done row: ok, no update
    if (done_in == nullptr || done_in[b] == 0) {
        for (;;) {
            // syndrome (_syndrome_ok): a pad reads total[N] = 0, an even bit
            int odd = 0;
            for (int c = tid; c < M; c += nt) {
                int p = 0;
#pragma unroll
                for (int r = 0; r < kSlots; ++r) {
                    if (kSlots > kRegSlots && r >= dc) break;
                    p ^= total[chk_vars[r * M + c]] < 0.0f;
                }
                odd |= p;
            }
            ok = __syncthreads_and(odd == 0) != 0;
            if (ok || it == max_iters) break;
            // the check update (_check_update), a thread a check
            for (int c = tid; c < M; c += nt)
                check_update<kBf16, kSlots>(M, E, dc, chk_edges + c, chk_vars + c, total, c2v, it == 0);
            __syncthreads();
            ++it;
            // totals (_var_totals), a thread a variable, slots left to right
            for (int v = tid; v < N; v += nt) {
                float s = rnd<kBf16>(c2v[var_edges[v]]);
                for (int d = 1; d < dv; ++d) s = __fadd_rn(s, rnd<kBf16>(c2v[var_edges[d * N + v]]));
                total[v] = __fadd_rn(lr[v], s);
            }
            __syncthreads();
        }
    }

    for (int v = tid; v < N; v += nt) {
        const float t = total[v];
        hard[b * N + v] = t < 0.0f;
        if (total_out != nullptr) total_out[b * N + v] = t;
    }
    if (tid == 0) {
        iters[b] = it;
        ok_out[b] = ok;
    }
}

// K3: decode_mm's and decode_bank_mm's log/sign update.
template <bool kBf16, int kSlots>
__global__ void __launch_bounds__(kMaxThreads, kSlots <= kRegSlots ? kMinBlocks : 1) bp_kernel(
    const float* __restrict__ llr, const uint8_t* __restrict__ done_in, const void* __restrict__ code_idx,
    int idx64, int n_codes, const int* __restrict__ header, const int16_t* __restrict__ tab, int N,
    int max_iters, int* __restrict__ hard, int* __restrict__ iters, uint8_t* __restrict__ ok_out,
    float* __restrict__ total_out) {
    decode_codeword<kBf16, kSlots>(llr, done_in, code_idx, idx64, n_codes, header, tab, N, max_iters, hard, iters,
                                   ok_out, total_out);
}

// K8's asynchronous copies from global to shared memory (LDGSTS: no
// register holds the data), their group's commit, and a wait for them all.
__device__ __forceinline__ void copy4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src) : "memory");
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src) : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// K8's row buffer, in floats: N and the pad's zero after them, rounded up
// to 16 bytes.
__host__ __device__ __forceinline__ int row_stride(int N) { return (N + 4) & ~3; }

// The int16 words a staged table of n entries may take: n, one before it
// and one past, rounded up to 4 bytes.
__host__ __device__ __forceinline__ int staged_words(int n) { return (n + 3) & ~1; }

// An LLR row into shared memory, in flight until copy_wait_all: 16 bytes a
// copy where the row starts on 16 bytes and N is a multiple of 4, else 4
// bytes a copy (a row of a slice that starts elsewhere, or of an N that 16
// bytes do not divide).
__device__ __forceinline__ void fetch_row(const float* __restrict__ src, int N, float* row, int tid, int nt) {
    if ((N & 3) == 0 && ((uintptr_t)src & 15) == 0) {
        for (int q = tid; q < N / 4; q += nt) copy16(row + 4 * q, src + 4 * q);
    } else {
        for (int v = tid; v < N; v += nt) copy4(row + v, src + v);
    }
}

// n int16 entries of a code's table into shared memory at dst (on 4 bytes,
// staged_words(n) of room), in flight until copy_wait_all: the 4-byte words
// that hold them, from the one that holds the first (the entry before it
// too, where the table starts between words) to the last whole one, and
// an odd last entry copied alone.  Returns where the table starts in dst.
__device__ __forceinline__ const int16_t* stage_table(int16_t* dst, const int16_t* __restrict__ src, int n,
                                                      int tid, int nt) {
    const int shift = (int)(((uintptr_t)src >> 1) & 1);  // 1 where src starts between words
    const int16_t* from = src - shift;                    // on 4 bytes: src itself or the entry before it
    const int words = (n + shift) >> 1;                   // whole words up to src[n - 1]
    for (int w = tid; w < words; w += nt) copy4(dst + 2 * w, from + 2 * w);
    if (((n + shift) & 1) && tid == nt - 1) dst[n + shift - 1] = src[n - 1];
    return dst + shift;
}

// decode_bank's code of an id: jnp's index into the C + 1 table rows (a
// negative id counts from the end once, then clamps to [0, C]); row 0 is
// code 1.
__device__ __forceinline__ int bank_code(long long id, int n_codes) {
    const long long row = min(max(id < 0 ? id + n_codes + 1 : id, 0LL), (long long)n_codes);
    return (int)max(row, 1LL) - 1;
}

// One syndrome pass of K8 (_syndrome_ok) over the values v (the LLRs at
// entry, then the totals): a thread a check, a pad reading v[N] = 0, an
// even bit; true where every check is even (a block-wide vote).
template <int kSlots>
__device__ __forceinline__ bool syndrome_ok(int M, int dc, const int16_t* chk_vars, const float* v, int tid,
                                            int nt) {
    int odd = 0;
    for (int c = tid; c < M; c += nt) {
        int p = 0;
#pragma unroll
        for (int r = 0; r < kSlots; ++r) {
            if (kSlots > kRegSlots && r >= dc) break;
            p ^= v[chk_vars[r * M + c]] < 0.0f;
        }
        odd |= p;
    }
    return __syncthreads_and(odd == 0) != 0;
}

// The codeword a K8 block takes after its current one (thread 0): the next
// of the stream's counter, past the grid's first codewords.
__device__ __forceinline__ int take(unsigned* work) { return gridDim.x + (int)atomicAdd(work, 1u); }

// K8: decode's and decode_bank's tanh-product update, blocks walking
// codewords where the grid is below B (else a block a codeword).  cm: the
// largest dc x M of the call's codes (the staged row tables' room); work:
// the launching stream's three counters (codewords taken, blocks left,
// codewords decoded), 0 at the launch and left at 0.
template <int kSlots>
__global__ void __maxnreg__(kSlots <= kRegSlots ? kGatherRegs : 255) bp_gather_kernel(
    const float* __restrict__ llr, const void* __restrict__ code_idx, int idx64, int n_codes,
    const int* __restrict__ header, const int16_t* __restrict__ tab, int N, int B, int max_e, int cm,
    int max_iters, int* __restrict__ hard, int* __restrict__ iters, uint8_t* __restrict__ ok_out,
    unsigned* __restrict__ work) {
    extern __shared__ float4 gather_smem[];
    float* lr = reinterpret_cast<float*>(gather_smem);  // [row_stride(N)], lr[N] = 0
    float* total = lr + row_stride(N);                   // [N + 1], total[N] = 0
    float* c2v = total + N + 1;                          // [max_e + 1], c2v[E] = 0
    int* next = reinterpret_cast<int*>(c2v + max_e + 1);  // [2]: the block's next codeword, by parity
    // the code's tables: chk_vars and chk_edges ([dc, M] each) and var_edges ([dv, N])
    int16_t* staged = reinterpret_cast<int16_t*>(next + 2);
    const int tid = threadIdx.x, nt = blockDim.x;
    const bool walk = B > (int)gridDim.x;  // else a block a codeword, and no counter
    bool early = true;  // the block's last codeword took no update: take the next one at this one's start

    int k = 0;  // the codewords this block decoded
    for (int b = blockIdx.x; b < B; ++k) {
        int taken = B;  // thread 0: the block's next codeword, taken now, so a block holds two at most
        if (tid == 0 && walk && early) taken = take(work);
        fetch_row(llr + (long long)b * N, N, lr, tid, nt);  // in flight while the code's header is read
        copy_commit();
        int code = 0;
        if (code_idx != nullptr) code = bank_code(idx64 ? ((const long long*)code_idx)[b] : ((const int*)code_idx)[b], n_codes);
        const int* h = header + code * kHeader;
        const int M = h[0], E = h[1], dv = h[2], dc = h[3];
        if (tid == 0) {
            lr[N] = 0.0f;
            next[k & 1] = taken;
        }
        copy_wait_all();
        __syncthreads();  // the row is in, and the block's next codeword

        // The first syndrome pass reads the LLRs (every message is 0, so the
        // first totals are llr + 0, of the same sign: only -0.0 becomes +0.0,
        // and no test or output tells them apart) and chk_vars from global
        // memory, each entry once; a codeword that takes an update stages
        // its code's tables and makes its first totals.
        int it = 0;
        bool ok = syndrome_ok<kSlots>(M, dc, tab + h[6], lr, tid, nt);
        if (!ok && max_iters > 0) {
            const int rc = staged_words(cm);
            const int16_t* chk_vars = stage_table(staged, tab + h[6], dc * M, tid, nt);         // [dc, M], pads N
            const int16_t* chk_edges = stage_table(staged + rc, tab + h[5], dc * M, tid, nt);   // [dc, M], pads E
            const int16_t* var_edges = stage_table(staged + 2 * rc, tab + h[4], dv * N, tid, nt);  // [dv, N], pads E
            copy_commit();
            for (int v = tid; v < N; v += nt) total[v] = __fadd_rn(lr[v], 0.0f);  // -0.0 + 0.0 is +0.0, as in _bp_gather
            if (tid == 0) {
                total[N] = 0.0f;
                c2v[E] = 0.0f;  // another code's message may lie there
            }
            copy_wait_all();
            __syncthreads();
            do {
                // the check update (_check_update), a thread a check; the first reads no message
                for (int c = tid; c < M; c += nt)
                    check_update_tanh<kSlots>(M, E, dc, chk_edges + c, chk_vars + c, total, c2v, it == 0);
                __syncthreads();
                ++it;
                // totals (_var_totals), a thread a variable, slots left to right
                for (int v = tid; v < N; v += nt) {
                    float s = c2v[var_edges[v]];
                    for (int d = 1; d < dv; ++d) s = __fadd_rn(s, c2v[var_edges[d * N + v]]);
                    total[v] = __fadd_rn(lr[v], s);
                }
                __syncthreads();
                ok = syndrome_ok<kSlots>(M, dc, chk_vars, total, tid, nt);
            } while (!ok && it < max_iters);
        }

        const float* out = it == 0 ? lr : total;
        int* hard_row = hard + (long long)b * N;
        for (int v = tid; v < N; v += nt) hard_row[v] = out[v] < 0.0f;
        if (tid == 0) {
            iters[b] = it;
            ok_out[b] = ok;
            if (walk && !early) next[k & 1] = take(work);  // after a codeword with updates: taken at the end
        }
        early = it == 0;
        __syncthreads();  // the next codeword is known, and every thread is done with this one's row and totals
        b = next[k & 1];
    }
    // The last block to leave checks the counters and sets them back to 0
    // for the stream's next launch.  A walk takes B codewords in all (one a
    // codeword decoded, and one past B a block), so counters at 0 when the
    // launch began end at B taken, B decoded and the grid's blocks left; any
    // other count means a launch began on counters not at 0, skipped or
    // repeated codewords and left outputs unwritten, and the kernel traps (the
    // call's next synchronising read raises).
    if (tid == 0 && walk) {
        atomicAdd(work + 2, (unsigned)k);
        __threadfence();
        const unsigned left = atomicAdd(work + 1, 1u);
        if (left >= gridDim.x) __trap();
        if (left == gridDim.x - 1) {
            if (atomicAdd(work, 0u) != (unsigned)B || atomicAdd(work + 2, 0u) != (unsigned)B) __trap();
            work[0] = 0;
            work[1] = 0;
            work[2] = 0;
            __threadfence();
        }
    }
}

// Shared memory a block takes for codewords of N bits, codes of at most E
// edges (ops/ldpc_cuda.py::smem_bytes and gather_smem_bytes): K3's, and
// K8's with its row buffer on 16 bytes and its code's staged tables (cm,
// vn: the largest dc x M and dv x N of the call's codes).
long long bp_smem_bytes(int N, int E) { return 4LL * (2LL * N + E + 2); }
long long gather_smem_bytes(int N, int E, int cm, int vn) {
    return 4LL * (row_stride(N) + N + E + 4) + 2LL * (2LL * staged_words(cm) + staged_words(vn));
}

using Kernel = void (*)(const float*, const uint8_t*, const void*, int, int, const int*, const int16_t*, int,
                        int, int*, int*, uint8_t*, float*);
using GatherKernel = void (*)(const float*, const void*, int, int, const int*, const int16_t*, int, int, int, int,
                              int, int*, int*, uint8_t*, unsigned*);

template <bool kBf16>
Kernel pick_slots(int slots) {
    switch (slots) {
        case 1: return bp_kernel<kBf16, 1>;
        case 2: return bp_kernel<kBf16, 2>;
        case 3: return bp_kernel<kBf16, 3>;
        case 4: return bp_kernel<kBf16, 4>;
        case 5: return bp_kernel<kBf16, 5>;
        case 6: return bp_kernel<kBf16, 6>;
        case 7: return bp_kernel<kBf16, 7>;
        case 8: return bp_kernel<kBf16, 8>;
        default: return bp_kernel<kBf16, kMaxDeg>;
    }
}

// The instantiation for rows of dc slots: exactly dc up to kRegSlots, else
// the guarded kMaxDeg.
Kernel pick(int bf16, int dc) { return bf16 ? pick_slots<true>(dc) : pick_slots<false>(dc); }

GatherKernel pick_gather(int dc) {
    switch (dc) {
        case 1: return bp_gather_kernel<1>;
        case 2: return bp_gather_kernel<2>;
        case 3: return bp_gather_kernel<3>;
        case 4: return bp_gather_kernel<4>;
        case 5: return bp_gather_kernel<5>;
        case 6: return bp_gather_kernel<6>;
        case 7: return bp_gather_kernel<7>;
        case 8: return bp_gather_kernel<8>;
        default: return bp_gather_kernel<kMaxDeg>;
    }
}

constexpr int kMaxDevices = 64;
constexpr int kForms = 3;  // K3, K3 with bf16, K8
constexpr int kGatherForm = 2;  // K8
constexpr int kKernels = kForms * (kRegSlots + 1);
int prepared[kMaxDevices][kKernels];  // the dynamic shared memory each kernel was last allowed, a device

// The attributes a launch needs, set once a kernel and device (and again
// for more shared memory): its dynamic shared memory, and the carveout that
// gives shared memory the most of an SM's 256 KB.  form: 0 K3, 1 K3 with
// bf16, 2 K8.
template <typename K>
cudaError_t prepare(K kernel, int form, int dc, long long smem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    int* done = dev < kMaxDevices ? &prepared[dev][form * (kRegSlots + 1) + (dc <= kRegSlots ? dc : 0)] : nullptr;
    if (done != nullptr && *done >= smem) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && done != nullptr) *done = (int)smem;
    return err;
}

// The launch's limits (the wrappers raise above them first).
bool bad_launch(int n_codes, int max_e, int dc, int warps, int B, int N, int max_iters, long long smem) {
    return B < 1 || N < 1 || N > kMaxIndex || max_e < 1 || max_e > kMaxIndex || dc < 1 || dc > kMaxDeg ||
           warps < 1 || 32 * warps > kMaxThreads || n_codes < 1 || max_iters < 0 || smem > kMaxSmem;
}

// Blocks of `warps` warps a kernel keeps resident on an SM; negative on a
// CUDA error.
template <typename K>
int resident(K kernel, int form, int dc, long long smem, int warps) {
    int blocks = 0;
    cudaError_t err = prepare(kernel, form, dc, smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * warps, (size_t)smem);
    return err == cudaSuccess ? blocks : -(int)err;
}

// K8's grid, found once a kernel, device, shared memory and block size:
// the blocks the card keeps resident (resident() on every SM); negative on
// a CUDA error.
struct GatherGrid {
    long long smem;
    int warps, blocks;
};
GatherGrid gather_grids[kMaxDevices][kRegSlots + 1];

int gather_grid(GatherKernel kernel, int dc, long long smem, int warps) {
    int dev = 0;
    const cudaError_t got = cudaGetDevice(&dev);
    if (got != cudaSuccess) return -(int)got;
    GatherGrid* done = dev < kMaxDevices ? &gather_grids[dev][dc <= kRegSlots ? dc : 0] : nullptr;
    if (done != nullptr && done->smem == smem && done->warps == warps) return done->blocks;
    int per_sm = resident(kernel, kGatherForm, dc, smem, warps), sms = 0;
    if (per_sm < 0) return per_sm;
    const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -(int)err;
    if (per_sm * sms < 1) return -(int)cudaErrorInvalidConfiguration;
    if (done != nullptr) *done = GatherGrid{smem, warps, per_sm * sms};
    return per_sm * sms;
}

}  // namespace

// llr [B, N] float32; done_in [B] bytes or null; code_idx [B] 1-based code
// ids (int64 if idx64, else int32) or null (every row code 1); header
// [n_codes, kHeader] int32 and tab int16 as ops/ldpc_cuda.py::bank_tables
// lays them out, every code's rows padded to dc slots, max_e the codes'
// largest E; warps: a block's warps (1 to 8); all contiguous.  Writes hard
// [B, N] int32, iters [B] int32, ok [B] bytes and, if total is not null,
// total [B, N] float32.  form: 0 K3, 1 K3 with the bfloat16 rounding of
// GR_DTL_TPU_BP_BF16.  Returns the CUDA error of the launch.
extern "C" int bp_decode_launch(const void* llr, const void* done_in, const void* code_idx, int idx64,
                                int n_codes, const void* header, const void* tab, int max_e, int dc, int warps,
                                int B, int N, int max_iters, int form, void* hard, void* iters, void* ok,
                                void* total, void* stream) {
    const long long smem = bp_smem_bytes(N, max_e);
    if (bad_launch(n_codes, max_e, dc, warps, B, N, max_iters, smem) || form < 0 || form >= kGatherForm)
        return (int)cudaErrorInvalidValue;
    const Kernel kernel = pick(form, dc);
    const cudaError_t err = prepare(kernel, form, dc, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, 32 * warps, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)llr, (const uint8_t*)done_in, code_idx, idx64, n_codes, (const int*)header,
        (const int16_t*)tab, N, max_iters, (int*)hard, (int*)iters, (uint8_t*)ok, (float*)total);
    return (int)cudaGetLastError();
}

// K8 (decode's and decode_bank's BP): bp_decode_launch's arguments less
// done_in, total and form (a code id picks its code by decode_bank's rule,
// bank_code), and cm, vn, the largest dc x M and dv x N of the codes (the
// room of the tables a block stages), and work, the launching stream's three
// uint32 counters, 0 before its first launch (the kernel leaves them at 0,
// and traps where a walk did not find them so).
// The grid is a wave of the blocks the card keeps resident, walking the
// codewords, where B fills kWalkWaves waves; below, a block a codeword (B
// blocks, no counter).  Returns the CUDA error of the launch.
extern "C" int bp_gather_launch(const void* llr, const void* code_idx, int idx64, int n_codes, const void* header,
                                const void* tab, int max_e, int dc, int warps, int B, int N, int max_iters, int cm,
                                int vn, void* hard, void* iters, void* ok, void* work, void* stream) {
    const long long smem = gather_smem_bytes(N, max_e, cm, vn);
    if (bad_launch(n_codes, max_e, dc, warps, B, N, max_iters, smem) || cm < 1 || vn < 1 || work == nullptr)
        return (int)cudaErrorInvalidValue;
    const GatherKernel kernel = pick_gather(dc);
    const int wave = gather_grid(kernel, dc, smem, warps);
    if (wave < 0) return -wave;
    const int grid = B < kWalkWaves * wave ? B : wave;
    kernel<<<grid, 32 * warps, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)llr, code_idx, idx64, n_codes, (const int*)header, (const int16_t*)tab, N, B, max_e, cm,
        max_iters, (int*)hard, (int*)iters, (uint8_t*)ok, (unsigned*)work);
    return (int)cudaGetLastError();
}

// Codewords an SM keeps resident at once (a codeword a block of `warps`
// warps) for codewords of N bits and codes of at most max_e edges and dc
// row slots, in a form (0 and 1 of bp_decode_launch's, 2 for
// bp_gather_launch's K8, whose staged tables take cm + vn more entries):
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative on a CUDA error.
extern "C" int bp_resident_codewords(int N, int max_e, int dc, int warps, int form, int cm, int vn) {
    if (form < 0 || form >= kForms) return -(int)cudaErrorInvalidValue;
    return form == kGatherForm ? resident(pick_gather(dc), form, dc, gather_smem_bytes(N, max_e, cm, vn), warps)
                               : resident(pick(form, dc), form, dc, bp_smem_bytes(N, max_e), warps);
}
