// K7: the adaptive MCS decision over a block's frames as one CUDA launch.
//
// What it replaces.  The JAX package runs the decision of
// gr_dtl_tpu/models/adaptive.py::feedback_step (:65-91) over the frames as a
// lax.scan: feedback_scan (:102), and the masked scan the streaming sessions
// and the link tools define inline (gr_dtl_tpu/models/session.py:673-680 and
// :766-779, tools/sample_link.py:134-142 and :227-235): a frame whose mask is
// False keeps the state and reports state.last.  XLA compiles it into one
// loop.  Its plain PyTorch version,
// gr_dtl_tpu_torch/models/adaptive.py::_feedback_scan_masked_torch, is a
// Python loop of ~35 kernel launches a frame.
//
// What bounds it.  Not bytes: a frame of a column is 9 bytes (its float32
// SNR, its mask byte, its int32 MCS id).  Not operations: a dozen integer
// selects.  The walk: every step depends on the last one through the active
// id, so a column costs a launch plus T dependent steps.  A step's chain is a
// shared-memory load of the rung at the active id, its two compares and the
// selects that give the next id.  The design keeps everything else off it:
//   * a thread a batch column, the carry (last, cand, counter) in registers;
//   * each rung's two thresholds, snr_th[i] and snr_th[i + 1] + hysteresis
//     (NaN where the ladder cannot go up: x > NaN is false), computed once a
//     block into shared memory, so a step reads one float2 at the active id
//     and branches nowhere;
//   * the SNRs and mask bytes of chunk k + 1 loaded into registers before
//     chunk k is walked, so their latency hides behind kChunk steps.  Two
//     loads stay on the chain: the first chunk's, and each of the last
//     T % kChunk frames', walked one at a time (a part chunk walked with
//     guarded loads and stores ran twice as slow: the guards' predicates
//     and addresses sit between the steps).
// tools/bench_feedback_scan.py times the chain alone (the floor of a step)
// and these choices against their alternatives.
//
// Contract.  A carried-in id lies in [0, n_mcs), as the plain loop requires
// (its table index raises outside the table); a step from such an id stays
// there.  An id outside stops the kernel with a device fault, as the plain
// loop's index does on the card.
//
// Exactness.  Every decision is an exact integer, so the kernel equals the
// reference bit for bit:
//   * `snr > snr_th[cur + 1] + hyst` rounds the float32 sum before the
//     compare (__fadd_rn), as PyTorch and XLA do between two of their ops;
//   * a NaN SNR compares False both ways (no fast-math);
//   * clip(cur + 1, 0, n - 1) and max(cur - 1, 0) as the reference writes
//     them; the counter wraps as int32 does (unsigned arithmetic here).
// The carry enters and leaves through device tensors, never the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;          // frames loaded a chunk ahead of the walk
constexpr int kMaxThreads = 128;    // a block's columns
constexpr int kMaxRungs = 1 << 12;  // rungs in shared memory: 32 KiB

struct State {
    int last, cand, counter;
};

// adaptive.feedback_step (reference :74-90) and the masked rule
// (session.py:677-678): a frame not decoded keeps the state and reports the
// active id.  r = (snr_th[last], snr_th[last + 1] + hyst or NaN).  Returns
// the id reported for the frame.
__device__ __forceinline__ int step(State& s, float x, bool m, float2 r, int decision_th) {
    const bool down = x < r.x;
    const bool up = x > r.y;
    const int candidate = down ? (s.last > 0 ? s.last - 1 : 0) : (up ? s.last + 1 : s.last);
    const bool propose = down || up;
    const bool changed = candidate != s.cand;
    const int new_cand = (propose && changed) ? candidate : s.cand;
    int new_counter = propose ? (changed ? 0 : (int)((unsigned)s.counter + 1u)) : 0;
    const bool commit = propose && !changed && new_counter >= decision_th;
    const int new_last = commit ? new_cand : s.last;
    new_counter = commit ? 0 : new_counter;
    s.cand = m ? new_cand : s.cand;
    s.counter = m ? new_counter : s.counter;
    s.last = m ? new_last : s.last;
    return s.last;
}

// The rung of id i < n: its down threshold and its up threshold (rounded to
// float32), NaN at the top of the ladder.
__device__ __forceinline__ float2 rung_of(const float* snr_th, int n, float hyst, int i) {
    return make_float2(snr_th[i], i + 1 < n ? __fadd_rn(snr_th[i + 1], hyst) : __int_as_float(0x7fc00000));
}

// kChunk frames of a column: SNRs from xp, mask bytes from mp (or all set).
__device__ __forceinline__ void load_chunk(float (&x)[kChunk], bool (&m)[kChunk], const float* xp,
                                           const uint8_t* mp, long long mts, int B) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
        x[k] = xp[(long long)k * B];
        m[k] = mp == nullptr || mp[k * mts] != 0;
    }
}

__global__ void feedback_scan_kernel(const float* __restrict__ snr, const uint8_t* __restrict__ mask,
                                     long long mask_t_stride, long long mask_b_stride,
                                     const float* __restrict__ snr_th, int n_mcs, float hyst,
                                     int decision_th, const int* __restrict__ last_in,
                                     const int* __restrict__ cand_in, const int* __restrict__ counter_in,
                                     int T, int B, int* __restrict__ mcs, int* __restrict__ state_out) {
    extern __shared__ float2 rungs[];  // [n_mcs]
    for (int i = threadIdx.x; i < n_mcs; i += blockDim.x) rungs[i] = rung_of(snr_th, n_mcs, hyst, i);
    __syncthreads();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    State s{last_in[b], cand_in[b], counter_in[b]};
    if (s.last < 0 || s.last >= n_mcs) __trap();
    const float* xp = snr + b;
    const uint8_t* mp = mask == nullptr ? nullptr : mask + b * mask_b_stride;
    int* op = mcs + b;
    int t = 0;
    float x[kChunk];
    bool m[kChunk];
    if (T >= kChunk) load_chunk(x, m, xp, mp, mask_t_stride, B);
    for (; t + kChunk <= T; t += kChunk) {
        const bool more = t + 2 * kChunk <= T;
        float xn[kChunk];
        bool mn[kChunk];
        if (more)
            load_chunk(xn, mn, xp + (long long)kChunk * B, mp == nullptr ? nullptr : mp + kChunk * mask_t_stride,
                       mask_t_stride, B);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) op[(long long)k * B] = step(s, x[k], m[k], rungs[s.last], decision_th);
        xp += (long long)kChunk * B;
        op += (long long)kChunk * B;
        if (mp != nullptr) mp += kChunk * mask_t_stride;
        if (more) {
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                x[k] = xn[k];
                m[k] = mn[k];
            }
        }
    }
    for (; t < T; ++t) {  // the last T % kChunk frames
        *op = step(s, *xp, mp == nullptr || *mp != 0, rungs[s.last], decision_th);
        xp += B;
        op += B;
        if (mp != nullptr) mp += mask_t_stride;
    }
    state_out[b] = s.last;
    state_out[B + b] = s.cand;
    state_out[2 * B + b] = s.counter;
}

}  // namespace

// snr [T, B] float32, mask [T, B] bytes at the given strides (in elements)
// or null (every frame counts), snr_th [>= n_mcs] float32, the state's three
// int32 [B] vectors with last in [0, n_mcs); writes mcs [T, B] int32 and
// state_out [3, B] int32 (last, cand, counter).  Returns the CUDA error of
// the launch.
extern "C" int feedback_scan_launch(const void* snr, const void* mask, long long mask_t_stride,
                                    long long mask_b_stride, const void* snr_th, int n_mcs, float hyst,
                                    int decision_th, const void* last, const void* cand,
                                    const void* counter, int T, int B, void* mcs, void* state_out,
                                    void* stream) {
    if (T < 0 || B < 1 || n_mcs < 1 || n_mcs > kMaxRungs) return (int)cudaErrorInvalidValue;
    const int threads = B < kMaxThreads ? ((B + 31) / 32) * 32 : kMaxThreads;
    const int blocks = (B + threads - 1) / threads;
    feedback_scan_kernel<<<blocks, threads, (size_t)n_mcs * sizeof(float2), (cudaStream_t)stream>>>(
        (const float*)snr, (const uint8_t*)mask, mask_t_stride, mask_b_stride, (const float*)snr_th, n_mcs,
        hyst, decision_th, (const int*)last, (const int*)cand, (const int*)counter, T, B, (int*)mcs,
        (int*)state_out);
    return (int)cudaGetLastError();
}
