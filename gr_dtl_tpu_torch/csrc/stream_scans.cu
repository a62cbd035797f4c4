// The streaming sessions' two per-frame recurrences as CUDA kernels.
//
// What they replace.  The JAX package writes both as lax.scan, which XLA
// compiles into the block step (there is no Pallas kernel for them):
//   * the trigger lock state machine,
//     gr_dtl_tpu/models/streaming.py::trigger_lock_scan (step at :163-178);
//   * the lost-frame accounting of the session step,
//     gr_dtl_tpu/models/session.py (acct at :214-223), and its batch sibling
//     gr_dtl_tpu/ops/metrics.py::lost_frames (step at :61-66).
// In eager PyTorch a scan over T frames is T iterations of ~10-15 tiny
// launches each, on the path of every block, so each gets one launch here.
// Their plain PyTorch versions are
// gr_dtl_tpu_torch/models/streaming.py::_trigger_lock_scan_torch and
// gr_dtl_tpu_torch/ops/metrics.py::_frame_accounting_torch.
//
// What bounds them.  Neither bytes nor operations: T items of 10 bytes
// (40 KB at T = 4096) and a dozen integer operations each.  The kernel is
// a sequential state machine with a four-word carry, so its time is the
// launch latency plus T dependent steps of one thread, whatever S.
//
// Design.  One thread a stream walks that stream's T items in device memory
// with the carry in registers; S streams are one launch of ceil(S / 32)
// blocks of 32 threads (a single stream is the S = 1 case of the same
// launch: the sessions of models/session.py hand it one stream, the sharded
// session of parallel/session.py every stream of its rank, so a block of a
// rank costs two launches whatever S).  The streams share nothing, so the
// threads never wait for each other.  The loads do not depend on the carry,
// so they run ahead of the dependent chain (const __restrict__: the
// read-only path, one 128-byte line serves 32 items of a stream); the stores
// are not waited for.  The carry enters and leaves through small device
// tensors, never the host.  int32 throughout, as the reference; x & 4095 is
// the floor-mod 4096 of a two's-complement int32, which is what jnp's and
// torch's % give for negative operands.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLockAfter = 3;    // LOCK_AFTER of models/streaming.py
constexpr int kUnlockAfter = 5;  // UNLOCK_AFTER
constexpr int kThreads = 32;     // streams a block

// Stream s = the thread's index; its state is state[4 s .. 4 s + 3] =
// [locked (0/1), expected, sync_count, miss_count], its items [s T, s T + T).
__global__ void trigger_lock_scan_kernel(const int* __restrict__ state_in,
                                         const int* __restrict__ cand,
                                         const uint8_t* __restrict__ found, int S, int T,
                                         int period, int tol, int* __restrict__ state_out,
                                         int* __restrict__ trig, uint8_t* __restrict__ valid) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= S) return;
    const size_t base = (size_t)s * T;
    cand += base;
    found += base;
    trig += base;
    valid += base;
    bool locked = state_in[4 * s] != 0;
    int expected = state_in[4 * s + 1], sync_count = state_in[4 * s + 2],
        miss_count = state_in[4 * s + 3];
#pragma unroll 4
    for (int i = 0; i < T; ++i) {
        const int c = cand[i];
        const bool ok = found[i] != 0;
        // |c - expected| in wrapping int32, as the reference's jnp.abs
        const int diff = (int)((unsigned)c - (unsigned)expected);
        const int adiff = diff < 0 ? (int)(0u - (unsigned)diff) : diff;
        const bool consistent = ok && adiff <= tol;
        sync_count = consistent ? sync_count + 1 : (ok ? 1 : 0);
        miss_count = (locked && !consistent) ? miss_count + 1 : 0;
        const bool take = consistent || (!locked && ok);
        const int t = take ? c : expected;
        trig[i] = t;
        valid[i] = (take || locked) ? 1 : 0;  // the state BEFORE this step
        if (sync_count >= kLockAfter) locked = true;
        if (miss_count >= kUnlockAfter) locked = false;
        expected = (int)((unsigned)t + (unsigned)period);
    }
    state_out[4 * s] = locked ? 1 : 0;
    state_out[4 * s + 1] = expected;
    state_out[4 * s + 2] = sync_count;
    state_out[4 * s + 3] = miss_count;
}

// rule 0 (the session's): an undecoded slot changes nothing; the first
//   received frame (expected < 0) counts no gap.
// rule 1 (metrics.lost_frames): a bad header is one lost frame and moves
//   the expectation on by one.
// Stream s = the thread's index: expected[s], items [s T, s T + T),
// totals[2 s .. 2 s + 1] = [sum of lost, count of ok].
__global__ void frame_accounting_kernel(const int* __restrict__ expected_in,
                                        const int* __restrict__ frame_no,
                                        const uint8_t* __restrict__ ok, int S, int T, int rule,
                                        int* __restrict__ expected_out, int* __restrict__ lost,
                                        int* __restrict__ totals) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= S) return;
    const size_t base = (size_t)s * T;
    frame_no += base;
    ok += base;
    lost += base;
    int expected = expected_in[s], sum_lost = 0, n_ok = 0;
#pragma unroll 4
    for (int i = 0; i < T; ++i) {
        const int no = frame_no[i];
        const bool okf = ok[i] != 0;
        const int gap = (int)(((unsigned)no - (unsigned)expected) & 4095u);
        int l;
        if (rule == 0) {
            l = (okf && expected >= 0) ? gap : 0;
            if (okf) expected = (int)(((unsigned)no + 1u) & 4095u);
        } else {
            l = okf ? gap : 1;
            expected = (int)(((unsigned)(okf ? no : expected) + 1u) & 4095u);
        }
        lost[i] = l;
        sum_lost += l;
        n_ok += okf ? 1 : 0;
    }
    expected_out[s] = expected;
    totals[2 * s] = sum_lost;
    totals[2 * s + 1] = n_ok;
}

int blocks_for(int S) { return (S + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int trigger_lock_scan_launch(const void* state_in, const void* cand, const void* found,
                                        int S, int T, int period, int tol, void* state_out,
                                        void* trig, void* valid, void* stream) {
    if (S < 1 || T < 0) return (int)cudaErrorInvalidValue;
    trigger_lock_scan_kernel<<<blocks_for(S), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)state_in, (const int*)cand, (const uint8_t*)found, S, T, period, tol,
        (int*)state_out, (int*)trig, (uint8_t*)valid);
    return (int)cudaGetLastError();
}

extern "C" int frame_accounting_launch(const void* expected_in, const void* frame_no,
                                       const void* ok, int S, int T, int rule, void* expected_out,
                                       void* lost, void* totals, void* stream) {
    if (S < 1 || T < 0) return (int)cudaErrorInvalidValue;
    frame_accounting_kernel<<<blocks_for(S), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)expected_in, (const int*)frame_no, (const uint8_t*)ok, S, T, rule,
        (int*)expected_out, (int*)lost, (int*)totals);
    return (int)cudaGetLastError();
}
