// The streaming sessions' two per-frame recurrences as CUDA kernels.
//
// What they replace.  The JAX package writes both as lax.scan, which XLA
// compiles into the block step (there is no Pallas kernel for them):
//   * the trigger lock state machine,
//     gr_dtl_tpu/models/streaming.py::trigger_lock_scan (step at :163-178);
//   * the lost-frame accounting of the session step,
//     gr_dtl_tpu/models/session.py (acct at :214-223), and its batch sibling
//     gr_dtl_tpu/ops/metrics.py::lost_frames (step at :61-66).
// Their plain PyTorch versions are
// gr_dtl_tpu_torch/models/streaming.py::_trigger_lock_scan_torch and
// gr_dtl_tpu_torch/ops/metrics.py::_frame_accounting_torch.  One launch each
// a block of frames, for one stream or for all S streams of a rank.
//
// What bounds them.  Neither bytes nor operations: T items of 10 bytes and a
// dozen integer operations each.  A walk over the frames costs a launch plus
// T dependent steps of 20-46 ns, so neither walks more than 32 frames one by
// one: what is left is a launch, the loads of a tile (coalesced: a block or
// a warp reads its stream's row), and a few dependent block- or warp-wide
// steps.
//
// frame_accounting: a block a stream, sized to T (a warp at T <= 32, up to
// 1024 threads), a thread a frame of each tile of blockDim frames.  The
// expectation before frame i depends only on the last decoded frame j < i:
//   rule 0 (the session's): (no[j] + 1) & 4095, or the carried-in value;
//   rule 1 (lost_frames'):  (no[j] + 1 + (i - 1 - j)) & 4095, or the carried
//                           value advanced by i.
// So one exclusive prefix-max of the 64-bit key (j + 1) << 32 | value (value
// no[j], or no[j] - j) gives it to every frame: warp __shfl_up_sync scans
// combined through shared memory, the tile's maximum carried to the next
// tile.  lost[i] is then elementwise; the two totals are a block reduction.
//
// trigger_lock_scan: a warp a stream.  The carry holds an unbounded
// expected, so there is no finite-state trick, but the machine forgets its
// past: one consistent frame sets expected to cand + period and miss to 0,
// only min(sync, 3) decides anything, and while locked not even that (see
// `same`).  A tile of 32 chunks of C frames (C the power of two that covers
// T, up to 32) is staged in shared memory with coalesced loads.  Lane l
// guesses its entry by walking the kWarm frames before its chunk from
// "locked, expected = cand[first - 1] + period, miss 0, sync 3" (from the
// true carry where they reach the tile's start; lane 0 starts from it), then
// walks its chunk.  Then rounds of repair: each lane whose predecessor's exit
// is not `same` as its entry re-walks from it, beside its old walk, until
// the two states are `same`; from there its old outputs and exit stand.  No
// lane changing ends the tile: after round r lanes 0..r are exact.  On the
// paths' streams the warm-up meets the true state and no round runs; a
// stream built to defeat the guess (nothing found for a whole tile) costs
// about two sequential walks, still exact.  At T <= 32 every warm-up would
// reach frame 0, so the lanes skip the staging and walk the frames in step
// from the carry, frame k broadcast from lane k's register by a shuffle:
// shared-memory addressing took as many issue slots as the step itself.  The exact sync_count leaves a
// tile as (found at its last inconsistent frame r) + (frames after r), or
// the entry's plus the tile's length (wrapping) if every frame of it was
// consistent.  tests/test_torch_scan_parallel.py holds the same algebra, in
// numpy, to the reference's scan.
//
// The carry enters and leaves through small device tensors, never the host.
// int32 throughout, wrapping as the reference's; x & 4095 is the floor-mod
// 4096 of a two's-complement int32, which is what jnp's and torch's % give
// for negative operands.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLockAfter = 3;    // LOCK_AFTER of models/streaming.py
constexpr int kUnlockAfter = 5;  // UNLOCK_AFTER
constexpr int kLanes = 32;       // a warp
constexpr int kMaxLogChunk = 5;  // chunks of up to 32 frames: a tile of 1024
constexpr int kMaxChunk = 1 << kMaxLogChunk;
constexpr int kStage = kLanes * (kMaxChunk + 1);  // a lane's chunk padded by one: no bank conflicts
constexpr int kWarm = 32;         // frames a lane walks before its chunk to guess its entry
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// The lock state with sync_count kept at min(sync, 3) after a step.
struct Lock {
    bool locked;
    int expected, miss, sync;
};

// Two states that give the same outputs from here on: locked, expected and
// miss equal, and sync too while unlocked.  While locked, sync decides
// nothing: it can only unlock through an inconsistent frame, which sets sync
// from the frame alone.
__device__ __forceinline__ bool same(const Lock& a, const Lock& b) {
    return a.locked == b.locked && a.expected == b.expected && a.miss == b.miss &&
           (a.locked || a.sync == b.sync);
}

// |c - expected| <= tol as the reference's jnp.abs in wrapping int32 has it,
// with one subtraction on the carry's chain: for tol >= 0 (`wide`),
// c - expected lies in [-tol, tol] when c + tol - expected <= 2 tol as
// unsigned; and |INT_MIN| is INT_MIN, which is <= any tol.
struct Tolerance {
    int tol;
    bool wide;
    unsigned span;
};

// One step of streaming.py:163-178.  Returns whether the frame was consistent.
__device__ __forceinline__ bool lock_step(Lock& s, int c, bool ok, int period, const Tolerance& tl,
                                          int& trig, uint8_t& valid) {
    const unsigned u = (unsigned)c + (unsigned)tl.tol - (unsigned)s.expected;
    const bool near = (tl.wide && u <= tl.span) || s.expected == (int)((unsigned)c ^ 0x80000000u);
    const bool cons = ok && near;
    const int sync = cons ? min((int)((unsigned)s.sync + 1u), kLockAfter) : (ok ? 1 : 0);
    const int miss = (s.locked && !cons) ? (int)((unsigned)s.miss + 1u) : 0;
    const bool take = cons || (!s.locked && ok);
    const int t = take ? c : s.expected;
    trig = t;
    valid = (take || s.locked) ? 1 : 0;  // the state BEFORE this step
    const bool locked = miss >= kUnlockAfter ? false : (sync >= kLockAfter || s.locked);
    s = Lock{locked, (int)((unsigned)t + (unsigned)period), miss, sync};
    return cons;
}

__device__ __forceinline__ Lock shfl_lock(const Lock& s, int src_lane) {
    return Lock{__shfl_sync(kFull, (int)s.locked, src_lane) != 0,
                __shfl_sync(kFull, s.expected, src_lane), __shfl_sync(kFull, s.miss, src_lane),
                __shfl_sync(kFull, s.sync, src_lane)};
}

// [locked (0/1), expected, sync_count, miss_count]
__device__ __forceinline__ void store_lock(int* out, const Lock& s, int sync_count) {
    out[0] = s.locked ? 1 : 0;
    out[1] = s.expected;
    out[2] = sync_count;
    out[3] = s.miss;
}

// Stream s = blockIdx.x, one warp; its state is state[4 s .. 4 s + 3] =
// [locked (0/1), expected, sync_count, miss_count], its items [s T, s T + T).
__global__ void __launch_bounds__(kLanes)
trigger_lock_scan_kernel(const int* __restrict__ state_in, const int* __restrict__ cand,
                         const uint8_t* __restrict__ found, int T, int period, int tol,
                         int* __restrict__ state_out, int* __restrict__ trig,
                         uint8_t* __restrict__ valid) {
    __shared__ int c_s[kStage], t_s[kStage];
    __shared__ uint8_t f_s[kStage], v_s[kStage];
    const int s = blockIdx.x, lane = threadIdx.x;
    const size_t base = (size_t)s * T;
    cand += base;
    found += base;
    trig += base;
    valid += base;
    // the exact carry: lane 0 of the first tile walks from it as it is
    Lock carry{state_in[4 * s] != 0, state_in[4 * s + 1], state_in[4 * s + 3], state_in[4 * s + 2]};
    int sync_exact = state_in[4 * s + 2];
    const Tolerance tl{tol, tol >= 0, 2u * (unsigned)tol};
    if (T <= kLanes) {
        // A frame a lane, and every lane's warm-up would reach frame 0: the
        // speculation has nothing to guess.  So every lane walks all T frames
        // from the carry in step, reading frame k from lane k's register
        // (no shared memory, no address arithmetic on the chain), and keeps
        // the outputs of its own frame.
        const bool here = lane < T;
        const int c_mine = here ? cand[lane] : 0;
        const unsigned found_bits = __ballot_sync(kFull, here && found[lane] != 0);
        int own_t = 0;
        uint8_t own_v = 0;
#pragma unroll 8
        for (int k = 0; k < T; ++k) {
            const int c = __shfl_sync(kFull, c_mine, k);
            const bool f = (found_bits >> k) & 1u;
            int t;
            uint8_t v;
            const bool cons = lock_step(carry, c, f, period, tl, t, v);
            sync_exact = cons ? (int)((unsigned)sync_exact + 1u) : (f ? 1 : 0);
            if (k == lane) {
                own_t = t;
                own_v = v;
            }
        }
        if (here) {
            trig[lane] = own_t;
            valid[lane] = own_v;
        }
        if (lane == 0) store_lock(state_out + 4 * s, carry, sync_exact);
        return;
    }
    int lc = 0;
    while (lc < kMaxLogChunk && (kLanes << lc) < T) ++lc;
    const int C = 1 << lc, stride = C + 1;
    const int* my_c = c_s + lane * stride;
    const uint8_t* my_f = f_s + lane * stride;
    int* my_t = t_s + lane * stride;
    uint8_t* my_v = v_s + lane * stride;
    for (int t0 = 0; t0 < T; t0 += kLanes << lc) {
        const int n = min(kLanes << lc, T - t0);
        __syncwarp();
        for (int k = lane; k < n; k += kLanes) {
            const int at = (k >> lc) * stride + (k & (C - 1));
            c_s[at] = cand[t0 + k];
            f_s[at] = found[t0 + k];
        }
        __syncwarp();
        const int lanes = (n + C - 1) >> lc, m = max(0, min(C, n - lane * C));
        // the guess: the kWarm frames before the chunk walked from "locked on
        // the frame before them", or from the carry where they reach frame 0
        Lock in = carry;
        if (lane > 0 && m > 0) {
            const int start = lane * C, first = start - min(kWarm, start);
            if (first > 0) {
                const int at = ((first - 1) >> lc) * stride + ((first - 1) & (C - 1));
                in = Lock{true, (int)((unsigned)c_s[at] + (unsigned)period), 0, kLockAfter};
            }
            int t_dummy;
            uint8_t v_dummy;
#pragma unroll 8
            for (int k = first; k < start; ++k) {
                const int at = (k >> lc) * stride + (k & (C - 1));
                lock_step(in, c_s[at], f_s[at] != 0, period, tl, t_dummy, v_dummy);
            }
        }
        // the speculative walk
        Lock out = in;
        int reset = -1;  // the chunk's last inconsistent frame
#pragma unroll 8
        for (int k = 0; k < m; ++k)
            if (!lock_step(out, my_c[k], my_f[k] != 0, period, tl, my_t[k], my_v[k])) reset = k;
        // rounds of repair
        for (;;) {
            Lock pred = shfl_lock(out, (lane + kLanes - 1) % kLanes);
            if (lane == 0) pred = in;
            const bool changed = lane > 0 && m > 0 && !same(pred, in);
            if (!__any_sync(kFull, changed)) break;
            if (changed) {
                Lock old = in, now = pred;
                int now_reset = -1, met = -1;
                for (int k = 0; k < m; ++k) {
                    const int c = my_c[k];
                    const bool f = my_f[k] != 0;
                    if (!lock_step(now, c, f, period, tl, my_t[k], my_v[k])) now_reset = k;
                    int t_old;
                    uint8_t v_old;
                    lock_step(old, c, f, period, tl, t_old, v_old);
                    if (same(old, now)) {
                        met = k;
                        break;
                    }
                }
                in = pred;
                if (met < 0) {
                    out = now;
                    reset = now_reset;
                } else if (reset <= met) {
                    reset = now_reset;
                }
            }
        }
        const int last = __reduce_max_sync(kFull, reset >= 0 ? lane * C + reset : -1);
        if (last >= 0)
            sync_exact = (f_s[(last >> lc) * stride + (last & (C - 1))] ? 1 : 0) + (n - 1 - last);
        else
            sync_exact = (int)((unsigned)sync_exact + (unsigned)n);
        carry = shfl_lock(out, lanes - 1);
        __syncwarp();
        for (int k = lane; k < n; k += kLanes) {
            const int at = (k >> lc) * stride + (k & (C - 1));
            trig[t0 + k] = t_s[at];
            valid[t0 + k] = v_s[at];
        }
    }
    if (lane == 0) store_lock(state_out + 4 * s, carry, sync_exact);
}

// rule 0 (the session's): an undecoded slot changes nothing; the first
//   received frame (expected < 0) counts no gap.
// rule 1 (metrics.lost_frames): a bad header is one lost frame and moves
//   the expectation on by one.
// Stream s = blockIdx.x: expected[s], items [s T, s T + T),
// totals[2 s .. 2 s + 1] = [sum of lost, count of ok].
__global__ void __launch_bounds__(kMaxThreads)
frame_accounting_kernel(const int* __restrict__ expected_in, const int* __restrict__ frame_no,
                        const uint8_t* __restrict__ ok, int T, int rule,
                        int* __restrict__ expected_out, int* __restrict__ lost,
                        int* __restrict__ totals) {
    __shared__ unsigned long long warp_max[kMaxThreads / kLanes];
    __shared__ int warp_sum[kMaxThreads / kLanes], warp_ok[kMaxThreads / kLanes];
    const int s = blockIdx.x, tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
    const int n_warps = blockDim.x / kLanes;
    const size_t base = (size_t)s * T;
    frame_no += base;
    ok += base;
    lost += base;
    const int e0 = expected_in[s];
    unsigned long long carry = 0;  // (j + 1) << 32 | value of the last ok j so far; 0 = none
    int sum_lost = 0, n_ok = 0;
    for (int t0 = 0; t0 < T; t0 += blockDim.x) {
        const int i = t0 + tid;
        const bool here = i < T;
        const int no = here ? frame_no[i] : 0;
        const bool okf = here && ok[i] != 0;
        const unsigned val = rule == 0 ? (unsigned)no : (unsigned)no - (unsigned)i;
        unsigned long long key = okf ? ((unsigned long long)(i + 1) << 32) | val : 0ull;
#pragma unroll
        for (int d = 1; d < kLanes; d <<= 1) {
            const unsigned long long u = __shfl_up_sync(kFull, key, d);
            if (lane >= d) key = max(key, u);
        }
        unsigned long long before = __shfl_up_sync(kFull, key, 1);  // frames < i of this warp
        if (lane == 0) before = 0ull;
        unsigned long long tile_max;
        if (n_warps == 1) {  // a warp: no shared memory, no barrier
            tile_max = __shfl_sync(kFull, key, kLanes - 1);
        } else {
            if (lane == kLanes - 1) warp_max[warp] = key;
            __syncthreads();
            if (warp == 0) {
                unsigned long long w = lane < n_warps ? warp_max[lane] : 0ull;
#pragma unroll
                for (int d = 1; d < kLanes; d <<= 1) {
                    const unsigned long long u = __shfl_up_sync(kFull, w, d);
                    if (lane >= d) w = max(w, u);
                }
                if (lane < n_warps) warp_max[lane] = w;
            }
            __syncthreads();
            if (warp > 0) before = max(before, warp_max[warp - 1]);  // of the warps before
            tile_max = warp_max[n_warps - 1];
            __syncthreads();  // warp_max read by all before the next tile writes it
        }
        before = max(before, carry);  // of the tiles before
        carry = max(carry, tile_max);
        if (here) {
            const bool has = (before >> 32) != 0;
            const unsigned v = (unsigned)before;
            int l;
            if (rule == 0) {
                const int e = has ? (int)((v + 1u) & 4095u) : e0;
                l = (okf && e >= 0) ? (int)(((unsigned)no - (unsigned)e) & 4095u) : 0;
            } else {
                const unsigned e = has ? v + (unsigned)i : (unsigned)e0 + (unsigned)i;
                l = okf ? (int)(((unsigned)no - e) & 4095u) : 1;
            }
            lost[i] = l;
            sum_lost = (int)((unsigned)sum_lost + (unsigned)l);
            n_ok += okf ? 1 : 0;
        }
    }
    sum_lost = (int)__reduce_add_sync(kFull, (unsigned)sum_lost);
    n_ok = (int)__reduce_add_sync(kFull, (unsigned)n_ok);
    if (n_warps > 1) {
        if (lane == 0) {
            warp_sum[warp] = sum_lost;
            warp_ok[warp] = n_ok;
        }
        __syncthreads();
    }
    if (tid == 0) {
        unsigned total = (unsigned)sum_lost;
        int count = n_ok;
        for (int w = 1; w < n_warps; ++w) {
            total += (unsigned)warp_sum[w];
            count += warp_ok[w];
        }
        const bool has = (carry >> 32) != 0;
        const unsigned v = (unsigned)carry;
        int e;
        if (rule == 0)
            e = has ? (int)((v + 1u) & 4095u) : e0;
        else
            e = has ? (int)((v + (unsigned)T) & 4095u)
                    : (T == 0 ? e0 : (int)(((unsigned)e0 + (unsigned)T) & 4095u));
        expected_out[s] = e;
        totals[2 * s] = (int)total;
        totals[2 * s + 1] = count;
    }
}

// A block sized to T: a warp for T <= 32, up to 1024 threads.
int accounting_threads(int T) {
    return T >= kMaxThreads ? kMaxThreads : T <= 1 ? kLanes : (T + kLanes - 1) / kLanes * kLanes;
}

}  // namespace

extern "C" int trigger_lock_scan_launch(const void* state_in, const void* cand, const void* found,
                                        int S, int T, int period, int tol, void* state_out,
                                        void* trig, void* valid, void* stream) {
    if (S < 1 || T < 0) return (int)cudaErrorInvalidValue;
    trigger_lock_scan_kernel<<<S, kLanes, 0, (cudaStream_t)stream>>>(
        (const int*)state_in, (const int*)cand, (const uint8_t*)found, T, period, tol,
        (int*)state_out, (int*)trig, (uint8_t*)valid);
    return (int)cudaGetLastError();
}

extern "C" int frame_accounting_launch(const void* expected_in, const void* frame_no,
                                       const void* ok, int S, int T, int rule, void* expected_out,
                                       void* lost, void* totals, void* stream) {
    if (S < 1 || T < 0 || (rule != 0 && rule != 1)) return (int)cudaErrorInvalidValue;
    frame_accounting_kernel<<<S, accounting_threads(T), 0, (cudaStream_t)stream>>>(
        (const int*)expected_in, (const int*)frame_no, (const uint8_t*)ok, T, rule,
        (int*)expected_out, (int*)lost, (int*)totals);
    return (int)cudaGetLastError();
}
