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
// selects.  The dependence: every step depends on the last one through the
// active id.  Two designs, one source, one launch a call; the wrapper
// (ops/feedback_cuda.py::design) picks one.
//
// The walk (feedback_scan_kernel): a thread a batch column walks the T frames
// with the state (last, cand, counter) in registers: a launch plus T
// dependent steps.  A step's chain is a shared-memory load of the rung at the
// active id, its two compares and the selects that give the next id.  The
// design keeps everything else off it:
//   * each rung's two thresholds, snr_th[i] and snr_th[i + 1] + hysteresis
//     (NaN where the ladder cannot go up: x > NaN is false), computed once a
//     block into shared memory, so a step reads one float2 at the active id
//     and branches nowhere;
//   * the SNRs and mask bytes of chunk k + 1 loaded into registers before
//     chunk k is walked, so their latency hides behind kChunk steps; the
//     last T % kChunk frames are walked one at a time.
// It serves short blocks (under 64 frames), where it sits near the launch
// floor, more columns than one wave of map blocks (over 256), and ladders
// the map below cannot hold.
//
// The map (feedback_scan_map_kernel): the decision is a finite-state
// machine.  While the active id is `last`, a frame can propose only
// max(last - 1, 0) ("down") or last + 1 ("up"); so `cand` matters only as
// one of those, as `last` itself (what a commit leaves), or as neither, and
// a reachable counter lies in [0, max(decision_th, 1)).  The canonical
// states, with thp = max(decision_th, 1):
//   s = (counter * 2 + up) * n + last          cand down or up, any counter
//   s = 2 n thp + last                         cand == last ("same"), counter 0
//   s = 2 n thp + n + last                     cand neither ("other"), counter 0
// n (2 thp + 2) states, 48 on the default ladder (4 rungs, decision_th 5).
// Same and other need no counter: their first proposal always changes the
// candidate, which zeroes it, and so does a frame that proposes nothing;
// other is the carried cand until then (no state reaches other from
// another class).  Every state a canonical state steps to is canonical.
// A block a column:
//   1. stage: a tile of kTile frames as one word each, 2 bits a rung: the
//      frame's code at each active id (0 nothing, 1 down, 2 up; every code
//      3 for a masked frame), from the same rounded thresholds as the walk,
//      a warp a chunk, with a flag for a chunk that has a frame not masked.
//      Before the first tile, the transition table next[code][s], built by
//      the walk's own step from each state's representative (other's cand
//      is -1, never a candidate), while the first tile's loads are in
//      flight; each later tile's loads are in flight beside the chain and
//      the emit before it;
//   2. map: a thread a (chunk of kChunk frames, state) pair walks the table
//      from that state over the chunk: the exit of every state.  A step is
//      a rotate, an and, a multiply-add and a shared-memory load (the table
//      first in shared memory, its entries byte offsets); a code's row
//      holds the states side by side, so a warp's threads, one a state,
//      meet few bank conflicts; the words come four to a load;
//   3. chain: one thread starts from the carry and takes a lookup a chunk
//      (the map holds row indices, so a lookup is one dependent load).
//      A carry whose cand is neither candidate and whose counter is not 0
//      walks as the same state with counter 0 (the first frame not masked
//      zeroes the counter either way; the counter is kept for the final
//      state while every frame is masked).  A down or up candidate with a
//      counter out of range (e.g. INT32_MAX, which wraps) is walked
//      exactly, chunk by chunk, until it is canonical;
//   4. emit: a thread a chunk walks it again from its true entry, its ids
//      gathered in registers and stored to shared memory; then a thread a
//      frame writes them out.  The chain's exit is the final state.
// The dependent depth is about 2 kChunk + T / kChunk short steps (~96 at T
// = 1024) in place of T; the map's work, n (2 thp + 2) walks of T frames,
// is spread over the block.  Past kTile frames the tiles run in order with
// the carry between them.  A ladder of more than kMapRungs rungs, or more
// than kMaxStates states, takes the walk.
//
// tools/bench_feedback_scan.py times both designs in turns, and the floors
// of their chains.
//
// Contract.  A carried-in id lies in [0, n_mcs), as the plain loop requires
// (its table index raises outside the table); a step from such an id stays
// there.  An id outside stops the kernel with a device fault, as the plain
// loop's index does on the card.
//
// Exactness.  Every decision is an exact integer, so both designs equal the
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

constexpr int kChunk = 32;          // frames loaded a chunk ahead of the walk; a map walk's frames
constexpr int kMaxThreads = 128;    // the walk: a block's columns
constexpr int kMaxRungs = 1 << 12;  // rungs in shared memory: 32 KiB
constexpr int kTile = 1024;                  // the map: frames a tile
constexpr int kTileChunks = kTile / kChunk;  // chunks a tile
constexpr int kChunkStride = kChunk + 4;     // words a chunk in shared memory: 16-byte rows, chunks on other banks
constexpr int kMapRungs = 16;                // 2 bits a rung in a 32-bit frame word
constexpr int kMaxStates = 512;              // canonical states (9 bits of a packed state)
constexpr int kMapThreads = 1024;            // a map block's threads, at most
constexpr uint32_t kMasked = 0xffffffffu;    // a masked frame: code 3 at every id

struct State {
    int last, cand, counter;
};

// adaptive.feedback_step (reference :74-90) after its compares, and the
// masked rule (session.py:677-678): a frame not decoded keeps the state and
// reports the active id.  Returns the id reported for the frame.
__device__ __forceinline__ int advance(State& s, bool down, bool up, bool m, int decision_th) {
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

// One frame.  r = (snr_th[last], snr_th[last + 1] + hyst or NaN).
__device__ __forceinline__ int step(State& s, float x, bool m, float2 r, int decision_th) {
    return advance(s, x < r.x, x > r.y, m, decision_th);
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

// ---- the map ----------------------------------------------------------------

// The frame's code at the rung r: 1 down, 2 up, 0 neither (down first, as
// the step takes it).
__device__ __forceinline__ uint32_t code_of(float x, float2 r) { return x < r.x ? 1u : (x > r.y ? 2u : 0u); }

// One frame given as its word: the step at the active id's code.
__device__ __forceinline__ int advance_word(State& s, uint32_t w, int decision_th) {
    const uint32_t k = (w >> (2 * s.last)) & 3u;
    return advance(s, k == 1u, k == 2u, k != 3u, decision_th);
}

// The canonical index of a state, or -1 if it has none (header comment).
__device__ __forceinline__ int canonical(const State& a, int n, int thp) {
    const int down = a.last > 0 ? a.last - 1 : 0;
    if (a.cand == down || a.cand == a.last + 1) {
        if (a.counter < 0 || a.counter >= thp) return -1;
        return (a.counter * 2 + (a.cand != down)) * n + a.last;
    }
    if (a.counter != 0) return -1;
    return 2 * n * thp + (a.cand == a.last ? 0 : n) + a.last;
}

// The state of canonical index s; `other` is the cand of the "other" class.
__device__ __forceinline__ State decode(int s, int n, int thp, int other) {
    const int du = 2 * n * thp;
    if (s < du) {
        const int q = s / n, l = s - q * n;
        return State{l, (q & 1) ? l + 1 : (l > 0 ? l - 1 : 0), q >> 1};
    }
    const int r = s - du, l = r < n ? r : r - n;
    return State{l, r < n ? l : other, 0};
}

// A packed state: the byte offset of its entry in a row of the table (2 s)
// above 5 bits of twice its id (the shift of its code in a frame word).
__device__ __forceinline__ uint32_t pack(int s, int n, int thp) {
    const int du = 2 * n * thp;
    const int l = s < du ? s % n : (s - du) % n;
    return ((uint32_t)(2 * s) << 5) | (uint32_t)(2 * l);
}

// kChunk frames from the packed state v through the table next (rows of
// row_bytes, one a code), their words read four at a time: returns the
// exit.  A step's chain is a rotate, an and, a multiply-add and the load.
// kEmit: the frames' ids, a byte each, gathered in registers and written to
// ids (16-byte aligned) at the end.
template <bool kEmit>
__device__ __forceinline__ uint32_t walk_table(uint32_t v, const uint4* __restrict__ w4,
                                               const unsigned char* __restrict__ next, int row_bytes,
                                               uint4* ids) {
    uint32_t got[kChunk / 4];
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
        const uint4 u = w4[q];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
        got[q] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            v = *(const uint16_t*)(next + (__funnelshift_r(w[j], w[j], v) & 3u) * row_bytes + (v >> 5));
            got[q] |= ((v & 31u) >> 1) << (8 * j);
        }
    }
    if (kEmit) {
#pragma unroll
        for (int h = 0; h < kChunk / 16; ++h)
            ids[h] = make_uint4(got[4 * h], got[4 * h + 1], got[4 * h + 2], got[4 * h + 3]);
    }
    return v;
}

// Shared memory of a map block, in bytes from its start: next [4][H]
// (packed states; first, so that a step's load needs no base); the frame
// words [kTileChunks][kChunkStride]; the map [chunks][H] (row indices:
// chunk c's exit of state s is the index (c + 1) H + s' of the next chunk's
// row); the chain's entry of each chunk, a row index or -1 [kTileChunks],
// and an odd carry's exact state [kTileChunks]; whether a chunk has a frame
// not masked [kTileChunks]; the ids of a tile [kTile]; the rungs
// [kMapRungs].
struct MapLayout {
    size_t words, map, entry, exact, live, ids, rungs, total;
};

__host__ __device__ inline MapLayout map_layout(int states, int chunks) {
    MapLayout m;
    m.words = ((size_t)4 * states * sizeof(uint16_t) + 15) / 16 * 16;
    m.map = m.words + (size_t)kTileChunks * kChunkStride * sizeof(uint32_t);
    m.entry = (m.map + (size_t)chunks * states * sizeof(uint16_t) + 15) / 16 * 16;
    m.exact = m.entry + kTileChunks * sizeof(int);
    m.live = m.exact + kTileChunks * sizeof(int4);
    m.ids = m.live + kTileChunks * sizeof(int);
    m.rungs = m.ids + kTile;
    m.total = m.rungs + kMapRungs * sizeof(float2);
    return m;
}

// Chunks of the first tile of T frames.
__host__ __device__ inline int tile_chunks(int T) { return ((T < kTile ? T : kTile) + kChunk - 1) / kChunk; }

// The chain's canonical index of a carry: its own, or, for a carry whose
// cand is neither candidate and whose counter is not 0, that of the same
// state with counter 0, the counter kept in *pend: the two walk alike, since
// the first frame not masked zeroes the counter either way; -1 (walk it
// exactly) for a down or up candidate with a counter out of range.
__device__ __forceinline__ int enter(const State& a, int n, int thp, int* pend) {
    const int down = a.last > 0 ? a.last - 1 : 0;
    *pend = 0;
    if (a.cand == down || a.cand == a.last + 1 || a.counter == 0) return canonical(a, n, thp);
    *pend = a.counter;
    return canonical(State{a.last, a.cand, 0}, n, thp);
}

__global__ void __launch_bounds__(kMapThreads)
    feedback_scan_map_kernel(const float* __restrict__ snr, const uint8_t* __restrict__ mask,
                             long long mask_t_stride, long long mask_b_stride, const float* __restrict__ snr_th,
                             int n, float hyst, int decision_th, const int* __restrict__ last_in,
                             const int* __restrict__ cand_in, const int* __restrict__ counter_in, int T, int B,
                             int* __restrict__ mcs, int* __restrict__ state_out) {
    const int thp = decision_th > 1 ? decision_th : 1;
    const int H = n * (2 * thp + 2);
    const MapLayout lay = map_layout(H, tile_chunks(T));
    extern __shared__ __align__(16) unsigned char smem[];
    uint16_t* next = (uint16_t*)smem;
    uint32_t* words = (uint32_t*)(smem + lay.words);
    uint16_t* map = (uint16_t*)(smem + lay.map);
    int* entry = (int*)(smem + lay.entry);
    int4* exact = (int4*)(smem + lay.exact);
    int* live = (int*)(smem + lay.live);
    uint8_t* ids = smem + lay.ids;
    float2* rungs = (float2*)(smem + lay.rungs);
    const int b = blockIdx.x;
    const int f = threadIdx.x;  // the frame of a tile a thread stages and writes

    // every global read of the prologue in flight at once: each thread's
    // frame of the first tile, the carry, the thresholds
    float x = 0.0f;
    bool m = false;
    auto load = [&](int t0) {
        m = false;
        if (f < min(kTile, T - t0)) {
            const long long t = t0 + f;
            x = snr[t * B + b];
            m = mask == nullptr || mask[t * mask_t_stride + b * mask_b_stride] != 0;
        }
    };
    load(0);
    State a{0, 0, 0};
    if (threadIdx.x == 0) a = State{last_in[b], cand_in[b], counter_in[b]};
    float lo = 0.0f, hi = 0.0f;
    if (f < n) {
        lo = snr_th[f];
        hi = f + 1 < n ? snr_th[f + 1] : 0.0f;
    }
    for (int e = threadIdx.x; e < 4 * H; e += blockDim.x) {  // next[code][s] by the walk's step
        const int k = e / H;
        State r = decode(e - k * H, n, thp, -1);
        advance(r, k == 1, k == 2, k != 3, decision_th);
        const int s2 = canonical(r, n, thp);
        if (s2 < 0) __trap();  // cannot happen: a canonical state steps to a canonical one
        next[e] = (uint16_t)pack(s2, n, thp);
    }
    if (f < n) rungs[f] = make_float2(lo, f + 1 < n ? __fadd_rn(hi, hyst) : __int_as_float(0x7fc00000));
    // the chain's carry (thread 0): canonical (s; the "other" class's cand;
    // a counter to keep until a frame is not masked) or exact (a)
    int s = -1, other = 0, pend = 0;
    if (threadIdx.x == 0) {
        if (a.last < 0 || a.last >= n) __trap();
        s = enter(a, n, thp, &pend);
        other = a.cand;
    }

    for (int t0 = 0; t0 < T; t0 += kTile) {
        const int len = min(kTile, T - t0);
        const int nch = len / kChunk + (len % kChunk != 0);
        __syncthreads();  // the rungs and the table are in; the last tile's ids are out
        // 1. stage the frame words; a chunk is a warp's frames
        if (f < nch * kChunk) {
            uint32_t w = kMasked;
            if (m) {
                w = 0;
                for (int l = 0; l < n; ++l) w |= code_of(x, rungs[l]) << (2 * l);
            }
            words[(f / kChunk) * kChunkStride + f % kChunk] = w;
            const unsigned any = __ballot_sync(0xffffffffu, w != kMasked);
            if (f % kChunk == 0) live[f / kChunk] = any != 0;
        }
        __syncthreads();
        // 2. the map: every (chunk, state) pair, states of a chunk side by side
        for (int task = threadIdx.x; task < nch * H; task += blockDim.x) {
            const int c = task / H;
            const uint32_t v = walk_table<false>(pack(task - c * H, n, thp), (const uint4*)(words + c * kChunkStride),
                                                 smem, 2 * H, nullptr);
            map[task] = (uint16_t)((c + 1) * H + (v >> 6));
        }
        __syncthreads();
        if (t0 + kTile < T) load(t0 + kTile);  // the next tile's frames, in flight beside the chain and emit
        // 3. the chain
        if (threadIdx.x == 0) {
            int c = 0;
            for (; c < nch && s < 0; ++c) {  // an odd carry: chunks exactly, until it is canonical
                entry[c] = -1;
                exact[c] = make_int4(a.last, a.cand, a.counter, 0);
                const uint32_t* wp = words + c * kChunkStride;
#pragma unroll 8
                for (int k = 0; k < kChunk; ++k) advance_word(a, wp[k], decision_th);
                s = enter(a, n, thp, &pend);
                other = a.cand;
            }
            if (s >= 0) {
                const int c0 = c;
                int row = c * H + s;
                for (; c < nch && c % 4 != 0; ++c) {  // a lookup a chunk
                    entry[c] = row;
                    row = map[row];
                }
                for (; c + 4 <= nch; c += 4) {  // four at a time, their entries in one store
                    int4 r;
                    r.x = row;
                    r.y = row = map[row];
                    r.z = row = map[row];
                    r.w = row = map[row];
                    row = map[row];
                    *(int4*)(entry + c) = r;
                }
                for (; c < nch; ++c) {
                    entry[c] = row;
                    row = map[row];
                }
                s = row - nch * H;
                for (c = c0; c < nch; ++c) pend = live[c] ? 0 : pend;
            }
            if (t0 + kTile >= T) {
                State fin = a;
                if (s >= 0) {
                    fin = decode(s, n, thp, other);
                    fin.counter = s >= 2 * n * thp ? pend : fin.counter;
                }
                state_out[b] = fin.last;
                state_out[B + b] = fin.cand;
                state_out[2 * B + b] = fin.counter;
            }
        }
        __syncthreads();
        // 4. emit: each chunk again from its true entry, its ids into shared memory
        for (int c = threadIdx.x; c < nch; c += blockDim.x) {
            const int e = entry[c];
            const uint32_t* wp = words + c * kChunkStride;
            if (e >= 0) {
                walk_table<true>(pack(e - c * H, n, thp), (const uint4*)wp, smem, 2 * H, (uint4*)(ids + c * kChunk));
            } else {
                const int4 q = exact[c];
                State st{q.x, q.y, q.z};
                for (int k = 0; k < kChunk; ++k) ids[c * kChunk + k] = (uint8_t)advance_word(st, wp[k], decision_th);
            }
        }
        __syncthreads();
        if (f < len) mcs[(long long)(t0 + f) * B + b] = ids[f];
    }
}

}  // namespace

// snr [T, B] float32, mask [T, B] bytes at the given strides (in elements)
// or null (every frame counts), snr_th [>= n_mcs] float32, the state's three
// int32 [B] vectors with last in [0, n_mcs); writes mcs [T, B] int32 and
// state_out [3, B] int32 (last, cand, counter).  design 0 is the walk, 1 the
// map (n_mcs <= kMapRungs and n_mcs (2 max(decision_th, 1) + 2) <=
// kMaxStates).  Returns the CUDA error of the launch.
extern "C" int feedback_scan_launch(const void* snr, const void* mask, long long mask_t_stride,
                                    long long mask_b_stride, const void* snr_th, int n_mcs, float hyst,
                                    int decision_th, const void* last, const void* cand,
                                    const void* counter, int T, int B, void* mcs, void* state_out,
                                    int design, void* stream) {
    if (T < 0 || B < 1 || n_mcs < 1 || n_mcs > kMaxRungs || design < 0 || design > 1)
        return (int)cudaErrorInvalidValue;
    if (design == 0) {
        const int threads = B < kMaxThreads ? ((B + 31) / 32) * 32 : kMaxThreads;
        const int blocks = (B + threads - 1) / threads;
        feedback_scan_kernel<<<blocks, threads, (size_t)n_mcs * sizeof(float2), (cudaStream_t)stream>>>(
            (const float*)snr, (const uint8_t*)mask, mask_t_stride, mask_b_stride, (const float*)snr_th, n_mcs,
            hyst, decision_th, (const int*)last, (const int*)cand, (const int*)counter, T, B, (int*)mcs,
            (int*)state_out);
        return (int)cudaGetLastError();
    }
    const long long thp = decision_th > 1 ? decision_th : 1;
    const long long H = (long long)n_mcs * (2 * thp + 2);
    if (n_mcs > kMapRungs || H > kMaxStates || T < 1) return (int)cudaErrorInvalidValue;
    const long long tasks = tile_chunks(T) * H;  // at least a thread a frame of a tile
    const long long want = tasks > 32LL * tile_chunks(T) ? (tasks + 31) / 32 * 32 : 32LL * tile_chunks(T);
    const int threads = want < kMapThreads ? (int)want : kMapThreads;
    feedback_scan_map_kernel<<<B, threads, map_layout((int)H, tile_chunks(T)).total, (cudaStream_t)stream>>>(
        (const float*)snr, (const uint8_t*)mask, mask_t_stride, mask_b_stride, (const float*)snr_th, n_mcs, hyst,
        decision_th, (const int*)last, (const int*)cand, (const int*)counter, T, B, (int*)mcs, (int*)state_out);
    return (int)cudaGetLastError();
}
