// The pilot-aided decision-directed equalizer recurrence as one CUDA kernel.
//
// What it replaces.  The JAX package writes the recurrence as a lax.scan over
// the symbols of a frame (unroll=4), which XLA compiles into the receive step
// (there is no Pallas kernel for it):
//   gr_dtl_tpu/ops/equalizer.py::equalize_frame (step at :162-179, the
//   frozen-taps branch at :131-160).
// In eager PyTorch that scan is a Python loop of ~90 small launches a symbol,
// ~3,700 a receive step.  Its plain PyTorch version is
// gr_dtl_tpu_torch/ops/equalizer.py::_equalize_frame_torch.
//
// What it computes.  Per frame row b, with the taps H [fft_len] carried over
// the symbols s = 0 .. n_sym-1 in order, per carrier:
//   eqd  = Y[b, s] / H;
//   dec  = the nearest point to eqd of the row's constellation (BPSK for the
//          first n_hdr symbols of the call, else cnst_id[b]: 2 QPSK, 3 8PSK,
//          4 16QAM, anything else BPSK), by the closed-form slicers;
//   ref  = the known pilot value on pilot carriers, else dec;
//   H    = alpha H + (1 - alpha) Y / ref_safe   on occupied and pilot carriers
//          (ref_safe = ref, or 1 where ref is 0); idle carriers keep H;
//   hard[b, s] = ref, soft[b, s] = eqd;
//   the row's sums of |eqd - pilot|^2 and |pilot|^2 over pilot carriers give
//   noise_var = max(sum / tot, 1e-12) and snr_db = 10 log10(sig_pw / noise_var).
// With `frozen` the update is switched off (the reference's branch from
// alpha >= 0.9995 on) and no taps are written.
//
// Table mode (wire-compat tables: foreign label -> point layouts, for which
// the closed-form slicers do not hold): dec is the table argmin of
// ops/constellation.py::nearest_point_table instead, the first of the valid
// points of the symbol's constellation row (2^id of them; bits per symbol
// equal the id) at the least dr*dr + di*di, a NaN counting as the least, as
// torch.argmin counts it; id 0, and any id outside 1..4, has no valid point
// and decides the row-0 point 0.  It is the second instantiation of the same
// kernel (kTable).
//
// What bounds it.  Bytes: a row reads n_sym x fft_len spectra and writes twice
// as much (hard and soft), 24 bytes a carrier and symbol: 65.0 MB at B = 2048,
// n_sym = 20, fft_len = 64, 19.4 us at 3.35 TB/s.  What stands in the way of
// that bound is the recurrence: 20 dependent steps a row, each a complex
// division and a decision deep; and, when every row is resident at once (B =
// 2048: ~31 warps an SM), what a step issues.
//
// Design.  One thread a carrier: a frame row is fft_len / 32 warps, a block
// holds 128 / fft_len rows (one, from fft_len 128 on), so every load and store
// of a warp is one run of 256 contiguous bytes.  H, the masks and the pilot
// sums stay in registers across all symbols; the sums are reduced once, at the
// end (shuffles, then one value a warp through shared memory).
//
// The update's division Y' / ref_safe has a divisor that is always one of a
// few values: a point of the row's constellation, a pilot value, or 1.  In
// c10's scaled division the ratio, the scale and the |c| >= |d| select depend
// on the divisor alone (`divisor` below), so each warp works them out once,
// before the steps, by the same operations, and a step only applies them
// (`divide`): the step's chain is one division (Y / H, whose divisor is the
// carry), the slicer, one shared-memory load and a few multiply-adds.  The
// warp's table in shared memory holds, an entry a value: the row's payload
// points (entries 0-15, in each slicer's own index order), BPSK's two points
// for the header symbols (16, 17), and the values of the warp's pilot
// carriers for the next symbols (after them: entry (s - s0) P + j for its j-th
// pilot, P the least power of two at or above its pilot count, refilled when
// the steps reach the end of what they hold), each with its ratio and scale (a
// value 0 with those of 1, as ref_safe substitutes) and beside them |pilot|^2
// and the select.  Each slicer yields the index of its decision (BPSK and
// QPSK from the sign bits, 8PSK the ring position, 16QAM the two axis levels,
// table mode the first minimum); a pilot carrier reads its pilot's entry
// instead; the one load gives the hard output and the update's constants.
// The constellation is one value a row, so each has a step loop of its own
// (after the header's BPSK steps), with no switch in the step; table mode's
// argmin reads the row's points two at a time, the same address in every lane
// (a broadcast), its groups of four unrolled.  The step holds no branch but
// the divisions' own slow paths: c10's zero divisor (a / +0 is a times +inf)
// and the pilot sums are selects.
//
// The spectra do not depend on the carry: each step copies the symbol kAhead
// steps on into a lane's ring in shared memory (cp.async, LDGSTS: no register
// holds it in flight) and waits for the copy of its own symbol only.  A ring of
// registers shifted down a slot a step, as before, moved each slot once its
// load was in, so every step waited on the load issued the step before.
//
// The receiver's first call, of one header symbol, is one step that divides
// as the plain loop does, with no tables and no shared memory: for one step
// the tables cost more than they save (with them that call took 5.6 against
// 4.2 us at B = 2048).  `spectra` may be a strided view (row and symbol
// strides in elements, unit stride along the carriers); everything written is
// contiguous, at 32-bit offsets from the row's first output.
//
// (On an NVIDIA H100 80GB HBM3 at 700 W, tools/bench_equalizer.py, the payload
// call of 20 symbols at B = 2048 / 1024 / 1, profiler device time.  The
// first design, a warp a row with two carriers a lane, the division as c10
// branches it and the pilot value loaded inside the step: 75.9 us at B = 2048,
// 43.6 at B = 1, 2.2 us a dependent step.  The second, a thread a carrier with
// both divisions, the decided point fed to the second and a switch on the
// constellation in the step: 37.1 / 27.7 / 16.2 us, 171 instructions a step
// over mixed ids, 4 MUFU.RCP.  This design: 30.1 / 15.8 / 9.2 us (in turns
// with the last), 133 instructions a step (BPSK or QPSK 120, 16QAM 127, 8PSK
// 166), 2 MUFU.RCP (8PSK's atan2f 2 more), 55 registers, 9 blocks an SM; table
// mode 43.4 / 27.2 / 10.2 us against 61.4 / 45.0 / 18.6; the header call 4.1 /
// 3.4 / 2.4 us against 4.2 / 3.5 / 2.7.  On the way: the tables with the
// register ring, 33.7 us at B = 2048 and 12.4 at B = 1.  The alternatives, in
// turns (--variants; the design's own 30.0-30.1 / 15.8-15.9 / 9.2-9.2 us,
// table mode 43.5-43.6): copying 3 symbols ahead 30.1-30.5 / 16.1-16.1 /
// 9.1-9.2, table 43.6-43.8; 6 ahead in a ring of 8 30.0-30.2 / 16.7-16.7 /
// 9.1-9.3, table 44.8-44.9; table mode's groups of four one at a time 46.3;
// the outputs by 64-bit pointers stepped a symbol (more instructions) 29.8-30.1
// / 15.9-16.1 / 9.3-9.3, within the turns' spread but at B = 1.)
//
// Arithmetic.  The plain version runs as a chain of PyTorch kernels, each
// rounding its result to float32, and the decisions feed back into H, so the
// kernel rounds where that chain rounds: every product or sum that PyTorch
// computes in a kernel of its own is an __fmul_rn / __fadd_rn here (never
// contracted into an FMA across two of PyTorch's kernels), a tensor divided by
// a Python scalar is a product with the reciprocal, torch.round is
// nearbyintf, `% 8` of an int32 is the floor modulo, and atan2f / cosf / sinf
// / log10f are the accurate ones (no --use_fast_math).  Inside one PyTorch
// kernel (the complex division and the complex product of c10::complex) the
// expressions are written as c10 writes them and left to the compiler's FMA
// contraction, as they are in PyTorch's build.  The tabled constants are those
// expressions evaluated early, so the outputs do not change by tabling them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern __shared__ float4 smem[];  // the block's dynamic shared memory: kWarpFloat4s a warp

namespace {

constexpr int kBlockThreads = 128;  // a block: 128 / fft_len rows, or one longer row
constexpr int kMaxFftLen = 256;     // the longest row a block takes
constexpr int kAhead = 2;           // symbols copied into shared memory ahead of their step
constexpr int kRing = 4;            // slots of a lane's ring of symbols (a power of two > kAhead)
constexpr int kMaxPoints = 16;      // a row of the point table (MAX_POINTS)
constexpr int kTypes = 5;           // rows of the point table (N_TYPES)
constexpr int kHdrEntry = 16;       // a warp table's entries 16, 17: BPSK's points
constexpr int kPointEntries = 18;   // the payload row's 16 and BPSK's 2
constexpr int kPilotEntries = 46;   // pilot values of the warp's carriers, for the next symbols
constexpr int kEntries = kPointEntries + kPilotEntries;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRing > kAhead && (kRing & (kRing - 1)) == 0, "the ring's slot is s & (kRing - 1)");
static_assert(kPilotEntries >= 32 && kPilotEntries <= 64, "a fill takes two rounds of a warp's lanes");

// The slicers' constants, float32 as ops/constellation.py rounds them.
constexpr float kQpskAmp = 0.353553385f;     // float32(0.5 * sqrt(2) / 2)
constexpr float kFourOverPi = 1.27323949f;   // float32(4 / pi)
constexpr float kPiOverFour = 0.785398185f;  // float32(pi / 4)
constexpr float kQamLevel = 0.316227764f;    // float32(1) / sqrt(float32(10))
constexpr float kQamTwoLevel = 0.632455528f; // float32(2) * kQamLevel
constexpr float kQamInvTwoLevel = 1.0f / kQamTwoLevel;

// A warp's part of the block's shared memory (the design note), in float4s:
// the table's entries (point or pilot value, ratio, scale of its ref_safe),
// beside them (|pilot value|^2, or 0 for a point; 1 where |re| >= |im|, else
// 0), the points alone two a float4 (table mode's argmin), and the ring of
// the lanes' next symbols, kRing slots of 32.
constexpr int kEntryAt = 0;
constexpr int kSideAt = kEntryAt + kEntries;            // float2s, two a float4
constexpr int kPairAt = kSideAt + kEntries / 2;
constexpr int kRingAt = kPairAt + kPointEntries / 2;    // float2s
constexpr int kWarpFloat4s = kRingAt + kRing * 32 / 2;
static_assert(kEntries % 2 == 0 && kPointEntries % 2 == 0, "float2 arrays of whole float4s");

__device__ __forceinline__ float4& entry_at(int w, int e) { return smem[w + kEntryAt + e]; }
__device__ __forceinline__ float2& side_at(int w, int e) { return reinterpret_cast<float2*>(smem + w + kSideAt)[e]; }
__device__ __forceinline__ float2& point_at(int w, int e) { return reinterpret_cast<float2*>(smem + w + kPairAt)[e]; }
__device__ __forceinline__ float2& ring_at(int w, int slot, int lane) {
    return reinterpret_cast<float2*>(smem + w + kRingAt)[slot * 32 + lane];
}

// An asynchronous copy of one complex64 from global to shared memory (LDGSTS,
// bypassing registers), its group's commit, and a wait for all but the newest
// n groups of this thread.
__device__ __forceinline__ void copy_async(float2* dst, const float2* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src) : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// x / y as c10::complex<float>::operator/= computes it (the scaled form:
// one ratio, one reciprocal), with selects where c10 branches on
// |c| >= |d|: p is the larger of c and d, q the other, and
//   |c| >= |d|:  ((a + b rat) scl, (b - a rat) scl),  rat = d / c, scl = 1 / (c + d rat)
//   otherwise:   ((a rat + b) scl, (b rat - a) scl),  rat = c / d, scl = 1 / (d + c rat)
// are both (x2 + x1 rat) scl, (y2 + y1 rat) scl.  `divisor` is what depends on
// y alone, `divide` the rest.  Each sum of a product is left to the compiler's
// contraction, as in PyTorch's build.
struct Divisor {
    float rat, scl;
    bool c_larger;
};

__device__ __forceinline__ Divisor divisor(float2 y) {
    const float c = y.x, d = y.y;
    const bool c_larger = fabsf(c) >= fabsf(d);
    const float p = c_larger ? c : d, q = c_larger ? d : c;
    const float rat = q / p;
    return {rat, 1.0f / (p + q * rat), c_larger};
}

__device__ __forceinline__ float2 divide(float2 x, Divisor v) {
    const float a = x.x, b = x.y;
    const float x1 = v.c_larger ? b : a, x2 = v.c_larger ? a : b;
    const float y1 = v.c_larger ? -a : b, y2 = v.c_larger ? b : -a;
    return make_float2((x2 + x1 * v.rat) * v.scl, (y2 + y1 * v.rat) * v.scl);
}

// a / +0, as c10 divides by |c| = 0: an infinity of a's sign, or a NaN
// where a is 0 or a NaN, which is a times +inf
__device__ __forceinline__ float over_zero(float a) { return __fmul_rn(a, INFINITY); }

__device__ __forceinline__ float2 cdiv(float2 x, float2 y) {
    const float2 r = divide(x, divisor(y));
    // y == 0: c10 returns (a / |c|, b / |d|); a select, no branch in the step
    return (y.x == 0.f && y.y == 0.f) ? make_float2(over_zero(x.x), over_zero(x.y)) : r;
}

// the plain loop's ref_safe: a reference of 0 divides as 1
__device__ __forceinline__ float2 ref_safe(float2 r) {
    return (r.x != 0.f || r.y != 0.f) ? r : make_float2(1.f, 0.f);
}

// One axis of the 16QAM slicer: the level clamp(floor(x / 2l + 2), 0, 3); its
// point is l (2u - 3).
__device__ __forceinline__ int qam16_level(float x) {
    return (int)fminf(fmaxf(floorf(__fadd_rn(__fmul_rn(x, kQamInvTwoLevel), 2.0f)), 0.0f), 3.0f);
}

// The closed-form slicers of ops/constellation.py::nearest_point, each giving
// the warp table's entry of its decision.  An entry's point is the one the
// slicer decides: entry i of a row holds point i in the slicer's order
// (table_point).
struct Bpsk {  // ids outside 2..4 too, and the header symbols
    __device__ __forceinline__ int operator()(float2 y) const { return kHdrEntry + (y.x > 0.f); }
};
struct Qpsk {
    __device__ __forceinline__ int operator()(float2 y) const { return (y.x > 0.f) | (y.y > 0.f) << 1; }
};
struct Psk8 {  // the ring position, floor modulo 8
    __device__ __forceinline__ int operator()(float2 y) const {
        return (int)nearbyintf(__fmul_rn(atan2f(y.y, y.x), kFourOverPi)) & 7;
    }
};
struct Qam16 {
    __device__ __forceinline__ int operator()(float2 y) const { return qam16_level(y.x) + 4 * qam16_level(y.y); }
};

// Entry i's point of the closed-form slicers for a row of id cid: entries
// 16, 17 and every id outside 2..4 BPSK's -1, +1 (by the sign bit); QPSK
// (+-a, +-a) by bits 0 and 1; 8PSK cos / sin of pos (pi / 4) (accurate cosf /
// sinf, as PyTorch's); 16QAM l (2u - 3), l (2v - 3) for i = u + 4v.
__device__ __forceinline__ float2 table_point(int i, int cid) {
    if (i < kHdrEntry) {
        switch (cid) {
            case 2: return make_float2(i & 1 ? kQpskAmp : -kQpskAmp, i & 2 ? kQpskAmp : -kQpskAmp);
            case 3: {
                const float pang = __fmul_rn((float)(i & 7), kPiOverFour);
                return make_float2(cosf(pang), sinf(pang));
            }
            case 4:
                return make_float2(__fmul_rn(kQamLevel, (float)(2 * (i & 3) - 3)),
                                   __fmul_rn(kQamLevel, (float)(2 * ((i >> 2) & 3) - 3)));
            default: break;
        }
    }
    return make_float2(i & 1 ? 1.0f : -1.0f, 0.0f);
}

// The table-mode slicer over entries kBase .. kBase + N - 1 (the row's valid
// points).  The distances are three of PyTorch's kernels and the sum a fourth,
// each rounding: no FMA.  The points go in groups of four: a group's distances
// are independent and computed side by side, its first minimum taken by a tree
// of pairs, then held against the best of the groups before it.  Lower
// indices are always on the left, and the right one wins only when strictly
// nearer, or a NaN against a number (torch.argmin counts a NaN as the least):
// the sequential first-minimum rule.  N = 0 (no valid point) decides entry
// kBase, the row-0 point 0.  The points come two at a time from the warp's
// table, the same address in every lane (a broadcast load).  (NVIDIA H100 80GB
// HBM3, 700 W, the second design, the points read by shuffle, payload call at
// B = 1 / 32 / 1024 / 2048 with mixed ids: a loop over the points, one at a time,
// took 19.4 / 37.2 / 47.1 / 63.4 us; all 16 side by side 18.0 / 29.2 / 40.0 /
// 76.6, 89 registers halving the blocks an SM holds; groups of four, one at a
// time, 57 registers, 18.5 / 34.4 / 44.8 / 61.1.  In this design the groups
// are unrolled: see the design note.)
struct Candidate {
    float d2;
    int entry;
};

__device__ __forceinline__ Candidate first_min(Candidate lo, Candidate hi) {
    const bool take_hi = hi.d2 < lo.d2 || (isnan(hi.d2) && !isnan(lo.d2));
    return take_hi ? hi : lo;
}

__device__ __forceinline__ Candidate candidate(float2 y, float px, float py, int entry) {
    const float dr = __fsub_rn(y.x, px), di = __fsub_rn(y.y, py);
    return {__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di)), entry};
}

template <int N, int kBase>
struct TableSlicer {
    int w;  // the warp's part of shared memory
    __device__ __forceinline__ int operator()(float2 y) const {
        if constexpr (N == 0) {
            return kBase;
        } else {
            constexpr int G = N < 4 ? N : 4;
            Candidate best;
#pragma unroll
            for (int g = 0; g < N; g += G) {
                Candidate c[G];
#pragma unroll
                for (int j = 0; j < G; j += 2) {
                    const float4 two = smem[w + kPairAt + (kBase + g + j) / 2];  // the same address in every lane
                    c[j] = candidate(y, two.x, two.y, kBase + g + j);
                    c[j + 1] = candidate(y, two.z, two.w, kBase + g + j + 1);
                }
#pragma unroll
                for (int span = 1; span < G; span *= 2) {
#pragma unroll
                    for (int j = 0; j + span < G; j += 2 * span) c[j] = first_min(c[j], c[j + span]);
                }
                best = g == 0 ? c[0] : first_min(best, c[0]);
            }
            return best.entry;
        }
    }
};

// |z|^2 for the pilot sums.  torch.abs(z) ** 2 is hypotf squared; the sums are
// taken in another order than PyTorch's anyway (agreement within rtol 1e-4), so
// the two squares are summed directly, with hypot's rule that an infinite part
// wins over a NaN (a frame slot of idle air has zero taps: the plain loop's
// noise variance there is inf or NaN, and the kernel's is the same).
__device__ __forceinline__ float abs2(float zr, float zi) {
    const float sq = fmaf(zr, zr, zi * zi);
    return (isinf(zr) | isinf(zi)) ? INFINITY : sq;  // no branch
}

// torch.clamp(x, min=lo): a NaN stays a NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    return v;
}

// the position of the j-th (from 0) set bit of m
__device__ __forceinline__ int nth_bit(unsigned m, int j) {
#pragma unroll 1
    for (int i = 0; i < j; ++i) m &= m - 1;
    return __ffs(m) - 1;
}

// a call of one header symbol and no other: one step, no tables
__host__ __device__ __forceinline__ bool one_header_step(int n_sym, int n_hdr) { return n_sym == 1 && n_hdr == 1; }

// one entry of a warp's table: v's ratio and scale (of 1 for a v of 0) beside v
__device__ __forceinline__ void put_entry(int w, int e, float2 v, float sq) {
    const Divisor dv = divisor(ref_safe(v));
    entry_at(w, e) = make_float4(v.x, v.y, dv.rat, dv.scl);
    side_at(w, e) = make_float2(sq, dv.c_larger ? 1.f : 0.f);
}

template <bool kTable>
__global__ void __launch_bounds__(kMaxFftLen) equalizer_kernel(
    const float2* __restrict__ spectra, long long row_stride, long long sym_stride,
    const float2* __restrict__ taps_in, const int* __restrict__ cnst_id,
    const uint8_t* __restrict__ occ_mask, const uint8_t* __restrict__ pilot_mask,
    const float2* __restrict__ pilot_vals, int B, int n_sym, int fft_len, int n_hdr, float alpha,
    float one_minus_alpha, int frozen, float inv_tot, float2* __restrict__ hard,
    float2* __restrict__ soft, float2* __restrict__ taps_out, float* __restrict__ snr_db,
    float* __restrict__ noise_var, const float2* __restrict__ points, int rows_per_block) {
    __shared__ float warp_err2[kMaxFftLen / 32], warp_sig2[kMaxFftLen / 32];
    // this thread's row of the block (at most four, fft_len >= 32) and its carrier
    const int r = (threadIdx.x >= fft_len) + (threadIdx.x >= 2 * fft_len) + (threadIdx.x >= 3 * fft_len);
    const int k = threadIdx.x - r * fft_len;
    const int row = blockIdx.x * rows_per_block + r;
    const int lane = threadIdx.x & 31;
    const int w = (threadIdx.x >> 5) * kWarpFloat4s;  // the warp's part of shared memory
    const bool active = row < B;  // a row past the batch waits at the barrier, no more

    float err2 = 0.f, sig2 = 0.f;  // this carrier's share of the row's pilot sums
    if (active) {
        const float2* y_next = spectra + (size_t)row * row_stride + k;  // this carrier's next symbol
        float2 H = taps_in[(size_t)row * fft_len + k];
        const bool is_pil = pilot_mask[k] != 0;
        const bool upd = is_pil || occ_mask[k] != 0;
        const int cid = cnst_id[row];
        // this carrier's outputs: symbol s's at [out], out = s fft_len (32 bits)
        float2* hard_row = hard + (size_t)row * n_sym * fft_len + k;
        float2* soft_row = soft + (size_t)row * n_sym * fft_len + k;
        int out = 0;
        // a step after its decision: the pilot sums, the update (ref: the hard
        // output, the decided point or the pilot value; dv: the divisor of the
        // update's (1 - alpha) Y / ref_safe; sq: |pilot value|^2 on pilot
        // carriers, else 0) and the outputs
        auto finish = [&](float2 Y, float2 eqd, float2 ref, Divisor dv, float sq) {
            err2 += is_pil ? abs2(__fsub_rn(eqd.x, ref.x), __fsub_rn(eqd.y, ref.y)) : 0.f;
            sig2 += sq;
            if (!frozen) {
                // (1 - alpha) * Y, then / ref_safe, then alpha * H + that: three of
                // PyTorch's kernels and a fourth for the sum, each rounding
                const float2 d = divide(make_float2(__fmul_rn(Y.x, one_minus_alpha),
                                                    __fmul_rn(Y.y, one_minus_alpha)), dv);
                const float2 Hn = make_float2(__fadd_rn(__fmul_rn(H.x, alpha), d.x),
                                              __fadd_rn(__fmul_rn(H.y, alpha), d.y));
                H = upd ? Hn : H;
            }
            hard_row[out] = ref;
            soft_row[out] = eqd;
            out += fft_len;
        };

        if (one_header_step(n_sym, n_hdr)) {
            // The receiver's first call, one header symbol: one BPSK step that
            // divides as the plain loop does; tables would cost it more than
            // they save (and the launch gives it no shared memory).
            const float2 Y = *y_next;
            const float2 pv = is_pil ? pilot_vals[k] : make_float2(0.f, 0.f);
            float2 p0 = make_float2(-1.f, 0.f), p1 = make_float2(1.f, 0.f);  // BPSK's points
            if constexpr (kTable) {
                p0 = points[kMaxPoints];
                p1 = points[kMaxPoints + 1];
            }
            const float2 eqd = cdiv(Y, H);
            const bool second = kTable ? first_min(candidate(eqd, p0.x, p0.y, 0), candidate(eqd, p1.x, p1.y, 1)).entry
                                       : eqd.x > 0.f;
            const float2 ref = is_pil ? pv : (second ? p1 : p0);
            finish(Y, eqd, ref, divisor(ref_safe(ref)), is_pil ? abs2(pv.x, pv.y) : 0.f);
        } else {
            // the first kAhead symbols into the ring now, a group each
#pragma unroll
            for (int a = 0; a < kAhead; ++a) {
                if (a < n_sym) copy_async(&ring_at(w, a, lane), y_next);
                copy_commit();
                y_next += sym_stride;
            }
            // table mode: the row of the point table its id selects (0: no valid point)
            const int type = (cid >= 1 && cid < kTypes) ? cid : 0;

            // the warp's pilot carriers, this lane's rank among them, and the pilot
            // entries' layout: entry (s - s0) P + j is symbol s's value on the warp's
            // j-th pilot carrier, P the least power of two >= the warp's pilots, for
            // `chunk` symbols from s0 on; a fill is two rounds of the warp's lanes
            const unsigned pil_lanes = __ballot_sync(kFull, is_pil);
            const int n_wp = __popc(pil_lanes);
            const int rank = __popc(pil_lanes & ((1u << lane) - 1));
            const int lp = n_wp > 1 ? 32 - __clz(n_wp - 1) : 0;
            const int chunk = kPilotEntries >> lp;
            const int k0 = k - lane;  // the warp's first carrier
            auto fill_load = [&](int s0, float2 (&pv)[2]) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int e = lane + 32 * h, sj = e >> lp, j = e & ((1 << lp) - 1);
                    pv[h] = make_float2(0.f, 0.f);
                    if (j < n_wp && sj < min(chunk, n_sym - s0))
                        pv[h] = pilot_vals[(size_t)(s0 + sj) * fft_len + k0 + nth_bit(pil_lanes, j)];
                }
            };
            auto fill_put = [&](int s0, const float2 (&pv)[2]) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int e = lane + 32 * h;
                    if ((e & ((1 << lp) - 1)) < n_wp && (e >> lp) < min(chunk, n_sym - s0))
                        put_entry(w, kPointEntries + e, pv[h], abs2(pv[h].x, pv[h].y));
                }
            };
            float2 pv[2];
            fill_load(0, pv);  // its loads in flight while the points are worked out
            // the warp's points: lane i < 18 puts entry i
            if (lane < kPointEntries) {
                float2 pt;
                if constexpr (kTable)
                    pt = points[(lane < kHdrEntry ? type : 1) * kMaxPoints + (lane & (kHdrEntry - 1))];
                else
                    pt = table_point(lane, cid);
                put_entry(w, lane, pt, 0.f);
                if constexpr (kTable) point_at(w, lane) = pt;
            }
            fill_put(0, pv);
            __syncwarp();

            const float4* entries = &entry_at(w, 0);
            const float2* sides = &side_at(w, 0);
            int s = 0, s_fill = chunk;             // the next symbol, and the first one the table lacks
            int pil_entry = kPointEntries + rank;  // a pilot carrier's entry for symbol s
            // the steps from s to s_end, deciding with `slice`
            auto run = [&](auto slice, int s_end) {
                while (s < s_end) {
                    if (s == s_fill) {  // the pilot entries of the next chunk of symbols
                        float2 more[2];
                        fill_load(s, more);
                        __syncwarp();  // every lane is done with the entries replaced
                        fill_put(s, more);
                        __syncwarp();
                        s_fill = s + chunk;
                        pil_entry = kPointEntries + rank;
                    }
                    const int stop = min(s_end, s_fill);
#pragma unroll 1
                    for (; s < stop; ++s) {
                        if (s + kAhead < n_sym) copy_async(&ring_at(w, (s + kAhead) & (kRing - 1), lane), y_next);
                        copy_commit();
                        copy_wait<kAhead>();  // symbol s's group is in
                        const float2 Y = ring_at(w, s & (kRing - 1), lane);
                        const float2 eqd = cdiv(Y, H);
                        // the decision's entry, or this symbol's pilot value's
                        const int dec = slice(eqd);
                        const int e = is_pil ? pil_entry : dec;
                        const float4 ent = entries[e];
                        const float2 sd = sides[e];
                        finish(Y, eqd, make_float2(ent.x, ent.y), {ent.z, ent.w, sd.y != 0.f}, sd.x);
                        y_next += sym_stride;
                        pil_entry += 1 << lp;
                    }
                }
            };

            // the header's BPSK steps, then the payload's, a loop a constellation
            if constexpr (kTable) {
                const TableSlicer<2, kHdrEntry> hdr{w};
                switch (type) {
                    case 1: run(hdr, n_sym); break;  // the header's points are the row's
                    case 2: run(hdr, n_hdr); run(TableSlicer<4, 0>{w}, n_sym); break;
                    case 3: run(hdr, n_hdr); run(TableSlicer<8, 0>{w}, n_sym); break;
                    case 4: run(hdr, n_hdr); run(TableSlicer<16, 0>{w}, n_sym); break;
                    default: run(hdr, n_hdr); run(TableSlicer<0, 0>{w}, n_sym); break;
                }
            } else {
                switch (cid) {
                    case 2: run(Bpsk{}, n_hdr); run(Qpsk{}, n_sym); break;
                    case 3: run(Bpsk{}, n_hdr); run(Psk8{}, n_sym); break;
                    case 4: run(Bpsk{}, n_hdr); run(Qam16{}, n_sym); break;
                    default: run(Bpsk{}, n_sym); break;
                }
            }
        }
        if (!frozen) taps_out[(size_t)row * fft_len + k] = H;
    }

    err2 = warp_sum(err2);
    sig2 = warp_sum(sig2);
    if (lane == 0) {
        warp_err2[threadIdx.x >> 5] = err2;
        warp_sig2[threadIdx.x >> 5] = sig2;
    }
    __syncthreads();
    if (active && k == 0) {
        const int first_warp = (r * fft_len) >> 5;
        float e = 0.f, g = 0.f;
        for (int i = 0; i < (fft_len >> 5); ++i) {
            e += warp_err2[first_warp + i];
            g += warp_sig2[first_warp + i];
        }
        // x / tot with tot a Python int is a product with float32(1 / tot)
        const float nv = clamp_min(__fmul_rn(e, inv_tot), 1e-12f);
        const float sig = clamp_min(__fmul_rn(g, inv_tot), 1e-12f);
        noise_var[row] = nv;
        snr_db[row] = __fmul_rn(10.0f, log10f(sig / nv));
    }
}

// A launch's shape at fft_len: rows a block, threads a block, dynamic shared memory.
struct LaunchShape {
    int rows, threads;
    size_t smem;
};

LaunchShape launch_shape(int fft_len) {
    const int rows = fft_len >= kBlockThreads ? 1 : kBlockThreads / fft_len;
    return {rows, rows * fft_len, (size_t)(rows * fft_len / 32) * kWarpFloat4s * sizeof(float4)};
}

}  // namespace

// spectra: complex64 [B, n_sym, fft_len] with strides (row_stride, sym_stride,
// 1) in elements; taps_in [B, fft_len], pilot_vals [n_sym, fft_len] (the rows
// of this call's symbols), hard / soft [B, n_sym, fft_len], taps_out [B,
// fft_len] contiguous complex64; cnst_id [B] int32; the masks [fft_len] bool;
// snr_db / noise_var [B] float32.  n_hdr: the call's first n_hdr symbols are
// header symbols (BPSK).  inv_tot: float32(1 / (n_sym * pilots a symbol)).
// points: null for the closed-form slicers, else the [5, 16] complex64 point
// table (table mode).
extern "C" int equalizer_launch(const void* spectra, long long row_stride, long long sym_stride,
                                const void* taps_in, const void* cnst_id, const void* occ_mask,
                                const void* pilot_mask, const void* pilot_vals, int B, int n_sym,
                                int fft_len, int n_hdr, float alpha, float one_minus_alpha,
                                int frozen, float inv_tot, void* hard, void* soft, void* taps_out,
                                void* snr_db, void* noise_var, const void* points, void* stream) {
    if (B < 1 || n_sym < 1 || fft_len < 32 || fft_len % 32 != 0 || fft_len > kMaxFftLen)
        return (int)cudaErrorInvalidValue;
    const LaunchShape ls = launch_shape(fft_len);
    const int blocks = (B + ls.rows - 1) / ls.rows;
    auto kernel = points ? equalizer_kernel<true> : equalizer_kernel<false>;
    kernel<<<blocks, ls.threads, one_header_step(n_sym, n_hdr) ? 0 : ls.smem, (cudaStream_t)stream>>>(
        (const float2*)spectra, row_stride, sym_stride, (const float2*)taps_in, (const int*)cnst_id,
        (const uint8_t*)occ_mask, (const uint8_t*)pilot_mask, (const float2*)pilot_vals, B, n_sym,
        fft_len, n_hdr, alpha, one_minus_alpha, frozen, inv_tot, (float2*)hard, (float2*)soft,
        (float2*)taps_out, (float*)snr_db, (float*)noise_var, (const float2*)points, ls.rows);
    return (int)cudaGetLastError();
}

// Blocks of a call at fft_len that one SM keeps resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), of the closed-form
// instantiation or (table != 0) of table mode's; negative on a CUDA error.
extern "C" int equalizer_resident_blocks(int fft_len, int table) {
    if (fft_len < 32 || fft_len % 32 != 0 || fft_len > kMaxFftLen) return -(int)cudaErrorInvalidValue;
    const LaunchShape ls = launch_shape(fft_len);
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, table ? equalizer_kernel<true> : equalizer_kernel<false>, ls.threads, ls.smem);
    return err == cudaSuccess ? blocks : -(int)err;
}
