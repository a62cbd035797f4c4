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
// kernel (kTable), so the closed-form one compiles as it did.
//
// What bounds it.  Bytes: a row reads n_sym x fft_len spectra and writes twice
// as much (hard and soft), 24 bytes a carrier and symbol, against ~150
// float32 operations: 65.0 MB at B = 2048, n_sym = 20, fft_len = 64, 19.4 us
// at 3.35 TB/s.  What stands in the way of that bound is the recurrence: 20
// dependent steps a row, each two complex divisions and a decision deep.
//
// Design.  One thread a carrier: a frame row is fft_len / 32 warps, a block
// holds 128 / fft_len rows (one, from fft_len 128 on), so every load and store
// of a warp is one run of 256 contiguous bytes and the card sees two warps a
// row to hide the recurrence's latency behind.  H, the masks and the pilot sums
// stay in registers across all symbols; the sums are reduced once, at the end
// (shuffles, then one value a warp through shared memory).  The spectra do
// not depend on the carry, so they are loaded kAhead symbols ahead of the step
// that uses them, into a ring of registers: the row's memory latency is paid
// once, not once a symbol (a step of a lone warp takes ~0.7 us, longer than a
// read from device memory, so two symbols ahead is enough).  8PSK's eight
// points are computed once a warp (accurate cosf / sinf, a lane each) and read
// by shuffle, so that a step holds no trigonometry but the atan2f.  The
// constellation is one value a row and symbol, so the slicer is a branch a
// warp takes together, and the complex division is written without its branch
// (selects on the larger of |c| and |d|), so no warp runs both sides of it.
// `spectra` may be a strided view (row and symbol strides in elements, unit
// stride along the carriers); everything written is contiguous.
//
// (On an NVIDIA H100 80GB HBM3 at 700 W, B = 2048, n_sym = 20: a warp a row
// with two carriers a lane, the division as c10 branches it and the pilot
// value loaded inside the step took 75.9 us, 43.6 us at B = 1: 2.2 us a
// dependent step; this form 36.9 us, 52% of the bound, and 16.1 us at B = 1:
// a launch and 20 steps of ~0.67 us, some 190 instructions of a lone warp.)
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
// contraction, as they are in PyTorch's build.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 128;  // a block: 128 / fft_len rows, or one longer row
constexpr int kMaxFftLen = 256;     // the longest row a block takes
constexpr int kAhead = 2;           // symbols loaded ahead of their step
constexpr int kMaxPoints = 16;      // a row of the point table (MAX_POINTS)
constexpr int kTypes = 5;           // rows of the point table (N_TYPES)

// The slicers' constants, float32 as ops/constellation.py rounds them.
constexpr float kQpskAmp = 0.353553385f;     // float32(0.5 * sqrt(2) / 2)
constexpr float kFourOverPi = 1.27323949f;   // float32(4 / pi)
constexpr float kPiOverFour = 0.785398185f;  // float32(pi / 4)
constexpr float kQamLevel = 0.316227764f;    // float32(1) / sqrt(float32(10))
constexpr float kQamTwoLevel = 0.632455528f; // float32(2) * kQamLevel
constexpr float kQamInvTwoLevel = 1.0f / kQamTwoLevel;

// x / y as c10::complex<float>::operator/= computes it (the scaled form:
// one ratio, one reciprocal), with selects where c10 branches on
// |c| >= |d|: p is the larger of c and d, q the other, and
//   |c| >= |d|:  ((a + b rat) scl, (b - a rat) scl),  rat = d / c, scl = 1 / (c + d rat)
//   otherwise:   ((a rat + b) scl, (b rat - a) scl),  rat = c / d, scl = 1 / (d + c rat)
// are both (x2 + x1 rat) scl, (y2 + y1 rat) scl.  Each sum of a product is left
// to the compiler's contraction, as in PyTorch's build.
__device__ __forceinline__ float2 cdiv(float2 x, float2 y) {
    const float a = x.x, b = x.y, c = y.x, d = y.y;
    const bool c_larger = fabsf(c) >= fabsf(d);
    const float p = c_larger ? c : d, q = c_larger ? d : c;
    if (p == 0.f && q == 0.f) return make_float2(a / fabsf(c), b / fabsf(d));  // inf or NaN, as c10
    const float rat = q / p;
    const float scl = 1.0f / (p + q * rat);
    const float x1 = c_larger ? b : a, x2 = c_larger ? a : b;
    const float y1 = c_larger ? -a : b, y2 = c_larger ? b : -a;
    return make_float2((x2 + x1 * rat) * scl, (y2 + y1 * rat) * scl);
}

// One axis of the 16QAM slicer: clamp(floor(x / 2l + 2), 0, 3), then l (2u - 3).
__device__ __forceinline__ float qam16_axis(float x) {
    const float u = fminf(fmaxf(floorf(__fadd_rn(__fmul_rn(x, kQamInvTwoLevel), 2.0f)), 0.0f), 3.0f);
    return __fmul_rn(kQamLevel, (float)(2 * (int)u - 3));
}

// ops/constellation.py::nearest_point's decided point; cid is one value a
// warp, and every lane of the warp comes here.  psk_cos / psk_sin: lane l
// holds cosf / sinf of ring position l % 8 (8PSK rows only).
__device__ __forceinline__ float2 decide(float2 y, int cid, float psk_cos, float psk_sin) {
    switch (cid) {
        case 2:
            return make_float2(y.x > 0.f ? kQpskAmp : -kQpskAmp, y.y > 0.f ? kQpskAmp : -kQpskAmp);
        case 3: {
            const float ang = atan2f(y.y, y.x);
            const int pos = (int)nearbyintf(__fmul_rn(ang, kFourOverPi)) & 7;  // floor modulo 8
            return make_float2(__shfl_sync(0xffffffffu, psk_cos, pos),
                               __shfl_sync(0xffffffffu, psk_sin, pos));
        }
        case 4:
            return make_float2(qam16_axis(y.x), qam16_axis(y.y));
        default:
            return make_float2(y.x > 0.f ? 1.0f : -1.0f, 0.0f);
    }
}

// The table-mode slicer.  pt: lane l holds point l % 16 of the symbol's
// constellation row, read by shuffle; n_valid (0, 2, 4, 8 or 16) is one
// value a warp, and every lane of the warp comes here.  The distances are
// three of PyTorch's kernels and the sum a fourth, each rounding: no FMA.
// The points go in groups of four: a group's distances are independent and
// computed side by side, its first minimum taken by a tree of pairs, then
// held against the best of the groups before it.  Lower indices are always
// on the left, and the right one wins only when strictly nearer, or a NaN
// against a number (torch.argmin counts a NaN as the least): the sequential
// first-minimum rule.  (NVIDIA H100 80GB HBM3, 700 W, payload call at B = 1 /
// 32 / 1024 / 2048 with mixed ids: a loop over the points, one at a time,
// took 19.4 / 37.2 / 47.1 / 63.4 us; all 16 side by side 18.0 / 29.2 /
// 40.0 / 76.6, 89 registers halving the blocks an SM holds; groups of four,
// 57 registers, 18.5 / 34.4 / 44.8 / 61.1.)
struct Candidate {
    float d2;
    float2 p;
};

__device__ __forceinline__ Candidate first_min(Candidate lo, Candidate hi) {
    const bool take_hi = hi.d2 < lo.d2 || (isnan(hi.d2) && !isnan(lo.d2));
    return take_hi ? hi : lo;
}

template <int N>
__device__ __forceinline__ float2 decide_table_n(float2 y, float2 pt) {
    constexpr int G = N < 4 ? N : 4;
    Candidate best;
#pragma unroll 1
    for (int g = 0; g < N; g += G) {
        Candidate c[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
            const float2 p = make_float2(__shfl_sync(0xffffffffu, pt.x, g + j), __shfl_sync(0xffffffffu, pt.y, g + j));
            const float dr = __fsub_rn(y.x, p.x), di = __fsub_rn(y.y, p.y);
            c[j] = {__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di)), p};
        }
#pragma unroll
        for (int w = 1; w < G; w *= 2) {
#pragma unroll
            for (int j = 0; j + w < G; j += 2 * w) c[j] = first_min(c[j], c[j + w]);
        }
        best = g == 0 ? c[0] : first_min(best, c[0]);
    }
    return best.p;
}

__device__ __forceinline__ float2 decide_table(float2 y, float2 pt, int n_valid) {
    switch (n_valid) {
        case 2: return decide_table_n<2>(y, pt);
        case 4: return decide_table_n<4>(y, pt);
        case 8: return decide_table_n<8>(y, pt);
        case 16: return decide_table_n<16>(y, pt);
        default:  // no valid point: the argmin of all-inf distances, point 0
            return make_float2(__shfl_sync(0xffffffffu, pt.x, 0), __shfl_sync(0xffffffffu, pt.y, 0));
    }
}

// |z|^2 for the pilot sums.  torch.abs(z) ** 2 is hypotf squared; the sums are
// taken in another order than PyTorch's anyway (agreement within rtol 1e-4), so
// the two squares are summed directly, with hypot's rule that an infinite part
// wins over a NaN (a frame slot of idle air has zero taps: the plain loop's
// noise variance there is inf or NaN, and the kernel's is the same).
__device__ __forceinline__ float abs2(float zr, float zi) {
    return (isinf(zr) || isinf(zi)) ? INFINITY : fmaf(zr, zr, zi * zi);
}

// torch.clamp(x, min=lo): a NaN stays a NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <bool kTable>
__global__ void __launch_bounds__(kMaxFftLen) equalizer_kernel(
    const float2* __restrict__ spectra, long long row_stride, long long sym_stride,
    const float2* __restrict__ taps_in, const int* __restrict__ cnst_id,
    const uint8_t* __restrict__ occ_mask, const uint8_t* __restrict__ pilot_mask,
    const float2* __restrict__ pilot_vals, int B, int n_sym, int fft_len, int n_hdr, float alpha,
    float one_minus_alpha, int frozen, float inv_tot, float2* __restrict__ hard,
    float2* __restrict__ soft, float2* __restrict__ taps_out, float* __restrict__ snr_db,
    float* __restrict__ noise_var, const float2* __restrict__ points) {
    __shared__ float warp_err2[kMaxFftLen / 32], warp_sig2[kMaxFftLen / 32];
    const int r = threadIdx.x / fft_len;    // this thread's row of the block
    const int k = threadIdx.x - r * fft_len;  // and its carrier
    const int row = blockIdx.x * (blockDim.x / fft_len) + r;
    const bool active = row < B;  // a row past the batch waits at the barrier, no more

    float err2 = 0.f, sig2 = 0.f;  // this carrier's share of the row's pilot sums
    if (active) {
        float2 H = taps_in[(size_t)row * fft_len + k];
        const bool is_pil = pilot_mask[k] != 0;
        const bool upd = !frozen && (is_pil || occ_mask[k] != 0);
        const int cid_payload = cnst_id[row];
        // 8PSK decides cos / sin of pos * (pi / 4), pos = 0..7: eight values, taken
        // once a warp by the accurate cosf / sinf and read by shuffle in the steps
        float psk_cos = 0.f, psk_sin = 0.f;
        if (!kTable && cid_payload == 3) {
            const float pang = __fmul_rn((float)(threadIdx.x & 7), kPiOverFour);
            psk_cos = cosf(pang);
            psk_sin = sinf(pang);
        }
        // table mode: the payload row's points and BPSK's (header symbols), a
        // lane a point, and the payload row's count of valid points
        float2 pay_pt = make_float2(0.f, 0.f), hdr_pt = make_float2(0.f, 0.f);
        int n_pay = 0;
        if (kTable) {
            const int type = (cid_payload >= 1 && cid_payload < kTypes) ? cid_payload : 0;
            pay_pt = points[type * kMaxPoints + (threadIdx.x & (kMaxPoints - 1))];
            hdr_pt = points[1 * kMaxPoints + (threadIdx.x & (kMaxPoints - 1))];
            n_pay = type ? 1 << type : 0;
        }
        // this carrier of the row's symbols: pointers that step a symbol at a time
        const float2* y_next = spectra + (size_t)row * row_stride + k;
        const float2* pv_sym = pilot_vals + k;
        float2* hard_sym = hard + (size_t)row * n_sym * fft_len + k;
        float2* soft_sym = soft + (size_t)row * n_sym * fft_len + k;

        float2 y_ring[kAhead];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
            y_ring[a] = make_float2(0.f, 0.f);
            if (a < n_sym) y_ring[a] = *y_next;
            y_next += sym_stride;
        }

        // one copy of the step, the ring shifted down a slot a symbol (an unrolled
        // ring is kAhead copies of ~370 instructions)
#pragma unroll 1
        for (int s = 0; s < n_sym; ++s) {
            const float2 Y = y_ring[0];
#pragma unroll
            for (int a = 0; a + 1 < kAhead; ++a) y_ring[a] = y_ring[a + 1];
            if (s + kAhead < n_sym) y_ring[kAhead - 1] = *y_next;  // kAhead steps early
            // needed only after the division and the slicer: a hit in L1 by then
            const float2 pv = is_pil ? *pv_sym : make_float2(0.f, 0.f);
            const float2 eqd = cdiv(Y, H);
            const float2 dec = kTable ? (s < n_hdr ? decide_table(eqd, hdr_pt, 2)
                                                   : decide_table(eqd, pay_pt, n_pay))
                                      : decide(eqd, s < n_hdr ? 1 : cid_payload, psk_cos, psk_sin);
            const float2 ref = is_pil ? pv : dec;
            if (is_pil) {
                err2 += abs2(__fsub_rn(eqd.x, pv.x), __fsub_rn(eqd.y, pv.y));
                sig2 += abs2(pv.x, pv.y);
            }
            if (upd) {
                // (1 - alpha) * Y, then / ref_safe, then alpha * H + that: three of
                // PyTorch's kernels and a fourth for the sum, each rounding
                const float2 ref_safe = (ref.x != 0.f || ref.y != 0.f) ? ref : make_float2(1.f, 0.f);
                const float2 scaled = make_float2(__fmul_rn(Y.x, one_minus_alpha),
                                                  __fmul_rn(Y.y, one_minus_alpha));
                const float2 d = cdiv(scaled, ref_safe);
                H.x = __fadd_rn(__fmul_rn(H.x, alpha), d.x);
                H.y = __fadd_rn(__fmul_rn(H.y, alpha), d.y);
            }
            *hard_sym = ref;
            *soft_sym = eqd;
            y_next += sym_stride;
            pv_sym += fft_len;
            hard_sym += fft_len;
            soft_sym += fft_len;
        }
        if (!frozen) taps_out[(size_t)row * fft_len + k] = H;
    }

    err2 = warp_sum(err2);
    sig2 = warp_sum(sig2);
    if ((threadIdx.x & 31) == 0) {
        warp_err2[threadIdx.x >> 5] = err2;
        warp_sig2[threadIdx.x >> 5] = sig2;
    }
    __syncthreads();
    if (active && k == 0) {
        const int first_warp = (r * fft_len) >> 5;
        float e = 0.f, g = 0.f;
        for (int w = 0; w < (fft_len >> 5); ++w) {
            e += warp_err2[first_warp + w];
            g += warp_sig2[first_warp + w];
        }
        // x / tot with tot a Python int is a product with float32(1 / tot)
        const float nv = clamp_min(__fmul_rn(e, inv_tot), 1e-12f);
        const float sig = clamp_min(__fmul_rn(g, inv_tot), 1e-12f);
        noise_var[row] = nv;
        snr_db[row] = __fmul_rn(10.0f, log10f(sig / nv));
    }
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
    const int rows_per_block = fft_len >= kBlockThreads ? 1 : kBlockThreads / fft_len;
    const int blocks = (B + rows_per_block - 1) / rows_per_block;
    auto kernel = points ? equalizer_kernel<true> : equalizer_kernel<false>;
    kernel<<<blocks, rows_per_block * fft_len, 0, (cudaStream_t)stream>>>(
        (const float2*)spectra, row_stride, sym_stride, (const float2*)taps_in, (const int*)cnst_id,
        (const uint8_t*)occ_mask, (const uint8_t*)pilot_mask, (const float2*)pilot_vals, B, n_sym,
        fft_len, n_hdr, alpha, one_minus_alpha, frozen, inv_tot, (float2*)hard, (float2*)soft,
        (float2*)taps_out, (float*)snr_db, (float*)noise_var, (const float2*)points);
    return (int)cudaGetLastError();
}
