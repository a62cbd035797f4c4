// Max-log soft LLRs of the coded payload, written straight into the frame
// bit stream (K9), CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: gr_dtl_tpu leaves ops/constellation.py::soft_llrs
// and models/receiver.py's serialisation to XLA, which fuses them.  The plain
// PyTorch version is models/receiver.py::_frame_llrs_torch
// (ops/constellation.py::soft_llrs, then four reshape, pad and select
// rounds): some 70 kernels that build four [B, S, 4] candidate tensors and
// select among them, tens of GB of traffic for what is below.
//
// For frame b, with c = cnst[b], k = bps[c] bits a symbol (a negative c
// counts from the table's end, as a tensor index does) and
// nv = max(noise_var[b], 1e-12), symbol s of soft[b] fills bits
// s*k .. s*k+k-1 of llrs[b] with v_j(soft[b, s]) / nv, j < k; every element
// from S*k on is 0, and a frame whose k is not 1..4 (or whose c lies outside
// the table) gets a row of zeros.  v is the closed form of c's constellation
// (ops/constellation.py::soft_llrs: BPSK for c = 1, QPSK 2, 8PSK 3, the
// 16QAM forms for any other c), 0 past the form's own bits.
//
// What bounds it: each symbol read once (8 bytes), each frame's row of
// max_bits floats written once (16 bytes a symbol at max_bits = 4 S), and 12
// bytes a frame: 24 B S + 12 B = 755 MB at B = 32,768, S = 960, 0.225 ms at
// the 3.35 TB/s of an H100 SXM.  The arithmetic is a few dozen operations a
// symbol (8PSK's 8 projections and 6 maxima the most), far below the float32
// ridge, so device memory binds; nothing here wants tensor cores or TMA.
//
// Design.
//  * A block a frame: the frame's id, bits a symbol and clamped noise
//    variance are read once, and the block computes that constellation's form
//    alone (a template a form, picked once a block), never four candidates.
//  * Symbols are read two at a time with 16-byte loads, neighbouring threads
//    on neighbouring pairs, every load of a chunk issued before the first is
//    used; a row that starts off a 16-byte boundary (an odd S puts every other
//    row there) takes 8-byte loads.
//  * A chunk of kChunk symbols' LLRs is staged in shared memory at its place
//    in the row (16 KiB; one chunk at S = 960), a pair's 2k floats with one or
//    two vector stores, then the chunk goes out with 16-byte coalesced stores;
//    so k = 3's 12-byte groups never meet device memory unaligned.  From the
//    staged end (S*k rounded up to 4) to max_bits the zero tail is stored
//    straight from registers, 16 bytes a thread.
//  * Blocks of 256 threads, registers capped so that 6 blocks stay resident
//    on an SM (__launch_bounds__): 48 warps' loads in flight an SM, where the
//    compiler's own choice (96 registers) left 2 blocks.
//  * Offsets of a row are 64-bit.
//
// (On an NVIDIA H100 80GB HBM3 at 700 W, tools/bench_llr.py, profiler device
// time over a ring of inputs: 249.6 us at B = 32,768, S = 960 all QPSK, 90.3%
// of the byte floor; 262.4 us with ids 1..4 mixed, 85.9%; 18.4 us at B = 2048
// mixed, 76.7%; the plain chain 30.6 and 1.86 ms by events.  The block shape
// in turns (--variants), at those three shapes: this one 259.9 / 262.5 / 18.5
// us; registers uncapped 411.0 / 412.5 / 28.9; 5 blocks an SM 270.5 / 274.7 /
// 19.6; 7 or 8 blocks 279.2-279.4 / 281.2-281.4 / 20.2-20.5; 128 threads at
// 16 blocks 256.1 / 278.4 / 19.2, at 12 blocks 278.4 / 295.7 / 20.6; 512
// threads at 3 blocks 322.2 / 328.7 / 22.8.  The first build, 64 registers
// and 4 blocks an SM, 289.8 / 294.8 / 20.5 us.)
//
// Arithmetic: bit-equal to the plain chain on the card.  Each step of that
// chain is a PyTorch kernel of its own that rounds its result to float32, so
// every product, sum and quotient here is __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn in the chain's order (never contracted into an FMA: the 8PSK
// projection is re*cos and im*sin each rounded, then added), with the float32
// values PyTorch casts its Python scalars to; torch.sign is (0 < u) - (u < 0),
// a clamp keeps a NaN, and amax propagates one (max.NaN.f32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                  // a block
constexpr int kMinBlocks = 6;                  // resident on an SM, at least (caps the registers)
constexpr int kChunk = 1024;                   // symbols a block stages at once
constexpr int kPairs = kChunk / 2 / kThreads;  // a thread's symbol pairs a chunk
static_assert(kPairs >= 1 && kPairs * 2 * kThreads == kChunk, "a chunk is whole pairs of every thread");

// ops/constellation.py's constants, as float32 (the CPU tests read them here)
constexpr float kBpskScale = -4.0f;                  // -4.0
constexpr float kQpskScale = -1.41421354f;           // -4.0 * _A_Q
constexpr float kQamFourLevel = 1.26491106f;         // _4L
constexpr float kQamEightLevelSq = 0.800000012f;     // _8LL
constexpr float kQamTwoLevel = 0.632455528f;         // _2L
constexpr float kPsk8Scale = 2.0f;                   // 2.0 * (m0 - m1)
constexpr float kNoiseVarMin = 9.99999996e-13f;      // the clamp's 1e-12
// the 8PSK ring (_PSK8_COS, _PSK8_SIN), and by bit the ring positions whose
// symbol has that bit set (_PSK8_BIT)
#define PSK8_COS {1.0f, 0.707106769f, 6.12323426e-17f, -0.707106769f, -1.0f, -0.707106769f, -1.83697015e-16f, 0.707106769f}
#define PSK8_SIN {0.0f, 0.707106769f, 1.0f, 0.707106769f, 1.22464685e-16f, -0.707106769f, -1.0f, -0.707106769f}
#define PSK8_ONES {0x66u, 0x3Cu, 0xF0u}

enum Form { kBpsk, kQpsk, kPsk8, kQam16 };

__device__ __forceinline__ float max_nan(float a, float b) {
    float d;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
}

// Gray 4-PAM of one axis: the inner bit's and the sign bit's LLR numerators.
__device__ __forceinline__ void pam4(float u, float& inner, float& sign) {
    const float au = fabsf(u);
    inner = __fsub_rn(__fmul_rn(kQamFourLevel, au), kQamEightLevelSq);
    const float sg = static_cast<float>(static_cast<int>(0.0f < u) - static_cast<int>(u < 0.0f));
    const float over = __fsub_rn(au, kQamTwoLevel);
    const float clamped = over < 0.0f ? 0.0f : over;  // a NaN stays
    sign = -__fadd_rn(__fmul_rn(kQamFourLevel, u), __fmul_rn(__fmul_rn(kQamFourLevel, sg), clamped));
}

// The form's four LLR numerators of one symbol (0 past its own bits).
template <int kForm>
__device__ __forceinline__ void numerators(float re, float im, float v[4]) {
    v[0] = v[1] = v[2] = v[3] = 0.0f;
    if constexpr (kForm == kBpsk) {
        v[0] = __fmul_rn(kBpskScale, re);
    } else if constexpr (kForm == kQpsk) {
        v[0] = __fmul_rn(kQpskScale, re);
        v[1] = __fmul_rn(kQpskScale, im);
    } else if constexpr (kForm == kPsk8) {
        constexpr float cs[8] = PSK8_COS;
        constexpr float sn[8] = PSK8_SIN;
        constexpr unsigned ones[3] = PSK8_ONES;
        float proj[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) proj[q] = __fadd_rn(__fmul_rn(re, cs[q]), __fmul_rn(im, sn[q]));
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                if ((ones[j] >> q) & 1u) m1 = max_nan(m1, proj[q]);
                else m0 = max_nan(m0, proj[q]);
            }
            v[j] = __fmul_rn(kPsk8Scale, __fsub_rn(m0, m1));
        }
    } else {
        pam4(re, v[0], v[1]);
        pam4(im, v[2], v[3]);
    }
}

// Frame `b`'s row: kForm's LLRs of its S symbols, k bits each, staged a chunk
// at a time; `used` (S*k up to a multiple of 4, at most max_bits) floats.
template <int kForm>
__device__ __forceinline__ void stage_and_store(const float2* __restrict__ row, float* __restrict__ out,
                                                float* stage, int S, int k, int used, float nv) {
    const bool vec = (reinterpret_cast<uintptr_t>(row) & 15u) == 0;
    for (int s0 = 0; s0 < S && s0 * k < used; s0 += kChunk) {
        const int s1 = min(s0 + kChunk, S);
        const int n_pairs = (s1 - s0 + 1) / 2;
        const int a1 = min(s1 == S ? used : s1 * k, used);  // the chunk's outputs: [s0*k, a1)
        float4 y[kPairs];
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
            const int p = threadIdx.x + i * kThreads;
            const int s = s0 + 2 * p;
            y[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (p < n_pairs) {
                if (vec && s + 1 < S) {
                    y[i] = __ldg(reinterpret_cast<const float4*>(row + s));
                } else {
                    const float2 a = __ldg(row + s);
                    const float2 b = s + 1 < S ? __ldg(row + s + 1) : make_float2(0.0f, 0.0f);
                    y[i] = make_float4(a.x, a.y, b.x, b.y);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
            const int p = threadIdx.x + i * kThreads;
            if (p >= n_pairs) continue;
            const bool second = s0 + 2 * p + 1 < S;
            float a[4], b[4];
            numerators<kForm>(y[i].x, y[i].y, a);
            numerators<kForm>(y[i].z, y[i].w, b);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j >= k) break;
                a[j] = __fdiv_rn(a[j], nv);
                b[j] = second ? __fdiv_rn(b[j], nv) : 0.0f;  // past S: the tail's zeros
            }
            float* dst = stage + 2 * p * k;
            switch (k) {
                case 1: *reinterpret_cast<float2*>(dst) = make_float2(a[0], b[0]); break;
                case 2: *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], b[0], b[1]); break;
                case 3:
                    reinterpret_cast<float2*>(dst)[0] = make_float2(a[0], a[1]);
                    reinterpret_cast<float2*>(dst)[1] = make_float2(a[2], b[0]);
                    reinterpret_cast<float2*>(dst)[2] = make_float2(b[1], b[2]);
                    break;
                default:
                    reinterpret_cast<float4*>(dst)[0] = make_float4(a[0], a[1], a[2], a[3]);
                    reinterpret_cast<float4*>(dst)[1] = make_float4(b[0], b[1], b[2], b[3]);
            }
        }
        const int n = a1 - s0 * k;  // a multiple of 4
        for (int i = 2 * n_pairs * k + threadIdx.x; i < n; i += kThreads) stage[i] = 0.0f;
        __syncthreads();
        float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(s0) * k);
        const float4* src = reinterpret_cast<const float4*>(stage);
        for (int q = threadIdx.x; q < n / 4; q += kThreads) dst[q] = src[q];
        __syncthreads();  // the next chunk reuses the stage
    }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
soft_demap_kernel(const float2* __restrict__ soft, const int* __restrict__ cnst,
                  const float* __restrict__ noise_var, const long long* __restrict__ bps, int n_types,
                  int S, int max_bits, float* __restrict__ llrs) {
    __shared__ __align__(16) float stage[kChunk * 4];
    const long long b = blockIdx.x;
    const int c = cnst[b];
    const int idx = c < 0 ? c + n_types : c;
    const long long kk = idx >= 0 && idx < n_types ? bps[idx] : 0;
    const int k = kk >= 1 && kk <= 4 ? static_cast<int>(kk) : 0;
    const float nv_in = noise_var[b];
    const float nv = nv_in < kNoiseVarMin ? kNoiseVarMin : nv_in;  // a NaN stays
    const float2* row = soft + b * S;
    float* out = llrs + b * max_bits;
    const long long staged = (static_cast<long long>(S) * k + 3) / 4 * 4;
    const int used = static_cast<int>(staged < max_bits ? staged : max_bits);
    if (k) {
        if (c == 1) stage_and_store<kBpsk>(row, out, stage, S, k, used, nv);
        else if (c == 2) stage_and_store<kQpsk>(row, out, stage, S, k, used, nv);
        else if (c == 3) stage_and_store<kPsk8>(row, out, stage, S, k, used, nv);
        else stage_and_store<kQam16>(row, out, stage, S, k, used, nv);
    }
    float4* tail = reinterpret_cast<float4*>(out + used);
    for (int q = threadIdx.x; q < (max_bits - used) / 4; q += kThreads) tail[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

}  // namespace

// One launch on `stream`: soft [B, S] complex64, cnst [B] int32, noise_var
// [B] float32, bps [n_types] int64, llrs [B, max_bits] float32 (max_bits a
// multiple of 4, every buffer contiguous).  Returns the launch's CUDA error.
extern "C" int soft_demap_launch(const void* soft, const void* cnst, const void* noise_var, const void* bps,
                                 int n_types, long long B, int S, int max_bits, void* llrs, void* stream) {
    if (B < 1 || B > 0x7fffffffLL || S < 1 || S > (1 << 28) || max_bits < 4 || max_bits % 4 != 0 || n_types < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    soft_demap_kernel<<<static_cast<unsigned>(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(soft), static_cast<const int*>(cnst), static_cast<const float*>(noise_var),
        static_cast<const long long*>(bps), n_types, S, max_bits, static_cast<float*>(llrs));
    return static_cast<int>(cudaGetLastError());
}
