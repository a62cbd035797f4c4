// Codeword LLRs straight from the frames' LLR rows (K10), CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: gr_dtl_tpu's models/fec_chain.py leaves the
// codeword extraction to XLA (a gather it fuses with its index arithmetic).
// The plain PyTorch version is models/fec_chain.py::_extract_torch: with
// W > 1 frames a transport block it first builds each group's LLR stream
// (_group_llrs: four int64 index tensors of [G, W max_frame_bits], a gather
// and a select), then gathers the codewords' slots through three more int64
// tensors of [G, Cmax, Nmax] and pins the unsent ones; ~25 kernels that move
// over 20 GB for the 1.65 GB below at the stream cell's block.
//
// For group g (rows g*W .. g*W+W-1 of llrs, every row of max_bits LLRs), its
// group stream is row g itself when W = 1, and when W > 1 the W rows' first
// fb = frame_bits[bps[g]] LLRs one after another, 0 from W fb on.  Slot
// (c, p) of out[g] (Cmax codewords of Nmax slots, the bank's padded layout
// [parity: Mmax | systematic: Nmax - Mmax]) holds, for a real codeword c,
//   parity p < Mmax:        stream[cw_start + p], sent iff p < m[g];
//   systematic t = p - Mmax: stream[cw_start + m[g] + t], sent iff t < k'[c],
// the stream's index clamped to [0, L - 1] (L = W max_bits, or max_bits at
// W = 1) as the plain gather clamps it; every other slot, and every slot of a
// codeword that is not real, holds `pin` (+SHORTENED_LLR).
//
// What bounds it: device memory.  Each group's sent LLRs are read once and
// its Cmax Nmax slots written once, a few hundred bytes of schedule beside
// them; at the stream cell's block (G = 32,768, W = 2, the ladder's 2.5 bits
// a symbol on average) 0.63 GB read and 1.02 GB written, 0.49 ms at the
// 3.35 TB/s of an H100 SXM.  There is no arithmetic to speak of; the index
// work a slot is a few integer operations once the frame boundaries are
// resolved while staging.
//
// Design.
//  * A block a group.  Its schedule (a codeword's start, its sent parity and
//    systematic counts) goes to shared memory first, with the extent of the
//    sent stream, the largest end of a real codeword's bits.
//  * The group's stream up to that extent (at most W max_bits floats, 30 KiB
//    at W = 2) is staged in shared memory by cp.async, 16 bytes a copy where
//    the row and the frame's place in the stream allow it (every frame of the
//    dtl-fec configuration), 4 bytes elsewhere: the frame boundaries are
//    resolved here, once a frame, and no int64 index ever meets device
//    memory.  Past W fb the stream is zero-filled in shared memory.
//  * The group's Cmax Nmax slots are contiguous in out; they are written in
//    order with 16-byte stores (a scalar head and tail where the slab does not
//    start or end on 16 bytes), each element picked from the stage or pinned.
//  * Blocks of 128 threads, registers capped for 12 blocks an SM (40
//    registers); shared memory (31.1 KiB a block at W = 2, 15.4 KiB at
//    W = 1) allows 7 and 14, and one block's store phase runs beside other
//    blocks' loads.
//  * Rows are read as they lie: a row stride of any size (16-byte copies
//    where it keeps rows on 16 bytes), offsets 64-bit.
//
// Bit-equal to the plain chain by construction: every element is a copy of
// an input float, or `pin` as PyTorch casts the Python scalar to float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // a block
constexpr int kMinBlocks = 12;  // resident on an SM, at least (caps the registers)

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// n floats of `src` to `dst` by cp.async: 16-byte copies where both lie on
// 16 bytes, 4-byte ones for the rest.
__device__ __forceinline__ void stage_copy(float* dst, const float* src, int n) {
    if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15u) == 0) {
        const int n4 = n >> 2;
        for (int i = threadIdx.x; i < n4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
        for (int i = 4 * n4 + threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, src + i);
    } else {
        for (int i = threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, src + i);
    }
}

// A codeword's schedule as the slots read it.
struct Codeword {
    long long start;  // its first bit in the stream
    int n_par;        // parity slots sent (m, 0 if not real)
    int n_sys;        // systematic slots sent (k', 0 if not real)
};

struct Slots {
    const long long* start;  // [Cmax]
    const int* n_par;        // [Cmax]
    const int* n_sys;        // [Cmax]
    const float* stage;      // the group's stream
    long long m;             // the group's check bits
    long long last;          // L - 1: the plain gather's clamp
    int Mmax;
    float pin;

    __device__ __forceinline__ Codeword codeword(int c) const { return {start[c], n_par[c], n_sys[c]}; }

    __device__ __forceinline__ float at(const Codeword& w, int p) const {
        const bool par = p < Mmax;
        const int t = p - Mmax;
        const bool sent = par ? p < w.n_par : t < w.n_sys;
        long long off = w.start + (par ? static_cast<long long>(p) : m + t);
        off = off < 0 ? 0 : (off > last ? last : off);
        return sent ? stage[off] : pin;
    }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
codewords_kernel(const float* __restrict__ llrs, long long row_stride, int max_bits, int W,
                 const long long* __restrict__ bps, const int* __restrict__ frame_bits, int n_fb,
                 const long long* __restrict__ m_of, const long long* __restrict__ k_prime,
                 const long long* __restrict__ cw_start, const bool* __restrict__ real, int Cmax, int Nmax,
                 int Mmax, float pin, float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int L = W > 1 ? W * max_bits : max_bits;
    float* stage = reinterpret_cast<float*>(smem);
    long long* s_start = reinterpret_cast<long long*>(smem + (static_cast<size_t>(L) * 4 + 15) / 16 * 16);
    int* s_par = reinterpret_cast<int*>(s_start + Cmax);
    int* s_sys = s_par + Cmax;
    __shared__ int s_extent;
    const int n_slots = Cmax * Nmax;  // below 2^31 (the launch checks)

    const long long g = blockIdx.x;  // a block a group
    const long long m = m_of[g];
    if (threadIdx.x == 0) s_extent = 1;  // at least one float staged: a clamped index reads it
    __syncthreads();
    // ---- the schedule, and the extent of the stream its sent slots read ----
    for (int c = threadIdx.x; c < Cmax; c += kThreads) {
        const long long i = g * Cmax + c;
        const bool r = real[i];
        const long long kp = k_prime[i], st = cw_start[i];
        const int par = r ? static_cast<int>(m < 0 ? 0 : (m > Mmax ? Mmax : m)) : 0;
        const long long sys = r ? (kp < 0 ? 0 : kp) : 0;
        s_start[c] = st;
        s_par[c] = par;
        s_sys[c] = static_cast<int>(sys > Nmax ? Nmax : sys);
        if (r) {
            // the last stream index a sent slot of c reads, plus one
            long long end = 0;
            if (par > 0) end = st + par;
            if (sys > 0) end = st + m + sys;
            end = end < 1 ? 1 : (end > L ? L : end);
            atomicMax(&s_extent, static_cast<int>(end));
        }
    }
    __syncthreads();
    const int extent = s_extent;
    // ---- stage the group's stream [0, extent) ----
    if (W == 1) {
        stage_copy(stage, llrs + g * row_stride, extent);
    } else {
        const long long b = bps[g];
        const int fb = b >= 0 && b < n_fb ? frame_bits[b] : 0;
        int done = 0;
        for (int f = 0; f < W && fb > 0 && done < extent; ++f) {
            const int n = min(fb, extent - done);
            stage_copy(stage + done, llrs + (g * W + f) * row_stride, n);
            done += n;
        }
        for (int i = done + threadIdx.x; i < extent; i += kThreads) stage[i] = 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();
    // ---- write the group's Cmax Nmax slots in order ----
    const Slots s{s_start, s_par, s_sys, stage, m, static_cast<long long>(L) - 1, Mmax, pin};
    float* slab = out + g * n_slots;
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(slab) & 15u) >> 2);
    const int head = mis ? (4 - mis < n_slots ? 4 - mis : n_slots) : 0;
    for (int q = threadIdx.x; q < head; q += kThreads) slab[q] = s.at(s.codeword(q / Nmax), q % Nmax);
    const int n4 = (n_slots - head) / 4;
    float4* body = reinterpret_cast<float4*>(slab + head);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
        const int q = head + 4 * i;
        int c = q / Nmax;
        int p = q - c * Nmax;
        Codeword w = s.codeword(c);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            v[e] = s.at(w, p);
            if (++p == Nmax) {
                p = 0;
                if (e < 3) w = s.codeword(++c);  // q + e + 1 < n_slots: c stays below Cmax
            }
        }
        body[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int q = head + 4 * n4 + threadIdx.x; q < n_slots; q += kThreads)
        slab[q] = s.at(s.codeword(q / Nmax), q % Nmax);
}

// Shared memory a block takes: the stage of L floats (16-byte aligned), then
// the schedule (an int64 and two int32 a codeword).
long long smem_bytes(int W, int max_bits, int Cmax) {
    const long long L = W > 1 ? static_cast<long long>(W) * max_bits : max_bits;
    return (L * 4 + 15) / 16 * 16 + static_cast<long long>(Cmax) * 16;
}

}  // namespace

// One launch on `stream`: llrs [G W, max_bits] float32 (rows `row_stride`
// floats apart), bps [G] int64, frame_bits [n_fb] int32, m [G] int64,
// k_prime and cw_start [G, Cmax] int64, real [G, Cmax] bool, out [G, Cmax,
// Nmax] float32; every buffer but llrs contiguous.  Returns the launch's CUDA
// error.
extern "C" int codewords_launch(const void* llrs, long long row_stride, int max_bits, int W, const void* bps,
                                const void* frame_bits, int n_fb, const void* m, const void* k_prime,
                                const void* cw_start, const void* real, long long G, int Cmax, int Nmax, int Mmax,
                                float pin, void* out, void* stream) {
    if (G < 1 || G > 0x7fffffffLL || W < 1 || max_bits < 1 || row_stride < 0 || Cmax < 1 || Nmax < 1 ||
        Mmax < 0 || Mmax > Nmax || n_fb < 1 || static_cast<long long>(W) * max_bits > 0x7fffffffLL ||
        static_cast<long long>(Cmax) * Nmax > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long smem = smem_bytes(W, max_bits, Cmax);
    if (smem > 48 * 1024) {  // past what the card allows a block, this refuses
        const cudaError_t e = cudaFuncSetAttribute(codewords_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    codewords_kernel<<<static_cast<unsigned>(G), kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(llrs), row_stride, max_bits, W, static_cast<const long long*>(bps),
        static_cast<const int*>(frame_bits), n_fb, static_cast<const long long*>(m),
        static_cast<const long long*>(k_prime), static_cast<const long long*>(cw_start),
        static_cast<const bool*>(real), Cmax, Nmax, Mmax, pin, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}
