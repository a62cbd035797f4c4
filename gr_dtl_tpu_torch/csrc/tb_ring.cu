// Streaming transport-block reassembly (the TB ring) as two CUDA kernels.
//
// What they replace.  The JAX package writes the reassembly as a lax.scan
// over the frames of a block, which XLA compiles into the block step (there
// is no Pallas kernel for it):
//   gr_dtl_tpu/models/fec_chain.py::tb_reassemble (step at :211-231).
// In eager PyTorch that scan is F iterations of ~25 small launches, each
// rewriting the whole [W, maxF] buffer.  Its plain PyTorch version is
// gr_dtl_tpu_torch/models/fec_chain.py::_tb_reassemble_torch.
//
// What it computes.  Frames in stream order; carry = (tb_no, llrs [W, maxF],
// present [W], cnst, plen, fec_id).  At position i:
//   is_new = ok[i] && tb_no[i] != carry.tb_no;
//   emitted row i is the carry BEFORE the step, valid = is_new && carry.tb_no >= 0;
//   on is_new the buffer and present are cleared, the scalars take frame i's;
//   slot = clip(tb_offset[i] / max(frame_bits(cnst[i]), 1), 0, W - 1);
//   if ok[i] (then tb_no[i] equals the carry's new tb_no) slot <- llrs[i].
//
// What bounds it.  Bytes, and only in the second kernel: every emitted row is
// a copy of W rows of maxF floats, (F + 1) W maxF 4 bytes written and up to
// as many read (the F input rows and the W carried ones are what must be
// read).  The first kernel is a state machine over F header records of 21
// bytes: launch latency plus F dependent steps.
//
// Design.  No LLR moves in the sequential part.  tb_ring_walk walks the
// records with the scalar carry in registers and, per slot, the SOURCE ROW
// of its present content: -2 = that slot of the carried-in buffer,
// -1 = zeros, j >= 0 = frame j of this block.  It is one warp of W lanes:
// lane w owns slot w, so the slot table is one register a lane and the
// slot test needs no division; every lane walks all the records and holds
// the same scalar carry.  Each record is loaded whole before the carry is
// looked at, so the loads run ahead of the dependent chain, which is four
// selects.  (On an NVIDIA H100 80GB HBM3 at 700 W, F = 1024, W = 2: one
// thread with the table as a local array, loads under the branches that need
// them and the frame bits indexed from the parameter struct took 328 us, this
// form 172 us: ~170 ns a step, what one warp takes for ~45 dependent
// instructions.)  It writes the emitted scalars,
// valid, the new scalar carry, present, and the table
// src [F + 1, W] (row F is the new carry's buffer).  tb_ring_copy, one block
// per (row, slot) of src, then copies maxF floats from that source (or
// stores zeros) into emitted.llrs[i, w] or the NEW carry buffer, with
// 16-byte accesses where the rows allow.  Never in place: a source may be
// the old carry.  Two launches a block of frames, whatever F.
//
// The copy is exact (error 0 against the plain loop).  The slot needs no
// division: with bits >= 1, clip(floor(off / bits), 0, W - 1) == w is
// (w == 0 or off >= w bits) and (w == W - 1 or off < (w + 1) bits), for a
// negative offset too (the reference's // floors), in 64-bit products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 32;        // slots a transport block may have (tb_frames): one warp
constexpr int kCopyThreads = 256;

struct FrameBits {
    int of_cnst[5];  // bits of one frame for constellation id 0..4
};

// state_in: four device scalars (tb_no, cnst, plen, fec_id); state_out: [4]
// in the same order.  Launched as one block of W <= 32 threads.
__global__ void tb_ring_walk_kernel(
    const int* __restrict__ tb_no_in, const int* __restrict__ cnst_in,
    const int* __restrict__ plen_in, const int* __restrict__ fec_in,
    const uint8_t* __restrict__ present_in, const int* __restrict__ tb_no,
    const int* __restrict__ tb_offset, const int* __restrict__ cnst_id,
    const int* __restrict__ tb_payload, const int* __restrict__ fec_id,
    const uint8_t* __restrict__ ok, int F, int W, FrameBits fb, int* __restrict__ state_out,
    uint8_t* __restrict__ present_out, int* __restrict__ e_cnst, int* __restrict__ e_plen,
    int* __restrict__ e_fec, int* __restrict__ e_tb_no, uint8_t* __restrict__ e_valid,
    int* __restrict__ src) {
    const int w = threadIdx.x;  // this lane's slot
    int c_tb = tb_no_in[0], c_cnst = cnst_in[0], c_plen = plen_in[0], c_fec = fec_in[0];
    const int fb0 = max(fb.of_cnst[0], 1), fb1 = max(fb.of_cnst[1], 1), fb2 = max(fb.of_cnst[2], 1),
              fb3 = max(fb.of_cnst[3], 1), fb4 = max(fb.of_cnst[4], 1);
    int cur = -2;
    bool present = present_in[w] != 0;
#pragma unroll 4
    for (int i = 0; i < F; ++i) {
        // off the carry's chain: the record, and whether its slot is this lane's
        const bool okf = ok[i] != 0;
        const int tb = tb_no[i], cn = cnst_id[i], pl = tb_payload[i], fe = fec_id[i];
        const long long off = tb_offset[i];
        // (a chain of selects: indexing the parameter array by a variable
        // compiles to a chain of predicated constant-bank loads, 70 ns a step)
        const long long bits = cn <= 0 ? fb0 : cn == 1 ? fb1 : cn == 2 ? fb2 : cn == 3 ? fb3 : fb4;
        // clip(floor(off / bits), 0, W - 1) == w, without the division
        const bool mine = okf && (w == 0 || off >= w * bits) && (w == W - 1 || off < (w + 1) * bits);
        // on it: the carry BEFORE this step goes out, then the step
        const bool is_new = okf && tb != c_tb;
        src[i * W + w] = cur;
        if (w == 0) {
            e_cnst[i] = c_cnst;
            e_plen[i] = c_plen;
            e_fec[i] = c_fec;
            e_tb_no[i] = c_tb;
            e_valid[i] = (is_new && c_tb >= 0) ? 1 : 0;
        }
        // a new tb_no starts a fresh buffer (stale slots erased); a decoded
        // frame (its tb_no is the carry's now) fills its slot
        c_tb = is_new ? tb : c_tb;
        c_cnst = is_new ? cn : c_cnst;
        c_plen = is_new ? pl : c_plen;
        c_fec = is_new ? fe : c_fec;
        cur = mine ? i : (is_new ? -1 : cur);
        present = mine || (present && !is_new);
    }
    src[F * W + w] = cur;
    present_out[w] = present ? 1 : 0;
    if (w == 0) {
        state_out[0] = c_tb;
        state_out[1] = c_cnst;
        state_out[2] = c_plen;
        state_out[3] = c_fec;
    }
}

// One block per (row i of src, slot w): row i < F goes to emitted[i, w],
// row F to the new carry buffer's slot w.
template <typename T>
__global__ void tb_ring_copy_kernel(const int* __restrict__ src, const T* __restrict__ llrs,
                                    const T* __restrict__ carry_in, int F, int W, int row_len,
                                    T* __restrict__ emitted, T* __restrict__ carry_out, T zero) {
    const int i = blockIdx.x / W, w = blockIdx.x % W;
    const int s = src[blockIdx.x];
    T* dst = (i < F ? emitted + ((size_t)i * W + w) * row_len : carry_out + (size_t)w * row_len);
    if (s == -1) {
        for (int x = threadIdx.x; x < row_len; x += kCopyThreads) dst[x] = zero;
        return;
    }
    const T* from = (s < 0 ? carry_in + (size_t)w * row_len : llrs + (size_t)s * row_len);
    for (int x = threadIdx.x; x < row_len; x += kCopyThreads) dst[x] = from[x];
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" int tb_ring_walk_launch(const void* tb_no_in, const void* cnst_in, const void* plen_in,
                                   const void* fec_in, const void* present_in, const void* tb_no,
                                   const void* tb_offset, const void* cnst_id,
                                   const void* tb_payload, const void* fec_id, const void* ok,
                                   int F, int W, int fb0, int fb1, int fb2, int fb3, int fb4,
                                   void* state_out, void* present_out, void* e_cnst, void* e_plen,
                                   void* e_fec, void* e_tb_no, void* e_valid, void* src,
                                   void* stream) {
    if (W < 1 || W > kMaxW || F < 0) return (int)cudaErrorInvalidValue;
    FrameBits fb = {{fb0, fb1, fb2, fb3, fb4}};
    tb_ring_walk_kernel<<<1, W, 0, (cudaStream_t)stream>>>(
        (const int*)tb_no_in, (const int*)cnst_in, (const int*)plen_in, (const int*)fec_in,
        (const uint8_t*)present_in, (const int*)tb_no, (const int*)tb_offset, (const int*)cnst_id,
        (const int*)tb_payload, (const int*)fec_id, (const uint8_t*)ok, F, W, fb, (int*)state_out,
        (uint8_t*)present_out, (int*)e_cnst, (int*)e_plen, (int*)e_fec, (int*)e_tb_no,
        (uint8_t*)e_valid, (int*)src);
    return (int)cudaGetLastError();
}

// 16-byte accesses when the row length and every base pointer allow.
extern "C" int tb_ring_copy_launch(const void* src, const void* llrs, const void* carry_in, int F,
                                   int W, int max_f, void* emitted, void* carry_out,
                                   void* stream) {
    if (W < 1 || W > kMaxW || F < 0 || max_f < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (F + 1) * W;
    const bool vec = max_f % 4 == 0 && aligned16(llrs) && aligned16(carry_in) &&
                     aligned16(emitted) && aligned16(carry_out);
    if (vec) {
        tb_ring_copy_kernel<float4><<<blocks, kCopyThreads, 0, (cudaStream_t)stream>>>(
            (const int*)src, (const float4*)llrs, (const float4*)carry_in, F, W, max_f / 4,
            (float4*)emitted, (float4*)carry_out, make_float4(0.f, 0.f, 0.f, 0.f));
    } else {
        tb_ring_copy_kernel<float><<<blocks, kCopyThreads, 0, (cudaStream_t)stream>>>(
            (const int*)src, (const float*)llrs, (const float*)carry_in, F, W, max_f,
            (float*)emitted, (float*)carry_out, 0.f);
    }
    return (int)cudaGetLastError();
}
