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
// read).  The first kernel reads F header records of 21 bytes and writes the
// source table; a walk over the records one at a time (~170 ns a step) would
// cost ten times the copy at F = 1024, so it is a few block-wide scans: a
// launch, the loads of the records and 2 + W dependent scans of up to three
// barriers each.
//
// Design.  No LLR moves in the first kernel.  tb_ring_walk computes, per slot,
// the SOURCE ROW of its content before every frame (-2 = that slot of the
// carried-in buffer, -1 = zeros, j >= 0 = frame j of this block) without a
// sequential walk, from two identities of the step:
//   * the carry's tb_no before frame i is the tb_no of the last ok frame
//     j < i, or the carried-in one: an ok frame with an equal tb_no leaves
//     it, one with a new tb_no sets it.  Given it, is_new[i] is elementwise;
//   * with b the last is_new frame before i and a the last frame before i
//     that was ok and fell in slot w ("mine"), slot w's source is a if
//     a >= 0 and a >= b, else -1 if b exists, else -2; the emitted scalars
//     (cnst, plen, fec_id) are frame b's, or the carried-in ones.
// So a block a ring, a thread a frame of each tile of up to 1024 frames:
// pass 1 is an exclusive prefix-max of the ok indices (then a gather of
// tb_no), pass 2 one of the is_new indices and one of each slot's "mine"
// indices (W <= 32 slots), each a warp __shfl_up_sync scan combined through
// shared memory, the tile's maxima carried to the next tile.  The slot test
// needs no division: with bits >= 1, clip(floor(off / bits), 0, W - 1) == w
// is (w == 0 or off >= w bits) and (w == W - 1 or off < (w + 1) bits), for a
// negative offset too (the reference's // floors), in 64-bit products; the
// frame bits are a chain of selects (indexing the parameter array by a
// variable compiles to predicated constant-bank loads).  It writes the
// emitted scalars, valid, the new scalar carry, present, and the table src
// [S, F + 1, W] (row F is the new carry's buffer).  tb_ring_copy, one block
// per (ring, row, slot) of src, then copies maxF floats from that source (or
// stores zeros) into emitted.llrs[r, i, w] or the NEW carry buffer, with
// 16-byte accesses where the rows allow.  Never in place: a source may be
// the old carry.  Two launches a block of frames, whatever F and S; one ring
// is the S = 1 case of the same two launches.  The copy is exact (error 0
// against the plain loop); tests/test_torch_scan_parallel.py holds the
// scans' algebra, in numpy, to the reference's scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 32;  // slots a transport block may have (tb_frames)
constexpr int kLanes = 32;
constexpr int kMaxThreads = 1024;  // frames of a tile of the walk
constexpr int kCopyThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct FrameBits {
    int of_cnst[5];  // bits of one frame for constellation id 0..4
};

// Exclusive prefix-max over the block's threads in order, with `carry` (the
// maximum of the earlier tiles) folded in: thread t gets max(carry, v of
// threads < t); `total` gets max(carry, v of every thread).  Values >= -1.
// `tot` is kMaxThreads / kLanes ints of shared memory.
__device__ __forceinline__ int block_excl_max(int v, int carry, int* tot, int& total) {
    const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
    const int n_warps = blockDim.x / kLanes;
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
        const int u = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v = max(v, u);
    }
    if (n_warps == 1) {  // a warp: no shared memory, no barrier
        int before = __shfl_up_sync(kFull, v, 1);
        if (lane == 0) before = -1;
        total = max(carry, __shfl_sync(kFull, v, kLanes - 1));
        __syncwarp();  // what the warp read or wrote before the scan, ordered as a barrier would
        return max(before, carry);
    }
    if (lane == kLanes - 1) tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int w = lane < n_warps ? tot[lane] : -1;
#pragma unroll
        for (int d = 1; d < kLanes; d <<= 1) {
            const int u = __shfl_up_sync(kFull, w, d);
            if (lane >= d) w = max(w, u);
        }
        if (lane < n_warps) tot[lane] = w;
    }
    __syncthreads();
    int before = __shfl_up_sync(kFull, v, 1);  // threads < t of this warp
    if (lane == 0) before = -1;
    if (warp > 0) before = max(before, tot[warp - 1]);  // of the warps before
    total = max(carry, tot[n_warps - 1]);
    __syncthreads();  // tot read by all before the next scan writes it
    return max(before, carry);
}

// Ring r = blockIdx.x.  state_in: four device vectors [S] (tb_no, cnst,
// plen, fec_id); state_out: [4, S] in the same order.  Records of ring r
// are [r F, r F + F), its slots [r W, r W + W).  Launched as S blocks of
// a multiple of 32 threads.
__global__ void __launch_bounds__(kMaxThreads) tb_ring_walk_kernel(
    const int* __restrict__ tb_no_in, const int* __restrict__ cnst_in,
    const int* __restrict__ plen_in, const int* __restrict__ fec_in,
    const uint8_t* __restrict__ present_in, const int* __restrict__ tb_no,
    const int* __restrict__ tb_offset, const int* __restrict__ cnst_id,
    const int* __restrict__ tb_payload, const int* __restrict__ fec_id,
    const uint8_t* __restrict__ ok, int S, int F, int W, FrameBits fb,
    int* __restrict__ state_out, uint8_t* __restrict__ present_out, int* __restrict__ e_cnst,
    int* __restrict__ e_plen, int* __restrict__ e_fec, int* __restrict__ e_tb_no,
    uint8_t* __restrict__ e_valid, int* __restrict__ src) {
    __shared__ int tot[kMaxThreads / kLanes];
    __shared__ int mine_run[kMaxW];  // each slot's last "mine" frame so far
    __shared__ int tb_tile[kMaxThreads];  // the tile's tb_no, for the gather after pass 1
    const int r = blockIdx.x, tid = threadIdx.x;
    const size_t rec = (size_t)r * F;
    tb_no += rec;
    tb_offset += rec;
    cnst_id += rec;
    tb_payload += rec;
    fec_id += rec;
    ok += rec;
    e_cnst += rec;
    e_plen += rec;
    e_fec += rec;
    e_tb_no += rec;
    e_valid += rec;
    src += (size_t)r * (F + 1) * W;
    const int c_tb = tb_no_in[r], c_cnst = cnst_in[r], c_plen = plen_in[r], c_fec = fec_in[r];
    const int fb0 = max(fb.of_cnst[0], 1), fb1 = max(fb.of_cnst[1], 1), fb2 = max(fb.of_cnst[2], 1),
              fb3 = max(fb.of_cnst[3], 1), fb4 = max(fb.of_cnst[4], 1);
    if (tid < W) mine_run[tid] = -1;
    int ok_run = -1, new_run = -1;  // the last ok and the last is_new frame so far
    int tb_run = c_tb;               // the carry's tb_no after the tiles before
    __syncthreads();
    for (int t0 = 0; t0 < F; t0 += blockDim.x) {
        const int i = t0 + tid;
        const bool here = i < F;
        const bool okf = here && ok[i] != 0;
        const int tb = here ? tb_no[i] : 0, cn = here ? cnst_id[i] : 0;
        const long long off = here ? tb_offset[i] : 0;
        // pass 1: the carry's tb_no before frame i, hence is_new
        tb_tile[tid] = tb;
        const int j = block_excl_max(okf ? i : -1, ok_run, tot, ok_run);
        const int tb_before = j >= t0 ? tb_tile[j - t0] : tb_run;
        if (ok_run >= t0) tb_run = tb_tile[ok_run - t0];  // read before the next barrier
        const bool is_new = okf && tb != tb_before;
        // pass 2: the last is_new frame before i, and each slot's last "mine"
        const int b = block_excl_max(is_new ? i : -1, new_run, tot, new_run);
        if (here) {
            e_tb_no[i] = tb_before;
            e_valid[i] = (is_new && tb_before >= 0) ? 1 : 0;
            e_cnst[i] = b >= 0 ? cnst_id[b] : c_cnst;
            e_plen[i] = b >= 0 ? tb_payload[b] : c_plen;
            e_fec[i] = b >= 0 ? fec_id[b] : c_fec;
        }
        const long long bits = cn <= 0 ? fb0 : cn == 1 ? fb1 : cn == 2 ? fb2 : cn == 3 ? fb3 : fb4;
        for (int w = 0; w < W; ++w) {
            // clip(floor(off / bits), 0, W - 1) == w, without the division
            const bool mine =
                okf && (w == 0 || off >= w * bits) && (w == W - 1 || off < (w + 1) * bits);
            int run;
            const int a = block_excl_max(mine ? i : -1, mine_run[w], tot, run);
            if (here) src[(size_t)i * W + w] = (a >= 0 && a >= b) ? a : (b >= 0 ? -1 : -2);
            if (tid == 0) mine_run[w] = run;  // every thread read it before the scan's barriers
        }
    }
    __syncthreads();
    if (tid < W) {
        const int a = mine_run[tid];
        const bool mine_last = a >= 0 && a >= new_run;
        src[(size_t)F * W + tid] = mine_last ? a : (new_run >= 0 ? -1 : -2);
        present_out[r * W + tid] = (mine_last || (new_run < 0 && present_in[r * W + tid] != 0)) ? 1 : 0;
    }
    if (tid == 0) {
        state_out[r] = tb_run;
        state_out[S + r] = new_run >= 0 ? cnst_id[new_run] : c_cnst;
        state_out[2 * S + r] = new_run >= 0 ? tb_payload[new_run] : c_plen;
        state_out[3 * S + r] = new_run >= 0 ? fec_id[new_run] : c_fec;
    }
}

// One block per (ring r, row i of src, slot w), numbered (r (F + 1) + i) W + w:
// row i < F goes to emitted[r, i, w], row F to the new carry buffer's [r, w].
template <typename T>
__global__ void tb_ring_copy_kernel(const int* __restrict__ src, const T* __restrict__ llrs,
                                    const T* __restrict__ carry_in, int F, int W, int row_len,
                                    T* __restrict__ emitted, T* __restrict__ carry_out, T zero) {
    const int r = blockIdx.x / ((F + 1) * W), rem = blockIdx.x % ((F + 1) * W);
    const int i = rem / W, w = rem % W;
    const int s = src[blockIdx.x];
    T* dst = (i < F ? emitted + (((size_t)r * F + i) * W + w) * row_len
                    : carry_out + ((size_t)r * W + w) * row_len);
    if (s == -1) {
        for (int x = threadIdx.x; x < row_len; x += kCopyThreads) dst[x] = zero;
        return;
    }
    const T* from = (s < 0 ? carry_in + ((size_t)r * W + w) * row_len
                           : llrs + ((size_t)r * F + s) * row_len);
    for (int x = threadIdx.x; x < row_len; x += kCopyThreads) dst[x] = from[x];
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" int tb_ring_walk_launch(const void* tb_no_in, const void* cnst_in, const void* plen_in,
                                   const void* fec_in, const void* present_in, const void* tb_no,
                                   const void* tb_offset, const void* cnst_id,
                                   const void* tb_payload, const void* fec_id, const void* ok,
                                   int S, int F, int W, int fb0, int fb1, int fb2, int fb3,
                                   int fb4, void* state_out, void* present_out, void* e_cnst,
                                   void* e_plen, void* e_fec, void* e_tb_no, void* e_valid,
                                   void* src, void* stream) {
    if (S < 1 || W < 1 || W > kMaxW || F < 0) return (int)cudaErrorInvalidValue;
    FrameBits fb = {{fb0, fb1, fb2, fb3, fb4}};
    // a block a ring, a thread a frame of a tile, at least a warp
    const int frames = F > W ? F : W;
    const int threads = frames >= kMaxThreads ? kMaxThreads : (frames + kLanes - 1) / kLanes * kLanes;
    tb_ring_walk_kernel<<<S, threads, 0, (cudaStream_t)stream>>>(
        (const int*)tb_no_in, (const int*)cnst_in, (const int*)plen_in, (const int*)fec_in,
        (const uint8_t*)present_in, (const int*)tb_no, (const int*)tb_offset, (const int*)cnst_id,
        (const int*)tb_payload, (const int*)fec_id, (const uint8_t*)ok, S, F, W, fb,
        (int*)state_out, (uint8_t*)present_out, (int*)e_cnst, (int*)e_plen, (int*)e_fec,
        (int*)e_tb_no, (uint8_t*)e_valid, (int*)src);
    return (int)cudaGetLastError();
}

// 16-byte accesses when the row length and every base pointer allow.
extern "C" int tb_ring_copy_launch(const void* src, const void* llrs, const void* carry_in, int S,
                                   int F, int W, int max_f, void* emitted, void* carry_out,
                                   void* stream) {
    if (S < 1 || W < 1 || W > kMaxW || F < 0 || max_f < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)S * (F + 1) * W;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const bool vec = max_f % 4 == 0 && aligned16(llrs) && aligned16(carry_in) &&
                     aligned16(emitted) && aligned16(carry_out);
    if (vec) {
        tb_ring_copy_kernel<float4><<<(unsigned)blocks, kCopyThreads, 0, (cudaStream_t)stream>>>(
            (const int*)src, (const float4*)llrs, (const float4*)carry_in, F, W, max_f / 4,
            (float4*)emitted, (float4*)carry_out, make_float4(0.f, 0.f, 0.f, 0.f));
    } else {
        tb_ring_copy_kernel<float><<<(unsigned)blocks, kCopyThreads, 0, (cudaStream_t)stream>>>(
            (const int*)src, (const float*)llrs, (const float*)carry_in, F, W, max_f,
            (float*)emitted, (float*)carry_out, 0.f);
    }
    return (int)cudaGetLastError();
}
