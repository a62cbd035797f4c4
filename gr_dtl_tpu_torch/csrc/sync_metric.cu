// Schmidl-Cox timing metric, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel gr_dtl_tpu/ops/sync_pallas.py::_metric_kernel
// (launched by timing_metric_pallas, pallas_call at sync_pallas.py:149).
//
// For a complex64 stream r of length n and each d < n - 64:
//   P(d)  = sum_{m<32} conj(r[d+m]) * r[d+m+32]
//   R1(d) = sum_{m<32} |r[d+m]|^2
//   R2(d) = R1(d+32)
//   M(d)  = |P(d)|^2 / max(R1(d) * R2(d), 1e-12)
//
// What bounds it: 8 bytes in and 12 bytes out per sample (P as float2, M as
// float): 8 n + 12 (n - 64) = 75.4 MB for the 3,770,368-sample stream of a
// 2048-frame step, 0.0225 ms at the 3.35 TB/s of an H100 SXM.  The sums
// below cost about 2 flops a byte, a tenth of the float32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 flops a byte), so device memory bounds the kernel;
// tensor cores, wgmma and clusters have nothing to do here and are not used.
//
// Design.
//  * A block takes a tile of 2048 consecutive outputs of one row and
//    stages the tile's 2048 + 64 samples in shared memory with 16-byte
//    loads, all issued before the first is used, so every block keeps its
//    whole tile in flight; several blocks are resident on an SM.  The 64-sample
//    halo is 3% extra reading at 2048 outputs a tile.
//  * Tiles are laid on a grid that starts on a 64-byte boundary of the row's
//    M output (a 128-byte boundary of P), worked out per row from the
//    pointers: in a [S, n] batch an odd n or row shifts every row's alignment.
//    Whether a row's input and P output can take 16-byte accesses is decided
//    per row from their addresses; a row that cannot takes 8-byte ones.
//  * Each sample is multiplied once: c[i] = conj(r[i]) r[i+32], e[i] = |r[i]|^2.
//  * Window sums are two-level block sums over aligned groups of 32, the
//    arithmetic of ops/sync.py::_moving_sum: with epre the exclusive prefix
//    within a group and tot the group's total, the window starting at
//    d = 32 b + j is (tot_b - epre_b[j]) + epre_{b+1}[j].  Every output sums
//    at most 64 values whatever n is, so float32 precision does not depend
//    on the stream length.  A "walker" of 16 lanes (half a warp) holds one
//    group, two samples a lane, scans it with 4 shuffle steps, and walks
//    along a run of consecutive groups: epre_{b+1}[j], r[i+32] and the next
//    group's energy are then the same lane's values of the next step, kept
//    in registers.  No sum goes through shared memory and the block syncs
//    once.
//  * One energy sum: E(d) is formed once per group; R1(d) = E(d) and
//    R2(d) = E(d+32) is the next step's E in the same lane.
//  * Stores come straight from the walkers: P as float4 (two outputs a
//    lane, 256 contiguous bytes a walker), M as float2 (128 contiguous bytes).
//  * Samples before 0 or past n read as zero; outputs outside [0, n - 64)
//    are not written; offsets are 64-bit.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W limit, L2 cold (a ring
// of four streams), by gr_dtl_tpu_torch/tools/bench_sync_metric.py: 0.0296 ms
// at n = 3,770,368 (2.55 TB/s, 76% of the bound; 0.0277 ms in the profiler),
// against 0.0741 ms for the kernel this one replaced (256 outputs a block,
// three direct 32-term sums a thread from shared memory), both timed in one
// run, the one PERF.md quotes; 56 registers, 16,896 bytes of shared memory, no spills.  Tiles of 1024
// to 4096 outputs and 64 to 256 threads time within 2% of each other; a
// cp.async ring was not tried, the plain loads being over 2 TB/s.  PERF.md
// has the rest.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kHalf = 32;                        // repetition lag, fft_len / 2: the group size
constexpr int kTile = 2048;                      // outputs per block (TILE of ops/sync_cuda.py)
constexpr int kThreads = 128;                    // threads per block
constexpr int kLanes = kHalf / 2;                // lanes of a walker, two samples each
constexpr int kWalkers = kThreads / kLanes;      // walkers per block
constexpr int kRun = kTile / kHalf / kWalkers;   // groups of outputs a walker emits
constexpr int kSpan = kTile + 2 * kHalf;         // samples a block stages
constexpr int kPairs = kSpan / 2;                // 16-byte pairs of samples staged
constexpr int kLoads = (kPairs + kThreads - 1) / kThreads;  // pairs a thread stages
constexpr int kAlign = 16;                       // tile origin: a multiple of 16 outputs
static_assert(kThreads % 32 == 0 && kRun >= 1 && kRun * kWalkers * kHalf == kTile,
              "kTile must be a multiple of 32 * (kThreads / 16)");

// Inclusive scan of v over the 16 lanes of a walker: the exclusive prefix
// of this lane and the group's total.
__device__ __forceinline__ void group_scan(float v, unsigned mask, int lane,
                                           float& excl, float& total) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const float up = __shfl_up_sync(mask, v, off, kLanes);
    if (lane >= off) v += up;
  }
  const float up = __shfl_up_sync(mask, v, 1, kLanes);
  excl = lane ? up : 0.f;
  total = __shfl_sync(mask, v, kLanes - 1, kLanes);
}

// One walker's run: kRun groups of outputs from kRun + 2 groups of samples.
// kFull: every output of the tile exists and P takes float4 stores.
template <bool kFull>
__device__ __forceinline__ void walk(const float4* __restrict__ s4, float2* __restrict__ prow,
                                     float* __restrict__ mrow, long long d0, long long out_len,
                                     bool p_vec) {
  const int lane = threadIdx.x % kLanes;
  const int walker = threadIdx.x / kLanes;
  const unsigned mask = 0xffffu << (threadIdx.x & kLanes);  // this half of the warp
  const int slot = walker * kRun * kHalf + 2 * lane;        // this lane's first sample in the tile

  float4 cur = s4[slot / 2];
  // previous group: exclusive prefixes at this lane's two samples, and totals
  float qr0 = 0.f, qr1 = 0.f, qi0 = 0.f, qi1 = 0.f, qe0 = 0.f, qe1 = 0.f;
  float tr = 0.f, ti = 0.f, te = 0.f;
  // group before that: its window sums, waiting for the next group's energy
  float wr0 = 0.f, wr1 = 0.f, wi0 = 0.f, wi1 = 0.f, we0 = 0.f, we1 = 0.f;

#pragma unroll
  for (int k = 0; k < kRun + 2; ++k) {
    // the last step needs only its own energies: no sample 32 ahead of it
    const float4 nxt = k <= kRun ? s4[(slot + (k + 1) * kHalf) / 2] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float cr0 = cur.x * nxt.x + cur.y * nxt.y;  // Re(conj(r[i]) r[i+32])
    const float ci0 = cur.x * nxt.y - cur.y * nxt.x;  // Im
    const float cr1 = cur.z * nxt.z + cur.w * nxt.w;
    const float ci1 = cur.z * nxt.w - cur.w * nxt.z;
    const float e0 = cur.x * cur.x + cur.y * cur.y;
    const float e1 = cur.z * cur.z + cur.w * cur.w;
    float xr, xi, xe, nr, ni, ne;
    group_scan(cr0 + cr1, mask, lane, xr, nr);
    group_scan(ci0 + ci1, mask, lane, xi, ni);
    group_scan(e0 + e1, mask, lane, xe, ne);
    const float pr0 = xr, pr1 = xr + cr0, pi0 = xi, pi1 = xi + ci0, pe0 = xe, pe1 = xe + e0;

    // windows starting in the previous group: its tail plus this group's head
    const float vr0 = (tr - qr0) + pr0, vr1 = (tr - qr1) + pr1;
    const float vi0 = (ti - qi0) + pi0, vi1 = (ti - qi1) + pi1;
    const float ve0 = (te - qe0) + pe0, ve1 = (te - qe1) + pe1;

    if (k >= 2) {  // emit group k - 2: R1 = its energy window, R2 = the next group's
      const long long d = d0 + slot + (k - 2) * kHalf;
      const float m0 = (wr0 * wr0 + wi0 * wi0) / fmaxf(we0 * ve0, 1e-12f);
      const float m1 = (wr1 * wr1 + wi1 * wi1) / fmaxf(we1 * ve1, 1e-12f);
      if (kFull || (d >= 0 && d + 1 < out_len)) {
        if (kFull || p_vec) {
          *reinterpret_cast<float4*>(prow + d) = make_float4(wr0, wi0, wr1, wi1);
        } else {
          prow[d] = make_float2(wr0, wi0);
          prow[d + 1] = make_float2(wr1, wi1);
        }
        *reinterpret_cast<float2*>(mrow + d) = make_float2(m0, m1);
      } else {
        if (d >= 0 && d < out_len) {
          prow[d] = make_float2(wr0, wi0);
          mrow[d] = m0;
        }
        if (d + 1 >= 0 && d + 1 < out_len) {
          prow[d + 1] = make_float2(wr1, wi1);
          mrow[d + 1] = m1;
        }
      }
    }
    wr0 = vr0, wr1 = vr1, wi0 = vi0, wi1 = vi1, we0 = ve0, we1 = ve1;
    qr0 = pr0, qr1 = pr1, qi0 = pi0, qi1 = pi1, qe0 = pe0, qe1 = pe1;
    tr = nr, ti = ni, te = ne;
    cur = nxt;
  }
}

__global__ void __launch_bounds__(kThreads)
sc_metric_kernel(const float2* __restrict__ r, float2* __restrict__ p,
                 float* __restrict__ m, long long n, long long out_len) {
  __shared__ float4 s4[kPairs];
  const long long row = blockIdx.y;
  const float2* __restrict__ rin = r + row * n;
  float2* __restrict__ prow = p + row * out_len;
  float* __restrict__ mrow = m + row * out_len;

  // Output d of this row sits kAlign-aligned in M where (d + phase) % kAlign == 0;
  // tile t covers the outputs d with t * kTile <= d + phase < (t + 1) * kTile.
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(mrow) >> 2) & (kAlign - 1));
  const long long d0 = static_cast<long long>(blockIdx.x) * kTile - phase;  // -15..0 in tile 0
  if (d0 >= out_len) return;
  // d0 + phase is even, so pairs of samples (and of P) starting at d0 + 2 q
  // are 16-byte aligned when the row's element d0 is
  const bool in_vec = (((reinterpret_cast<uintptr_t>(rin) >> 3) + d0) & 1) == 0;
  const bool p_vec = (((reinterpret_cast<uintptr_t>(prow) >> 3) + d0) & 1) == 0;

  // ---- stage the tile's samples: all loads first, then the stores ----
  float4 v[kLoads];
  if (in_vec && d0 >= 0 && d0 + kSpan <= n) {
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(rin + d0);
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int q = threadIdx.x + j * kThreads;
      if (q < kPairs) v[j] = __ldg(g4 + q);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int q = threadIdx.x + j * kThreads;
      const long long d = d0 + 2 * q;
      float2 a = make_float2(0.f, 0.f), b = a;
      if (q < kPairs) {
        if (in_vec && d >= 0 && d + 1 < n) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(rin + d));
          a = make_float2(t.x, t.y), b = make_float2(t.z, t.w);
        } else {
          if (d >= 0 && d < n) a = __ldg(rin + d);
          if (d + 1 >= 0 && d + 1 < n) b = __ldg(rin + d + 1);
        }
      }
      v[j] = make_float4(a.x, a.y, b.x, b.y);
    }
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int q = threadIdx.x + j * kThreads;
    if (q < kPairs) s4[q] = v[j];
  }
  __syncthreads();

  // ---- walk: a walker whose run lies past the row's end has nothing to emit ----
  const long long run0 = d0 + (threadIdx.x / kLanes) * (kRun * kHalf);
  if (run0 >= out_len) return;
  if (p_vec && d0 >= 0 && d0 + kTile <= out_len) {
    walk<true>(s4, prow, mrow, d0, out_len, true);
  } else {
    walk<false>(s4, prow, mrow, d0, out_len, p_vec);
  }
}

}  // namespace

// r: [rows, n] complex64; p: [rows, n - 64] complex64; m: [rows, n - 64]
// float32; all contiguous on the current device.  `tiles`: blocks per row,
// from ops/sync_cuda.py::tiles_per_row; a row's tile grid starts up to
// kAlign - 1 outputs before its output 0 and must reach past its last.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sc_metric_launch(const void* r, void* p, void* m, long long n, int rows,
                                long long tiles, void* stream) {
  const long long out_len = n - 2 * kHalf;
  if (out_len <= 0 || rows <= 0 || rows > 65535 || tiles > 0x7fffffffLL ||
      tiles * kTile < out_len + kAlign - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(rows));
  sc_metric_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(r), static_cast<float2*>(p), static_cast<float*>(m), n, out_len);
  return static_cast<int>(cudaGetLastError());
}
