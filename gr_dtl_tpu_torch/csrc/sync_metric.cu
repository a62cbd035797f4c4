// Schmidl-Cox timing metric, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel gr_dtl_tpu/ops/sync_pallas.py::_metric_kernel
// (launched by timing_metric_pallas, pallas_call at sync_pallas.py:149).
//
// For a complex64 stream r of length n and each d < n - 64:
//   P(d)  = sum_{m<32} conj(r[d+m]) * r[d+m+32]
//   R1(d) = sum_{m<32} |r[d+m]|^2
//   R2(d) = sum_{m<32} |r[d+m+32]|^2
//   M(d)  = |P(d)|^2 / max(R1(d) * R2(d), 1e-12)
//
// What bounds it: per output sample the metric needs 8 bytes of input and
// 12 of output (P as float2, M as float), about 75 MB for the 3.77 Msample
// stream of a 2048-frame step (an estimate of ~22 us at the published
// 3.35 TB/s of an H100 SXM at its 700 W limit, not a measurement).
// Computed with sliding sums it is a few flops per sample, so the metric
// is bound by device memory.  This first kernel reads every input sample
// from device memory once per block (plus a 63-sample halo) and writes
// each output once, which meets that bound for device memory; but it
// recomputes each 32-term sum directly, 64 shared-memory loads and ~400
// instructions per output, so on paper shared-memory bandwidth and then
// float32 instruction throughput take longer than device memory.  Sliding the sums along
// a run of outputs per thread is the later fix.
//
// Design: a 1-D grid over blocks of 256 outputs (a second grid dimension
// walks the rows of an [S, n] batch).  Each block stages its 256 + 63
// input samples in shared memory as float2; each thread forms its own three
// 32-term sums directly.  Every sum adds only 32 values, so float32
// precision does not depend on the stream length (the same argument as the
// two-level block sums of ops/sync.py::_moving_sum), and no state crosses
// blocks.  The Pallas kernel's [rows, 128] lane layout and its roll-based
// shift-doubling sums are a TPU layout and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kHalf = 32;                       // repetition lag, fft_len / 2
constexpr int kBlock = 256;                     // outputs (threads) per block
constexpr int kSpan = kBlock + 2 * kHalf - 1;   // input samples a block reads

__global__ void __launch_bounds__(kBlock)
sc_metric_kernel(const float2* __restrict__ r, float2* __restrict__ p,
                 float* __restrict__ m, long long n, long long out_len) {
  __shared__ float2 s[kSpan];
  const float2* row_in = r + static_cast<long long>(blockIdx.y) * n;
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  for (int i = threadIdx.x; i < kSpan; i += kBlock) {
    const long long idx = base + i;
    s[i] = idx < n ? row_in[idx] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  const long long d = base + threadIdx.x;
  if (d >= out_len) return;
  float pr = 0.f, pi = 0.f, r1 = 0.f, r2 = 0.f;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float2 a = s[threadIdx.x + k];
    const float2 b = s[threadIdx.x + k + kHalf];
    pr += a.x * b.x + a.y * b.y;  // Re(conj(a) * b)
    pi += a.x * b.y - a.y * b.x;  // Im(conj(a) * b)
    r1 += a.x * a.x + a.y * a.y;
    r2 += b.x * b.x + b.y * b.y;
  }
  const long long o = static_cast<long long>(blockIdx.y) * out_len + d;
  p[o] = make_float2(pr, pi);
  m[o] = (pr * pr + pi * pi) / fmaxf(r1 * r2, 1e-12f);
}

}  // namespace

// r: [rows, n] complex64; p: [rows, n - 64] complex64; m: [rows, n - 64]
// float32; all contiguous on the current device.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int sc_metric_launch(const void* r, void* p, void* m, long long n,
                                int rows, void* stream) {
  const long long out_len = n - 2 * kHalf;
  if (out_len <= 0 || rows <= 0 || rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((out_len + kBlock - 1) / kBlock),
                  static_cast<unsigned>(rows));
  sc_metric_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(r), static_cast<float2*>(p),
      static_cast<float*>(m), n, out_len);
  return static_cast<int>(cudaGetLastError());
}
