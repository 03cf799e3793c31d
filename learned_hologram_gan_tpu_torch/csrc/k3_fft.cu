// K3: one-axis FFT of (B, R, C) complex64 planes, along axis -1 or -2.
//
// Replaces learned_hologram_gan_tpu/ops/pallas/spectral.py:_dft_pass (the
// pl.pallas_call at spectral.py:320), as fft2_pallas/ifft2_pallas use it: a
// 1-D DFT along one axis of the planes in one residency; a 2-D FFT is two
// passes.  The TPU form is a four-step DFT as GEMMs on the MXU; here it is
// the register-resident Stockham FFT of fft_hopper.cuh, 5 n log2 n
// operations per line instead of the GEMMs' O(n^1.5).
//
//   y[b, ..., k, ...] = scale * sum_j x[b, ..., j, ...] * exp(-+2*pi*i*j*k/n)
//
// with the sign + for `inverse`.  The caller passes scale = 1 or 1/n; the
// adjoint of an unnormalised forward transform is the unnormalised inverse.
// The inverse runs as conj(F(conj(x))), folded into the load and the store.
//
// Lengths: every n = 2^a 3^b 5^c up to 16384 (fft_plan.py:make_plan):
// powers of two on E = min(n, 32) in one library, each other length on its
// own library with its plan compiled in (1280 = 16 * 5 * 16 on E = 16, 768
// = 16 * 3 * 16), each a DFT of length n itself, never padded to a power of
// two.
//
// Bound: a pass reads and writes the planes once, 2 * 8 bytes per element;
// at the training shapes (12 planes of 1024 x 1024) that is 201 MB, ~0.06
// ms at 3.35 TB/s, against ~6.3e8 FLOP (~0.01 ms at 67 TFLOP/s f32): it is
// bound by bytes, so the design is about the loads and stores.
//
// Design: a block owns `lpb` lines of one plane.  Along axis -1 (lines
// contiguous) thread j of a line loads elements j + T c, consecutive
// threads on consecutive addresses (256 bytes a warp at n >= 1024); a
// 1024-point line is one warp, and its exchange needs only __syncwarp.
// Along axis -2 (lines strided by C) the block's lpb neighbouring columns
// are interleaved across the lanes, so each row is read and written as a
// segment of lpb * 8 bytes (64 bytes at n = 1024, and at every mixed-radix
// length whose 8 lines fit a block: up to 1024 threads and 227 KB, one
// block an SM where two do not fit), and the exchange is interleaved too
// (position q of column l at q * lpb + l) under the block's barrier.  Each thread issues all E of its loads before it
// computes, so 8 KB per warp are in flight.  Along axis -1 a line's
// exchange needs only __syncwarp where its T threads lie in one warp
// (fft_hopper.cuh:line_in_warp); else the block's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_hopper.cuh"

namespace {

using lhg::hopper::FftPlan;
using lhg::hopper::LineSync;
using lhg::hopper::fft_line;
using lhg::hopper::max_block_threads;

template <int E, bool kColumns>
__global__ void __launch_bounds__(LHG_FFT_K3_LAUNCH_BOUND(E, kColumns))  // max_ or line_block_threads(E)
fft_axis_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                const float2* __restrict__ twiddle, const __grid_constant__ FftPlan plan,
                int lines, int lpb, long long line_stride, long long elem_stride,
                long long plane_stride, int inverse, float scale) {
  extern __shared__ float2 smem[];
#ifdef LHG_FFT_RADICES
  if (kColumns) lpb = lhg::hopper::compiled::kK3Columns;  // a constant: constant strides
#endif
  const int T = plan.threads;
  const int t = threadIdx.x;
  const int l = kColumns ? t % lpb : t / T;
  const int j = kColumns ? t / lpb : t % T;
  const int line = blockIdx.x * lpb + l;
  const bool valid = line < lines;
  const size_t base = static_cast<size_t>(blockIdx.y) * plane_stride +
                      static_cast<size_t>(valid ? line : 0) * line_stride;
  const float conj = inverse ? -1.0f : 1.0f;

  float2 v[E];
#pragma unroll
  for (int c = 0; c < E; ++c) {
    const size_t e = static_cast<size_t>(j + c * T);
    v[c] = valid ? x[base + e * elem_stride] : make_float2(0.f, 0.f);
    v[c].y *= conj;
  }
  float2* buf = kColumns ? smem + l : smem + static_cast<size_t>(l) * plan.buffer;
  fft_line<E>(v, plan, j, buf, kColumns ? lpb : 1, twiddle,
              LineSync{!kColumns && lhg::hopper::line_in_warp(T)});
  if (!valid) return;
  const float scale_y = conj * scale;
#pragma unroll
  for (int c = 0; c < E; ++c) {
    const size_t e = static_cast<size_t>(j + c * T);
    y[base + e * elem_stride] = make_float2(v[c].x * scale, v[c].y * scale_y);
  }
}

template <int E>
int launch(bool columns, const float2* x, float2* y, const float2* tw, const FftPlan& plan,
           int planes, int lines, int lpb, long long line_stride, long long elem_stride,
           long long plane_stride, int inverse, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(lpb) * plan.buffer * sizeof(float2);
  auto kernel = columns ? fft_axis_kernel<E, true> : fft_axis_kernel<E, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lines + lpb - 1) / lpb, planes);
  kernel<<<grid, lpb * plan.threads, smem, stream>>>(x, y, tw, plan, lines, lpb, line_stride,
                                                      elem_stride, plane_stride, inverse, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Transforms (planes, R, C) complex64 `x` into `y` (distinct buffers) along
// axis -1 (axis_last != 0: n = C, lines = R) or -2 (n = R, lines = C), on
// `stream`, with the plan `plan_ints` (host memory, fft_plan.py:plan_ints)
// and its twiddles `twiddle` (device), `lpb` lines to a block.  Returns a
// cudaError_t value: 0 on success.  The Python wrapper checks devices,
// shapes, types and contiguity, and picks lpb.
extern "C" int k3_fft_axis(const void* x, void* y, const void* twiddle, const int* plan_ints,
                           int planes, int rows, int cols, int axis_last, int lpb, int inverse,
                           float scale, int device, void* stream) {
  const FftPlan plan = lhg::hopper::plan_from_ints(plan_ints);
#ifdef LHG_FFT_RADICES
  if (!lhg::hopper::plan_ints_match(plan_ints)) return static_cast<int>(cudaErrorInvalidValue);
#endif
  const int n = axis_last ? cols : rows;
  const int lines = axis_last ? rows : cols;
  const int limit = axis_last ? lhg::hopper::line_block_threads(plan.elems) : max_block_threads(plan.elems);
  if (plan.n != n || plan.elems * plan.threads != n || lpb < 1 || (lpb & (lpb - 1)) != 0 ||
      lpb * plan.threads > limit || planes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#ifdef LHG_FFT_RADICES
  if (!axis_last && lpb != lhg::hopper::compiled::kK3Columns) return static_cast<int>(cudaErrorInvalidValue);
#endif
  const long long line_stride = axis_last ? cols : 1;
  const long long elem_stride = axis_last ? 1 : cols;
  const long long plane_stride = static_cast<long long>(rows) * cols;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float2* xc = static_cast<const float2*>(x);
  float2* yc = static_cast<float2*>(y);
  const float2* t = static_cast<const float2*>(twiddle);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool columns = !axis_last;
#define LHG_K3_CASE(E)                                                                  \
  case E:                                                                               \
    return launch<E>(columns, xc, yc, t, plan, planes, lines, lpb, line_stride, elem_stride, \
                     plane_stride, inverse, scale, s);
  switch (plan.elems) {
    LHG_FFT_KERNEL_ELEMS(LHG_K3_CASE)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LHG_K3_CASE
}

extern "C" const char* k3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
