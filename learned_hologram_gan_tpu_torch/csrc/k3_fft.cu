// K3: one-axis FFT of (B, R, C) complex64 planes, along axis -1 or -2.
//
// Replaces learned_hologram_gan_tpu/ops/pallas/spectral.py:_dft_pass (the
// pl.pallas_call at spectral.py:320), as fft2_pallas/ifft2_pallas use it: a
// 1-D DFT along one axis of the planes in one residency; a 2-D FFT is two
// passes.  The TPU form is a four-step DFT as GEMMs on the MXU; here it is a
// radix-2 FFT in shared memory (fft_radix2.cuh), which does 5 n log2 n
// operations per line instead of the GEMMs' O(n^1.5).
//
//   y[b, ..., k, ...] = scale * sum_j x[b, ..., j, ...] * exp(-+2*pi*i*j*k/n)
//
// with the sign + for `inverse`.  The caller passes scale = 1 or 1/n; the
// adjoint of an unnormalised forward transform is the unnormalised inverse.
//
// Design: one block owns TL neighbouring lines of one plane, loads them
// once into shared memory in bit-reversed order (consecutive threads read
// consecutive addresses: along k for axis -1, along the lines for axis -2),
// transforms in place, and writes once.  Bound: a pass reads and writes the
// planes once, 2 * 8 bytes per element; at the training shapes (12 planes
// of 1024 x 1024) that is 201 MB, ~0.06 ms at 3.35 TB/s, against ~6.3e8
// FLOP (~0.01 ms at 67 TFLOP/s f32): it is bound by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_radix2.cuh"

namespace {

using lhg::bit_reverse;
using lhg::fft_rows;
using lhg::log2_int;

constexpr int kThreads = 512;

template <int TL>
__global__ void __launch_bounds__(kThreads)
fft_axis_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                const float2* __restrict__ twiddle, int n, int lines,
                long long line_stride, long long elem_stride,
                long long plane_stride, int k_fastest, int inverse,
                float scale) {
  extern __shared__ float2 smem[];
  float2* tw = smem;            // (n / 2,)
  float2* buf = smem + n / 2;   // (n, TL)

  const int log2n = log2_int(n);
  const int shift = 32 - log2n;
  const size_t base = static_cast<size_t>(blockIdx.y) * plane_stride +
                      static_cast<size_t>(blockIdx.x) * TL * line_stride;

  for (int i = threadIdx.x; i < n / 2; i += blockDim.x) tw[i] = twiddle[i];
  for (int i = threadIdx.x; i < n * TL; i += blockDim.x) {
    const int k = k_fastest ? i % n : i / TL;
    const int t = k_fastest ? i / n : i % TL;
    buf[bit_reverse(k, shift) * TL + t] =
        x[base + t * line_stride + static_cast<size_t>(k) * elem_stride];
  }
  __syncthreads();
  fft_rows<TL>(buf, tw, n, log2n, inverse != 0);
  for (int i = threadIdx.x; i < n * TL; i += blockDim.x) {
    const int k = k_fastest ? i % n : i / TL;
    const int t = k_fastest ? i / n : i % TL;
    const float2 v = buf[k * TL + t];
    y[base + t * line_stride + static_cast<size_t>(k) * elem_stride] =
        make_float2(v.x * scale, v.y * scale);
  }
}

template <int TL>
int launch(const float2* x, float2* y, const float2* tw, int planes, int n,
           int lines, long long line_stride, long long elem_stride,
           long long plane_stride, int k_fastest, int inverse, float scale,
           cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(n) * TL + n / 2) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      fft_axis_kernel<TL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(lines / TL, planes);
  fft_axis_kernel<TL><<<grid, kThreads, smem, stream>>>(
      x, y, tw, n, lines, line_stride, elem_stride, plane_stride, k_fastest,
      inverse, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Transforms (planes, R, C) complex64 `x` into `y` (distinct buffers) along
// axis -1 (axis_last != 0: n = C, lines = R) or -2 (n = R, lines = C), on
// `stream`.  Returns a cudaError_t value: 0 on success.  n must be a power
// of two and lines % tl == 0; the Python wrapper checks devices, shapes,
// types and contiguity.
extern "C" int k3_fft_axis(const void* x, void* y, const void* twiddle,
                           int planes, int rows, int cols, int axis_last,
                           int tl, int inverse, float scale, int device,
                           void* stream) {
  const int n = axis_last ? cols : rows;
  const int lines = axis_last ? rows : cols;
  if (n < 2 || (n & (n - 1)) != 0 || lines % tl != 0 || planes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long line_stride = axis_last ? cols : 1;
  const long long elem_stride = axis_last ? 1 : cols;
  const long long plane_stride = static_cast<long long>(rows) * cols;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float2* xc = static_cast<const float2*>(x);
  float2* yc = static_cast<float2*>(y);
  const float2* t = static_cast<const float2*>(twiddle);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tl) {
    case 8:
      return launch<8>(xc, yc, t, planes, n, lines, line_stride, elem_stride,
                       plane_stride, axis_last, inverse, scale, s);
    case 4:
      return launch<4>(xc, yc, t, planes, n, lines, line_stride, elem_stride,
                       plane_stride, axis_last, inverse, scale, s);
    case 2:
      return launch<2>(xc, yc, t, planes, n, lines, line_stride, elem_stride,
                       plane_stride, axis_last, inverse, scale, s);
    case 1:
      return launch<1>(xc, yc, t, planes, n, lines, line_stride, elem_stride,
                       plane_stride, axis_last, inverse, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* k3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
