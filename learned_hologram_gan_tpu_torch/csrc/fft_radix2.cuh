// Radix-2 FFT in shared memory, shared by K1/K2 (k1_asm_propagate.cu) and
// K3 (k3_fft.cu).
//
// A block holds an (n, TC) row-major tile: TC independent lines of length n,
// element k of line c at buf[k * TC + c].  fft_rows transforms every line
// in place.  The input must be stored in bit-reversed order along k; the
// result comes out in natural order, unscaled.  Twiddles tw[k] =
// (cos, sin)(2*pi*k/n), k < n/2, come from a host table computed in float64.

#pragma once

#include <cuda_runtime.h>

namespace lhg {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ int bit_reverse(int k, int shift) {
  return static_cast<int>(__brev(static_cast<unsigned>(k)) >> shift);
}

__device__ __forceinline__ int log2_int(int n) {
  return 31 - __clz(n);
}

// In-place radix-2 decimation-in-time FFT along the n rows of `buf`, one
// __syncthreads per stage (and one at the end).  `inverse` conjugates the
// twiddles; no 1/n scale is applied.
template <int TC>
__device__ void fft_rows(float2* buf, const float2* tw, int n, int log2n,
                         bool inverse) {
  const int total = (n >> 1) * TC;
  for (int s = 1; s <= log2n; ++s) {
    const int h = 1 << (s - 1);
    const int tw_stride = n >> s;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int c = idx % TC;
      const int b = idx / TC;
      const int k = b & (h - 1);
      const int i = ((b >> (s - 1)) << s) + k;
      const int j = i + h;
      float2 w = tw[k * tw_stride];
      if (!inverse) w.y = -w.y;
      const float2 u = buf[i * TC + c];
      const float2 v = cmul(buf[j * TC + c], w);
      buf[i * TC + c] = make_float2(u.x + v.x, u.y + v.y);
      buf[j * TC + c] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
}

}  // namespace lhg
