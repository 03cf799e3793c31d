// K4: the transfer-stack apply,
//
//   out[b, d, c] = g0[b, c] * exp(-2*pi*i * z_d * w[c]) * mask,
//
// g0 (B, C, Rp, Cp) complex64, w (C, Rp, Cp) float32, mask (Rp, Cp) float32,
// z (D,) float32 -> out (B, D, C, Rp, Cp) complex64, interleaved (re, im) as
// torch.view_as_real lays it out.  It replaces
// learned_hologram_gan_tpu/ops/pallas/transfer.py:_kernel (the
// pl.pallas_call at transfer.py:104, apply_transfer_stack).
//
// Numerics follow _kernel's float32 order exactly: theta = (f32(-2*pi) * z)
// * w with no FMA contraction, the full-precision sincosf (theta reaches
// ~1e4 rad, so this file must not be built with --use_fast_math), then
// (g0r*hr - g0i*hi) * m and (g0r*hi + g0i*hr) * m.
//
// What bounds it on this card: bytes.  At the training focal stack's shape
// (B 4, C 3, 1024^2, D 20) it writes 4*20*3*1024^2*8 B = 2.01 GB and reads
// ~0.12 GB (g0 once, the w-grid and mask from L2 per plane): >= 0.64 ms at
// 3.35 TB/s, against ~3e9 operations (theta, sincos, the complex multiply
// and the mask), ~0.05 ms at 67 TFLOP/s.  Design: one grid-stride pass, a
// block row per (b, d, c) plane so no thread divides a 64-bit index, each
// element computed and written once as one 8-byte store, H never stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    transfer_stack_kernel(const float2* __restrict__ g0,
                          const float* __restrict__ w_grid,
                          const float* __restrict__ mask,
                          const float* __restrict__ dists,
                          float2* __restrict__ out, int batch, int num_d,
                          int channels, int plane_size, float neg_two_pi) {
  const int planes = batch * num_d * channels;
  for (int plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const int c = plane % channels;
    const int d = (plane / channels) % num_d;
    const int b = plane / (channels * num_d);
    const float sz = __fmul_rn(neg_two_pi, dists[d]);
    const float2* g = g0 + (static_cast<size_t>(b) * channels + c) * plane_size;
    const float* wc = w_grid + static_cast<size_t>(c) * plane_size;
    float2* o = out + static_cast<size_t>(plane) * plane_size;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < plane_size;
         i += gridDim.x * kThreads) {
      const float theta = __fmul_rn(sz, wc[i]);
      float hi, hr;
      sincosf(theta, &hi, &hr);
      const float2 v = g[i];
      const float m = mask[i];
      o[i] = make_float2(
          __fmul_rn(__fsub_rn(__fmul_rn(v.x, hr), __fmul_rn(v.y, hi)), m),
          __fmul_rn(__fadd_rn(__fmul_rn(v.x, hi), __fmul_rn(v.y, hr)), m));
    }
  }
}

}  // namespace

// Launches K4 on `stream`.  Returns a cudaError_t value, 0 on success.  The
// Python wrapper checks devices, shapes, types and contiguity.
extern "C" int k4_transfer_stack(const void* g0, const void* w_grid,
                                 const void* mask, const void* dists, void* out,
                                 int batch, int num_d, int channels,
                                 int plane_size, float neg_two_pi, int device,
                                 void* stream) {
  if (batch < 1 || num_d < 1 || channels < 1 || plane_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long planes = static_cast<long long>(batch) * num_d * channels;
  if (planes > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // enough blocks along a plane to fill the card several times over
  const int blocks_x = static_cast<int>(
      (plane_size + kThreads - 1) / kThreads < 64 ? (plane_size + kThreads - 1) / kThreads : 64);
  const int blocks_y = static_cast<int>(planes < 65535 ? planes : 65535);
  transfer_stack_kernel<<<dim3(blocks_x, blocks_y), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(g0), static_cast<const float*>(w_grid),
      static_cast<const float*>(mask), static_cast<const float*>(dists),
      static_cast<float2*>(out), batch, num_d, channels, plane_size,
      neg_two_pi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* k4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
